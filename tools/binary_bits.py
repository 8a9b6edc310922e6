#!/usr/bin/env python3
"""The binary step rule's card solves of ``chip_smoke.py`` phase 4, to compare two trees' bits.

    python3 tools/binary_bits.py [--src DIR]

Solves match and vcover on ``rgg(12, seed=0)`` with
``Solver(MWUOptions(eps=0.1, step_rule="binary"))`` on the GPU, as phase 4
does, and prints for each its status, feasibility calls, lane iterations,
probes, objective, the sha256 of x, and the launches of the search and
probe kernels. ``--src DIR`` imports ``repro_torch`` from DIR (an unpacked
tree of another commit, whose kernels are then built there) instead of
this tree's ``src``. Run each tree in its own process: two builds of the
kernel library do not work in one.
"""
from __future__ import annotations

import argparse
import hashlib
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src", help="the tree whose repro_torch is run")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("binary_bits: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch import kernels as K
    from repro_torch.api import MWUOptions, Solver, Status
    from repro_torch.graphs import build, rgg

    g = rgg(12, seed=0)
    opts = MWUOptions(eps=0.1, step_rule="binary")
    print(f"tree {args.src}", flush=True)
    for family in ("match", "vcover"):
        prob = build(family, g, device="cuda")
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        sol = Solver(opts).solve(prob)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in K.launch_counts().items() if k in ("linesearch_probe", "newton_search",
                                                                          "binary_search")}
        digest = hashlib.sha256(np.ascontiguousarray(sol.x).tobytes()).hexdigest()
        print(f"{family}: {Status.NAMES[sol.status]}, {sol.feasibility_calls} calls, {sol.mwu_iters_total} lane "
              f"iterations, {sol.ls_probes_total} probes, objective {sol.objective!r}, sha256 x {digest}; launches "
              f"{counts}; {wall:.2f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
