#!/usr/bin/env python3
"""The graph-LP serving run of ``chip_smoke.py`` phase 6, to compare two trees' bits.

    python3 tools/serve_bits.py [--src DIR] [--requests N]

Builds phase 6's requests (match and vcover alternating, request i on
``erdos(n, m, seed=i)`` of ``chip_smoke.SERVE_TIERS[i % 3]``), serves them
through ``LPEngine(LPServeConfig(MWUOptions(eps=0.1, step_rule="newton"),
lanes=4))`` on the GPU, and prints for each request its feasibility
calls, lane iterations, objective and the sha256 of its x, then
``chip_smoke.served_digest`` over all of them (the line phase 6 prints)
and the engine's launches. ``--src DIR`` imports ``repro_torch`` from DIR
(an unpacked tree of another commit, whose kernels are then built there)
instead of this tree's ``src``. Run each tree in its own process: two
builds of the kernel library do not work in one.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src", help="the tree whose repro_torch is run")
    ap.add_argument("--requests", type=int, default=12, help="requests served (phase 6's count)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("serve_bits: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.src.resolve()))
    sys.path.insert(1, str(ROOT))
    from chip_smoke import EPS, SERVE_TIERS, served_digest
    from repro_torch import kernels as K
    from repro_torch.api import MWUOptions
    from repro_torch.graphs import build, erdos
    from repro_torch.lpserve import LPEngine, LPServeConfig

    print(f"tree {args.src}", flush=True)
    probs = [build(("match", "vcover")[i % 2], erdos(*SERVE_TIERS[i % 3], seed=i), device="cuda")
             for i in range(args.requests)]
    engine = LPEngine(LPServeConfig(opts=MWUOptions(eps=EPS, step_rule="newton"), lanes=4))
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    sols = engine.solve_many(probs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for i, (p, sol) in enumerate(zip(probs, sols)):
        digest = hashlib.sha256(np.ascontiguousarray(sol.x).tobytes()).hexdigest()
        print(f"request {i:2d} {p.name:6s}: {sol.feasibility_calls} calls, {sol.mwu_iters_total} lane iterations, "
              f"objective {sol.objective!r}, sha256 x {digest}", flush=True)
    print(f"sha256 served answers: {served_digest(sols)} ({len(sols)} requests, engine {wall:.2f} s)", flush=True)
    print(f"launches: {json.dumps(K.launch_counts())}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
