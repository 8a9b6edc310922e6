"""The control that sets the upper readings of ``correct``'s limits.

    python lpbench/control.py --workload <cell> --seeds 1,2,3 [--seconds 1]

For each seed, one run of the cell (``harness.run_cell``) with the port's
float32 path switched on: the nearest precision below the configurations'
float64. It drives the cell's own window, at the cell's own sizes, and is
judged by the harness's own ``correct``; each run prints one JSON line
with its seed, ``correct`` and the numbers compared. The program's own
readings are those of the cell's runs (``run.py``). The benchmark's runs
do not run this.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from lpbench import harness

    if not torch.cuda.is_available():
        print("lpbench.control: needs a CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",") if s):
        out = harness.run_cell(args.workload, seed, args.seconds, False, dtype="float32", root=ROOT)
        print(json.dumps({"seed": seed, "correct": out["correct"], "failed": out["failed"],
                          "attempted": out["attempted"], "checks": out["checks"], "log": out["log"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
