"""Run one cell of the port's benchmark once and print its result line.

    python lpbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout: the program is ``src/repro_torch``, put on
``sys.path`` here. The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
with its limit); the checks are also the last lines of standard error.
Exits 2 without a result where there is no CUDA card or fewer than the
cell asks for, and 3 where JAX or the JAX package was loaded.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from lpbench import harness, spec

    cell = spec.resolve(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"lpbench: {args.workload} needs {cell.chips} CUDA card(s), found {n}", file=sys.stderr)
        return 2
    out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device="cuda",
                           t_process=T_PROCESS, root=ROOT)
    found = harness.forbidden_modules()
    if found:
        print(f"lpbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    log = out.pop("log")
    print(json.dumps(out), flush=True)
    for line in log:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
