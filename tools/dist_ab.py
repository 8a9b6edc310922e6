#!/usr/bin/env python3
"""Phase 8 (b) of two trees' ``chip_smoke.py`` in turns, on one graph.

    python3 tools/dist_ab.py --other DIR [--order other,this,this,other]

``DIR`` is another tree of the repo (e.g. a parent commit unpacked with
``git archive``). One process builds phase 3's bmatch graph at the
Netflix shape once, with its exact maximum and the builder's search
bounds, and hands it to each tree's ``dist_solve`` in the given order:
two ``--dist-rank`` processes of that tree's script and ``src`` on the
card, over gloo. So the trees differ only in their rank processes, and
every run sees the same graph and host process. A line per run: each
rank's time to solution and x gather seconds, the processes' wall, the
check failures, and the host's available memory and load before it.
Needs one GPU.
"""
import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path


def host_state() -> dict:
    mem = dict(line.split(":", 1) for line in Path("/proc/meminfo").read_text().splitlines())
    return dict(mem_available_gb=int(mem["MemAvailable"].split()[0]) / 2**20,
                loadavg=Path("/proc/loadavg").read_text().split()[:3])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path, required=True, help="the other tree's root")
    ap.add_argument("--order", default="other,this,this,other,this,other,other,this",
                    help="comma-separated runs, each 'this' or 'other'")
    args = ap.parse_args()
    trees = {"this": Path(__file__).resolve().parents[1], "other": args.other.resolve()}
    sys.path.insert(0, str(trees["this"] / "src"))
    smoke = {}
    for tag, root in trees.items():
        spec = importlib.util.spec_from_file_location(f"chip_smoke_{tag}", root / "chip_smoke.py")
        smoke[tag] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(smoke[tag])

    import torch

    from repro_torch.graphs import baselines, bipartite_ratings, build

    t0 = time.perf_counter()
    g = bipartite_ratings(480_189, 17_770, avg_ratings=209, seed=0)
    exact = baselines.hopcroft_karp_bmatch(g)
    prob = build("bmatch", g, device="cuda", dtype=torch.float64)
    lo, hi = prob.lo, prob.hi
    del prob
    torch.cuda.empty_cache()
    print(f"setup {time.perf_counter() - t0:.1f} s, exact {exact}, bounds [{lo}, {hi}]", flush=True)
    bad = 0
    for i, tag in enumerate(args.order.split(",")):
        before = host_state()
        failures = []
        r = smoke[tag].dist_solve(g, lo, hi, exact, failures)
        reports = r.get("reports", [])
        bad += len(failures) + (not reports)
        print(f"RUN {i + 1} {tag} failures={len(failures)} "
              f"time_to_solution_s={[x['wall_s'] for x in reports]} "
              f"gather_s={[x['all_gather']['ms'] / 1e3 for x in reports]} processes_s={r.get('wall_s')} "
              f"host_before={json.dumps(before)}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
