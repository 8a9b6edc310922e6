"""Serving demo: mixed-size graph-LP traffic through repro_torch.lpserve.

    PYTHONPATH=src python -m repro_torch.lpserve [--requests 12] [--lanes 8] [--device cpu]
        [--tiers 40x100,60x160,80x220]

The port's twin of ``examples/serve_lp_batch.py``, with its arguments, its
printout and its asserts. Heterogeneous requests (different graph sizes,
multiple LP families) go through the :class:`repro_torch.lpserve.LPEngine`:
each problem is padded into its shape bucket via ``edge_mask``, bucket
lanes are continuously refilled from the queue, and every dispatch round
drives ONE batched feasibility loop per bucket. ``--device`` picks where
the problems live (default ``cuda``); ``--tiers`` the graph sizes (``n x
m`` of ``erdos``, request i on tier i mod the tier count).

The script asserts every request returns a feasible certified Solution
that matches the sequential ``Solver.solve`` objective within 3*eps, and
that batching actually happened (fewer batches than feasibility calls).
"""
import argparse
import sys
import time

import torch

from ..api import MWUOptions, Solver
from ..graphs import build, erdos
from . import LPEngine, LPServeConfig


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--eps", type=float, default=0.1)
    ap.add_argument("--families", default="match,vcover")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiers", default="40x100,60x160,80x220", help="graph size tiers, n x m of erdos(n, m)")
    args = ap.parse_args(argv)

    # size tiers -> mixed-shape traffic (the thing the engine exists for)
    size_tiers = [tuple(int(v) for v in t.split("x")) for t in args.tiers.split(",")]
    families = args.families.split(",")
    probs = []
    for i in range(args.requests):
        n, m = size_tiers[i % len(size_tiers)]
        probs.append(build(families[i % len(families)], erdos(n, m, seed=i), device=args.device))

    opts = MWUOptions(eps=args.eps, step_rule="newton")
    engine = LPEngine(LPServeConfig(opts=opts, lanes=args.lanes))

    _sync(args.device)
    t0 = time.perf_counter()
    sols = engine.solve_many(probs)
    _sync(args.device)
    t_engine = time.perf_counter() - t0

    solver = Solver(opts, batch_width=1)
    t0 = time.perf_counter()
    refs = [solver.solve(p) for p in probs]
    _sync(args.device)
    t_seq = time.perf_counter() - t0

    stats = engine.stats()
    print(f"{args.requests} mixed-size requests ({', '.join(families)}; tiers {size_tiers}) on {args.device}")
    print(f"engine    : {t_engine:6.2f}s  ({stats['batches']} batches, "
          f"{stats['feasibility_calls']} probes, "
          f"occupancy {stats['lane_occupancy']:.0%}, "
          f"padding waste {stats['padding_waste']:.0%})")
    print(f"sequential: {t_seq:6.2f}s  (per-request binary search)")
    print(f"compiles  : {stats['compiles']} "
          f"(+{stats['compile_cache_hits']} cache hits); "
          f"latency p50 {stats['latency_p50_s']:.2f}s p99 {stats['latency_p99_s']:.2f}s")
    for key, b in stats["buckets"].items():
        print(f"  bucket {key:20s} requests={b['requests']:3d} batches={b['batches']:3d} "
              f"occupancy={b['lane_occupancy']:.0%} waste={b['padding_waste']:.0%}")

    # smoke contract, as the reference example's
    for i, (p, sol, ref) in enumerate(zip(probs, sols, refs)):
        assert sol.feasible, f"request {i} ({p.name} on {p.graph.name}): not feasible"
        rel = abs(sol.objective - ref.objective) / max(abs(ref.objective), 1e-12)
        assert rel <= 3.0 * args.eps, (
            f"request {i}: engine objective {sol.objective:.4f} deviates "
            f"{rel:.3f} from sequential {ref.objective:.4f}"
        )
        print(f"  request {i:2d}: {p.name:7s} {p.graph.name:8s} "
              f"obj={sol.objective:8.3f} (seq {ref.objective:8.3f}) "
              f"calls={sol.feasibility_calls}")
    assert stats["batches"] < stats["feasibility_calls"], "batching never kicked in"
    print("all requests feasible; engine objectives match sequential solve")
    return 0


if __name__ == "__main__":
    sys.exit(main())
