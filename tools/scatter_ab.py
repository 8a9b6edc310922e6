#!/usr/bin/env python3
"""Time layouts and dispatch orders of the incidence scatter on one GPU.

    python3 tools/scatter_ab.py [--src DIR] [--edges E] [--slab-cols C ...] [--bits]

The kernel of ``csrc/incidence_scatter.cu`` runs M x at two shapes, each
timed as ``chip_smoke.py`` times a kernel (one call captured in a CUDA
graph, replayed between CUDA events), twice in turns, in f32 and f64:

* ``bmatch``: ``chip_smoke.py``'s phase 2 inputs (``scatter_inputs``: the
  bmatch graph's shape, users ascending, items of Zipf popularity), E
  edges over 497,959 vertices; x does not fit the L2.
* ``serving``: the match operator of phase 6's tier-1 request 4,
  ``erdos(800_000, 3_000_000, seed=4)`` padded by ``pad_problem`` onto the
  bucket V1048576xE4194304 (``serving_scatter_op``); x fits the L2.

Layouts: both sides as the operator builds them, in its dispatch order
(``both``), side-major (``both_side_major``: a's tiles, then b's) and
interleaved by slab of x (``both_interleaved``: ``csr.dispatch_order``);
the u side alone (x read in order), the v side alone as built, the v side
in one piece (``v_whole``: no slabs, x read through the permutation), the
same segments with the permutation replaced by the identity
(``v_identity``: what the scattered reads cost), and, at bmatch, the v side
cut into slabs of C values of x (``v_cols<C>``). Beside them, eagerly
timed: ``torch.mv`` over the n x E ``torch.sparse_csr_tensor`` of both
sides' entries (cuSPARSE) and the two ``index_add_`` calls the kernel
replaced. Every layout's sums are held against the plain version at the
reductions' bars (1e-4 at f32, 1e-10 at f64, relative to max(1,
|plain|)); the tool exits non-zero if one is outside its bar.

``--src DIR`` imports ``repro_torch`` from DIR (an unpacked tree of another
commit, whose kernels are then built there) instead of this tree's
``src``; layouts that tree's wrapper does not take (dispatch orders) are
left out. ``--bits`` also prints the sha256 of the f64 product at the
bmatch inputs and of the x of ``chip_smoke.py``'s bmatch solve, so that
two trees' bits can be compared. Run each tree in its own process: two
builds of the kernel library do not work in one.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src", help="the tree whose repro_torch is timed")
    ap.add_argument("--edges", type=int, default=98_609_647)
    ap.add_argument("--slab-cols", type=int, nargs="*", default=[1 << 17, 1 << 19, 1 << 21])
    ap.add_argument("--bits", action="store_true", help="print the sha256 of the f64 product and of bmatch's x")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scatter_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.src.resolve()))
    sys.path.insert(1, str(ROOT))
    from chip_smoke import call_ms, device_ms, scatter_inputs, scatter_x, serving_scatter_op, sha256, sparse_matrix
    from repro_torch.core.operators import Incidence
    from repro_torch.kernels import incidence_scatter
    from repro_torch.kernels.incidence_scatter import csr as csr_mod
    from repro_torch.kernels.incidence_scatter import Segments, segments
    from repro_torch.kernels.incidence_scatter.ref import incidence_scatter_ref

    import repro_torch
    ordered = hasattr(csr_mod, "dispatch_order")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    print(f"  repro_torch from {Path(repro_torch.__file__).parent}; dispatch orders: {ordered}", flush=True)
    dev = torch.device("cuda")
    failed = []
    for shape in ("bmatch", "serving"):
        if shape == "bmatch":
            n, n_items, E = 497_959, 17_770, args.edges
            u, v = scatter_inputs(n, n_items, E)
            op, keep, slab_cols = Incidence(u=u, v=v, n_vertices=n), None, args.slab_cols
        else:
            op = serving_scatter_op()
            u, v, n, E, keep, slab_cols = op.u, op.v, op.n_vertices, int(op.u.shape[0]), op.edge_mask, []
        a, b = op.csr
        whole = segments(v, n, E, keep=keep, slab_cols=E)
        ident = Segments(rows=n, cols=E, nnz=whole.nnz, offsets=whole.offsets, src=torch.arange(
            whole.nnz, dtype=torch.int32, device=dev), wt=None, splits=whole.splits, span=n)
        slabbed = {c: segments(v, n, E, keep=keep, slab_cols=c) for c in slab_cols}
        print(f"== {shape}: E {E} ({a.nnz} kept), n {n}; u side {a.tiles if ordered else '?'} tiles, v side in "
              f"{b.slabs} slabs of rows [{b.lo}, {b.lo + b.span}); " + ", ".join(
                  f"{c} cols: {s.slabs} slabs" for c, s in slabbed.items()), flush=True)
        for dtype in (torch.float32, torch.float64):
            tol = 1e-4 if dtype == torch.float32 else 1e-10
            x = scatter_x(E, dtype)
            xw = x if keep is None else x * keep.to(dtype)
            mat = sparse_matrix((a, b), dtype)
            plain = {"both": incidence_scatter_ref(x, a, b), "u": incidence_scatter_ref(x, a),
                     "v": incidence_scatter_ref(x, b), "v_identity": incidence_scatter_ref(x, ident)}
            layouts = {"u": lambda: incidence_scatter(x, a), "v": lambda: incidence_scatter(x, b),
                       "v_whole": lambda: incidence_scatter(x, whole),
                       "v_identity": lambda: incidence_scatter(x, ident)}
            if ordered:
                side_major = torch.arange(a.tiles + b.tiles, dtype=torch.int32, device=dev)
                inter = csr_mod.dispatch_order(a, b)
                layouts.update(both=lambda: incidence_scatter(x, a, b, order=op.scatter_order),
                               both_side_major=lambda: incidence_scatter(x, a, b, order=side_major),
                               both_interleaved=lambda: incidence_scatter(x, a, b, order=inter))
            else:
                layouts.update(both=lambda: incidence_scatter(x, a, b))
            for c, s in slabbed.items():
                layouts[f"v_cols{c}"] = lambda s=s: incidence_scatter(x, s)
            library = {"cusparse": lambda: torch.mv(mat, x),
                       "index_add": lambda: torch.zeros(n, dtype=dtype, device=dev).index_add_(0, u, xw)
                       .index_add_(0, v, xw)}
            first = None  # the first both-sides product: every order and launch gives its bits
            for name, fn in {**layouts, **library}.items():
                want = plain["both"] if name.startswith("both") or name in library else \
                    plain.get(name, plain["v"])
                got = fn()
                err = ((got - want).abs() / want.abs().clamp(min=1.0)).max().item()
                if name.startswith("both"):
                    first = got if first is None else first
                    err = err if torch.equal(got, fn()) and torch.equal(got, first) else float("inf")
                print(f"  {str(dtype).removeprefix('torch.'):8s} {name:17s} {err:.3g} from the plain version"
                      + (f"; two calls bit-equal: {torch.equal(got, fn())}" if name == "cusparse" else ""),
                      flush=True)
                if not err <= tol and name != "cusparse":
                    failed.append((shape, name, str(dtype), err))
            times = {name: [] for name in {**layouts, **library}}
            for order in (list(times), list(reversed(times))):
                for name in order:
                    times[name].append(device_ms(layouts[name], 10) if name in layouts else
                                       call_ms(library[name], 10))
            for name, ts in times.items():
                print(f"  {str(dtype).removeprefix('torch.'):8s} {name:17s} {'eager' if name in library else 'device'}"
                      f" ms {ts[0]:.4f} / {ts[1]:.4f}", flush=True)
            if args.bits and shape == "bmatch" and dtype == torch.float64:
                print(f"sha256 scatter f64 [{E}, {n}]: {sha256(op.matvec(x))}", flush=True)
            del x, xw, mat, plain, first
        del op, a, b, whole, ident, slabbed, u, v
        torch.cuda.empty_cache()
    if args.bits:
        from repro_torch.api import MWUOptions, Solver
        from repro_torch.graphs import bipartite_ratings, build

        prob = build("bmatch", bipartite_ratings(480_189, 17_770, avg_ratings=209, seed=0), device="cuda",
                     dtype=torch.float64)
        sol = Solver(MWUOptions(eps=0.1, step_rule="newton"), batch_width=4).solve(prob)
        print(f"sha256 bmatch x: {sha256(sol.x)} ({sol.mwu_iters_total} lane iterations, "
              f"objective {sol.objective!r})", flush=True)
    if failed:
        print(f"scatter_ab: outside the bar: {failed}", file=sys.stderr)
        return 1
    print("scatter_ab: every layout within its bar")
    return 0


if __name__ == "__main__":
    sys.exit(main())
