#!/usr/bin/env python3
"""Time layouts of the incidence scatter's CSR on one GPU.

    python3 tools/scatter_ab.py [--edges E] [--slab-cols C ...]

The committed kernel (``csrc/incidence_scatter.cu``) runs on the edges of
``chip_smoke.py``'s phase 2 (bmatch's shape: users ascending, items of
Zipf popularity), with its segments laid out in several ways: both sides
as ``Incidence.csr`` builds them, the u side alone (x read in order), the
v side alone as built, the v side in one piece (no slabs: x read through
the permutation), the same segments with the permutation replaced by the
identity (x read in order: what the scattered reads cost), and the v side
cut into slabs of C values of x (the layout ``csr.segments`` builds;
its default is ``SLAB_COLS``). Each layout is timed as ``chip_smoke.py``
times a kernel (one call captured in a CUDA graph, replayed between CUDA
events), twice in turns, in f32 and f64, beside the two ``index_add_``
calls the kernel replaced; every layout's sums are held against the
plain version at the reductions' bars (1e-4 at f32, 1e-10 at f64,
relative to max(1, |plain|)). Exits non-zero if one is outside its bar.
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
    ap.add_argument("--edges", type=int, default=98_609_647)
    ap.add_argument("--slab-cols", type=int, nargs="*", default=[1 << 17, 1 << 18, 1 << 19, 1 << 20, 1 << 21])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scatter_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import device_ms
    from repro_torch.core.operators import Incidence
    from repro_torch.kernels import incidence_scatter
    from repro_torch.kernels.incidence_scatter import Segments, segments
    from repro_torch.kernels.incidence_scatter.ref import incidence_scatter_ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n, n_items, E = 497_959, 17_770, args.edges
    n_users = n - n_items
    u = torch.randint(0, n_users, (E,), generator=gen, device=dev, dtype=torch.int32).sort().values
    v = n_users + torch.clamp((n_items * torch.rand(E, generator=gen, device=dev, dtype=torch.float64) ** 2)
                              .to(torch.int32), max=n_items - 1)
    a, b = Incidence(u=u, v=v, n_vertices=n).csr
    whole = segments(v, n, E, slab_cols=E)
    ident = Segments(rows=n, cols=E, nnz=E, offsets=whole.offsets, src=torch.arange(E, dtype=torch.int32, device=dev),
                     wt=None, splits=whole.splits, span=n)
    slabbed = {c: segments(v, n, E, slab_cols=c) for c in args.slab_cols}
    print(f"  Incidence.csr: v side in {b.slabs} slabs of rows [{b.lo}, {b.lo + b.span}); "
          + ", ".join(f"{c} cols: {s.slabs} slabs" for c, s in slabbed.items()), flush=True)
    torch.cuda.synchronize()
    failed = []
    for dtype in (torch.float32, torch.float64):
        tol = 1e-4 if dtype == torch.float32 else 1e-10
        x = torch.rand(E, generator=gen, device=dev, dtype=dtype)
        plain = {"both": incidence_scatter_ref(x, a, b), "u": incidence_scatter_ref(x, a),
                 "v": incidence_scatter_ref(x, b)}
        layouts = {"both": lambda: incidence_scatter(x, a, b), "u": lambda: incidence_scatter(x, a),
                   "v": lambda: incidence_scatter(x, b), "v_whole": lambda: incidence_scatter(x, whole),
                   "v_identity": lambda: incidence_scatter(x, ident),
                   "index_add": lambda: torch.zeros(n, dtype=dtype, device=dev).index_add_(0, u, x)
                   .index_add_(0, v, x)}
        for c, s in slabbed.items():
            layouts[f"v_cols{c}"] = lambda s=s: incidence_scatter(x, s)
        for name, fn in layouts.items():
            want = plain["v"] if name.startswith(("v_cols", "v_whole")) else plain.get(name)
            if want is not None:
                err = ((fn() - want).abs() / want.abs().clamp(min=1.0)).max().item()
                if not err <= tol:
                    failed.append((name, str(dtype), err))
        times = {name: [] for name in layouts}
        for order in (list(layouts), list(reversed(layouts))):
            for name in order:
                times[name].append(device_ms(layouts[name], 10))
        for name, ts in times.items():
            print(f"  {str(dtype).removeprefix('torch.'):8s} {name:14s} device ms {ts[0]:.4f} / {ts[1]:.4f}",
                  flush=True)
        del x, plain
    if failed:
        print(f"scatter_ab: outside the bar: {failed}", file=sys.stderr)
        return 1
    print("scatter_ab: every layout within its bar")
    return 0


if __name__ == "__main__":
    sys.exit(main())
