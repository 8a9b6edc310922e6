"""Incidence scatter: a deterministic CSR segmented sum (the product M x).

``out[r] = base[r] + sum over row r's entries of a and of b``, where a
and b are the :class:`Segments` of an operator's two sides (its u and v
endpoints). A CUDA ``x`` launches the hand-written kernel of
``csrc/incidence_scatter.cu``, whose sums run in an order fixed by the
segments, so two calls give the same bits; a CPU ``x`` takes the plain
version in ``ref.py``. A CUDA call never falls back: it launches or raises.
"""
from __future__ import annotations

import torch

from .. import loader
from .csr import MERGE_TILE, Segments, dispatch_order
from .ref import incidence_scatter_ref


def _check(name: str, x: torch.Tensor, s: Segments, rows: int) -> None:
    if s.rows != rows or s.cols != x.shape[0]:
        raise ValueError(f"{name}: segments of {s.rows} rows over {s.cols} values, expected {rows} over {x.shape[0]}")
    q = s.slabs * s.span  # CSR rows
    if s.lo < 0 or s.span < 0 or s.lo + s.span > rows or s.slabs < 1:
        raise ValueError(f"{name}: rows [{s.lo}, {s.lo + s.span}) in {s.slabs} slabs, of {rows} rows")
    if s.offsets.device != x.device or s.offsets.dtype != torch.int64 or s.offsets.shape != (q + 1,):
        raise ValueError(f"{name}: offsets must be {q + 1} int64 values on {x.device}")
    tiles = -(-(q + s.nnz) // MERGE_TILE)
    if s.splits.device != x.device or s.splits.dtype != torch.int64 or s.splits.shape != (tiles + 1,):
        raise ValueError(f"{name}: splits must be {tiles + 1} int64 values on {x.device}")
    if s.src is not None:
        loader.check_indices(name, x, s.src)
        if s.src.shape[0] != s.nnz:
            raise ValueError(f"{name}: src has {s.src.shape[0]} entries, nnz {s.nnz}")
    elif s.nnz > x.shape[0]:
        raise ValueError(f"{name}: {s.nnz} entries read x[i] of {x.shape[0]} values")


def _flops(out, x, a, b=None, *rest, **kw) -> dict:
    return {loader.dtype_rate(x.dtype): 2 * (a.nnz + (0 if b is None else b.nnz))}


@loader.counted("incidence_scatter", _flops)
def incidence_scatter(x: torch.Tensor, a: Segments, b: Segments | None = None,
                      base: torch.Tensor | None = None, order: torch.Tensor | None = None) -> torch.Tensor:
    """The rows' sums of ``a`` and ``b`` over x, added to ``base`` (None: 0),
    in x's dtype; ``b`` None: one side. ``order``: the kernel's dispatch
    order over the two sides' merge tiles (None: ``dispatch_order(a, b)``,
    built on this call; an operator keeps its own). Every order gives the
    same bits."""
    if x.device.type == "cpu":
        return incidence_scatter_ref(x, a, b, base)
    n = a.rows
    sides = [s for s in (a, b) if s is not None]
    wts = [None if s.wt is None else s.wt.to(x.dtype).contiguous() for s in sides]
    dtype = loader.check_vectors("incidence_scatter", x, *[t for t in [base, *wts] if t is not None])
    for s in sides:
        _check("incidence_scatter", x, s, n)
    if base is not None and base.shape[0] != n:
        raise ValueError(f"incidence_scatter: base has {base.shape[0]} values, expected {n}")
    if order is None:
        order = dispatch_order(a, b)
    tiles = sum(s.tiles for s in sides)
    if order.device != x.device or order.dtype != torch.int32 or order.shape != (tiles,) or \
            not order.is_contiguous():
        raise ValueError(f"incidence_scatter: order must be {tiles} contiguous int32 values on {x.device}")
    lib = loader.load()
    if lib.rt_incidence_scatter_tile() != MERGE_TILE:
        raise RuntimeError(f"incidence_scatter: the kernel's merge tile is {lib.rt_incidence_scatter_tile()}, "
                           f"the segments' {MERGE_TILE}")
    out = torch.empty(n, dtype=dtype, device=x.device)
    scratch = torch.empty(sum(lib.rt_incidence_scatter_scratch(s.span, s.slabs, s.nnz) for s in sides),
                          dtype=dtype, device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    args = []
    for s, wt in zip([a, b], wts + [None]):
        args += [None] * 4 + [0] * 4 if s is None else \
            [ptr(s.offsets), ptr(s.splits), ptr(s.src), ptr(wt), s.nnz, s.lo, s.span, s.slabs]
    with torch.cuda.device(x.device):
        rc = loader.kernel_fn("rt_incidence_scatter", dtype)(
            x.data_ptr(), ptr(base), out.data_ptr(), n, *args, order.data_ptr(), scratch.data_ptr(),
            loader.stream_handle(x)
        )
    loader.check_status(rc, "incidence_scatter")
    loader.LAUNCHES["incidence_scatter"] += 1
    return out
