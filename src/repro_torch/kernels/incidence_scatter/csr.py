"""The CSR form of one side of a scatter product, built once per operator.

A product that sums edge values into rows (``Incidence.matvec`` and the
like) is a sum over segments: row r takes the entries ``offsets[r]`` to
``offsets[r+1] - 1``, entry i contributing ``wt[i] * x[src[i]]``. The
entries are the operator's edges grouped by row in a stable order, so each
segment keeps edge order. Masked edges are left out: ``where(mask, x, 0)``
adds exactly nothing for them, whatever x holds.

Built with plain PyTorch on the index tensors' device; a graph's ``u`` is
already sorted (``Graph.from_edges`` emits edges by ``(lo, hi)``), and a
side that is sorted and unmasked keeps no permutation: its entry i reads
``x[i]`` (``src`` None).

A side whose entries, grouped by row, read x out of order (the v side of
an edge list, the partner endpoints of an adjacency, a COO's columns)
takes 8 bytes of each 32-byte sector it fetches. Where x is long, such a
side is cut into slabs of :data:`SLAB_COLS` values of x, so that the reads
of one slab stay in the L2: its CSR rows are then (slab, row) pairs,
slab-major, over the rows ``[lo, lo + span)`` that the side touches, and
the kernel adds a row's slabs in an order fixed by their count.

The kernel walks the merge of the CSR's row ends with its entries (merge
path) in tiles of :data:`MERGE_TILE` items; where each tile starts in that
merge depends on the CSR alone, so it is computed here once (``splits``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["MERGE_TILE", "SLAB_COLS", "Segments", "merge_splits", "segments"]

#: merge items a block of the kernel takes (csrc/incidence_scatter.cu,
#: kScatterTile; the wrapper checks that the two agree)
MERGE_TILE = 2048
#: values of x a slab covers (4 MB at f64; tools/scatter_ab.py)
SLAB_COLS = 1 << 19


@dataclass(frozen=True)
class Segments:
    """Entries grouped by row: CSR row q sums entries ``offsets[q]`` to
    ``offsets[q+1] - 1``; entry i is ``wt[i] * x[src[i]]`` (``src`` None:
    ``x[i]``; ``wt`` None: weight 1) for an x of ``cols`` values. CSR row
    ``k * span + q`` is output row ``lo + q`` over slab k of ``slabs``; the
    output has ``rows`` rows (unslabbed: lo 0, span rows, slabs 1)."""

    rows: int
    cols: int
    nnz: int
    offsets: torch.Tensor  # (slabs * span + 1,) int64
    src: torch.Tensor | None  # (nnz,) int32
    wt: torch.Tensor | None  # (nnz,)
    splits: torch.Tensor  # (tiles + 1,) int64: CSR rows whose ends come before each merge tile
    lo: int = 0
    span: int = 0
    slabs: int = 1

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.offsets, self.src, self.wt, self.splits)
                   if t is not None)


def segments(row_of: torch.Tensor, rows: int, cols: int, *, src: torch.Tensor | None = None,
             wt: torch.Tensor | None = None, keep: torch.Tensor | None = None,
             slab_cols: int = SLAB_COLS) -> Segments:
    """The entries e (those with ``keep[e]``, if given) grouped by row
    ``row_of[e]`` in a stable order; entry e reads ``x[src[e]]`` (``src``
    None: ``x[e]``) with weight ``wt[e]``. ``row_of`` and ``src`` are int32.
    A side that reads x out of order (its x indices, in CSR order, not
    ascending) is cut into slabs of ``slab_cols`` values of x, at most one
    CSR row for every 8 entries."""
    if src is not None and src.dtype != torch.int32:
        raise TypeError(f"segments: src must be int32, got {src.dtype}")
    r, idx = row_of, None
    if keep is not None:
        idx = torch.nonzero(keep).squeeze(1)
        r = r.index_select(0, idx)
    nnz = int(r.shape[0])
    if nnz > 1 and not bool((r[1:] >= r[:-1]).all()):
        r, order = torch.sort(r, stable=True)
        idx = order if idx is None else idx.index_select(0, order)
    # the x index each entry reads, in CSR order (None: entry i reads x[i])
    at = idx if src is None else (src if idx is None else src.index_select(0, idx))
    lo, span, slabs = 0, rows, 1
    if at is not None and nnz > 1 and not bool((at[1:] >= at[:-1]).all()):
        lo, span = int(r[0]), int(r[-1]) - int(r[0]) + 1
        slabs = max(1, min(-(-cols // slab_cols), nnz // (8 * span)))
    if slabs > 1:
        # regroup slab-major, (slab of x, row), stably: a segment keeps edge order
        key, order = torch.sort((at.to(torch.int64) * slabs // cols) * span + (r.to(torch.int64) - lo), stable=True)
        idx = order if idx is None else idx.index_select(0, order)
    else:
        lo, span, key = 0, rows, r
    offsets = torch.searchsorted(key, torch.arange(slabs * span + 1, dtype=key.dtype, device=key.device))
    if idx is not None:
        src = idx.to(torch.int32) if src is None else src.index_select(0, idx)
        wt = None if wt is None else wt.index_select(0, idx)
    return Segments(rows=rows, cols=cols, nnz=nnz, offsets=offsets, src=src, wt=wt,
                    splits=merge_splits(offsets, nnz), lo=lo, span=span, slabs=slabs)


def merge_splits(offsets: torch.Tensor, nnz: int) -> torch.Tensor:
    """CSR rows consumed before each merge tile starts, and the row count last.

    In the merge of the row ends with the entries (an entry j before row
    end q iff j < offsets[q+1]), row q's end is item q + offsets[q+1]; the
    rows consumed before item d are those whose end lies before it."""
    rows = offsets.shape[0] - 1
    ends = torch.arange(rows, dtype=torch.int64, device=offsets.device) + offsets[1:]
    items = rows + nnz
    tiles = -(-items // MERGE_TILE)
    starts = torch.arange(tiles + 1, dtype=torch.int64, device=offsets.device) * MERGE_TILE
    return torch.searchsorted(ends, starts.clamp(max=items))
