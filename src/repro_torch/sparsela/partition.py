"""2-D edge partition of the implicit incidence matrix (paper §5.2), in numpy.

Port of ``repro.sparsela.partition``, the same arrays. The vertex set is
split into G contiguous blocks (G = grid side); edge (u, v) belongs to
grid cell (block(u), block(v)). Rank (i, j) of a G x G grid stores its
cell's edges with *block-local* endpoint indices, padded to the max cell
population (one shape on every rank). With this layout
(:mod:`repro_torch.sparsela.distributed`):

    y = M x  : per-cell segment-sums -> sum over the row + sum over the
               column + grid transpose
    g = M^T w: w block arrives by row residency + grid transpose, then a
               pure local gather  w_i[u_loc] + w_j[v_loc]

Each rank communicates O(n/G) words per product — the paper's bound.
Preprocessing is host-side numpy, once per graph (like the paper's
matrix assembly).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..graphs.graph import Graph

__all__ = ["Partition2D", "partition_edges", "partition_edges_1d"]


def partition_edges_1d(n_edges: int, parts: int) -> tuple[int, int]:
    """1-D contiguous edge-slab split (the ``repro_torch.dist`` pod layout).

    Where :func:`partition_edges` builds the paper's 2-D grid layout
    (block-local endpoint ids, per-cell padding) for the legacy
    ``core.mwu_dist`` shims, the distributed solver keeps *global*
    endpoint ids and simply slabs the edge dimension across the ranks of
    a pod: pod rank k owns edges ``[k * slab, (k + 1) * slab)`` of the
    (end-padded) edge list, and the vertex-space coupling is completed
    by one ``all_reduce`` per matvec instead of grid transposes.

    Returns ``(padded_edge_count, slab_width)`` with
    ``padded_edge_count == parts * slab_width`` and
    ``slab_width == ceil(n_edges / parts)``; padding (masked edges)
    is appended at the global end, so a solution over the padded edge
    list strips back to the original with ``x[:n_edges]``.
    """
    parts = max(int(parts), 1)
    n_edges = max(int(n_edges), 1)
    slab = -(-n_edges // parts)
    return parts * slab, slab


@dataclass
class Partition2D:
    grid: int  # G (square grid side)
    n_pad: int  # padded vertex count (G * block)
    block: int  # vertices per block
    e_cell: int  # padded edges per cell
    # (G, G, e_cell) int32 block-local endpoint ids + validity mask
    u_loc: np.ndarray
    v_loc: np.ndarray
    mask: np.ndarray

    @property
    def shapes(self):
        return dict(grid=self.grid, block=self.block, e_cell=self.e_cell)


def partition_edges(g: Graph, grid: int, pad_factor: float = 1.0) -> Partition2D:
    """Assign each edge to cell (block(u), block(v)); pad cells equally."""
    block = (g.n + grid - 1) // grid
    n_pad = block * grid
    bu = (g.u // block).astype(np.int64)
    bv = (g.v // block).astype(np.int64)
    cell = bu * grid + bv
    order = np.argsort(cell, kind="stable")
    cell_sorted = cell[order]
    counts = np.bincount(cell_sorted, minlength=grid * grid)
    e_cell = int(max(8, np.ceil(counts.max() * max(pad_factor, 1.0))))

    u_loc = np.zeros((grid * grid, e_cell), np.int32)
    v_loc = np.zeros((grid * grid, e_cell), np.int32)
    mask = np.zeros((grid * grid, e_cell), bool)
    starts = np.zeros(grid * grid + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    us = (g.u[order] % block).astype(np.int32)
    vs = (g.v[order] % block).astype(np.int32)
    for c in range(grid * grid):
        s, e = starts[c], starts[c + 1]
        k = e - s
        u_loc[c, :k] = us[s:e]
        v_loc[c, :k] = vs[s:e]
        mask[c, :k] = True
    return Partition2D(
        grid=grid,
        n_pad=n_pad,
        block=block,
        e_cell=e_cell,
        u_loc=u_loc.reshape(grid, grid, e_cell),
        v_loc=v_loc.reshape(grid, grid, e_cell),
        mask=mask.reshape(grid, grid, e_cell),
    )
