"""Implicit incidence products over a G x G grid of ranks (paper §5.2).

Port of ``repro.sparsela.distributed``, on ``torch.distributed``. All
functions here are *local* functions: each rank calls them with its own
shard, and they complete their sums with collectives over the rank's row
and column of the grid (:class:`Grid`). Rank (i, j) — rank i * G + j of
the default group, the reference's data-major order — holds edge cell
(i, j) of :func:`repro_torch.sparsela.partition.partition_edges` and the
vertex-block-i shard of every vertex vector (the same on every rank of
grid row i).

Communication per product (per rank): one all_reduce over the row or the
column of a (block,) vector + one grid transpose — O(n/G) words, matching
the paper's 2-D layout analysis. The reference's ``psum`` over its
``model`` axis is the sum over a grid row here, over ``data`` the sum over
a grid column, and its ``ppermute`` a pair of point-to-point messages.
These are plain tensor operations (the legacy layout, off the solver's
path).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from ..core.mwu import all_reduce
from ..dist.mesh import world_timeout

__all__ = ["Grid", "grid_transpose", "mx_local", "mtw_local", "vertex_psum_lse"]


@dataclass(frozen=True)
class Grid:
    """This rank's place (i, j) on a G x G grid of ranks, with the groups of
    its grid row (the ranks (i, *)) and its grid column (the ranks (*, j))."""

    G: int
    i: int
    j: int
    row_group: Any
    col_group: Any

    @staticmethod
    def build(G: int) -> "Grid":
        """The grid over the default group, whose world size must be G * G.
        Every rank must call it (group creation is collective)."""
        world = dist.get_world_size()
        if world != G * G:
            raise ValueError(f"a {G} x {G} rank grid needs {G * G} ranks, the default process group has {world}")
        timeout = world_timeout()
        rows = [dist.new_group([i * G + j for j in range(G)], timeout=timeout) for i in range(G)]
        cols = [dist.new_group([i * G + j for i in range(G)], timeout=timeout) for j in range(G)]
        i, j = divmod(dist.get_rank(), G)
        return Grid(G, i, j, rows[i], cols[j])


def _host(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` where ``group``'s backend takes it: gloo's point-to-point
    messages take no CUDA tensor."""
    return t.cpu() if dist.get_backend(group) == "gloo" else t


def grid_transpose(x: torch.Tensor, grid: Grid) -> torch.Tensor:
    """This rank's value sent to its transposed grid position (j, i); returns
    the value received from there (a diagonal rank keeps its own)."""
    if grid.i == grid.j:
        return x
    peer = grid.j * grid.G + grid.i
    src = _host(x.contiguous(), None)
    out = torch.empty_like(src)
    for work in dist.batch_isend_irecv([dist.P2POp(dist.isend, src, peer), dist.P2POp(dist.irecv, out, peer)]):
        work.wait()
    return out.to(x.device)


def mx_local(u_loc, v_loc, mask, x_loc, block: int, grid: Grid) -> torch.Tensor:
    """y = M x with edge-sharded x. Returns the block-i shard of y (the same
    on every rank of grid row i).

    u_loc/v_loc: (e_cell,) block-local endpoints; x_loc: (e_cell,).
    """
    xm = torch.where(mask, x_loc, 0.0)
    pu = torch.zeros(block, dtype=x_loc.dtype, device=x_loc.device).index_add_(0, u_loc, xm)
    pv = torch.zeros(block, dtype=x_loc.dtype, device=x_loc.device).index_add_(0, v_loc, xm)
    pu = all_reduce(pu, dist.ReduceOp.SUM, grid.row_group)  # complete u-sums for row-block i
    pv = all_reduce(pv, dist.ReduceOp.SUM, grid.col_group)  # complete v-sums for col-block j
    return pu + grid_transpose(pv, grid)  # now v-sums for block i


def mtw_local(u_loc, v_loc, mask, w_loc, grid: Grid) -> torch.Tensor:
    """g = M^T w with vertex-sharded w (block i on grid row i). Returns the
    edge-cell shard of g.

    The row block w_i is resident; the column block w_j arrives by the grid
    transpose (the paper's row+column broadcast)."""
    w_col = grid_transpose(w_loc, grid)  # block j for this rank
    g = w_loc[u_loc] + w_col[v_loc]
    return torch.where(mask, g, 0.0)


def vertex_psum_lse(a_loc: torch.Tensor, grid: Grid):
    """Stable distributed logsumexp over a vertex-sharded vector.

    a_loc: (block,) local slice (the same on every rank of a grid row).
    Returns (lse, local softmax numerator exp(a - m_global), the global sum);
    dividing by the sum gives the global softmax restricted to the local
    block. The reductions run over the grid column (one rank a block).
    """
    m = all_reduce(a_loc.max().clone(), dist.ReduceOp.MAX, grid.col_group)
    e = torch.exp(a_loc - m)
    s = all_reduce(e.sum(), dist.ReduceOp.SUM, grid.col_group)
    return m + torch.log(s), e, s
