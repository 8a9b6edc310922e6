"""DEPRECATED distributed MWU entry points — thin shims over ``repro_torch.dist``.

Port of ``repro.core.mwu_dist``. The 2-D grid-partitioned solver of the
reference's past is superseded by the distributed solver layer:

* :class:`repro_torch.dist.MeshPlan` + :class:`repro_torch.dist.DistSolver`
  run the SAME core loop (``core.mwu``) over ranks with 1-D edge slabs and
  all_reduce-completed constraint rows;
* the legacy 2-D layout itself survives as
  :func:`repro_torch.sparsela.partition.partition_edges` (host-side
  preprocessing).

These shims keep the old call signatures and result types alive by
translating onto the new layer; importing this module emits one
``DeprecationWarning`` per process. ``mesh`` is a :class:`MeshPlan` (or
None for one rank) where the reference takes a jax ``Mesh``, and the
shims build their problem on ``device`` (the card unless the caller asks
for the CPU) in float64. New code should use ``repro_torch.dist``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..sparsela.partition import Partition2D
from ..utils.deprecation import warn_once
from .mwu import MWUOptions
from .operators import Incidence

__all__ = ["dist_matching_solve", "DistMWUResult", "make_pod_parallel_solver"]

warn_once(
    "core.mwu_dist",
    "repro_torch.core.mwu_dist is deprecated; use repro_torch.dist (MeshPlan + DistSolver) for distributed solves",
)


class DistMWUResult(NamedTuple):
    x: torch.Tensor  # (G, G, e_cell) edge shards (legacy cell layout)
    status: Any
    iters: Any
    probes: Any
    objective: float  # <1, x>
    max_px: Any


def _flatten_partition(part: Partition2D):
    """Cell layout -> global edge list + the cell indices to scatter back."""
    mask = np.asarray(part.mask)
    i_idx, j_idx, k_idx = np.nonzero(mask)
    u = np.asarray(part.u_loc)[i_idx, j_idx, k_idx] + i_idx * part.block
    v = np.asarray(part.v_loc)[i_idx, j_idx, k_idx] + j_idx * part.block
    return u.astype(np.int32), v.astype(np.int32), (i_idx, j_idx, k_idx)


def _match_problem(u, v, n_vertices: int, c, bound: float, device, edge_mask=None, p_mask=None):
    """max <c, x> : Mx <= 1 over edges (u, v), as a Problem at ``bound``."""
    from ..api.problem import Problem

    return Problem(
        name="match", kind="packing", sense="max", bound_mode="objective_covering",
        P=Incidence(u=u, v=v, n_vertices=int(n_vertices), edge_mask=edge_mask), c=c, p_mask=p_mask,
        lo=1.0, hi=float(bound), n_vars=int(u.shape[0]), nnz=2 * int(u.shape[0]), device=device,
    )


def dist_matching_solve(part: Partition2D, n_vertices: int, bound: float, mesh, eps: float = 0.1,
                        max_iter: int = 5000, *, device="cuda"):
    """Feasibility solve: exists x >= 0 with Mx <= 1, <1,x> >= bound.

    Deprecated shim: flattens the legacy 2-D cell partition back into a
    global edge list and runs :class:`repro_torch.dist.DistSolver` with an
    edge-slab pod plan over all of ``mesh``'s ranks (a ``MeshPlan``, or
    None for one). The result keeps the old (G, G, e_cell) x layout.
    """
    from ..dist import DistSolver, MeshPlan

    u, v, cell_idx = _flatten_partition(part)
    u_t, v_t = torch.as_tensor(u, device=device), torch.as_tensor(v, device=device)
    prob = _match_problem(u_t, v_t, n_vertices, torch.ones(u.shape[0], dtype=torch.float64, device=device),  # repro: noqa[RPR003] the shim's documented f64
                          bound, device)
    n_devices = mesh.n_devices if mesh is not None else 1
    solver = DistSolver(
        MWUOptions(eps=eps, step_rule="binary", max_iter=max_iter),
        plan=MeshPlan(pod=n_devices, data=1),
    )
    res = solver.feasible(prob, float(bound))
    x_flat = res.x.cpu().numpy()
    x_cells = np.zeros((part.grid, part.grid, part.e_cell), x_flat.dtype)
    x_cells[cell_idx] = x_flat
    return DistMWUResult(
        x=torch.as_tensor(x_cells),
        status=res.status,
        iters=res.iters,
        probes=res.ls_probes,
        objective=float(x_flat.sum()),
        max_px=res.max_px,
    )


def make_pod_parallel_solver(mesh, G: int, block: int, n_vertices: int, n_edges: int, eps: float = 0.1,
                             max_iter: int = 5000, ls_cap: int = 60, *, device="cuda"):
    """Pod-parallel bound search (beyond-paper, DESIGN.md §5). Deprecated.

    Returns ``fn(bounds, u, v, mask) -> (status, iters, objective,
    max_px)``, each of ``len(bounds)``: the bounds are tested concurrently,
    as the lanes of one :class:`repro_torch.dist.DistSolver` batch on
    ``mesh`` (a ``MeshPlan``, or None for one rank). The reference's pods
    are the plan's lane groups, its ``data`` axis. ``u``, ``v`` and ``mask``
    are the legacy (G, G, e_cell) cell shards (the same on every rank);
    the shim reassembles them into a global edge list over the padded
    vertex range, the padded vertices masked out of the packing rows.
    ``ls_cap`` is accepted for signature compatibility; the core step
    rules carry their own probe caps.

    New code: ``repro_torch.dist.DistSolver.solve_batch`` with a
    ``data``-axis plan does the same fan-out over any problem family.
    """
    from ..dist import DistSolver, MeshPlan

    del ls_cap, n_edges  # legacy knobs of the hand-rolled line search and layout
    n_pad = G * block
    solver = DistSolver(MWUOptions(eps=eps, step_rule="binary", max_iter=max_iter),
                        plan=mesh if mesh is not None else MeshPlan())

    def fn(bounds, u, v, msk):
        u, v = torch.as_tensor(np.asarray(u), device=device), torch.as_tensor(np.asarray(v), device=device)
        em = torch.as_tensor(np.asarray(msk), device=device).reshape(-1)
        blocks = torch.arange(G, dtype=u.dtype, device=device) * block
        u_g = (u + blocks[:, None, None]).reshape(-1)
        v_g = (v + blocks[None, :, None]).reshape(-1)
        c = em.to(torch.float64)  # repro: noqa[RPR003] the shim's documented f64
        p_mask = torch.arange(n_pad, device=device) < n_vertices  # padded vertex rows stay out of smax
        bounds = np.atleast_1d(np.asarray(bounds, dtype=np.float64))  # repro: noqa[RPR003] host bounds
        prob = _match_problem(u_g, v_g, n_pad, c, float(bounds.max()), device, edge_mask=em, p_mask=p_mask)
        res = solver.solve_batch(prob, bounds)
        obj = (res.x * c).sum(dim=1).cpu().numpy()
        return res.status, res.iters, obj, res.max_px

    return fn
