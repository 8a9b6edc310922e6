"""``DistSolver``: the port's MWU loop over the ranks of a (pod, data) mesh.

Port of ``repro.dist.solver``. The single-device
:class:`repro_torch.api.Solver` runs its lanes (bounds x instances) as one
loop (``core.mwu.solve_lanes``). This module runs that same loop — the same
``core.mwu`` code, the same CUDA kernels, the same options — on the ranks
of a :class:`~repro_torch.dist.mesh.MeshPlan`:

* lanes split across ``data`` into contiguous blocks, one block a lane
  group, with no communication — the paper's rank-level bound sweep;
* each lane's variable space splits across ``pod`` (``repro_torch.dist.shard``),
  with the constraint-space coupling all_reduce-completed per matvec — the
  paper's edge-partitioned within-solve scheme.

Every rank holds the whole Problem (built alike on every rank), cuts its
slab on the host, runs its lane group's loop over its slab, and gathers
every lane's whole result, so each rank returns the same ``MWUResult``.
Under ``MeshPlan()`` no group exists, no wrapper or slab is built, and the
loop is ``Solver.solve_batch``'s: the results are bit-identical.

The reference's two execution shapes (``vmap`` over lanes, and its
``no_vmap`` path that keeps the Pallas pack out of ``custom_vmap``) have no
counterpart: the port's lanes are lanes of one loop either way. Nor has its
jit callable cache: nothing compiles; a slab's operators (and their scatter
CSR) are kept across the calls of one bound search, as ``solve_stack``
keeps a served request's. A lane's collectives run in the lane's turn, so
a loop iteration of K lanes runs K all_reduces of each kind.

``DistSolver`` subclasses ``Solver`` and overrides only its feasibility
primitives; the inherited bound search (``solve``) is thereby
distributed for free.
"""
from __future__ import annotations

import weakref

import numpy as np
import torch
import torch.distributed as dist

from ..api.problem import Problem
from ..api.solver import Solver, _check_stackable, _lane_problem
from ..core.mwu import MWUResult, solve_lanes
from .mesh import Mesh, MeshPlan
from .shard import PodSum, SlabCols, global_columns, pod_mode, pod_slab

__all__ = ["DistSolver"]


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``t`` of ``group`` (one shape on every rank), stacked in
    group order, on ``t``'s device (gloo stages CUDA tensors through the
    host itself)."""
    src = t.contiguous()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    return torch.stack(out)


class DistSolver(Solver):
    """Rank-distributed drop-in for :class:`repro_torch.api.Solver`.

    Parameters are ``Solver``'s plus ``plan``, the
    :class:`~repro_torch.dist.mesh.MeshPlan` to run on. ``MeshPlan()`` (the
    default) is the 1-rank identity plan: every result is bit-identical to
    the plain ``Solver``, so callers can hold a single solver type and
    scale by swapping the plan. A plan of more ranks needs an initialised
    default process group of ``pod * data`` ranks, each of which makes the
    same calls with the same Problems and bounds.

    ``dist_stats`` counts launches / lanes / MWU iterations and (for
    pod-split plans) an estimate of all_reduce rounds — 3 collectives per
    iteration (dy, dz, the max of d) plus init (y, z, the min) — surfaced
    by ``repro_torch.lpserve``'s ``stats()``; the reference's key for them
    is ``psum_rounds``.
    """

    def __init__(self, opts=None, *, plan: MeshPlan | None = None, **kwargs):
        super().__init__(opts, **kwargs)
        self.plan = plan if plan is not None else MeshPlan()
        self.dist_stats = {
            "launches": 0,
            "feasibility_calls": 0,
            "mwu_iters": 0,
            "psum_rounds": 0,
        }
        # edge slabs by id of their problem: (weak reference to it, slab)
        self._slabs: dict[int, tuple] = {}

    # -- layout -----------------------------------------------------------
    def _slab(self, problem: Problem, mesh: Mesh) -> Problem:
        """This rank's edge slab of ``problem``, cut once while ``problem`` lives."""
        hit = self._slabs.get(id(problem))
        if hit is not None and hit[0]() is problem:
            return hit[1]
        slab = pod_slab(problem, self.plan.pod, mesh.pod_index)
        self._slabs = {k: v for k, v in self._slabs.items() if v[0]() is not None}
        self._slabs[id(problem)] = (weakref.ref(problem), slab)
        return slab

    def _lane(self, problem: Problem, bound: float, mode: str, ncols: int, mesh: Mesh) -> tuple:
        """One lane's ``(P, C, p_mask, c_mask)``: whole on a 1-rank pod, else
        this rank's slab with its operators wrapped to complete their rows."""
        plan = self.plan
        if plan.pod == 1:
            return problem.instantiate(bound)
        if mode == "edge_slab":
            P, C, pm, cm = self._slab(problem, mesh).instantiate(bound)
            return PodSum(P, mesh.pod_group), PodSum(C, mesh.pod_group), pm, cm
        P, C, pm, cm = problem.instantiate(bound)
        block = -(-ncols // plan.pod)

        def wrap(op):
            return SlabCols(op, block=block, n_pod=plan.pod, n_cols=ncols, index=mesh.pod_index,
                            group=mesh.pod_group)

        return wrap(P), wrap(C), pm, cm

    def _run(self, problems: list, bounds: np.ndarray) -> MWUResult:
        """Lane j = (problems[j], bounds[j]) over the mesh; every rank gets the
        whole batched result."""
        plan = self.plan
        mesh = plan.build()
        B = len(bounds)
        mode = pod_mode(problems[0])
        if mode == "edge_slab":
            ncols = int(problems[0].P.u.shape[-1])
        else:
            ncols = global_columns(problems[0], bounds[0], False)

        # lanes fan out over data: pad the count to a multiple of the axis by
        # repeating the last lane; data group d takes the d-th block
        pad = (-B) % plan.data
        problems = list(problems) + [problems[-1]] * pad
        bounds = list(bounds) + [bounds[-1]] * pad
        per = (B + pad) // plan.data
        mine = range(mesh.data_index * per, (mesh.data_index + 1) * per)
        lanes = [self._lane(problems[j], float(bounds[j]), mode, ncols, mesh) for j in mine]
        res = solve_lanes(lanes, self.opts, group=mesh.pod_group, init_cols=ncols if plan.pod > 1 else None)
        if plan.n_devices > 1:
            res = self._gather(res, mesh, ncols, B)

        self.dist_stats["launches"] += 1
        self.dist_stats["feasibility_calls"] += B
        self.dist_stats["mwu_iters"] += int(np.sum(res.iters))
        if plan.pod > 1:
            self.dist_stats["psum_rounds"] += 3 * int(np.max(res.iters, initial=0)) + 3
        return res

    @staticmethod
    def _gather(res: MWUResult, mesh: Mesh, ncols: int, B: int) -> MWUResult:
        """Every lane's whole result on every rank: x's pod slabs joined over
        the pod group (padding stripped), then the lane groups over the data
        group (padded lanes stripped)."""
        x = res.x
        if mesh.pod_group is not None:  # [pod, K, slab] -> [K, pod * slab]
            x = _all_gather(x, mesh.pod_group).permute(1, 0, 2).reshape(x.shape[0], -1)
        x = x[:, :ncols]
        # the scalar fields as float64 rows: integers up to 2^53 are exact
        rows = torch.tensor(np.stack([res.status, res.iters, res.ls_probes, res.max_px, res.min_cx], axis=1),
                            dtype=torch.float64, device=x.device)
        if mesh.data_group is not None:
            x = _all_gather(x, mesh.data_group).reshape(-1, x.shape[1])
            rows = _all_gather(rows, mesh.data_group).reshape(-1, rows.shape[1])
        f = rows[:B].cpu().numpy()
        as_int = f[:, :3].astype(np.int64)
        return MWUResult(x=x[:B], status=as_int[:, 0], iters=as_int[:, 1], ls_probes=as_int[:, 2],
                         max_px=f[:, 3], min_cx=f[:, 4])

    # -- feasibility primitives (everything else is inherited) -------------
    def lower_batch(self, problem, bounds, *, batched_problem: bool = False):
        """The reference lowers its shard_map program here; the port compiles
        none. Its static-analysis analogues are ROADMAP.md queue 1 item 14."""
        raise NotImplementedError("DistSolver.lower_batch: no program to lower in the port (ROADMAP.md queue 1 "
                                  "item 14: the tracecheck analogues)")

    def jaxpr_batch(self, problem, bounds, *, batched_problem: bool = False):
        """See :meth:`lower_batch`."""
        raise NotImplementedError("DistSolver.jaxpr_batch: no jaxpr in the port (ROADMAP.md queue 1 item 14: "
                                  "the tracecheck analogues)")

    def solve_batch(self, problem, bounds, *, batched_problem: bool = False) -> MWUResult:
        """Batched feasibility fanned out over the (pod, data) mesh.

        Same contract as ``Solver.solve_batch``: returns an ``MWUResult``
        with leading dim ``len(bounds)``. Lanes split over ``data`` (the
        lane count is padded to a multiple of the axis by repeating the
        last lane; padding is stripped before returning), each lane's
        variable space over ``pod``.
        """
        bounds = np.atleast_1d(np.asarray(bounds, dtype=np.float64))
        if batched_problem:
            K = len(np.atleast_1d(problem.lo))
            if K != len(bounds):
                raise ValueError(f"solve_batch: {len(bounds)} bounds for {K} stacked problems")
            return self._run([_lane_problem(problem, j) for j in range(K)], bounds)
        return self._run([problem] * len(bounds), bounds)

    def solve_stack(self, problems: list[Problem], bounds) -> MWUResult:
        """``Solver.solve_stack`` over the mesh: lane j runs over
        ``problems[j]``, whose slab (and its CSR) this solver keeps while the
        problem lives."""
        problems = list(problems)
        if not problems:
            raise ValueError("stack_problems: need at least one problem")
        _check_stackable(problems)
        bounds = np.atleast_1d(np.asarray(bounds, dtype=np.float64))
        if len(problems) != len(bounds):
            raise ValueError(f"solve_batch: {len(bounds)} bounds for {len(problems)} stacked problems")
        return self._run(problems, bounds)

    def feasible(self, problem, bound=None, trace: bool = False):
        """One feasibility solve, pod-split when the plan has more than one rank.

        Tracing (``trace=True``) stays on the single-device path: its rows
        are the host's and this rank's. On the identity plan the inherited
        path is also the bit-parity baseline, so it is used directly.
        """
        if trace or self.plan.n_devices == 1:
            return super().feasible(problem, bound, trace=trace)
        b = 1.0 if bound is None else float(bound)
        return self.solve_batch(problem, [b]).lane(0)
