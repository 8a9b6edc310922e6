"""The slab layout of a ``Problem`` over the ranks of a (pod, data) mesh.

Port of ``repro.dist.shard``. PAPER.md's MPI scheme partitions the
incidence matrix by edges: each rank owns an edge slab, runs the
gather/scatter kernels on its slab, and exchanges the vertex-space
coupling terms (the smax/smin gradient weights live in vertex space) with
its neighbors. Here:

* **edge_slab mode** — the paper's scheme, verbatim. For packing
  problems whose operator is an :class:`~repro_torch.core.operators.Incidence`
  with an objective-covering row (matching / b-matching — the paper's
  flagship distributed workload), the edge-dimension leaves (``P.u``,
  ``P.v``, ``P.weights``, ``P.edge_mask``, ``c``) split across the pod's
  ranks by :func:`repro_torch.sparsela.partition.partition_edges_1d`.
  Each rank runs the CUDA kernels on its own edge slab; the
  per-iteration vertex images ``y = Px`` / ``dy = Pd`` and the objective
  row ``z = <c,x>/M`` are completed by one ``all_reduce`` each
  (:class:`PodSum`), and constraint-space vectors stay replicated so the
  smoothing / line-search math is untouched.

* **column mode** — the generic fallback for every other family
  (vertex cover, dominating set, densest subgraph, generalized
  matching). The operators stay whole on every rank; :class:`SlabCols`
  views a contiguous *column* (variable) slab as the local operator by
  embedding the slab into the full column space for ``matvec`` (then
  all_reduce) and extracting the slab from full-width ``rmatvec``/``colmax``
  results. Exact on any operator — but no per-rank work reduction; it
  exists so ``DistSolver`` is total over the Problem surface, and so the
  ``data`` fan-out composes with a pod axis longer than 1.

The reference's ``problem_specs``/``bounds_spec``/``result_specs`` tell
``shard_map`` how to slice a Problem and reassemble a result. Here every
rank holds the whole Problem and cuts its own slab on the host before the
solve (:func:`pod_slab`); ``DistSolver`` gathers the results.

Replication invariant (what makes the core loop reusable): every
constraint-row vector (y, z, dy, dz, the masks, every line-search
probe) is replicated across the pod because the wrapped ``matvec``
all_reduces; only two *variable-space* reductions in the whole MWU loop
need the group (``init_x``'s fallback min, the infeasible-direction
``max(d)``), which ``core.mwu`` takes through its ``group`` argument.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from ..api.problem import Problem
from ..api.solver import _lane_problem
from ..core.mwu import all_reduce
from ..core.operators import Incidence, LinOp
from ..sparsela.partition import partition_edges_1d

__all__ = [
    "PodSum",
    "SlabCols",
    "pod_mode",
    "slab_pad_problem",
    "pod_slab",
    "global_columns",
]


# ------------------------------------------------------------- operators --
@dataclass
class PodSum(LinOp):
    """Edge-slab wrapper: local scatter, all_reduce-completed constraint rows.

    ``inner`` is built from this rank's edge slab but keeps *global* vertex
    ids (rows). ``matvec`` therefore produces a partial constraint image
    which one ``all_reduce`` over ``group`` completes — after which y/z are
    fully replicated, so ``rmatvec`` (gather of a replicated vector onto
    the local slab) and ``colmax`` (per-local-column) need no communication
    at all, and ``as_gather`` is the inner operator's: a slab, its padded
    edge masked or not, keeps the step direction's fused gather.
    """

    inner: LinOp
    group: Any = None

    @property
    def shape(self):
        return self.inner.shape

    def matvec(self, x):
        return all_reduce(self.inner.matvec(x), dist.ReduceOp.SUM, self.group)

    def rmatvec(self, y):
        return self.inner.rmatvec(y)

    def as_gather(self, y):
        return self.inner.as_gather(y)

    def colmax(self, row_scale=None):
        return self.inner.colmax(row_scale)

    @property
    def nnz(self):
        return self.inner.nnz


@dataclass
class SlabCols(LinOp):
    """Column-slab view of a whole operator (generic pod fallback).

    Pod rank ``index`` owns columns ``[index * block, (index + 1) * block)``
    of the ``n_cols``-wide ``inner``. ``matvec`` embeds the local slab into
    a zero-padded full vector, applies ``inner`` and all_reduces the linear
    partials; ``rmatvec``/``colmax`` compute full-width and extract the
    slab (into a vector of its own, aligned for the kernels). Exact for any
    linear operator; the per-rank matvec work is NOT reduced (see module
    docstring for why it exists).
    """

    inner: LinOp
    block: int = 0  # local slab width
    n_pod: int = 1  # ranks on the pod axis
    n_cols: int = 0  # true global column count
    index: int = 0  # this rank's place on the pod axis
    group: Any = None

    @property
    def shape(self):
        return (self.inner.shape[0], self.block)

    def _embed(self, x):
        """Local slab -> full (n_cols,) vector, zeros elsewhere."""
        buf = torch.zeros(self.block * self.n_pod, dtype=x.dtype, device=x.device)
        buf[self.index * self.block:(self.index + 1) * self.block] = x
        return buf[:self.n_cols]

    def _extract(self, full):
        """Full (n_cols,) vector -> this rank's slab (zero past the end)."""
        out = torch.zeros(self.block, dtype=full.dtype, device=full.device)
        start = self.index * self.block
        part = full[start:start + self.block]
        out[:part.shape[0]] = part
        return out

    def matvec(self, x):
        return all_reduce(self.inner.matvec(self._embed(x)), dist.ReduceOp.SUM, self.group)

    def rmatvec(self, y):
        return self._extract(self.inner.rmatvec(y))

    def colmax(self, row_scale=None):
        return self._extract(self.inner.colmax(row_scale))

    @property
    def nnz(self):
        return self.inner.nnz


# ----------------------------------------------------------- mode choice --
def pod_mode(problem: Problem) -> str:
    """``"edge_slab"`` when the paper's edge partition applies, else ``"column"``.

    Edge-slab needs the variables to BE the edges of an ``Incidence``
    packing operator with the objective entering as a covering row
    (``bound_mode="objective_covering"``): then ``P.u/v/weights/
    edge_mask`` and ``c`` are all edge-aligned and slab-splittable.
    """
    P = problem.P
    if (
        problem.bound_mode == "objective_covering"
        and isinstance(P, Incidence)
        and problem.c is not None
        and int(problem.c.shape[-1]) == int(P.u.shape[-1])
    ):
        return "edge_slab"
    return "column"


# ---------------------------------------------------------- slab padding --
def _pad_last(a, pad: int, fill):
    if a is None or pad == 0:
        return a
    return torch.cat([a, torch.full(a.shape[:-1] + (pad,), fill, dtype=a.dtype, device=a.device)], dim=-1)


def slab_pad_problem(problem: Problem, pod: int) -> tuple[Problem, int]:
    """Pad the edge dimension to a multiple of ``pod`` (edge_slab mode).

    Padded edges are fully masked (``edge_mask=False``, zero objective),
    appended at the global end so contiguous pod slabs reassemble into
    padded-global order and ``x[..., :n_edges]`` strips them. Returns
    ``(padded problem, original edge count)``; with no padding to add the
    problem is returned untouched.
    """
    P = problem.P
    n_edges = int(P.u.shape[-1])
    padded, _ = partition_edges_1d(n_edges, pod)
    pad = padded - n_edges
    if pad == 0:
        return problem, n_edges
    mask = P.edge_mask
    if mask is None:
        mask = torch.ones(P.u.shape, dtype=torch.bool, device=P.u.device)
    P2 = Incidence(
        u=_pad_last(P.u, pad, 0),
        v=_pad_last(P.v, pad, 0),
        n_vertices=P.n_vertices,
        weights=_pad_last(P.weights, pad, 0),
        edge_mask=_pad_last(mask, pad, False),
    )
    c2 = _pad_last(problem.c, pad, 0)
    return dataclasses.replace(problem, P=P2, c=c2), n_edges


def pod_slab(problem: Problem, pod: int, index: int) -> Problem:
    """Pod rank ``index``'s edge slab of ``problem`` (edge_slab mode): the
    edge leaves of :func:`slab_pad_problem`'s padded problem cut to the
    rank's contiguous slab, each copied into a tensor of its own (aligned
    for the kernels' vector loads); every other field kept. This is the
    slicing that the reference's ``problem_specs`` asks of ``shard_map``."""
    padded, _ = slab_pad_problem(problem, pod)
    P = padded.P
    _, slab = partition_edges_1d(int(P.u.shape[-1]), pod)
    lo, hi = index * slab, (index + 1) * slab

    def cut(a):
        return None if a is None else a[..., lo:hi].clone()

    P2 = Incidence(u=cut(P.u), v=cut(P.v), n_vertices=P.n_vertices, weights=cut(P.weights),
                   edge_mask=cut(P.edge_mask))
    return dataclasses.replace(padded, P=P2, c=cut(padded.c))


# ---------------------------------------------------------- column count --
def global_columns(problem: Problem, bound, batched: bool) -> int:
    """Host-side global variable count of the instantiated feasibility LP.

    This is the ``n`` the single-device ``init_x`` would see — the
    distributed solver passes it through ``_run(init_cols=...)`` so the
    init scale (and hence the whole trajectory) matches the unsharded
    solve regardless of slab padding.
    """
    template = _lane_problem(problem, 0) if batched else problem
    P0, C0, _, _ = template.instantiate(None if problem.bound_mode == "none" else float(bound))
    ref = P0 if P0 is not None else C0
    return int(ref.shape[1])
