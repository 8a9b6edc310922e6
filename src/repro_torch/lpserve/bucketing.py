"""Shape buckets: pad heterogeneous graph LPs onto shared shapes, in PyTorch.

Port of ``repro.lpserve.bucketing``. Requests are rounded up to a small
ladder of bucket sizes and padded into their bucket, so that requests of
one bucket share every tensor shape and run as the lanes of one batched
feasibility loop.

For graph LPs the padding is *masked*, not merely zeroed:

* padded edges get ``edge_mask=False`` in the implicit operators, so
  they vanish from every matvec/rmatvec/colmax (and from the scatter's
  CSR: ``kernels/incidence_scatter/csr.py`` leaves them out);
* padded constraint rows are excluded from the smoothed potentials via
  ``p_mask``/``c_mask``, which the kernels take as row masks (otherwise an
  all-zero covering row would make every padded problem infeasible);
* padded objective entries are zero, so certificates and objectives are
  computed over real variables only.

Together these guarantee *padding parity*: the padded LP has the same
feasible set over real variables as the original, so the certified
objective agrees with the unpadded solve within the usual (1+eps) band.
Padded tensors live on the problem's device.

``pad_problems`` output feeds straight into
:func:`repro_torch.api.stack_problems` — problems padded into the same
bucket share every leaf shape and all static metadata.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..api.problem import Problem
from ..core.operators import (
    AdjacencyPlusId,
    Coo,
    Incidence,
    InterweavedId,
    LinOp,
    ScaledRows,
    Transposed,
    VertexEdgePair,
    VStack,
)

__all__ = ["BucketSpec", "BucketPolicy", "problem_dims", "pad_problem", "pad_problems", "padding_waste"]


@dataclass(frozen=True)
class BucketSpec:
    """One batch shape: every request padded here shares its lanes' shapes."""

    n_vertices: int
    n_edges: int

    def __str__(self):
        return f"V{self.n_vertices}xE{self.n_edges}"


@dataclass(frozen=True)
class BucketPolicy:
    """Rounds request dims up to bucket dims.

    Explicit ladders (``vertex_sizes`` / ``edge_sizes``) win when given;
    otherwise dims round up to ``floor * growth^k`` (geometric ladder,
    default power-of-two above a floor) so the number of distinct
    batch shapes stays logarithmic in the size spread.
    """

    vertex_sizes: tuple[int, ...] | None = None
    edge_sizes: tuple[int, ...] | None = None
    vertex_floor: int = 64
    edge_floor: int = 256
    growth: float = 2.0

    def __post_init__(self):
        if self.growth <= 1.0:
            raise ValueError("growth must be > 1")
        for ladder in (self.vertex_sizes, self.edge_sizes):
            if ladder is not None and tuple(sorted(ladder)) != tuple(ladder):
                raise ValueError(f"bucket ladder must be sorted, got {ladder}")

    @staticmethod
    def _round_up(x: int, ladder, floor: int, growth: float) -> int:
        if ladder is not None:
            for size in ladder:
                if x <= size:
                    return int(size)
            raise ValueError(
                f"request dim {x} exceeds the largest configured bucket {ladder[-1]}"
            )
        if x <= floor:
            return int(floor)
        k = math.ceil(math.log(x / floor) / math.log(growth))
        # float log can land one rung high/low; snap to the smallest rung >= x
        while floor * growth ** (k - 1) >= x:
            k -= 1
        while floor * growth**k < x:
            k += 1
        return int(math.ceil(floor * growth**k))

    def bucket_for(self, n_vertices: int, n_edges: int) -> BucketSpec:
        return BucketSpec(
            n_vertices=self._round_up(n_vertices, self.vertex_sizes, self.vertex_floor, self.growth),
            n_edges=self._round_up(n_edges, self.edge_sizes, self.edge_floor, self.growth),
        )


# ------------------------------------------------------------------ dims --
def _op_dims(op: LinOp):
    """(n_vertices | None, n_edges | None) implied by one operator."""
    if isinstance(op, (Incidence, AdjacencyPlusId, VertexEdgePair)):
        return op.n_vertices, int(op.u.shape[-1])
    if isinstance(op, InterweavedId):
        return None, op.n_edges
    if isinstance(op, (Transposed, ScaledRows)):
        return _op_dims(op.inner)
    if isinstance(op, VStack):
        n = m = None
        for o in op.ops:
            on, om = _op_dims(o)
            n = on if n is None else n
            m = om if m is None else m
        return n, m
    return None, None  # Coo / Dense carry no graph dims of their own


def problem_dims(prob: Problem) -> tuple[int, int]:
    """(n_vertices, n_edges) of the graph behind a builder Problem."""
    if prob.graph is not None:
        return int(prob.graph.n), int(prob.graph.m)
    n = m = None
    for op in (prob.P, prob.C):
        if op is None:
            continue
        on, om = _op_dims(op)
        n = on if n is None else n
        m = om if m is None else m
    if n is None or m is None:
        raise ValueError(
            f"problem {prob.name!r}: cannot infer (n_vertices, n_edges) from "
            "its operators; attach the source Graph or use graph-implicit ops"
        )
    return int(n), int(m)


# --------------------------------------------------------------- padding --
def _pad1(a: torch.Tensor, length: int, fill) -> torch.Tensor:
    extra = length - int(a.shape[0])
    if extra < 0:
        raise ValueError(f"cannot pad array of length {a.shape[0]} down to {length}")
    if extra == 0:
        return a
    return torch.cat([a, torch.full((extra,), fill, dtype=a.dtype, device=a.device)])


def _pad_edge_mask(old_mask, m_old: int, E: int, device) -> torch.Tensor:
    """Bucket edge mask: real edges keep their (optional) old mask, pads are off."""
    if old_mask is None:
        return torch.arange(E, device=device) < m_old
    return _pad1(old_mask.to(torch.bool), E, False)


def _pad_op(op: LinOp, N: int, E: int) -> LinOp:
    """Pad one operator onto bucket dims (padded entries fully masked)."""
    if isinstance(op, (Incidence, AdjacencyPlusId, VertexEdgePair)):
        kw = dict(u=_pad1(op.u, E, 0), v=_pad1(op.v, E, 0), n_vertices=N,
                  edge_mask=_pad_edge_mask(op.edge_mask, int(op.u.shape[0]), E, op.u.device))
        if isinstance(op, Incidence):
            kw["weights"] = None if op.weights is None else _pad1(op.weights, E, 0)
        return type(op)(**kw)
    if isinstance(op, InterweavedId):
        return InterweavedId(n_edges=E, edge_mask=_pad_edge_mask(op.edge_mask, op.n_edges, E, op.device),
                             device=op.device)
    if isinstance(op, Transposed):
        return Transposed(_pad_op(op.inner, N, E))
    if isinstance(op, ScaledRows):
        inner = _pad_op(op.inner, N, E)
        grow = inner.shape[0] - op.inner.shape[0]
        # padded rows are masked out of the potentials; scale 1 keeps them finite
        return ScaledRows(scale=_pad1(op.scale, int(op.scale.shape[0]) + grow, 1.0), inner=inner)
    if isinstance(op, VStack):
        return VStack(ops=tuple(_pad_op(o, N, E) for o in op.ops))
    if isinstance(op, Coo):
        r, c = op.shape
        # The only builder Coo is the edge-indexed x<=1 box (E x E identity);
        # padded entries carry val 0 per the Coo padding contract.
        if r != c:
            raise NotImplementedError("pad_problem: only square (edge-box) Coo supported")
        return Coo(rows=_pad1(op.rows, E, 0), cols=_pad1(op.cols, E, 0), vals=_pad1(op.vals, E, 0), _shape=(E, E))
    raise NotImplementedError(f"pad_problem: no padding rule for {type(op).__name__}")


def _row_mask(op: LinOp, vm, em):
    """Bool mask of *real* rows of a padded operator."""
    if isinstance(op, (Incidence, AdjacencyPlusId, VertexEdgePair)):
        return vm
    if isinstance(op, (InterweavedId, Coo)):
        return em  # edge rows (the Coo: the edge box)
    if isinstance(op, Transposed):
        return _col_mask(op.inner, vm, em)
    if isinstance(op, ScaledRows):
        return _row_mask(op.inner, vm, em)
    if isinstance(op, VStack):
        return torch.cat([_row_mask(o, vm, em) for o in op.ops])
    raise NotImplementedError(f"row mask for {type(op).__name__}")


def _col_mask(op: LinOp, vm, em):
    """Bool mask of *real* columns (variables) of a padded operator."""
    if isinstance(op, (Incidence, Coo)):
        return em  # edge columns (the Coo: the edge box)
    if isinstance(op, AdjacencyPlusId):
        return vm
    if isinstance(op, (VertexEdgePair, InterweavedId)):
        return torch.repeat_interleave(em, 2)
    if isinstance(op, Transposed):
        return _row_mask(op.inner, vm, em)
    if isinstance(op, ScaledRows):
        return _col_mask(op.inner, vm, em)
    if isinstance(op, VStack):
        return _col_mask(op.ops[0], vm, em)
    raise NotImplementedError(f"col mask for {type(op).__name__}")


def pad_problem(prob: Problem, bucket: BucketSpec) -> Problem:
    """Pad ``prob`` onto ``bucket`` dims with full mask bookkeeping.

    The result shares structure, leaf shapes and static metadata with every
    other same-family problem padded into ``bucket``, so
    :func:`repro_torch.api.stack_problems` accepts the mix and one batched
    loop serves them all. Its tensors are on ``prob.device``.
    """
    if prob.bound_mode == "callable":
        raise ValueError(
            f"problem {prob.name!r}: bound_mode='callable' closures cannot be "
            "padded/stacked; declare the bound through an array leaf instead"
        )
    n_old, m_old = problem_dims(prob)
    N, E = bucket.n_vertices, bucket.n_edges
    if n_old > N or m_old > E:
        raise ValueError(f"problem {prob.name!r} with dims ({n_old}, {m_old}) does not fit bucket {bucket}")
    vm = torch.arange(N, device=prob.device) < n_old
    em = torch.arange(E, device=prob.device) < m_old

    P = None if prob.P is None else _pad_op(prob.P, N, E)
    C = None if prob.C is None else _pad_op(prob.C, N, E)

    def grown_mask(old, op_pad):
        derived = _row_mask(op_pad, vm, em)
        if old is None:
            return derived
        return _pad1(old.to(torch.bool), int(derived.shape[0]), False)

    p_mask = None if P is None else grown_mask(prob.p_mask, P)
    c_mask = None if C is None else grown_mask(prob.c_mask, C)

    ref = P if P is not None else C
    n_vars = int(ref.shape[1])
    c = None if prob.c is None else _pad1(prob.c, n_vars, 0)
    nnz = sum(op.nnz for op in (P, C) if op is not None)
    return Problem(
        name=prob.name, kind=prob.kind, sense=prob.sense, bound_mode=prob.bound_mode, P=P, C=C, c=c,
        p_mask=p_mask, c_mask=c_mask, lo=prob.lo, hi=prob.hi, n_vars=n_vars, nnz=nnz, graph=prob.graph,
        device=prob.device, dtype=prob.dtype,
    )


def pad_problems(probs: list[Problem], policy: BucketPolicy | None = None,
                 bucket: BucketSpec | None = None) -> tuple[list[Problem], BucketSpec]:
    """Pad a mixed-size batch into one shared bucket.

    The bucket is ``bucket`` when given, else the policy bucket of the
    largest dims in the batch. Returns (padded problems, bucket) ready
    for :func:`repro_torch.api.stack_problems`.
    """
    if not probs:
        raise ValueError("pad_problems: need at least one problem")
    if bucket is None:
        policy = policy if policy is not None else BucketPolicy()
        dims = [problem_dims(p) for p in probs]
        bucket = policy.bucket_for(max(n for n, _ in dims), max(m for _, m in dims))
    return [pad_problem(p, bucket) for p in probs], bucket


def padding_waste(prob: Problem, bucket: BucketSpec) -> float:
    """Fraction of bucket edge slots wasted on padding for this problem."""
    _, m_old = problem_dims(prob)
    return 1.0 - m_old / max(bucket.n_edges, 1)
