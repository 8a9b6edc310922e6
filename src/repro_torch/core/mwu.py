"""MWU solver for mixed packing & covering LPs (paper Algorithms 1-2), in PyTorch.

Port of ``repro.core.mwu``. Feasibility problem (paper eq. 2):

    exists x >= 0  with  P x <= 1  and  C x >= 1,

P, C entrywise nonnegative ``LinOp``s. The solver returns a
(1+eps)-relative solution (P x <= (1+eps) 1, C x >= 1) or reports
INFEASIBLE.

The reference's single ``lax.while_loop`` becomes a Python loop over a
set of lanes: K independent feasibility problems of one shape (K bounds of
one problem, or K stacked instances), as the reference's
``Solver.solve_batch`` maps its loop across them with ``jax.vmap``.
:func:`solve` is the loop at K = 1. Each loop iteration runs, for every
lane still running, on that lane's rows of the lane-major state (x
``[K, n]``, y and z ``[K, m]``) and on the tensors' device:

- two softmax-weight sweeps (``smoothing``: the softmax kernel),
- the step direction and its max in one launch (the step-direction
  kernel), which gathers the packing gradient itself where ``P``'s
  transposed product is a gather (``LinOp.as_gather``: bmatch, match,
  with the edge factor of a padded or weighted incidence: served match
  lanes, padded edge slabs); else the transposed product comes first,
- the covering gradient's transposed product,
- two scatter-add products (``operators``: on the card the segmented-sum
  kernel, which sums in a fixed order, so a card solve repeats),
- the step size (``stepsize``), decided on the device by the rule's
  record function (:func:`_record_fn`), which takes max(d) from the
  card and leaves the step there: for the Newton and binary rules one
  launch of their search kernel, masked or not; for the standard rule
  (alpha = 1) a few plain tensor operations,
- three fused updates of x, y and z in place (the axpy kernel), which
  read the step from device memory, and whose min of z is the loop
  condition.

Row masks (``p_mask``, ``c_mask``: padded rows of a served request,
gen-match's rows with no lower bound) go into the kernels as their row
masks, one byte a row: the softmax weights, the search's probes and the
y and z updates' min and max run over the kept rows, as the reference's
``where`` expressions do. Each lane writes one float64 row of a ``[K, 9]``
record on the device: the search's ``[alpha, probes, completes, step,
bad]``, then the z update's min and max and the y update's min and max
over the kept rows. The loop reads that record once a loop iteration for
all lanes, and from it advances each lane and drops the finished ones. A
lane of any rule, masked or not, reads nothing else. A finished lane
launches nothing and keeps its bits, and its iteration count stops, as a
lane does under the reference's ``vmap``. Every lane runs the same launches on its
own rows as a solve of that lane alone, so each lane equals its own
:func:`solve` bit for bit. There is no backend option: CUDA tensors run
the CUDA kernels, CPU tensors their plain versions.

State kept across iterations (paper Alg. 2 lines 3, 10, 15): x and the
constraint images y = Px, z = Cx, so each iteration performs exactly two
pairs of products — never recomputing Px from scratch.

Distributed runs (:mod:`repro_torch.dist`) slab the variable space across
the ranks of a ``torch.distributed`` process group: the operators complete
their constraint rows with an ``all_reduce`` (``dist.shard``), so y, z and
the step images stay replicated, and the loop itself has only two
variable-space reductions to complete, as the reference's ``_run(axis=...)``
has: ``init_x``'s fallback min and the step direction's max. ``group``
names that group, ``init_cols`` the global column count; without a group
the loop runs no collective and its bits are the single-device ones.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..kernels import axpy_reduce, step_direction
from .operators import LinOp
from .smoothing import smax_and_weights, smin_and_weights
from .stepsize import STEP_RULES, binary_step_record, host_rule_record, newton_step_record, standard_step_record

__all__ = [
    "MWUOptions",
    "MWUResult",
    "Status",
    "solve",
    "solve_lanes",
    "solve_traced",
    "init_x",
    "make_eta",
    "all_reduce",
]


class Status:
    RUNNING = 0
    FEASIBLE = 1
    INFEASIBLE = 2
    ITER_LIMIT = 3

    NAMES = {0: "RUNNING", 1: "FEASIBLE", 2: "INFEASIBLE", 3: "ITER_LIMIT"}


@dataclass(frozen=True)
class MWUOptions:
    """Solver configuration (the reference's, without ``kernel_backend``:
    the tensors' device decides where each kernel runs)."""

    eps: float = 0.1
    max_iter: int = 5000  # paper §6.2
    step_rule: str = "newton"  # "std" | "binary" | "newton"
    ls_eps: float | None = None  # line-search relative tolerance (default: eps)
    eta_factor: float = 10.0  # eta = eta_factor * log(m) / eps (paper line 2)
    pure: bool | None = None  # None = auto-detect single-row objective embedding
    # packing slack accepted at termination; the theory gives (1+eps).
    check_packing: bool = True

    def resolve_pure(self, P: LinOp, C: LinOp) -> bool:
        if self.pure is not None:
            return self.pure
        return P.shape[0] == 1 or C.shape[0] == 1

    @property
    def ls_tol(self) -> float:
        return self.eps if self.ls_eps is None else self.ls_eps


@dataclass
class MWUResult:
    """A feasibility solve's result. For a batch (:func:`solve_lanes`) every
    field carries the leading lane dim, as in the reference: ``x`` is a
    ``[K, n]`` tensor, the others numpy arrays of length K."""

    x: torch.Tensor  # on the solve's device
    status: Any  # Status code
    iters: Any  # MWU iterations executed
    ls_probes: Any  # total line-search probes (Table 3)
    max_px: Any  # max_i (Px)_i at exit
    min_cx: Any  # min_i (Cx)_i at exit

    @property
    def feasible(self):
        return self.status == Status.FEASIBLE

    def lane(self, j: int) -> "MWUResult":
        """Lane j of a batch, as the result of one solve."""
        return MWUResult(x=self.x[j], status=int(self.status[j]), iters=int(self.iters[j]),
                         ls_probes=int(self.ls_probes[j]), max_px=float(self.max_px[j]),
                         min_cx=float(self.min_cx[j]))


def make_eta(m: int, eps: float, eta_factor: float = 10.0):
    return eta_factor * np.log(max(m, 2)) / eps


def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as the reference holds eta in the loop dtype."""
    return float(torch.tensor(value, dtype=dtype))


def all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    """``t`` reduced in place by ``op`` (a ``torch.distributed.ReduceOp``)
    over the ranks of ``group``, with the group's own backend; with no group,
    ``t`` untouched. Returns ``t``."""
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


def init_x(P: LinOp, eps: float, dtype: torch.dtype, n_cols: int | None = None, group=None) -> torch.Tensor:
    """x_i = eps / (n * ||P_{:,i}||_inf)  (paper Alg. 1 line 3).

    Guarantees every packing row starts at most eps. Columns absent from P
    (colmax = 0) would start unbounded; they are clamped to the max of the
    present columns' scale (only well-posed LPs reach us in practice).

    ``n_cols`` overrides the column count when ``P`` is a rank's slab of a
    wider operator (``repro_torch.dist``), so the init scale matches the
    single-device solve; ``group`` names the ranks the fallback min must
    reduce over in that case.
    """
    n = P.shape[1] if n_cols is None else n_cols
    cm = P.colmax().to(dtype)
    inf = torch.full((), torch.inf, dtype=dtype, device=cm.device)
    safe = torch.where(cm > 0, cm, inf)
    x = eps / (n * safe)
    fallback = all_reduce(torch.where(cm > 0, x, inf).min(), dist.ReduceOp.MIN, group)
    fallback = torch.where(torch.isfinite(fallback), fallback, torch.full_like(fallback, eps / n))
    return torch.where(cm > 0, x, fallback).to(dtype)


def _masked_min(v, mask) -> torch.Tensor:
    return v.min() if mask is None else torch.where(mask, v, torch.inf).min()


def _masked_max(v, mask) -> torch.Tensor:
    return v.max() if mask is None else torch.where(mask, v, -torch.inf).max()


# the lane record's fields, one float64 row a lane
_ALPHA, _PROBES, _COMPLETES, _STEP, _BAD, _MIN_Z, _MAX_Z, _MIN_Y, _MAX_Y = range(9)
_FIELDS = 9


def _rows(K: int, n: int, dtype: torch.dtype, device) -> torch.Tensor:
    """A ``[K, n]`` lane tensor whose rows start 64 elements apart at least,
    so that every row is 16-byte aligned for the kernels' vector loads."""
    return torch.empty(K, -(-n // 64) * 64, dtype=dtype, device=device)[:, :n]


@dataclass
class _Lane:
    k: int  # row of the lane tensors and the record
    P: LinOp
    C: LinOp
    pm: Any
    cm: Any
    eta: float
    scale: float
    x: torch.Tensor  # the lane's rows, updated in place
    y: torch.Tensor
    z: torch.Tensor
    rec: torch.Tensor  # the lane's record row
    alpha_dev: torch.Tensor  # the last step taken, on the device: the search's warm start
    group: Any = None  # the ranks sharing the lane's variable space (repro_torch.dist), or None
    min_z: float = 0.0  # masked min of z: the loop condition
    max_y: float = 0.0  # masked max of y (for the trace)
    it: int = 0
    probes: int = 0
    alpha_prev: float = 1.0
    status: int = Status.RUNNING
    viol: float = 0.0  # the trace's violation at the start of the iteration

    def running(self, max_iter: int) -> bool:
        return self.status == Status.RUNNING and not self.min_z >= 1.0 and self.it < max_iter


def _record_fn(rule: str):
    """The record function of step rule ``rule``, which decides the
    iteration's step on the device; a rule that ``STEP_RULES`` alone holds
    (a host loop, such as an oracle of ``stepsize``) runs through
    ``host_rule_record``."""
    records = {"std": standard_step_record, "binary": binary_step_record, "newton": newton_step_record}
    return records[rule] if rule in records else host_rule_record(STEP_RULES[rule])


def _iteration(ln: _Lane, record_fn, ls_eps) -> None:
    """One MWU iteration (Alg. 2 body) on lane ``ln``'s rows; the step and
    the search's result go into the lane's record on the device."""
    P, C, pm, cm, x, y, z = ln.P, ln.C, ln.pm, ln.cm, ln.x, ln.y, ln.z

    # gradients of the smoothed constraint potentials (lines 5-6)
    _, wp = smax_and_weights(y, ln.eta, where=pm)
    _, wc = smin_and_weights(z, ln.eta, where=cm)
    # packing gradient P^T grad smax(Px): gathered inside the step-direction
    # kernel where it is a gather (an edge mask and weights included), else
    # computed here
    gather = P.as_gather(wp)
    g = None if gather is not None else P.rmatvec(wp)
    h = C.rmatvec(wc)  # covering gradient C^T grad smin(Cx)

    # step direction (line 7): d_i = scale * max(0, 1 - g_i/h_i) * x_i;
    # its max over every rank's slab decides line 8
    d, d_max = step_direction(h, x, ln.scale, g=g, gather=gather)
    all_reduce(d_max, dist.ReduceOp.MAX, ln.group)

    # step images (line 10) — the second product pair
    dy = P.matvec(d)
    dz = C.matvec(d)

    # step size (line 11) and the terminal test (lines 8 and 12)
    record_fn(y, z, dy, dz, ln.eta, ls_eps, d_max, ln.alpha_dev, out=ln.rec[:_MIN_Z], p_mask=pm, c_mask=cm)
    step = ln.rec[_STEP:_BAD]

    # apply (lines 14-15); a terminal iteration moves by 0. The fused
    # updates give min(z) (the next loop condition) and max(y) over the
    # kept rows for free.
    axpy_reduce(x, d, step, out=x)
    axpy_reduce(y, dy, step, out=y, red=ln.rec[_MIN_Y:_MAX_Y + 1], keep=pm)
    axpy_reduce(z, dz, step, out=z, red=ln.rec[_MIN_Z:_MAX_Z + 1], keep=cm)


def _advance(ln: _Lane, r: list) -> tuple:
    """Advance lane ``ln`` past its iteration from its record row ``r``;
    returns the iteration's trace row."""
    bad, alpha, probes = r[_BAD] != 0.0, r[_ALPHA], int(r[_PROBES])
    ln.min_z, ln.max_y = r[_MIN_Z], r[_MAX_Y]
    ln.status = Status.INFEASIBLE if bad else Status.RUNNING
    ln.it += 1
    ln.probes += probes
    if not bad:
        ln.alpha_prev = alpha
    return (ln.it - 1, ln.viol, ln.alpha_prev, probes)


def _start(lanes: list, opts: MWUOptions, group=None, init_cols: int | None = None) -> tuple:
    """The state of ``lanes`` (a list of ``(P, C, p_mask, c_mask)`` of one
    shape) before the loop's first iteration: x from ``init_x``, y and z
    its images, each lane's record row and warm start. Returns (the lanes,
    the ``[K, n]`` x, the ``[K, 9]`` record)."""
    K = len(lanes)
    P0, C0 = lanes[0][:2]
    dt = torch.promote_types(P0.colmax().dtype, C0.colmax().dtype)
    dt = dt if dt.is_floating_point else torch.float32
    x0 = [init_x(P, opts.eps, dt, n_cols=init_cols, group=group) for P, *_ in lanes]
    dev = x0[0].device
    X, Y, Z = _rows(K, P0.shape[1], dt, dev), _rows(K, P0.shape[0], dt, dev), _rows(K, C0.shape[0], dt, dev)
    rec = torch.zeros(K, _FIELDS, dtype=torch.float64, device=dev)  # repro: noqa[RPR003] the lane record: one f64 row a lane
    alpha = torch.ones(K, dtype=torch.float64, device=dev)  # repro: noqa[RPR003] the lanes' last steps, f64 as the record's alpha
    state = []
    for k, (P, C, pm, cm) in enumerate(lanes):
        if (P.shape, C.shape) != (P0.shape, C0.shape):
            raise ValueError(f"lane {k}: operators of shapes {P.shape}, {C.shape}; lane 0's {P0.shape}, {C0.shape}")
        m = P.shape[0] + C.shape[0]
        eta = _in_dtype(make_eta(m, opts.eps, opts.eta_factor), dt)
        # pure packing/covering admit a 2x larger step scale (paper §2.2)
        scale = _in_dtype((1.0 if opts.resolve_pure(P, C) else 0.5) / eta, dt)
        X[k].copy_(x0[k])
        Y[k].copy_(P.matvec(x0[k]).to(dt))
        Z[k].copy_(C.matvec(x0[k]).to(dt))
        state.append(_Lane(k=k, P=P, C=C, pm=pm, cm=cm, eta=eta, scale=scale, x=X[k], y=Y[k], z=Z[k], rec=rec[k],
                           alpha_dev=alpha[k:k + 1], group=group))
    # the starting min z and max y of every lane in one read
    start = torch.stack([torch.stack([_masked_min(ln.z, ln.cm), _masked_max(ln.y, ln.pm)]) for ln in state]).tolist()  # repro: noqa[RPR002] the start read, once a solve
    for ln, (min_z, max_y) in zip(state, start):
        ln.min_z, ln.max_y = min_z, max_y
    return state, X, rec


def _run(lanes: list, opts: MWUOptions, rows: list | None = None, group=None,
         init_cols: int | None = None) -> tuple[list, torch.Tensor]:
    """The MWU loop over ``lanes``, a list of ``(P, C, p_mask, c_mask)``
    of one shape; returns the finished lanes and the ``[K, n]`` x. With
    ``rows`` a list of K lists, each lane's iterations append their
    (iteration, violation at its start, alpha after it, probes) rows.
    ``group`` and ``init_cols``: a distributed run's (module docstring).
    Every rank of ``group`` reads the same record, bit for bit, since it is
    built from replicated vectors only, so the ranks leave the loop
    together."""
    state, X, rec = _start(lanes, opts, group, init_cols)
    record_fn = _record_fn(opts.step_rule)
    active = [ln for ln in state if ln.running(opts.max_iter)]
    while active:
        for ln in active:
            ln.viol = max(ln.max_y - 1.0, 1.0 - ln.min_z, 0.0)
            _iteration(ln, record_fn, opts.ls_tol)
        r = rec.tolist()  # repro: noqa[RPR002] the one host read of a loop iteration, for all lanes
        for ln in active:
            row = _advance(ln, r[ln.k])
            if rows is not None:
                rows[ln.k].append(row)
        active = [ln for ln in active if ln.running(opts.max_iter)]
    return state, X


def _finalize(opts: MWUOptions, state: list, X: torch.Tensor) -> MWUResult:
    """The batch's result: every field with the leading lane dim."""
    max_px = torch.stack([_masked_max(ln.y, ln.pm) for ln in state]).tolist()  # repro: noqa[RPR002] the finalize read, once a solve
    status = []
    for ln, mp in zip(state, max_px):
        covered = ln.min_z >= 1.0
        packed = mp <= 1.0 + opts.eps + 1e-9 or not opts.check_packing
        if ln.status == Status.INFEASIBLE:
            status.append(Status.INFEASIBLE)
        else:
            status.append(Status.FEASIBLE if covered and packed else Status.ITER_LIMIT)
    return MWUResult(x=X, status=np.asarray(status), iters=np.asarray([ln.it for ln in state]),
                     ls_probes=np.asarray([ln.probes for ln in state]), max_px=np.asarray(max_px),
                     min_cx=np.asarray([ln.min_z for ln in state]))


def solve_lanes(lanes: list, opts: MWUOptions = MWUOptions(), *, group=None,
                init_cols: int | None = None) -> MWUResult:
    """Solve K feasibility LPs of one shape at once: ``lanes`` is a list of
    ``(P, C, p_mask, c_mask)``. Returns an ``MWUResult`` whose every field
    has leading dim K; lane j equals ``solve`` of lanes[j] bit for bit.
    ``group``/``init_cols``: a distributed run's (``repro_torch.dist``), whose
    operators are rank slabs; x is then this rank's slab."""
    if not lanes:
        raise ValueError("solve_lanes: no lanes")
    return _finalize(opts, *_run(list(lanes), opts, group=group, init_cols=init_cols))


def solve(P: LinOp, C: LinOp, opts: MWUOptions = MWUOptions(), p_mask=None, c_mask=None) -> MWUResult:
    """Solve the feasibility LP  P x <= 1, C x >= 1, x >= 0."""
    return solve_lanes([(P, C, p_mask, c_mask)], opts).lane(0)


def solve_traced(P: LinOp, C: LinOp, opts: MWUOptions = MWUOptions(), p_mask=None, c_mask=None):
    """Solve recording per-iteration diagnostics (Fig. 3).

    Returns (MWUResult, trace) with trace = dict of numpy arrays:
    ``max_violation`` = max(0, max(Px)-1, 1-min(Cx)) at the start of every
    iteration (plus the final state when the loop exits before the
    iteration cap), ``alpha``, ``probes`` — the reference's layout. The
    rows come from the loop's one read an iteration.
    """
    rows: list = [[]]
    res = _finalize(opts, *_run([(P, C, p_mask, c_mask)], opts, rows=rows)).lane(0)
    rows = rows[0]
    viol = [r[1] for r in rows]
    if res.iters < opts.max_iter:
        # loop exited through its own condition: record the final state
        viol.append(max(0.0, res.max_px - 1.0, 1.0 - res.min_cx))
    trace = {
        "max_violation": np.asarray(viol),
        "alpha": np.asarray([r[2] for r in rows]),
        "probes": np.asarray([r[3] for r in rows]),
    }
    return res, trace
