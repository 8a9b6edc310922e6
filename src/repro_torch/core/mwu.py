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
  transposed product is a plain gather (``LinOp.as_gather``: bmatch,
  match); else the transposed product comes first (the gather kernel for
  incidence),
- the covering gradient's transposed product,
- two scatter-add products (``operators``: on the card the segmented-sum
  kernel, which sums in a fixed order, so a card solve repeats),
- one step-size search (``stepsize``): for the Newton rule on an unmasked
  problem, one launch of the search kernel, which takes max(d) from the
  card and leaves the step there (``newton_step_record``); else a host
  loop (one two-sided probe launch and one read a probe),
- three fused updates of x, y and z in place (the axpy kernel), which
  read the step from device memory on the Newton lanes, and whose min of
  z is the loop condition.

Each lane writes one float64 row of a ``[K, 9]`` record on the device:
the search's ``[alpha, probes, completes, step, bad]``, then the z
update's min and max and the y update's min and max. The loop reads that
record once a loop iteration for all lanes, and from it advances each
lane and drops the finished ones. A Newton lane of an unmasked problem
reads nothing else; a lane of another rule also reads max(d) and its
probes, and a masked lane its masked min of z. A finished lane launches
nothing and keeps its bits, and its iteration count stops, as a lane does
under the reference's ``vmap``. Every lane runs the same launches on its
own rows as a solve of that lane alone, so each lane equals its own
:func:`solve` bit for bit. There is no backend option: CUDA tensors run
the CUDA kernels, CPU tensors their plain versions.

State kept across iterations (paper Alg. 2 lines 3, 10, 15): x and the
constraint images y = Px, z = Cx, so each iteration performs exactly two
pairs of products — never recomputing Px from scratch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..kernels import axpy_reduce, step_direction
from .operators import LinOp
from .smoothing import smax_and_weights, smin_and_weights
from .stepsize import STEP_RULES, newton_step_record

__all__ = [
    "MWUOptions",
    "MWUResult",
    "Status",
    "solve",
    "solve_lanes",
    "solve_traced",
    "init_x",
    "make_eta",
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


def init_x(P: LinOp, eps: float, dtype: torch.dtype) -> torch.Tensor:
    """x_i = eps / (n * ||P_{:,i}||_inf)  (paper Alg. 1 line 3).

    Guarantees every packing row starts at most eps. Columns absent from P
    (colmax = 0) would start unbounded; they are clamped to the max of the
    present columns' scale (only well-posed LPs reach us in practice).
    """
    n = P.shape[1]
    cm = P.colmax().to(dtype)
    inf = torch.full((), torch.inf, dtype=dtype, device=cm.device)
    safe = torch.where(cm > 0, cm, inf)
    x = eps / (n * safe)
    fallback = torch.where(cm > 0, x, inf).min()
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
    alpha_dev: torch.Tensor | None  # alpha_prev on the device (Newton lanes of unmasked problems), else None
    min_z: float = 0.0  # masked min of z: the loop condition
    max_y: float = 0.0  # masked max of y (for the trace)
    it: int = 0
    probes: int = 0
    alpha_prev: float = 1.0
    status: int = Status.RUNNING
    host_step: tuple = ()  # (bad, alpha, probes) of a host-rule iteration
    viol: float = 0.0  # the trace's violation at the start of the iteration

    def running(self, max_iter: int) -> bool:
        return self.status == Status.RUNNING and not self.min_z >= 1.0 and self.it < max_iter


def _iteration(ln: _Lane, step_fn, ls_eps) -> None:
    """One MWU iteration (Alg. 2 body) on lane ``ln``'s rows. A Newton lane
    of an unmasked problem leaves its step and the search's result in its
    record; a lane of another rule keeps them in ``ln.host_step``."""
    P, C, pm, cm, x, y, z = ln.P, ln.C, ln.pm, ln.cm, ln.x, ln.y, ln.z

    # gradients of the smoothed constraint potentials (lines 5-6)
    _, wp = smax_and_weights(y, ln.eta, where=pm)
    _, wc = smin_and_weights(z, ln.eta, where=cm)
    # packing gradient P^T grad smax(Px): gathered inside the step-direction
    # kernel where it is a plain gather, else computed here
    gather = P.as_gather(wp)
    g = None if gather is not None else P.rmatvec(wp)
    h = C.rmatvec(wc)  # covering gradient C^T grad smin(Cx)

    # step direction (line 7): d_i = scale * max(0, 1 - g_i/h_i) * x_i
    d, d_max = step_direction(h, x, ln.scale, g=g, gather=gather)

    # step images (line 10) — the second product pair
    dy = P.matvec(d)
    dz = C.matvec(d)

    # step size (line 11) and the terminal test (lines 8 and 12)
    if ln.alpha_dev is not None:
        newton_step_record(y, z, dy, dz, ln.eta, ls_eps, d_max, ln.alpha_dev, out=ln.rec[:_MIN_Z])
        step = ln.rec[_STEP:_BAD]
    else:
        infeasible_dir = d_max.item() <= 0  # line 8
        ss = step_fn(y, z, dy, dz, ln.eta, pm, cm, ls_eps, ln.alpha_prev)
        bad = infeasible_dir or ss.alpha < 1  # line 12
        ln.host_step = (bad, ss.alpha, ss.probes)
        step = 0.0 if bad else ss.alpha

    # apply (lines 14-15); a terminal iteration moves by 0. The fused
    # updates give min(z) (the next loop condition) and max(y) for free.
    axpy_reduce(x, d, step, out=x)
    axpy_reduce(y, dy, step, out=y, red=ln.rec[_MIN_Y:_MAX_Y + 1])
    axpy_reduce(z, dz, step, out=z, red=ln.rec[_MIN_Z:_MAX_Z + 1])
    if cm is not None:
        ln.min_z = _masked_min(z, cm).item()


def _advance(ln: _Lane, r: list, trace: bool) -> tuple:
    """Advance lane ``ln`` past its iteration from its record row ``r``;
    returns the iteration's trace row."""
    if ln.alpha_dev is not None:
        bad, alpha, probes = r[_BAD] != 0.0, r[_ALPHA], int(r[_PROBES])
    else:
        bad, alpha, probes = ln.host_step
    if ln.cm is None:
        ln.min_z = r[_MIN_Z]
    if ln.pm is None:
        ln.max_y = r[_MAX_Y]
    elif trace:
        ln.max_y = _masked_max(ln.y, ln.pm).item()
    ln.status = Status.INFEASIBLE if bad else Status.RUNNING
    ln.it += 1
    ln.probes += probes
    if not bad:
        ln.alpha_prev = alpha
    return (ln.it - 1, ln.viol, ln.alpha_prev, probes)


def _run(lanes: list, opts: MWUOptions, rows: list | None = None) -> tuple[list, torch.Tensor]:
    """The MWU loop over ``lanes``, a list of ``(P, C, p_mask, c_mask)``
    of one shape; returns the finished lanes and the ``[K, n]`` x. With
    ``rows`` a list of K lists, each lane's iterations append their
    (iteration, violation at its start, alpha after it, probes) rows."""
    K = len(lanes)
    P0, C0 = lanes[0][:2]
    dt = torch.promote_types(P0.colmax().dtype, C0.colmax().dtype)
    dt = dt if dt.is_floating_point else torch.float32
    step_fn = STEP_RULES[opts.step_rule]
    x0 = [init_x(P, opts.eps, dt) for P, *_ in lanes]
    dev = x0[0].device
    X, Y, Z = _rows(K, P0.shape[1], dt, dev), _rows(K, P0.shape[0], dt, dev), _rows(K, C0.shape[0], dt, dev)
    rec = torch.zeros(K, _FIELDS, dtype=torch.float64, device=dev)
    alpha = torch.ones(K, dtype=torch.float64, device=dev)
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
        device_step = opts.step_rule == "newton" and pm is None and cm is None
        state.append(_Lane(k=k, P=P, C=C, pm=pm, cm=cm, eta=eta, scale=scale, x=X[k], y=Y[k], z=Z[k], rec=rec[k],
                           alpha_dev=alpha[k:k + 1] if device_step else None))
    # the starting min z and max y of every lane in one read
    start = torch.stack([torch.stack([_masked_min(ln.z, ln.cm), _masked_max(ln.y, ln.pm)]) for ln in state]).tolist()
    for ln, (min_z, max_y) in zip(state, start):
        ln.min_z, ln.max_y = min_z, max_y

    active = [ln for ln in state if ln.running(opts.max_iter)]
    while active:
        for ln in active:
            ln.viol = max(ln.max_y - 1.0, 1.0 - ln.min_z, 0.0)
            _iteration(ln, step_fn, opts.ls_tol)
        r = rec.tolist()  # the one host read of a loop iteration, for all lanes
        for ln in active:
            row = _advance(ln, r[ln.k], rows is not None)
            if rows is not None:
                rows[ln.k].append(row)
        active = [ln for ln in active if ln.running(opts.max_iter)]
    return state, X


def _finalize(opts: MWUOptions, state: list, X: torch.Tensor) -> MWUResult:
    """The batch's result: every field with the leading lane dim."""
    max_px = torch.stack([_masked_max(ln.y, ln.pm) for ln in state]).tolist()  # one read
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


def solve_lanes(lanes: list, opts: MWUOptions = MWUOptions()) -> MWUResult:
    """Solve K feasibility LPs of one shape at once: ``lanes`` is a list of
    ``(P, C, p_mask, c_mask)``. Returns an ``MWUResult`` whose every field
    has leading dim K; lane j equals ``solve`` of lanes[j] bit for bit."""
    if not lanes:
        raise ValueError("solve_lanes: no lanes")
    return _finalize(opts, *_run(list(lanes), opts))


def solve(P: LinOp, C: LinOp, opts: MWUOptions = MWUOptions(), p_mask=None, c_mask=None) -> MWUResult:
    """Solve the feasibility LP  P x <= 1, C x >= 1, x >= 0."""
    return solve_lanes([(P, C, p_mask, c_mask)], opts).lane(0)


def solve_traced(P: LinOp, C: LinOp, opts: MWUOptions = MWUOptions(), p_mask=None, c_mask=None):
    """Solve recording per-iteration diagnostics (Fig. 3).

    Returns (MWUResult, trace) with trace = dict of numpy arrays:
    ``max_violation`` = max(0, max(Px)-1, 1-min(Cx)) at the start of every
    iteration (plus the final state when the loop exits before the
    iteration cap), ``alpha``, ``probes`` — the reference's layout. The
    rows come from the loop's one read an iteration (a masked lane also
    reads its masked max of y).
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
