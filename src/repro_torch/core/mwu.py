"""MWU solver for mixed packing & covering LPs (paper Algorithms 1-2), in PyTorch.

Port of ``repro.core.mwu``. Feasibility problem (paper eq. 2):

    exists x >= 0  with  P x <= 1  and  C x >= 1,

P, C entrywise nonnegative ``LinOp``s. The solver returns a
(1+eps)-relative solution (P x <= (1+eps) 1, C x >= 1) or reports
INFEASIBLE.

The reference's single ``lax.while_loop`` becomes a Python loop; each
iteration runs on the tensors' device:

- two softmax-weight sweeps (``smoothing``: the softmax kernel),
- the step direction and its max in one launch (the step-direction
  kernel), which gathers the packing gradient itself where ``P``'s
  transposed product is a plain gather (``LinOp.as_gather``: bmatch,
  match); else the transposed product comes first (the gather kernel for
  incidence),
- the covering gradient's transposed product,
- two scatter-add products (``operators``: on the card the segmented-sum
  kernel, which sums in a fixed order, so a card solve repeats),
- one step-size search (``stepsize``: for the Newton rule on the card, one
  launch of the search kernel; else one two-sided probe launch a probe),
- three fused updates of x, y and z (the axpy kernel), whose min of z
  is the loop condition.

The host reads max(d), the step-size search's result and min(z) back per
iteration: three reads with the Newton rule on the card, one more a probe
on the host loops. There is no backend option: CUDA tensors run the CUDA kernels,
CPU tensors their plain versions.

State kept across iterations (paper Alg. 2 lines 3, 10, 15): x and the
constraint images y = Px, z = Cx, so each iteration performs exactly two
pairs of products — never recomputing Px from scratch.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels import axpy_reduce, step_direction
from .operators import LinOp
from .smoothing import smax_and_weights, smin_and_weights
from .stepsize import STEP_RULES

__all__ = [
    "MWUOptions",
    "MWUResult",
    "Status",
    "solve",
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
    x: torch.Tensor  # on the solve's device
    status: int  # Status code
    iters: int  # MWU iterations executed
    ls_probes: int  # total line-search probes (Table 3)
    max_px: float  # max_i (Px)_i at exit
    min_cx: float  # min_i (Cx)_i at exit

    @property
    def feasible(self) -> bool:
        return self.status == Status.FEASIBLE


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


def _masked_min(v, mask) -> float:
    if mask is None:
        return v.min().item()
    return torch.where(mask, v, torch.inf).min().item()


def _masked_max(v, mask) -> float:
    if mask is None:
        return v.max().item()
    return torch.where(mask, v, -torch.inf).max().item()


@dataclass
class _State:
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    min_z: float  # masked min of z: the loop condition
    it: int = 0
    probes: int = 0
    alpha_prev: float = 1.0
    status: int = Status.RUNNING


def _iteration(P: LinOp, C: LinOp, eta: float, scale: float, step_fn, ls_eps, p_mask, c_mask, s: _State) -> int:
    """One MWU iteration (Alg. 2 body), updating ``s`` in place; returns its probe count."""
    x, y, z = s.x, s.y, s.z

    # gradients of the smoothed constraint potentials (lines 5-6)
    _, wp = smax_and_weights(y, eta, where=p_mask)
    _, wc = smin_and_weights(z, eta, where=c_mask)
    # packing gradient P^T grad smax(Px): gathered inside the step-direction
    # kernel where it is a plain gather, else computed here
    gather = P.as_gather(wp)
    g = None if gather is not None else P.rmatvec(wp)
    h = C.rmatvec(wc)  # covering gradient C^T grad smin(Cx)

    # step direction (line 7): d_i = scale * max(0, 1 - g_i/h_i) * x_i
    d, d_max = step_direction(h, x, scale, g=g, gather=gather)
    infeasible_dir = d_max.item() <= 0  # line 8

    # step images (line 10) — the second product pair
    dy = P.matvec(d)
    dz = C.matvec(d)

    # step size (line 11)
    ss = step_fn(y, z, dy, dz, eta, p_mask, c_mask, ls_eps, s.alpha_prev)
    bad = infeasible_dir or ss.alpha < 1  # line 12

    # apply (lines 14-15); never move on a terminal iteration. The fused
    # update gives min(z + alpha dz), the next loop condition, for free.
    aa = 0.0 if bad else ss.alpha
    s.x, _, _ = axpy_reduce(x, d, aa)
    s.y, _, _ = axpy_reduce(y, dy, aa)
    s.z, z_min, _ = axpy_reduce(z, dz, aa)
    s.min_z = z_min.item() if c_mask is None else _masked_min(s.z, c_mask)

    s.status = Status.INFEASIBLE if bad else Status.RUNNING
    s.it += 1
    s.probes += ss.probes
    if not bad:
        s.alpha_prev = ss.alpha
    return ss.probes


def _run(P: LinOp, C: LinOp, opts: MWUOptions, pm, cm, rows: list | None = None) -> MWUResult:
    """The driver loop. With ``rows`` a list, each iteration appends its
    (iteration, violation at its start, alpha after it, probes) row."""
    m = P.shape[0] + C.shape[0]
    dt = torch.promote_types(P.colmax().dtype, C.colmax().dtype)
    dt = dt if dt.is_floating_point else torch.float32
    eta = _in_dtype(make_eta(m, opts.eps, opts.eta_factor), dt)
    # pure packing/covering admit a 2x larger step scale (paper §2.2)
    scale = _in_dtype((1.0 if opts.resolve_pure(P, C) else 0.5) / eta, dt)
    step_fn = STEP_RULES[opts.step_rule]

    x0 = init_x(P, opts.eps, dt)
    z0 = C.matvec(x0).to(dt)
    s = _State(x=x0, y=P.matvec(x0).to(dt), z=z0, min_z=_masked_min(z0, cm))
    while s.status == Status.RUNNING and not s.min_z >= 1.0 and s.it < opts.max_iter:
        if rows is None:
            _iteration(P, C, eta, scale, step_fn, opts.ls_tol, pm, cm, s)
            continue
        it, viol = s.it, max(_masked_max(s.y, pm) - 1.0, 1.0 - s.min_z, 0.0)
        probes = _iteration(P, C, eta, scale, step_fn, opts.ls_tol, pm, cm, s)
        rows.append((it, viol, s.alpha_prev, probes))
    return _finalize(opts, s, pm)


def _finalize(opts: MWUOptions, s: _State, p_mask) -> MWUResult:
    max_px = _masked_max(s.y, p_mask)
    covered = s.min_z >= 1.0
    packed = max_px <= 1.0 + opts.eps + 1e-9 or not opts.check_packing
    if s.status == Status.INFEASIBLE:
        status = Status.INFEASIBLE
    else:
        status = Status.FEASIBLE if covered and packed else Status.ITER_LIMIT
    return MWUResult(x=s.x, status=status, iters=s.it, ls_probes=s.probes, max_px=max_px, min_cx=s.min_z)


def solve(P: LinOp, C: LinOp, opts: MWUOptions = MWUOptions(), p_mask=None, c_mask=None) -> MWUResult:
    """Solve the feasibility LP  P x <= 1, C x >= 1, x >= 0."""
    return _run(P, C, opts, p_mask, c_mask)


def solve_traced(P: LinOp, C: LinOp, opts: MWUOptions = MWUOptions(), p_mask=None, c_mask=None):
    """Solve recording per-iteration diagnostics (Fig. 3).

    Returns (MWUResult, trace) with trace = dict of numpy arrays:
    ``max_violation`` = max(0, max(Px)-1, 1-min(Cx)) at the start of every
    iteration (plus the final state when the loop exits before the
    iteration cap), ``alpha``, ``probes`` — the reference's layout.
    """
    rows: list = []
    res = _run(P, C, opts, p_mask, c_mask, rows=rows)
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
