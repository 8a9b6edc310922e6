"""Step-size search for MWU (paper §4, Algorithms 2-3), in PyTorch.

Port of ``repro.core.stepsize``. Given the constraint values y = Px,
z = Cx and the step images dy = Pd, dz = Cd, find the largest alpha with

    f(alpha) = Phi(alpha) / Psi(alpha) >= 1,
    Phi(alpha) = smin_eta(z + alpha dz) - smin_eta(z),
    Psi(alpha) = smax_eta(y + alpha dy) - smax_eta(y),

by exponential + binary search (Algorithm 3) or by a warm-started,
safeguarded Newton iteration on f(alpha) - 1. Every search stops early
once min(z + alpha dz) >= 1 while f(alpha) >= 1, then shrinks the step to
the smallest completing alpha.

The reference runs these searches as ``lax.while_loop``s on the device.
Here the Newton search on the card is one launch of
:func:`repro_torch.kernels.newton_search`, which runs the whole search
there, over the rows that the masks keep (padded rows of a served
request, gen-match's rows with no lower bound). :func:`newton_step` reads
its result back once; the MWU loop calls :func:`newton_step_record`
instead, which takes max(d) from the card, decides the iteration's step
there and leaves it in a device record, so that the loop reads the search
only with the rest of its lane record. Elsewhere (the binary and standard
rules, the CPU) the searches are Python loops over host floats: each
probe evaluates both sides in one :func:`repro_torch.kernels.linesearch_probe2`
call (the CUDA kernel on the card, masked or not) and reads the six
results back in one copy, which is one host sync per probe. The Newton
search's host loop is the search kernel's plain version
(``kernels/linesearch_probe/ref.py``); over the probe kernel on the card
it is ``_newton_step_host``, and the search kernel gives the same alpha
(bit for bit), probes and ``completes`` as that loop on the same state.
The iteration caps and the probe counting are the reference's, so the
same state gives the same alpha, ``completes`` and probe count as the
reference, except where an ulp of difference decides one of the search's
comparisons.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..kernels import linesearch_probe2, newton_search
from ..kernels.linesearch_probe.ref import (MAX_BIN_ITERS, Probe, fmax, newton_search_loop, refine_completion,
                                            two_sided_probe_fn)

__all__ = ["StepSizeResult", "standard_step", "binary_search_step", "newton_step", "newton_step_record",
           "make_probe_fn", "STEP_RULES"]

_MAX_EXP_ITERS = 64  # 2^64 dynamic range is enough for any float32/64 alpha


class StepSizeResult(NamedTuple):
    alpha: float  # chosen step size (>= 1 on feasible instances)
    probes: int  # number of f(alpha) evaluations (Table 3 "step size iters")
    completes: bool  # this step satisfies all covering constraints


def _masked_min(v: torch.Tensor, mask) -> torch.Tensor:
    if mask is None:
        return v.min()
    return torch.where(mask, v, torch.inf).min()


def make_probe_fn(y, z, dy, dz, eta: float, p_mask=None, c_mask=None, with_grad=False) -> Callable[[float], Probe]:
    """Close over the iteration state; returns probe(alpha) -> Probe.

    A probe is one two-sided probe sweep (packing side sign +1 over the rows
    ``p_mask`` keeps, covering side sign -1 over the rows ``c_mask``
    keeps), which gives the Newton slopes for free: ``with_grad`` is moot,
    as on the reference's kernel path.
    """
    buf = torch.empty(6, dtype=y.dtype, device=y.device)

    def sweep(alpha):
        # the one host sync of a probe
        return linesearch_probe2(y, dy, z, dz, alpha, eta, out=buf, p_keep=p_mask, c_keep=c_mask).tolist()

    return two_sided_probe_fn(sweep, eta, torch.finfo(y.dtype).tiny)


def standard_step(y, z, dy, dz, eta, p_mask=None, c_mask=None, ls_eps=0.1, alpha0=None) -> StepSizeResult:
    """The theoretical step alpha = 1 (Mahoney et al. implicit choice)."""
    min_z = _masked_min(z + dz, c_mask).item()
    return StepSizeResult(alpha=1.0, probes=0, completes=min_z >= 1)


def binary_search_step(y, z, dy, dz, eta, p_mask=None, c_mask=None, ls_eps=0.1, alpha0=None) -> StepSizeResult:
    """Algorithm 3: exponential bracket + binary search, warm-startable.

    Returns the largest alpha with f(alpha) >= 1 up to relative width
    ls_eps. If that alpha is < 1 the caller must declare infeasibility
    (paper, Alg. 2 line 12).
    """
    probe = make_probe_fn(y, z, dy, dz, eta, p_mask, c_mask)
    a0 = 1.0 if alpha0 is None else fmax(alpha0, 1.0)
    p0 = probe(a0)

    # --- upward exponential phase: double while f >= 1 ------------------
    # stop on bracket (f < 1) or on covering completion (Alg. 3 line 4)
    a_up, p_up, n_up = a0, p0, 1
    while p_up.f >= 1 and p_up.min_z < 1 and n_up < _MAX_EXP_ITERS:
        a_up *= 2
        p_up = probe(a_up)
        n_up += 1
    completed_up = p_up.f >= 1 and p_up.min_z >= 1

    # --- downward exponential phase (warm start overshot): halve while f < 1
    a_dn, p_dn, n_dn = a0, p0, 0
    while p_dn.f < 1 and a_dn > 1e-12 and n_dn < _MAX_EXP_ITERS:
        a_dn /= 2
        p_dn = probe(a_dn)
        n_dn += 1

    # bracket [lb, ub] with f(lb) >= 1 > f(ub)
    need_down = p0.f < 1
    lb = a_dn if need_down else a_up / 2
    ub = a_dn * 2 if need_down else a_up
    n_exp = 1 + n_dn if need_down else n_up

    # --- binary phase ----------------------------------------------------
    n_bin, done = 0, completed_up
    while not done and ub - lb > ls_eps * lb and n_bin < MAX_BIN_ITERS:
        beta = 0.5 * (lb + ub)
        p = probe(beta)
        ok = p.f >= 1
        done = ok and p.min_z >= 1
        if ok:
            lb = beta
        else:
            ub = beta
        n_bin += 1

    alpha = a_up if completed_up else lb
    # If this step completes the covering constraints, shrink it to the
    # *smallest* completing alpha so packing does not overshoot (1+eps).
    completes = _masked_min(z + alpha * dz, c_mask).item() >= 1
    n_ref = 0
    if completes:
        alpha, n_ref = refine_completion(probe, alpha, ls_eps)
    return StepSizeResult(alpha=alpha, probes=n_exp + n_bin + n_ref, completes=completes)


def newton_step(y, z, dy, dz, eta, p_mask=None, c_mask=None, ls_eps=0.1, alpha0=None) -> StepSizeResult:
    """Warm-started, safeguarded Newton on g(alpha) = f(alpha) - 1 (§4.2).

    After convergence, multiplicatively backs off by (1 - ls_eps) until the
    bang-for-buck invariant (16) holds, as the paper prescribes. The search
    is one call of :func:`repro_torch.kernels.newton_search`, masked or not
    (on the card one launch, read once; on the CPU its plain version, the
    host loop over plain probes).
    """
    alpha, probes, completes = newton_search(y, dy, z, dz, eta, ls_eps, alpha0, p_keep=p_mask,
                                             c_keep=c_mask).tolist()
    return StepSizeResult(alpha=alpha, probes=int(probes), completes=bool(completes))


def newton_step_record(y, z, dy, dz, eta, ls_eps, d_max, alpha_prev, out=None, p_mask=None,
                       c_mask=None) -> torch.Tensor:
    """``newton_step`` with the MWU iteration's step decision, without a
    host read: the search warm-started at ``alpha_prev`` (a one-value
    float64 tensor, updated when the step is taken), over the rows the
    masks keep, and ``[alpha, probes, completes, step, bad]`` as a float64
    5-vector on y's device, into ``out`` when given. ``bad`` is ``d_max <=
    0 or alpha < 1`` (Alg. 2 lines 8 and 12) and ``step`` is 0 if bad,
    else alpha. On the card one launch of the search kernel; on the CPU its
    plain version (``kernels/linesearch_probe/ref.py``, ``newton_step_ref``).
    alpha, probes and completes are ``newton_step``'s at the same state."""
    return newton_search(y, dy, z, dz, eta, ls_eps, alpha_prev, d_max=d_max, out=out, p_keep=p_mask,
                         c_keep=c_mask)


def _newton_step_host(y, z, dy, dz, eta, p_mask=None, c_mask=None, ls_eps=0.1, alpha0=None) -> StepSizeResult:
    """``newton_step`` as a host loop over ``make_probe_fn``'s probes (one
    host sync each): over the probe kernel on the card, masked or not, the
    search kernel's oracle."""
    probe = make_probe_fn(y, z, dy, dz, eta, p_mask, c_mask, with_grad=True)
    return StepSizeResult(*newton_search_loop(probe, torch.finfo(y.dtype).tiny, ls_eps, alpha0))


STEP_RULES = {
    "std": standard_step,
    "binary": binary_search_step,
    "newton": newton_step,
}
