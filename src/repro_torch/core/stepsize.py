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
Here the Newton search of an unmasked problem on the card is one launch
of :func:`repro_torch.kernels.newton_search`, which runs the whole search
there. :func:`newton_step` reads its result back once; the MWU loop calls
:func:`newton_step_record` instead, which takes max(d) from the card,
decides the iteration's step there and leaves it in a device record, so
that the loop reads the search only with the rest of its lane record.
Elsewhere (the binary rule, masked problems,
the CPU) the searches are Python loops over host floats: each probe
evaluates both sides on the device (one
:func:`repro_torch.kernels.linesearch_probe2` call for unmasked problems,
the CUDA kernel on the card) and reads the six results back in one copy,
which is one host sync per probe. The Newton search's host loop is the
search kernel's plain version (``kernels/linesearch_probe/ref.py``); over
the probe kernel on the card it is ``_newton_step_host``, and the search
kernel gives the same alpha (bit for bit), probes and ``completes`` as
that loop on the same state. The iteration caps and the probe counting
are the reference's, so the same state gives the same alpha,
``completes`` and probe count as the reference, except where an ulp of
difference decides one of the search's comparisons.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..kernels import linesearch_probe2, newton_search
from ..kernels.linesearch_probe.ref import (MAX_BIN_ITERS, Probe, fmax, newton_search_loop, ratio, refine_completion,
                                            two_sided_probe_fn)
from .smoothing import logsumexp_shifted

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

    Unmasked problems evaluate a probe as one two-sided probe sweep
    (packing side sign +1, covering side sign -1), which gives the Newton
    slopes for free; ``with_grad`` only matters on the masked path, as in
    the reference.
    """
    tiny = torch.finfo(y.dtype).tiny

    if p_mask is None and c_mask is None:
        buf = torch.empty(6, dtype=y.dtype, device=y.device)

        def sweep(alpha):
            return linesearch_probe2(y, dy, z, dz, alpha, eta, out=buf).tolist()  # the one host sync of a probe

        return two_sided_probe_fn(sweep, eta, tiny)

    ay = eta * y
    az = -eta * z
    if p_mask is not None:
        ay = torch.where(p_mask, ay, -torch.inf)
    if c_mask is not None:
        az = torch.where(c_mask, az, -torch.inf)
    lse_y0, _ = logsumexp_shifted(ay)
    lse_z0, _ = logsumexp_shifted(az)
    lse_y0, lse_z0 = torch.stack([lse_y0, lse_z0]).tolist()

    def probe(alpha: float) -> Probe:
        ya = eta * (y + alpha * dy)
        za = -eta * (z + alpha * dz)
        if p_mask is not None:
            ya = torch.where(p_mask, ya, -torch.inf)
        if c_mask is not None:
            za = torch.where(c_mask, za, -torch.inf)
        lse_ya, _ = logsumexp_shifted(ya)
        lse_za, _ = logsumexp_shifted(za)
        if with_grad:
            dpsi = torch.dot(torch.exp(ya - lse_ya), dy)  # <softmax(eta(y+a dy)), dy>
            dphi = torch.dot(torch.exp(za - lse_za), dz)  # <softmax(-eta(z+a dz)), dz>
        else:
            dpsi = dphi = torch.zeros((), dtype=y.dtype, device=y.device)
        min_z = _masked_min(z + alpha * dz, c_mask)
        lse_ya, lse_za, dpsi, dphi, min_z = torch.stack([lse_ya, lse_za, dpsi, dphi, min_z]).tolist()
        # Psi = smax(y+a dy) - smax(y);  Phi = smin(z+a dz) - smin(z)
        psi = (lse_ya - lse_y0) / eta
        phi = -(lse_za - lse_z0) / eta
        return Probe(f=ratio(phi, psi, tiny), phi=phi, psi=psi, dphi=dphi, dpsi=dpsi, min_z=min_z)

    return probe


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
    bang-for-buck invariant (16) holds, as the paper prescribes. An
    unmasked search is one call of :func:`repro_torch.kernels.newton_search`
    (on the card one launch, read once; on the CPU its plain version, the
    host loop); a masked one runs the host loop over masked probes.
    """
    if p_mask is None and c_mask is None:
        alpha, probes, completes = newton_search(y, dy, z, dz, eta, ls_eps, alpha0).tolist()
        return StepSizeResult(alpha=alpha, probes=int(probes), completes=bool(completes))
    return _newton_step_host(y, z, dy, dz, eta, p_mask, c_mask, ls_eps, alpha0)


def newton_step_record(y, z, dy, dz, eta, ls_eps, d_max, alpha_prev, out=None) -> torch.Tensor:
    """``newton_step`` for an unmasked problem with the MWU iteration's step
    decision, without a host read: the search warm-started at
    ``alpha_prev`` (a one-value float64 tensor, updated when the step is
    taken) and ``[alpha, probes, completes, step, bad]`` as a float64
    5-vector on y's device, into ``out`` when given. ``bad`` is ``d_max <=
    0 or alpha < 1`` (Alg. 2 lines 8 and 12) and ``step`` is 0 if bad,
    else alpha. On the card one launch of the search kernel; on the CPU its
    plain version (``kernels/linesearch_probe/ref.py``, ``newton_step_ref``).
    alpha, probes and completes are ``newton_step``'s at the same state."""
    return newton_search(y, dy, z, dz, eta, ls_eps, alpha_prev, d_max=d_max, out=out)


def _newton_step_host(y, z, dy, dz, eta, p_mask=None, c_mask=None, ls_eps=0.1, alpha0=None) -> StepSizeResult:
    """``newton_step`` as a host loop over ``make_probe_fn``'s probes (one
    host sync each): the masked path, and over the probe kernel on the card
    the search kernel's oracle."""
    probe = make_probe_fn(y, z, dy, dz, eta, p_mask, c_mask, with_grad=True)
    return StepSizeResult(*newton_search_loop(probe, torch.finfo(y.dtype).tiny, ls_eps, alpha0))


STEP_RULES = {
    "std": standard_step,
    "binary": binary_search_step,
    "newton": newton_step,
}
