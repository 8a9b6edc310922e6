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
Here they are Python loops over host floats: each probe evaluates both
sides on the device (two :func:`repro_torch.kernels.linesearch_probe`
calls for unmasked problems, the CUDA kernel on the card) and reads the
six results back in one copy, which is one host sync per probe. The
iteration caps and the probe counting are the reference's, so the same
state gives the same alpha, ``completes`` and probe count, except where
an ulp of difference decides one of the search's comparisons.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..kernels import linesearch_probe
from .smoothing import logsumexp_shifted

__all__ = ["StepSizeResult", "standard_step", "binary_search_step", "newton_step", "make_probe_fn", "STEP_RULES"]

_MAX_EXP_ITERS = 64  # 2^64 dynamic range is enough for any float32/64 alpha
_MAX_BIN_ITERS = 64
_MAX_NEWTON_ITERS = 30
_MAX_BACKOFF_ITERS = 64


class StepSizeResult(NamedTuple):
    alpha: float  # chosen step size (>= 1 on feasible instances)
    probes: int  # number of f(alpha) evaluations (Table 3 "step size iters")
    completes: bool  # this step satisfies all covering constraints


class _Probe(NamedTuple):
    """f(alpha) and its pieces at one probe point (host floats)."""

    f: float
    phi: float
    psi: float
    dphi: float
    dpsi: float
    min_z: float  # min of covering values at this alpha


def _masked_min(v: torch.Tensor, mask) -> torch.Tensor:
    if mask is None:
        return v.min()
    return torch.where(mask, v, torch.inf).min()


# NaN-propagating max/min/clip, as jnp.maximum/minimum/clip behave
def _fmax(a: float, b: float) -> float:
    return math.nan if (a != a or b != b) else (a if a >= b else b)


def _fmin(a: float, b: float) -> float:
    return math.nan if (a != a or b != b) else (a if a <= b else b)


def _ratio(phi: float, psi: float, tiny: float) -> float:
    # covering must improve and packing must not decrease for the
    # invariant to be meaningful; on degenerate steps psi can be ~0.
    return math.inf if psi <= tiny else phi / _fmax(psi, tiny)


def make_probe_fn(y, z, dy, dz, eta: float, p_mask=None, c_mask=None, with_grad=False) -> Callable[[float], _Probe]:
    """Close over the iteration state; returns probe(alpha) -> _Probe.

    Unmasked problems evaluate a probe as two fused probe sweeps (packing
    side sign +1, covering side sign -1), which give the Newton slopes for
    free; ``with_grad`` only matters on the masked path, as in the
    reference.
    """
    tiny = torch.finfo(y.dtype).tiny

    if p_mask is None and c_mask is None:
        buf = torch.empty(6, dtype=y.dtype, device=y.device)

        def sweep(alpha):
            linesearch_probe(y, dy, alpha, eta, 1.0, out=buf[:3])
            linesearch_probe(z, dz, alpha, eta, -1.0, out=buf[3:])
            return buf.tolist()  # the one host sync of a probe

        lse_y0, _, _, lse_z0, _, _ = sweep(0.0)

        def probe_kernel(alpha: float) -> _Probe:
            lse_ya, dpsi, _, lse_za, dphi, min_z = sweep(alpha)
            psi = (lse_ya - lse_y0) / eta
            phi = -(lse_za - lse_z0) / eta  # smin = -lse(-eta z)/eta
            return _Probe(f=_ratio(phi, psi, tiny), phi=phi, psi=psi, dphi=dphi, dpsi=dpsi, min_z=min_z)

        return probe_kernel

    ay = eta * y
    az = -eta * z
    if p_mask is not None:
        ay = torch.where(p_mask, ay, -torch.inf)
    if c_mask is not None:
        az = torch.where(c_mask, az, -torch.inf)
    lse_y0, _ = logsumexp_shifted(ay)
    lse_z0, _ = logsumexp_shifted(az)
    lse_y0, lse_z0 = torch.stack([lse_y0, lse_z0]).tolist()

    def probe(alpha: float) -> _Probe:
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
        return _Probe(f=_ratio(phi, psi, tiny), phi=phi, psi=psi, dphi=dphi, dpsi=dpsi, min_z=min_z)

    return probe


def standard_step(y, z, dy, dz, eta, p_mask=None, c_mask=None, ls_eps=0.1, alpha0=None) -> StepSizeResult:
    """The theoretical step alpha = 1 (Mahoney et al. implicit choice)."""
    min_z = _masked_min(z + dz, c_mask).item()
    return StepSizeResult(alpha=1.0, probes=0, completes=min_z >= 1)


def _refine_completion(probe, hi: float, ls_eps: float) -> tuple[float, int]:
    """Smallest alpha in (0, hi] with min_z(alpha) >= 1 (monotone in alpha).

    The completing step must not overshoot: covering overshoot translates
    directly into packing violation beyond (1+eps). Bisect to within
    ls_eps relative width; the result still satisfies the bang-for-buck
    invariant because f is decreasing (smaller alpha => larger f).
    """
    lo, h, n = 0.0, hi, 0
    while h - lo > ls_eps * h and n < _MAX_BIN_ITERS:
        mid = 0.5 * (lo + h)
        if probe(mid).min_z >= 1:
            h = mid
        else:
            lo = mid
        n += 1
    return _fmax(h, 1.0), n


def binary_search_step(y, z, dy, dz, eta, p_mask=None, c_mask=None, ls_eps=0.1, alpha0=None) -> StepSizeResult:
    """Algorithm 3: exponential bracket + binary search, warm-startable.

    Returns the largest alpha with f(alpha) >= 1 up to relative width
    ls_eps. If that alpha is < 1 the caller must declare infeasibility
    (paper, Alg. 2 line 12).
    """
    probe = make_probe_fn(y, z, dy, dz, eta, p_mask, c_mask)
    a0 = 1.0 if alpha0 is None else _fmax(alpha0, 1.0)
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
    while not done and ub - lb > ls_eps * lb and n_bin < _MAX_BIN_ITERS:
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
        alpha, n_ref = _refine_completion(probe, alpha, ls_eps)
    return StepSizeResult(alpha=alpha, probes=n_exp + n_bin + n_ref, completes=completes)


def newton_step(y, z, dy, dz, eta, p_mask=None, c_mask=None, ls_eps=0.1, alpha0=None) -> StepSizeResult:
    """Warm-started, safeguarded Newton on g(alpha) = f(alpha) - 1 (§4.2).

    After convergence, multiplicatively backs off by (1 - ls_eps) until the
    bang-for-buck invariant (16) holds, as the paper prescribes.
    """
    probe = make_probe_fn(y, z, dy, dz, eta, p_mask, c_mask, with_grad=True)
    tiny = torch.finfo(y.dtype).tiny
    a = 1.0 if alpha0 is None else _fmax(alpha0, 1e-6)
    p, n, done = probe(a), 1, False
    while not done and n < _MAX_NEWTON_ITERS:
        # f' = (Phi' Psi - Phi Psi') / Psi^2   (negative: f is decreasing)
        psi2 = _fmax(p.psi * p.psi, tiny)
        fp = _fmin((p.dphi * p.psi - p.phi * p.dpsi) / psi2, -tiny)  # enforce the known sign
        raw = a - (p.f - 1.0) / fp
        # trust-region safeguard: at most 8x move per iteration
        a2 = _fmax(_fmin(_fmax(raw, a * 0.125), a * 8.0), 1e-12)
        p2 = probe(a2)
        done = abs(a2 - a) <= ls_eps * a or (p2.f >= 1 and p2.min_z >= 1)
        a, p, n = a2, p2, n + 1

    # back off multiplicatively until invariant satisfied (paper §4.2)
    n_bo = 0
    while p.f < 1 and n_bo < _MAX_BACKOFF_ITERS:
        a *= 1.0 - ls_eps
        p = probe(a)
        n_bo += 1

    # completion refinement: smallest alpha that satisfies covering
    completes = p.min_z >= 1 and p.f >= 1
    n_ref = 0
    if completes:
        a, n_ref = _refine_completion(probe, a, ls_eps)
    return StepSizeResult(alpha=a, probes=n + n_bo + n_ref, completes=completes)


STEP_RULES = {
    "std": standard_step,
    "binary": binary_search_step,
    "newton": newton_step,
}
