"""Plain versions of the line-search probe (PyTorch, dtype-preserving) and
of the Newton step-size search over it.

The search is ``core.stepsize``'s Newton rule as a host loop over probes,
one host read a probe. :func:`newton_search_loop` takes any probe
function: ``core.stepsize`` runs it over the probe kernel on the card,
where it is the search kernel's oracle. Every function takes optional row
masks (``keep``; ``p_keep`` for the packing side, ``c_keep`` for the
covering side): a row that is not kept counts as a = -inf and is left out
of min v, as ``core.stepsize``'s masked ``make_probe_fn`` leaves it out.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

MAX_NEWTON_ITERS = 30  # the reference's caps
MAX_BACKOFF_ITERS = 64
MAX_BIN_ITERS = 64


def linesearch_probe_ref(y: torch.Tensor, dy: torch.Tensor, alpha: float, eta: float, sign: float = 1.0,
                         keep: torch.Tensor | None = None):
    """[lse, slope, min_v] for v = y + alpha*dy and a = sign*eta*v, as one
    vector, over the rows ``keep`` keeps. The masked form is the reference's
    masked probe (``repro.core.stepsize.make_probe_fn``: the slope as
    <exp(a - lse), dy>, rounded as there), so the CPU's masked searches keep
    its bits."""
    v = y + alpha * dy
    a = (sign * eta) * v
    if keep is not None:
        a, v = torch.where(keep, a, -torch.inf), torch.where(keep, v, torch.inf)
    m = a.max()
    if keep is not None:  # every row masked out: lse = -inf, not NaN
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(a - m)
    s = e.sum()
    lse = m + torch.log(s)
    slope = (e * dy).sum() / s if keep is None else torch.dot(torch.exp(a - lse), dy)
    return torch.stack([lse, slope, v.min()])


def linesearch_probe2_ref(y, dy, z, dz, alpha: float, eta: float, p_keep=None, c_keep=None):
    """Both sides of a step-size probe: (y, dy) at sign +1, then (z, dz) at sign -1."""
    return torch.cat([linesearch_probe_ref(y, dy, alpha, eta, 1.0, p_keep),
                      linesearch_probe_ref(z, dz, alpha, eta, -1.0, c_keep)])


class Probe(NamedTuple):
    """f(alpha) and its pieces at one probe point (host floats)."""

    f: float
    phi: float
    psi: float
    dphi: float
    dpsi: float
    min_z: float  # min of covering values at this alpha


# NaN-propagating max/min, as jnp.maximum/minimum behave
def fmax(a: float, b: float) -> float:
    return math.nan if (a != a or b != b) else (a if a >= b else b)


def fmin(a: float, b: float) -> float:
    return math.nan if (a != a or b != b) else (a if a <= b else b)


def ratio(phi: float, psi: float, tiny: float) -> float:
    # covering must improve and packing must not decrease for the
    # invariant to be meaningful; on degenerate steps psi can be ~0.
    return math.inf if psi <= tiny else phi / fmax(psi, tiny)


def two_sided_probe_fn(sweep: Callable[[float], list], eta: float, tiny: float) -> Callable[[float], Probe]:
    """probe(alpha) over ``sweep(alpha)``, the six host floats of a two-sided
    probe ``[lse_y, slope_y, min_y, lse_z, slope_z, min_z]``; sweeps once at
    alpha = 0 first. Psi = smax(y + a dy) - smax(y), Phi = smin(z + a dz) -
    smin(z), with smin = -lse(-eta z)/eta."""
    lse_y0, _, _, lse_z0, _, _ = sweep(0.0)

    def probe(alpha: float) -> Probe:
        lse_ya, dpsi, _, lse_za, dphi, min_z = sweep(alpha)
        psi = (lse_ya - lse_y0) / eta
        phi = -(lse_za - lse_z0) / eta
        return Probe(f=ratio(phi, psi, tiny), phi=phi, psi=psi, dphi=dphi, dpsi=dpsi, min_z=min_z)

    return probe


def refine_completion(probe, hi: float, ls_eps: float) -> tuple[float, int]:
    """Smallest alpha in (0, hi] with min_z(alpha) >= 1 (monotone in alpha).

    The completing step must not overshoot: covering overshoot translates
    directly into packing violation beyond (1+eps). Bisect to within
    ls_eps relative width; the result still satisfies the bang-for-buck
    invariant because f is decreasing (smaller alpha => larger f).
    """
    lo, h, n = 0.0, hi, 0
    while h - lo > ls_eps * h and n < MAX_BIN_ITERS:
        mid = 0.5 * (lo + h)
        if probe(mid).min_z >= 1:
            h = mid
        else:
            lo = mid
        n += 1
    return fmax(h, 1.0), n


def newton_search_loop(probe: Callable[[float], Probe], tiny: float, ls_eps: float,
                       alpha0: float | None) -> tuple[float, int, bool]:
    """Warm-started, safeguarded Newton on g(alpha) = f(alpha) - 1 (§4.2):
    ``(alpha, probes, completes)``.

    After convergence, multiplicatively backs off by (1 - ls_eps) until the
    bang-for-buck invariant (16) holds, as the paper prescribes; a step that
    completes the covering constraints is then shrunk to the smallest
    completing alpha.
    """
    a = 1.0 if alpha0 is None else fmax(alpha0, 1e-6)
    p, n, done = probe(a), 1, False
    while not done and n < MAX_NEWTON_ITERS:
        # f' = (Phi' Psi - Phi Psi') / Psi^2   (negative: f is decreasing)
        psi2 = fmax(p.psi * p.psi, tiny)
        fp = fmin((p.dphi * p.psi - p.phi * p.dpsi) / psi2, -tiny)  # enforce the known sign
        raw = a - (p.f - 1.0) / fp
        # trust-region safeguard: at most 8x move per iteration
        a2 = fmax(fmin(fmax(raw, a * 0.125), a * 8.0), 1e-12)
        p2 = probe(a2)
        done = abs(a2 - a) <= ls_eps * a or (p2.f >= 1 and p2.min_z >= 1)
        a, p, n = a2, p2, n + 1

    # back off multiplicatively until invariant satisfied (paper §4.2)
    n_bo = 0
    while p.f < 1 and n_bo < MAX_BACKOFF_ITERS:
        a *= 1.0 - ls_eps
        p = probe(a)
        n_bo += 1

    # completion refinement: smallest alpha that satisfies covering
    completes = p.min_z >= 1 and p.f >= 1
    n_ref = 0
    if completes:
        a, n_ref = refine_completion(probe, a, ls_eps)
    return a, n + n_bo + n_ref, completes


def newton_search_ref(y, dy, z, dz, eta: float, ls_eps: float, alpha0: float | None = None, p_keep=None,
                      c_keep=None) -> torch.Tensor:
    """The Newton search over plain two-sided probes: ``[alpha, probes,
    completes]`` as a float64 3-vector on y's device."""
    tiny = torch.finfo(y.dtype).tiny
    probe = two_sided_probe_fn(lambda a: linesearch_probe2_ref(y, dy, z, dz, a, eta, p_keep, c_keep).tolist(), eta,
                               tiny)
    return torch.tensor(newton_search_loop(probe, tiny, ls_eps, alpha0), dtype=torch.float64, device=y.device)


def newton_step_ref(y, dy, z, dz, eta: float, ls_eps: float, d_max: torch.Tensor, alpha_prev: torch.Tensor,
                    p_keep=None, c_keep=None) -> torch.Tensor:
    """The search's step form: the Newton search warm-started at
    ``alpha_prev`` (a one-value float64 tensor) and the MWU iteration's
    decision on it (Alg. 2 lines 8 and 12), ``[alpha, probes, completes,
    step, bad]`` as a float64 5-vector with ``bad = max(d) <= 0 or alpha <
    1`` and ``step = 0 if bad else alpha``; ``alpha_prev`` becomes alpha
    when the step is taken."""
    alpha, probes, completes = newton_search_ref(y, dy, z, dz, eta, ls_eps, float(alpha_prev), p_keep,
                                                 c_keep).tolist()
    bad = float(d_max) <= 0 or alpha < 1
    if not bad:
        alpha_prev.fill_(alpha)
    return torch.tensor([alpha, probes, completes, 0.0 if bad else alpha, float(bad)], dtype=torch.float64,
                        device=y.device)
