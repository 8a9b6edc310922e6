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
Here the Newton and binary searches on the card are each one launch of
:func:`repro_torch.kernels.newton_search` or
:func:`repro_torch.kernels.binary_search`, which run the whole search
there, over the rows that the masks keep (padded rows of a served
request, gen-match's rows with no lower bound). :func:`newton_step` and
:func:`binary_search_step` read the result back once; the MWU loop calls
the rules' record functions instead (:func:`newton_step_record`,
:func:`binary_step_record` and :func:`standard_step_record`), which take max(d) from the card, decide the
iteration's step there and leave it in a device record, so that the loop
reads the step only with the rest of its lane record. On the CPU the
search wrappers run their plain versions (``kernels/linesearch_probe/ref.py``),
host loops over plain two-sided probes. Over the probe kernel on the card
(:func:`repro_torch.kernels.linesearch_probe2`, one launch and one host
read a probe) the same loops are ``_newton_step_host`` and
``_binary_search_step_host``: each search kernel gives the same alpha (bit
for bit), probes and ``completes`` as its loop on the same state. Nothing
on the main path calls those two. The iteration caps and the probe
counting are the reference's, so the same state gives the same alpha,
``completes`` and probe count as the reference, except where an ulp of
difference decides one of the search's comparisons.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..kernels import binary_search, linesearch_probe2, newton_search
from ..kernels.linesearch_probe.ref import Probe, binary_search_loop, newton_search_loop, two_sided_probe_fn

__all__ = ["StepSizeResult", "standard_step", "binary_search_step", "newton_step", "standard_step_record",
           "binary_step_record", "newton_step_record", "make_probe_fn", "STEP_RULES"]


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
    (paper, Alg. 2 line 12). The search is one call of
    :func:`repro_torch.kernels.binary_search`, masked or not (on the card
    one launch, read once; on the CPU its plain version, the host loop over
    plain probes).
    """
    alpha, probes, completes = binary_search(y, dy, z, dz, eta, ls_eps, alpha0, p_keep=p_mask,
                                             c_keep=c_mask).tolist()
    return StepSizeResult(alpha=alpha, probes=int(probes), completes=bool(completes))


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
    0 or alpha < 1`` (Alg. 2 lines 8 and 12) and ``step`` is 0 if bad, else
    alpha. On the card one launch of the search kernel; on the CPU its
    plain version (``kernels/linesearch_probe/ref.py``, ``newton_step_ref``).
    alpha, probes and completes are ``newton_step``'s at the same state."""
    return newton_search(y, dy, z, dz, eta, ls_eps, alpha_prev, d_max=d_max, out=out, p_keep=p_mask,
                         c_keep=c_mask)


def binary_step_record(y, z, dy, dz, eta, ls_eps, d_max, alpha_prev, out=None, p_mask=None,
                       c_mask=None) -> torch.Tensor:
    """:func:`newton_step_record` for the binary rule: one launch of the
    binary search kernel on the card (``ref.binary_step_ref`` on the CPU);
    alpha, probes and completes are ``binary_search_step``'s at the same
    state, warm-started at ``alpha_prev``."""
    return binary_search(y, dy, z, dz, eta, ls_eps, alpha_prev, d_max=d_max, out=out, p_keep=p_mask,
                         c_keep=c_mask)


def standard_step_record(y, z, dy, dz, eta, ls_eps, d_max, alpha_prev, out=None, p_mask=None,
                         c_mask=None) -> torch.Tensor:
    """:func:`newton_step_record` for the standard rule, in plain tensor
    operations on y's device (the reference's rule has no kernel): alpha 1,
    probes 0, ``completes = min(z + dz) >= 1`` over the rows ``c_mask``
    keeps, ``bad = d_max <= 0``, step 0 if bad else 1; ``alpha_prev``
    becomes 1 when the step is taken. No host read."""
    bad = (d_max <= 0).reshape(())
    completes = _masked_min(z + dz, c_mask) >= 1
    one = torch.ones((), dtype=torch.float64, device=y.device)  # repro: noqa[RPR003] the std rule's f64 record row
    rec = torch.stack([one, torch.zeros_like(one), completes.double(), (~bad).double(), bad.double()])
    alpha_prev.copy_(torch.where(bad, alpha_prev, one))
    return rec if out is None else out.copy_(rec)


def _binary_search_step_host(y, z, dy, dz, eta, p_mask=None, c_mask=None, ls_eps=0.1,
                             alpha0=None) -> StepSizeResult:
    """``binary_search_step`` as a host loop over ``make_probe_fn``'s probes
    (one host sync each): over the probe kernel on the card, masked or not,
    the binary search kernel's oracle."""
    probe = make_probe_fn(y, z, dy, dz, eta, p_mask, c_mask)
    return StepSizeResult(*binary_search_loop(probe, ls_eps, alpha0))


def _newton_step_host(y, z, dy, dz, eta, p_mask=None, c_mask=None, ls_eps=0.1, alpha0=None) -> StepSizeResult:
    """``newton_step`` as a host loop over ``make_probe_fn``'s probes (one
    host sync each): over the probe kernel on the card, masked or not, the
    search kernel's oracle."""
    probe = make_probe_fn(y, z, dy, dz, eta, p_mask, c_mask, with_grad=True)
    return StepSizeResult(*newton_search_loop(probe, torch.finfo(y.dtype).tiny, ls_eps, alpha0))


def host_rule_record(step_fn: Callable[..., StepSizeResult]) -> Callable[..., torch.Tensor]:
    """A record function over a host rule: ``step_fn`` (a rule of
    ``STEP_RULES``' form, such as the oracles above) is called with the
    warm start read from ``alpha_prev``, and the iteration's decision is
    made on the host, with max(d) read back; the record and ``alpha_prev``
    are then written as the record functions write them. It lets a host
    rule drive the MWU loop, to hold a record function against it."""
    def record(y, z, dy, dz, eta, ls_eps, d_max, alpha_prev, out=None, p_mask=None, c_mask=None):
        ss = step_fn(y, z, dy, dz, eta, p_mask, c_mask, ls_eps, alpha_prev.item())
        bad = d_max.item() <= 0 or ss.alpha < 1
        if not bad:
            alpha_prev.fill_(ss.alpha)
        rec = torch.tensor([ss.alpha, ss.probes, ss.completes, 0.0 if bad else ss.alpha, float(bad)],
                           dtype=torch.float64, device=y.device)  # repro: noqa[RPR003] a host rule's f64 record row
        return rec if out is None else out.copy_(rec)

    return record


STEP_RULES = {
    "std": standard_step,
    "binary": binary_search_step,
    "newton": newton_step,
}

