"""Smoothed max/min and their gradients (paper §2.2), in PyTorch.

Port of ``repro.core.smoothing``:

    smax_eta(v) = (1/eta) * log(sum_i exp(eta * v_i))
    smin_eta(v) = -(1/eta) * log(sum_i exp(-eta * v_i))

with gradients softmax(eta * v) and softmax(-eta * v), always through a
shifted logsumexp (eta = 10 log(m)/eps is far beyond the exp range).

``smax_and_weights`` / ``smin_and_weights`` — the per-iteration gradient
step of the MWU loop — call :func:`repro_torch.kernels.softmax_weights`
when unmasked (the CUDA kernel on the card, its plain version on the
CPU). Masked calls stay plain PyTorch on every device, as the reference
keeps them on XLA. ``eta`` is a host float throughout.
"""
from __future__ import annotations

import torch

from ..kernels import softmax_weights

__all__ = [
    "smax",
    "smin",
    "smax_weights",
    "smin_weights",
    "smax_and_weights",
    "smin_and_weights",
    "logsumexp_shifted",
]


def _neg_inf_where(a: torch.Tensor, where) -> torch.Tensor:
    return a if where is None else torch.where(where, a, -torch.inf)


def logsumexp_shifted(a: torch.Tensor, where: torch.Tensor | None = None):
    """Stable logsumexp returning (lse, shift) so callers can reuse the shift.

    ``where`` masks entries out of the reduction (treated as -inf).
    """
    a = _neg_inf_where(a, where)
    shift = a.max()
    # If everything is -inf (empty mask) keep shift finite to avoid nan.
    shift = torch.where(torch.isfinite(shift), shift, torch.zeros_like(shift))
    lse = shift + torch.log(torch.exp(a - shift).sum())
    return lse, shift


def smax(v: torch.Tensor, eta: float, where: torch.Tensor | None = None) -> torch.Tensor:
    """smax_eta(v); scalar. Within log(m)/eta of max(v) from above."""
    lse, _ = logsumexp_shifted(eta * v, where=where)
    return lse / eta


def smin(v: torch.Tensor, eta: float, where: torch.Tensor | None = None) -> torch.Tensor:
    """smin_eta(v); scalar. Within log(m)/eta of min(v) from below."""
    lse, _ = logsumexp_shifted(-eta * v, where=where)
    return -lse / eta


def smax_weights(v: torch.Tensor, eta: float, where: torch.Tensor | None = None) -> torch.Tensor:
    """w_p = grad smax_eta(v) = softmax(eta*v). Sums to 1."""
    return torch.softmax(_neg_inf_where(eta * v, where), dim=0)


def smin_weights(v: torch.Tensor, eta: float, where: torch.Tensor | None = None) -> torch.Tensor:
    """w_c = grad smin_eta(v) = softmax(-eta*v). Sums to 1."""
    return torch.softmax(_neg_inf_where(-eta * v, where), dim=0)


def _masked_and_weights(a: torch.Tensor, where):
    a = _neg_inf_where(a, where)
    shift = a.max()
    shift = torch.where(torch.isfinite(shift), shift, torch.zeros_like(shift))
    e = torch.exp(a - shift)
    s = e.sum()
    return shift + torch.log(s), e / s


def smax_and_weights(v, eta, where=None):
    """One-pass (smax, softmax(eta v)) sharing the max-shift.

    Unmasked calls go to the fused softmax-weights kernel; masked calls
    stay plain.
    """
    if where is None:
        lse, w = softmax_weights(v, eta, sign=1.0)
        return lse / eta, w
    lse, w = _masked_and_weights(eta * v, where)
    return lse / eta, w


def smin_and_weights(v, eta, where=None):
    """One-pass (smin, softmax(-eta v)) sharing the max-shift (sign=-1 kernel)."""
    if where is None:
        lse, w = softmax_weights(v, eta, sign=-1.0)
        return -lse / eta, w
    lse, w = _masked_and_weights(-eta * v, where)
    return -lse / eta, w
