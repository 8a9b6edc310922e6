"""Plain PyTorch version of the incidence gather (dtype-preserving)."""
from __future__ import annotations

import torch


def edge_factor(E: int, dtype: torch.dtype, device, mask: torch.Tensor | None = None,
                weights: torch.Tensor | None = None) -> torch.Tensor:
    """The E-length factor of a masked or weighted incidence operator
    (``Incidence._w``): ``weights`` (ones without) in ``dtype``, 0 where
    ``mask`` is False."""
    f = torch.ones(E, dtype=dtype, device=device) if weights is None else weights.to(dtype)
    return f if mask is None else torch.where(mask, f, 0.0)


def incidence_gather_ref(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor, mask: torch.Tensor | None = None,
                         weights: torch.Tensor | None = None) -> torch.Tensor:
    """g[e] = w[u[e]] + w[v[e]], times :func:`edge_factor` where a mask or
    weights are given (the plain chain of ``Incidence.rmatvec``);
    ``index_select`` takes the int32 indices as they are."""
    g = w.index_select(0, u) + w.index_select(0, v)
    if mask is None and weights is None:
        return g
    return g * edge_factor(g.shape[0], g.dtype, g.device, mask, weights)
