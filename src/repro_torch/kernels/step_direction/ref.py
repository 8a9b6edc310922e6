"""Plain PyTorch version of the step direction: the eager chain of the MWU
iteration (dtype-preserving)."""
from __future__ import annotations

import torch

from ..incidence_gather.ref import incidence_gather_ref


def step_direction_ref(h: torch.Tensor, x: torch.Tensor, scale: float, g: torch.Tensor | None = None,
                       gather: tuple | None = None):
    """(d, max d) with g given, or ``g = w[u] + w[v]`` for ``gather = (u, v, w)``,
    times the edge factor for ``gather = (u, v, w, mask, weights)``
    (``incidence_gather_ref``): ``d = scale * max(0, 1 - g/h) * x``, ``g/h``
    taken as inf where h <= tiny."""
    if g is None:
        g = incidence_gather_ref(*gather)
    tiny = torch.finfo(x.dtype).tiny
    ratio = torch.where(h > tiny, g / torch.clamp(h, min=tiny), torch.inf)
    d = scale * torch.clamp(1.0 - ratio, min=0.0) * x
    return d, d.max()
