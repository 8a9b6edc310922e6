"""RMSNorm / LayerNorm (computed in f32, cast back to the input's dtype).

Port of ``repro.models.layers.norms``.
"""
from __future__ import annotations

import torch

__all__ = ["norm_init", "apply_norm"]


def norm_init(d: int, norm_type: str, dtype, device) -> dict:
    p = {"scale": torch.ones(d, dtype=dtype, device=device)}
    if norm_type == "layernorm":
        p["bias"] = torch.zeros(d, dtype=dtype, device=device)
    return p


def apply_norm(params, x: torch.Tensor, norm_type: str, eps: float) -> torch.Tensor:
    xf = x.float()
    if norm_type == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, correction=0)  # jnp.var: population variance
        out = (xf - mu) / torch.sqrt(var + eps)
        out = out * params["scale"].float() + params["bias"].float()
    else:  # rmsnorm
        ms = (xf * xf).mean(dim=-1, keepdim=True)
        out = xf * (1.0 / torch.sqrt(ms + eps)) * params["scale"].float()
    return out.to(x.dtype)
