"""Dense FFN: SwiGLU (llama family) and GELU (starcoder2, hubert).

Port of ``repro.models.layers.mlp``. The weights are cast to the
activation's dtype and the products return that dtype, as the reference's
``preferred_element_type`` does. ``jax.nn.gelu`` defaults to the tanh
approximation, so the port uses ``approximate="tanh"``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..common import dense_init

__all__ = ["mlp_init", "mlp_apply"]


def mlp_init(gen: torch.Generator, cfg, dtype, device) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_type == "swiglu":
        return {
            "wg": dense_init(gen, (d, f), dtype, device),
            "wu": dense_init(gen, (d, f), dtype, device),
            "wd": dense_init(gen, (f, d), dtype, device),
        }
    return {
        "wu": dense_init(gen, (d, f), dtype, device),
        "wd": dense_init(gen, (f, d), dtype, device),
        "bu": torch.zeros(f, dtype=dtype, device=device),
        "bd": torch.zeros(d, dtype=dtype, device=device),
    }


def mlp_apply(params, x: torch.Tensor, cfg) -> torch.Tensor:
    def mm(a, w):
        return a @ w.to(a.dtype)

    if cfg.mlp_type == "swiglu":
        h = F.silu(mm(x, params["wg"])) * mm(x, params["wu"])
    else:
        h = F.gelu(mm(x, params["wu"]) + params["bu"].to(x.dtype), approximate="tanh")
    out = mm(h, params["wd"])
    if "bd" in params:
        out = out + params["bd"].to(x.dtype)
    return out
