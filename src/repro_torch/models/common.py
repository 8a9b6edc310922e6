"""Shared model-plane utilities: the dtype policy and parameter init.

Port of ``repro.models.common``. The sharding helpers are not carried over:
the port runs on one card, where ``with_sharding`` is a no-op in the
reference as well. Init draws from an explicit ``torch.Generator``; it gives
other numbers than ``jax.random`` from the same seed, so tests that compare
the two packages carry the reference's parameters across with
:func:`repro_torch.models.load_jax_params`.
"""
from __future__ import annotations

import math

import torch

__all__ = ["Dtypes", "torch_dtype", "dense_init", "truncated_normal_init"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16, "float64": torch.float64}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name ("bfloat16", "float32", ...)."""
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype name {name!r}; expected one of {sorted(_DTYPES)}")
    return _DTYPES[name]


class Dtypes:
    """Resolved dtype policy for a config."""

    def __init__(self, cfg):
        self.param = torch_dtype(cfg.param_dtype)
        self.compute = torch_dtype(cfg.dtype)
        self.logit = torch_dtype(cfg.logit_dtype)


def truncated_normal_init(gen: torch.Generator, shape, dtype, scale: float, device) -> torch.Tensor:
    """Normal cut at +-2 standard deviations, times std = scale / sqrt(fan_in)
    (fan_in = shape[-2], or shape[-1] for a vector), drawn in float32."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale / math.sqrt(fan_in)
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=gen)
    return (w * std).to(dtype)


def dense_init(gen: torch.Generator, shape, dtype, device, scale: float = 1.0) -> torch.Tensor:
    return truncated_normal_init(gen, shape, dtype, scale, device)
