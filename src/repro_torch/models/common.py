"""Shared model-plane utilities: the dtype policy, parameter init and the
sharding vocabulary.

Port of ``repro.models.common``. Sharding vocabulary (the reference's):
DP axes = ("pod", "data") where present, the batch and FSDP shards; TP axis
= "model", Megatron-style tensor-parallel dims. A :class:`P` names, for each
dim of a tensor, the mesh axes that split it; the layers' ``*_spec``
functions and ``Model.param_spec``/``cache_spec`` give one a tensor, and
``repro_torch.launch.mesh.sharding_for`` turns them into placements on a
``DeviceMesh``. ``with_sharding`` is not carried over: it annotates jit
programs and is a no-op outside a mesh context in the reference, and the
port's forward runs eagerly on one card. Init draws from an explicit ``torch.Generator``; it gives
other numbers than ``jax.random`` from the same seed, so tests that compare
the two packages carry the reference's parameters across with
:func:`repro_torch.models.load_jax_params`.
"""
from __future__ import annotations

import math

import torch

__all__ = ["Dtypes", "torch_dtype", "dense_init", "truncated_normal_init", "P", "TP", "dp_axes", "DP"]

TP = "model"


class P(tuple):
    """A partition spec, ``jax.sharding.PartitionSpec``'s counterpart: one
    entry a tensor dim, each None (not split), a mesh axis name, or a tuple
    of names (the dim split over those axes, the first the major one)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def dp_axes(mesh_axes) -> tuple:
    """The data-parallel axes present in this mesh ('pod' absorbs into DP)."""
    return tuple(a for a in ("pod", "data") if a in mesh_axes)


def DP(mesh_axes):
    """The batch dim's spec entry: both DP axes, the one present, or None."""
    axes = dp_axes(mesh_axes)
    return axes if len(axes) > 1 else (axes[0] if axes else None)

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


def truncated_normal_init(gen: torch.Generator | None, shape, dtype, scale: float, device) -> torch.Tensor:
    """Normal cut at +-2 standard deviations, times std = scale / sqrt(fan_in)
    (fan_in = shape[-2], or shape[-1] for a vector), drawn in float32. On
    the ``meta`` device nothing is drawn (``gen`` is None there): the
    abstract build, the counterpart of the reference's ``abstract_params``."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale / math.sqrt(fan_in)
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=gen)
    return (w * std).to(dtype)


def dense_init(gen: torch.Generator, shape, dtype, device, scale: float = 1.0) -> torch.Tensor:
    return truncated_normal_init(gen, shape, dtype, scale, device)
