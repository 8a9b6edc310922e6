"""Assigned input-shape cells and their inputs, as (shape, dtype) specs.

Port of ``repro.configs.shapes``. Four cells per architecture:

  train_4k    seq 4096  x global_batch 256   -> train step
  prefill_32k seq 32768 x global_batch 32    -> prefill / encode
  decode_32k  KV len 32768 x global_batch 128 -> decode (1 new token)
  long_500k   KV len 524288 x global_batch 1  -> decode (1 new token)

Skip rules as the reference's: encoder-only archs have no decode cells;
long_500k runs only for sub-quadratic archs (ssm / hybrid / SWA).
``input_specs`` gives ``(shape, torch dtype)`` pairs where the reference
gives ``jax.ShapeDtypeStruct``s; ``concrete_inputs`` draws the
reference's numbers from the same numpy stream, as torch tensors.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["SHAPES", "ShapeCell", "applicable", "skip_reason", "input_specs", "concrete_inputs", "cells_for"]


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    step: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


def skip_reason(cfg, cell: ShapeCell) -> str | None:
    if cell.step == "decode" and not cfg.has_decode:
        return "encoder-only: no autoregressive step exists"
    if cell.name == "long_500k" and not cfg.is_subquadratic:
        return "pure full attention: 512k dense KV cache is not meaningful"
    return None


def applicable(cfg, cell: ShapeCell) -> bool:
    return skip_reason(cfg, cell) is None


def cells_for(cfg):
    return [c for c in SHAPES.values() if applicable(cfg, c)]


def input_specs(cfg, cell: ShapeCell) -> dict:
    """Model inputs for this (arch x shape) cell, as (shape, dtype) pairs.

    train:   {"tokens"|"frames"[, "patches"], "targets", "loss_mask"}
    prefill: {"tokens"|"frames"[, "patches"]}
    decode:  {"tokens" (B,1) | "frames" (B,1,d)}  (+ cache built separately)
    """
    B, S = cell.global_batch, cell.seq_len
    d = cfg.d_model
    out = {}
    if cell.step == "decode":
        if cfg.modality == "audio_frames":
            out["frames"] = ((B, 1, d), torch.float32)
        else:
            out["tokens"] = ((B, 1), torch.int32)
        return out

    if cfg.modality == "audio_frames":
        out["frames"] = ((B, S, d), torch.float32)
    elif cfg.modality == "vision_text":
        npt = cfg.n_vision_patches
        out["patches"] = ((B, npt, d), torch.float32)
        out["tokens"] = ((B, S - npt), torch.int32)
    else:
        out["tokens"] = ((B, S), torch.int32)

    if cell.step == "train":
        out["targets"] = ((B, S), torch.int32)
        out["loss_mask"] = ((B, S), torch.float32)
    return out


def concrete_inputs(cfg, cell: ShapeCell, seed: int = 0, device="cuda") -> dict:
    """A concrete batch of the cell's specs on ``device``: the reference's
    numbers, drawn from ``np.random.default_rng(seed)`` in the specs' order."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, (shape, dtype) in input_specs(cfg, cell).items():
        if dtype == torch.int32:
            hi = cfg.vocab_size if k in ("tokens", "targets") else 2
            arr = rng.integers(0, hi, size=shape, dtype=np.int32)
        else:
            arr = rng.standard_normal(shape).astype(np.float32) * 0.02
        out[k] = torch.from_numpy(arr).to(device)
    if "loss_mask" in out:
        out["loss_mask"] = torch.ones(out["loss_mask"].shape, dtype=torch.float32, device=device)
    return out
