"""Rotary position embeddings (RoPE, arXiv:2104.09864).

Port of ``repro.models.layers.rope.apply_rope``: angles in f32, the two
halves of the head dim rotated (not interleaved pairs), cast back.
"""
from __future__ import annotations

import torch

__all__ = ["apply_rope"]


def _rope_angles(positions: torch.Tensor, d_head: int, theta: float):
    """(..., S) int positions -> cos/sin tables (..., S, d_head/2)."""
    half = d_head // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=positions.device) / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0) -> torch.Tensor:
    """x: (B, S, H, D) -> rotated; positions: (B, S) or (S,)."""
    if positions.dim() == 1:
        positions = positions[None, :]
    cos, sin = _rope_angles(positions, x.shape[-1], theta)
    cos = cos[:, :, None, :]  # broadcast over heads
    sin = sin[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
