"""Streaming softmax attention (causal / sliding-window / bidirectional, GQA).

Port of ``repro.kernels.flash_attention``: same signature and model layout,
``q`` (B, S, Hq, dh) and ``k``/``v`` (B, S, Hkv, dh). CUDA tensors launch
the hand-written kernel of ``csrc/flash_attention.cu``, which reads that
layout with strides (query head h reads kv head h // (Hq // Hkv)), so
nothing is transposed, repeated or padded. CPU tensors take the plain
version in ``ref.py``.

``positions`` is accepted and not read, as in the reference: key and query
positions are their indices 0..S-1. ``block_q``/``block_k`` were the TPU's
VMEM tiling; the CUDA kernel picks its own tiles and ignores them.
"""
import ctypes

import torch

from .. import loader
from .ref import flash_attention_plain

HEAD_DIMS = (16, 32, 64, 80, 128)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be (B, S, H, dh), got shape {tuple(t.shape)}")
        # rows are read as 16-byte cp.async copies (f32) or through TMA tensor maps (bf16)
        if t.stride(3) != 1 or t.data_ptr() % 16 or any(s * t.element_size() % 16 for s in t.stride()[:3]):
            raise ValueError(f"flash_attention: {name} needs a contiguous head dim and 16-byte aligned rows, "
                             f"got strides {t.stride()}")
    B, S, Hq, dh = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, S) or k.shape[3] != dh:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if Hq % k.shape[2]:
        raise ValueError(f"flash_attention: {Hq} query heads are not a multiple of {k.shape[2]} kv heads")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {dh} not built; supported: {HEAD_DIMS}")
    if S == 0:
        raise ValueError("flash_attention: needs S > 0")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be None or >= 1, got {window}")


def flash_attention(q, k, v, positions=None, *, causal=True, window=None, block_q=512, block_k=512):
    """q: (B,S,Hq,dh), k/v: (B,S,Hkv,dh) -> (B,S,Hq,dh) in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    _check(q, k, v, window)
    B, S, Hq, dh = q.shape
    o = torch.empty((B, S, Hq, dh), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        rc = loader.kernel_fn("rt_flash_attention", q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, Hq, k.shape[2], dh,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            int(causal), 0 if window is None else int(window), loader.stream_handle(q),
        )
    loader.check_status(rc, "flash_attention")
    loader.LAUNCHES["flash_attention"] += 1
    return o


_CONFIG_KEYS = ("swizzle_bytes", "box_cols", "boxes", "stages", "block_q", "block_k", "smem_bytes", "threads")


def bf16_config(dh: int) -> dict:
    """The tile choices of the bf16 kernel at head dim ``dh``, as the built
    library reports them (builds it on first use)."""
    out = (ctypes.c_int * len(_CONFIG_KEYS))()
    loader.check_status(loader.load().rt_flash_bf16_config(dh, out), "flash_attention config")
    return dict(zip(_CONFIG_KEYS, out))
