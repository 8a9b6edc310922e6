"""GQA attention for the full-sequence forward (dense | chunked | pallas).

Port of ``repro.models.layers.attention`` without the KV cache. Covers the
attention variants of the pool: GQA, MQA and MHA, QKV bias (qwen1.5),
RoPE, bidirectional (hubert) and sliding-window (mixtral) masks.

Implementations, chosen by ``impl`` (default ``cfg.attn_impl``) as in the
reference:
  * ``dense``   - materializes the scores; also taken whenever S <= attn_chunk.
  * ``chunked`` - running-LSE streaming over kv chunks in PyTorch, the twin
    of the flash kernel.
  * ``pallas``  - the flash-attention kernel (``repro_torch.kernels``): on
    the card the hand-written CUDA kernel, on the CPU its plain version.

Decode and prefill through a cache wait for the serving slice (ROADMAP
queue 1 item 15): ``attention_apply`` raises for a cache.
"""
from __future__ import annotations

import math

import torch

from ...kernels.flash_attention import flash_attention
from ..common import dense_init
from .rope import apply_rope

__all__ = ["attention_init", "attention_apply"]

_NEG_INF = -1e30


def attention_init(gen: torch.Generator, cfg, dtype, device) -> dict:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    p = {
        "wq": dense_init(gen, (d, qd), dtype, device),
        "wk": dense_init(gen, (d, kvd), dtype, device),
        "wv": dense_init(gen, (d, kvd), dtype, device),
        "wo": dense_init(gen, (qd, d), dtype, device, scale=1.0 / math.sqrt(2 * cfg.n_layers)),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(qd, dtype=dtype, device=device)
        p["bk"] = torch.zeros(kvd, dtype=dtype, device=device)
        p["bv"] = torch.zeros(kvd, dtype=dtype, device=device)
    return p


def _mask_bias(q_pos, k_pos, *, causal, window, dtype):
    """(..., Sq, Sk) additive mask from absolute positions."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    ok = kp >= 0  # valid slot
    if causal:
        ok = ok & (kp <= qp)
    if window is not None:
        ok = ok & (kp > qp - window)
    zero = torch.zeros((), dtype=dtype, device=ok.device)
    return torch.where(ok, zero, torch.full((), _NEG_INF, dtype=dtype, device=ok.device))


def _sdpa_dense(q, k, v, q_pos, k_pos, *, causal, window):
    """q: (B,Sq,Hq,dh); k/v: (B,Sk,Hkv,dh) -> (B,Sq,Hq,dh). f32 softmax."""
    B, Sq, Hq, dh = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float()
    scores = scores * (1.0 / math.sqrt(dh))
    mask = _mask_bias(q_pos, k_pos, causal=causal, window=window, dtype=torch.float32)
    if mask.dim() == 3:  # (B, Sq, Sk) -> broadcast over (Hkv, g)
        mask = mask[:, None, None, :, :]
    w = torch.softmax(scores + mask, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w.to(v.dtype), v)
    return out.reshape(B, Sq, Hq, dh)


def _sdpa_chunked(q, k, v, q_pos, k_pos, *, causal, window, q_block, kv_block):
    """Streaming attention (running max / sum / accumulator) over kv chunks,
    q blocks in an outer loop; the per-step footprint is (B, qb, Hq, cb)."""
    B, Sq, Hq, dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qb, cb = min(q_block, Sq), min(kv_block, Sk)
    n_qb, n_kb = -(-Sq // qb), -(-Sk // cb)
    pad = torch.nn.functional.pad
    q = pad(q, (0, 0, 0, 0, 0, n_qb * qb - Sq))
    qp = pad(q_pos, (0, n_qb * qb - Sq), value=2**30)
    k = pad(k, (0, 0, 0, 0, 0, n_kb * cb - Sk))
    v = pad(v, (0, 0, 0, 0, 0, n_kb * cb - Sk))
    kp = pad(k_pos, (0, n_kb * cb - Sk), value=-1)
    scale = 1.0 / math.sqrt(dh)

    outs = []
    for i in range(n_qb):
        qg = q[:, i * qb:(i + 1) * qb].reshape(B, qb, Hkv, g, dh)
        qpi = qp[i * qb:(i + 1) * qb]
        m = torch.full((B, Hkv, g, qb), _NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, Hkv, g, qb), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, Hkv, g, qb, dh), dtype=torch.float32, device=q.device)
        for j in range(n_kb):
            kj, vj = k[:, j * cb:(j + 1) * cb], v[:, j * cb:(j + 1) * cb]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kj).float() * scale
            s = s + _mask_bias(qpi, kp[j * cb:(j + 1) * cb], causal=causal, window=window, dtype=torch.float32)
            m2 = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m2[..., None])
            corr = torch.exp(m - m2)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p.to(vj.dtype), vj).float()
            m = m2
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, qb, Hq, dh))
    return torch.cat(outs, dim=1)[:, :Sq].to(q.dtype)


def attention_apply(params, x, cfg, *, positions, cache=None, impl=None):
    """Returns (out (B,S,d), new_cache); ``positions``: (S,) or (B,S).

    Only the cache-free full-sequence path is ported; the cache stays None.
    """
    if cache is not None:
        raise NotImplementedError("attention with a KV cache (decode, prefill) is not ported yet: "
                                  "ROADMAP queue 1 item 15")
    B, S, _ = x.shape
    impl = impl or cfg.attn_impl

    def mm(w):
        return x @ w.to(x.dtype)

    q, k, v = mm(params["wq"]), mm(params["wk"]), mm(params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    q = q.reshape(B, S, cfg.n_heads, cfg.d_head)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.d_head)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.d_head)

    if positions.dim() == 1:
        positions = positions[None, :].expand(B, S)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    k_pos = positions[0]
    if impl == "dense" or S <= cfg.attn_chunk:
        out = _sdpa_dense(q, k, v, positions, k_pos, causal=cfg.causal, window=cfg.sliding_window)
    elif impl == "pallas":
        out = flash_attention(q, k, v, positions[0], causal=cfg.causal, window=cfg.sliding_window,
                              block_q=min(cfg.attn_chunk, S), block_k=min(cfg.attn_chunk, S))
    elif impl == "chunked":
        out = _sdpa_chunked(q, k, v, positions[0], k_pos, causal=cfg.causal, window=cfg.sliding_window,
                            q_block=cfg.attn_chunk, kv_block=cfg.attn_chunk)
    else:
        raise ValueError(f"unknown attention impl {impl!r}; expected 'dense', 'chunked' or 'pallas'")
    out = out.reshape(B, S, cfg.q_dim) @ params["wo"].to(x.dtype)
    return out, None
