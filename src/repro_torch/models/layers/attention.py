"""GQA attention: the full-sequence forward (dense | chunked | pallas), and
prefill and decode over a KV cache.

Port of ``repro.models.layers.attention``. Covers the
attention variants of the pool: GQA, MQA and MHA, QKV bias (qwen1.5),
RoPE, bidirectional (hubert) and sliding-window masks (mixtral-8x22b's 48
query heads over 8 kv heads of d 128 in a 4,096-key window, ahead of its MoE
layer; the MQA local attention of recurrentgemma, 16 query heads over one kv
head of d 256 in a 2,048-key window).

Implementations, chosen by ``impl`` (default ``cfg.attn_impl``) as in the
reference:
  * ``dense``   - materializes the scores; also taken whenever S <= attn_chunk.
  * ``chunked`` - running-LSE streaming over kv chunks in PyTorch, the twin
    of the flash kernel.
  * ``pallas``  - the flash-attention kernel (``repro_torch.kernels``): on
    the card the hand-written CUDA kernel, on the CPU its plain version.

The KV cache (``KVCache``, ``init_kv_cache``) holds K (RoPE applied) and V
a slot a position, and each slot's absolute position (-1: empty). With a
sliding window it is a ring of ``min(max_len, window)`` slots, position p
in slot p mod W; without one, position p sits in slot p. A write past
``max_len`` raises ``ValueError`` where the cache holds fewer slots than
the keys a query sees (no window, or a ring shorter than the window): the
reference drops such a write, or wraps and evicts keys still inside the
window, silently. A write of S > W positions into a whole window's ring
keeps the last W, the reference's result (its scatter's last write wins)
without duplicate indices. The slots and the positions come from the host
position ``start`` of the first token, so a write is at most two slice
copies and reads nothing from the device. A cached step is functional, as
the reference's: it returns a new cache and leaves the given one as it
was.

With a cache, a prompt (S > 1, from position 0) attends over its own K and
V by the cache-free path's rule (the flash kernel for ``pallas``); a decode
step (S == 1) attends over the whole cache with ``_sdpa_dense`` (plain
tensor ops, as the reference computes it outside any Pallas kernel).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ...kernels.flash_attention import flash_attention
from ..common import TP, P, dense_init
from .rope import apply_rope

__all__ = ["attention_init", "attention_spec", "attention_apply", "KVCache", "init_kv_cache"]

_NEG_INF = -1e30


class KVCache(NamedTuple):
    """One layer's KV cache; a ring of slots for a sliding window."""

    k: torch.Tensor  # (B, S_cache, Hkv, dh), RoPE applied
    v: torch.Tensor  # (B, S_cache, Hkv, dh)
    slot_pos: torch.Tensor  # (S_cache,) int32 absolute position of each slot, -1 = empty


def init_kv_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device="cuda") -> KVCache:
    """An empty cache of ``max_len`` slots, ``min(max_len, window)`` for a sliding window."""
    if cfg.sliding_window is not None:
        max_len = min(max_len, cfg.sliding_window)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device), v=torch.zeros(shape, dtype=dtype, device=device),
                   slot_pos=torch.full((max_len,), -1, dtype=torch.int32, device=device))


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


def attention_spec(cfg, fsdp: bool) -> dict:
    """Partition specs of ``attention_init``'s parameters (reference
    ``attention.py:76``); fsdp also shards the non-TP dim over data."""
    dp = "data" if fsdp else None
    s = {"wq": P(dp, TP), "wk": P(dp, TP), "wv": P(dp, TP), "wo": P(TP, dp)}
    if cfg.qkv_bias:
        s.update({"bq": P(TP), "bk": P(TP), "bv": P(TP)})
    return s


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


def _cache_write(cache: KVCache, k, v, start: int, window) -> KVCache:
    """A new cache with x's K and V (positions start .. start + S - 1)
    written into their slots; only the last W positions of a longer write."""
    W, S = cache.k.shape[1], k.shape[1]
    if start + S > W and (window is None or W < window):
        raise ValueError(f"KV cache overflow: positions up to {start + S - 1} do not fit a cache of {W} slots "
                         f"({'without a sliding window' if window is None else f'below the window of {window}'})")
    n = min(S, W)
    first = start + S - n
    k, v = k[:, S - n:].to(cache.k.dtype), v[:, S - n:].to(cache.v.dtype)
    pos = torch.arange(first, first + n, dtype=torch.int32, device=cache.slot_pos.device)
    ck, cv, sp = cache.k.clone(), cache.v.clone(), cache.slot_pos.clone()
    s0 = first % W  # = first without a window (first + n <= W)
    a = min(n, W - s0)  # the slots up to the ring's end, then the rest from slot 0
    for dst, src in ((ck, k), (cv, v)):
        dst[:, s0:s0 + a] = src[:, :a]
        dst[:, :n - a] = src[:, a:]
    sp[s0:s0 + a] = pos[:a]
    sp[:n - a] = pos[a:]
    return KVCache(k=ck, v=cv, slot_pos=sp)


def _attend(q, k, v, positions, cfg, impl):
    """Attention of q over k and v of the same S tokens (cache-free, or a prompt)."""
    S = q.shape[1]
    k_pos = positions[0]
    if impl == "dense" or S <= cfg.attn_chunk:
        return _sdpa_dense(q, k, v, positions, k_pos, causal=cfg.causal, window=cfg.sliding_window)
    if impl == "pallas":
        return flash_attention(q, k, v, positions[0], causal=cfg.causal, window=cfg.sliding_window,
                               block_q=min(cfg.attn_chunk, S), block_k=min(cfg.attn_chunk, S))
    if impl == "chunked":
        return _sdpa_chunked(q, k, v, positions[0], k_pos, causal=cfg.causal, window=cfg.sliding_window,
                             q_block=cfg.attn_chunk, kv_block=cfg.attn_chunk)
    raise ValueError(f"unknown attention impl {impl!r}; expected 'dense', 'chunked' or 'pallas'")


def attention_apply(params, x, cfg, *, positions=None, cache: KVCache | None = None, start: int | None = None,
                    impl=None):
    """Returns (out (B,S,d), new_cache).

    cache=None: the full-sequence forward over ``positions``, (S,) or
    (B,S); the new cache is None.
    cache=KVCache: x's tokens sit at positions start .. start + S - 1,
    ``start`` a host int (and ``positions`` not given); writes their K and V
    into the cache and returns the new cache. S == 1 is a decode step over
    the whole cache; S > 1 is a prompt, from position 0, attending over
    itself.
    """
    B, S, _ = x.shape
    if cache is not None:
        if start is None or positions is not None:
            raise ValueError("attention_apply with a cache takes start, the host position of x's first token, "
                             "and no positions")
        positions = torch.arange(start, start + S, dtype=torch.int32, device=x.device)
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

    new_cache = None
    if cache is None:
        out = _attend(q, k, v, positions, cfg, impl)
    else:
        if S > 1 and start != 0:
            raise ValueError(f"a prompt of {S} tokens attends over itself only, so it starts at position 0, "
                             f"not {start}")
        new_cache = _cache_write(cache, k, v, start, cfg.sliding_window)
        if S > 1:
            out = _attend(q, k, v, positions, cfg, impl)
        else:
            out = _sdpa_dense(q, new_cache.k.to(q.dtype), new_cache.v.to(q.dtype), positions, new_cache.slot_pos,
                              causal=cfg.causal, window=cfg.sliding_window)
    out = out.reshape(B, S, cfg.q_dim) @ params["wo"].to(x.dtype)
    return out, new_cache
