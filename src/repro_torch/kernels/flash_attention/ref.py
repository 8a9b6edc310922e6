"""Plain PyTorch version of the flash-attention kernel.

``flash_attention_ref`` takes the folded-head layout of the reference's
oracle (``repro/kernels/flash_attention/ref.py``): scores in f32, the
finite -1e30 mask, softmax weights cast to v's dtype before the PV product.
``flash_attention_plain`` is the same function in the model layout, with
the GQA fold of the reference's wrapper (each kv head repeated for its
group of query heads).
"""
import math

import torch

_MASKED = -1e30


def flash_attention_ref(q, k, v, *, causal=True, window=None):
    """q: (BH, Sq, d); k/v: (BH, Sk, d) -> (BH, Sq, d) in q's dtype."""
    Sq, d = q.shape[1], q.shape[2]
    Sk = k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float())
    s.div_(math.sqrt(d))
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= kp > qp - window
    s.masked_fill_(~ok, _MASKED)
    w = torch.softmax(s, dim=-1).to(v.dtype)
    del s
    return torch.einsum("bqk,bkd->bqd", w, v).to(q.dtype)


def flash_attention_plain(q, k, v, *, causal=True, window=None):
    """q: (B, S, Hq, dh), k/v: (B, S, Hkv, dh) -> (B, S, Hq, dh)."""
    B, S, Hq, dh = q.shape
    g = Hq // k.shape[2]
    qf = q.transpose(1, 2).reshape(B * Hq, S, dh)
    kf = k.transpose(1, 2).repeat_interleave(g, dim=1).reshape(B * Hq, S, dh)
    vf = v.transpose(1, 2).repeat_interleave(g, dim=1).reshape(B * Hq, S, dh)
    out = flash_attention_ref(qf, kf, vf, causal=causal, window=window)
    return out.reshape(B, Hq, S, dh).transpose(1, 2)
