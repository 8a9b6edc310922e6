"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

Port of ``repro.models.layers.rglru``:

Recurrent block:  out = W_out( GeLU(W_gate u) * RGLRU(conv1d(W_x u)) )
RG-LRU cell:      r_t = sigmoid(W_a xi_t);  i_t = sigmoid(W_i xi_t)
                  log a_t = -c * softplus(Lambda) * r_t          (c = 8)
                  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * xi_t)

The casts are the reference's: the projections and the conv run in the
activation's dtype, the gates and the recurrence in f32 (``wa``, ``wi`` and
``lam`` are f32 parameters), and ``h`` is cast back before the gate
product. ``jax.nn.gelu`` defaults to the tanh form, so the port uses
``approximate="tanh"``.

The linear recurrence runs as the reference's ``jax.lax.associative_scan``
does, in log depth: ``_scan`` takes ceil(log2 S) doubling steps of
(a, b) . (a', b') = (a a', a' b + b') in plain tensor operations (a few
launches a step, none a token). It is no Pallas kernel in the reference.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..common import TP, P, dense_init

__all__ = ["rglru_init", "rglru_spec", "rglru_apply", "rglru_decode", "RGLRUState", "init_rglru_state"]

_C = 8.0
_CONV_K = 4


class RGLRUState(NamedTuple):
    conv: torch.Tensor  # (B, K-1, w) the conv window
    h: torch.Tensor  # (B, w) f32 recurrent state
    pos: torch.Tensor  # () int32


def init_rglru_state(cfg, batch: int, dtype=torch.float32, device="cuda") -> RGLRUState:
    w = cfg.rnn_width
    return RGLRUState(
        conv=torch.zeros((batch, _CONV_K - 1, w), dtype=dtype, device=device),
        h=torch.zeros((batch, w), dtype=torch.float32, device=device),
        pos=torch.zeros((), dtype=torch.int32, device=device),
    )


def rglru_init(gen: torch.Generator, cfg, dtype, device) -> dict:
    d, w = cfg.d_model, cfg.rnn_width
    return {
        "wx": dense_init(gen, (d, w), dtype, device),
        "wgate": dense_init(gen, (d, w), dtype, device),
        "conv_w": dense_init(gen, (_CONV_K, w), dtype, device, scale=1.0),
        "conv_b": torch.zeros(w, dtype=dtype, device=device),
        # diagonal recurrence and input gates, as the reference's
        "wa": dense_init(gen, (w,), torch.float32, device, scale=1.0),
        "wi": dense_init(gen, (w,), torch.float32, device, scale=1.0),
        "lam": torch.linspace(0.9, 0.999, w, dtype=torch.float64, device=device).to(torch.float32),  # repro: noqa[RPR003] drawn in f64, then cast to f32
        "wout": dense_init(gen, (w, d), dtype, device, scale=1.0 / math.sqrt(2 * cfg.n_layers)),
    }


def rglru_spec(cfg, fsdp: bool) -> dict:
    """Partition specs of ``rglru_init``'s parameters (reference ``rglru.py:63``)."""
    dp = "data" if fsdp else None
    return {"wx": P(dp, TP), "wgate": P(dp, TP), "conv_w": P(None, TP), "conv_b": P(TP), "wa": P(TP), "wi": P(TP),
            "lam": P(TP), "wout": P(TP, dp)}


def _gates(params, xi: torch.Tensor):
    """a and beta * (i * xi), in f32, from the conv output xi."""
    xf = xi.float()
    r = torch.sigmoid(xf * params["wa"])
    i = torch.sigmoid(xf * params["wi"])
    log_a = -_C * F.softplus(params["lam"]) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    return a, beta * (i * xf)


def _conv(params, x: torch.Tensor, window):
    """Causal depthwise conv of width 4 over (B, S, w); ``window`` is the
    carried (B, 3, w) or None (zeros). Returns (out, the new window)."""
    K = _CONV_K
    pad = x.new_zeros((x.shape[0], K - 1, x.shape[2])) if window is None else window.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    w = params["conv_w"].to(x.dtype)
    S = x.shape[1]
    out = sum(xp[:, i:i + S] * w[i] for i in range(K))
    return out + params["conv_b"].to(x.dtype), xp[:, -(K - 1):].clone()  # a view would keep all of xp alive


def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along dim 1 from h_{-1} = 0, in ceil(log2 S)
    doubling steps: after the step of offset o, (a, b) at t combine the
    elements t - 2o + 1 .. t (Hillis-Steele). Where autograd records
    (training), the same products are joined with ``torch.cat`` in place
    of written into preallocated halves (``out=`` has no backward)."""
    S = a.shape[1]
    off = 1
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        while off < S:
            nb = torch.cat([b[:, :off], torch.addcmul(b[:, off:], a[:, off:], b[:, :-off])], dim=1)
            if 2 * off < S:
                a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
            b = nb
            off *= 2
        return b
    while off < S:
        nb = torch.empty_like(b)
        nb[:, :off] = b[:, :off]
        torch.addcmul(b[:, off:], a[:, off:], b[:, :-off], out=nb[:, off:])
        if 2 * off < S:  # the last step needs no products of a
            na = torch.empty_like(a)
            na[:, :off] = a[:, :off]
            torch.mul(a[:, off:], a[:, :-off], out=na[:, off:])
            a = na
        b = nb
        off *= 2
    return b


def rglru_apply(params, xin: torch.Tensor, cfg, state: RGLRUState | None = None):
    """Full-sequence recurrent block. Returns (out (B, S, d), new state or None)."""
    S = xin.shape[1]
    xb = xin @ params["wx"].to(xin.dtype)
    gate = F.gelu(xin @ params["wgate"].to(xin.dtype), approximate="tanh")
    xi, conv_win = _conv(params, xb, None if state is None else state.conv)

    a, b = _gates(params, xi)  # (B, S, w) f32
    if state is not None:  # fold the carried state into the first step
        b[:, 0] += a[:, 0] * state.h
    h = _scan(a, b)
    y = h.to(xin.dtype) * gate
    out = y @ params["wout"].to(xin.dtype)
    new_state = None
    if state is not None:
        new_state = RGLRUState(conv=conv_win, h=h[:, -1], pos=state.pos + S)
    return out, new_state


def rglru_decode(params, xin: torch.Tensor, cfg, state: RGLRUState):
    """One token. xin: (B, 1, d). Returns (out (B, 1, d), new state)."""
    x1 = xin[:, 0]
    xb = x1 @ params["wx"].to(xin.dtype)
    gate = F.gelu(x1 @ params["wgate"].to(xin.dtype), approximate="tanh")
    win = torch.cat([state.conv.to(xin.dtype), xb[:, None]], dim=1)
    w = params["conv_w"].to(xin.dtype)
    xi = (win * w[None]).sum(dim=1) + params["conv_b"].to(xin.dtype)
    a, b = _gates(params, xi[:, None, :])
    a, b = a[:, 0], b[:, 0]
    h = a * state.h + b
    y = h.to(xin.dtype) * gate
    out = (y @ params["wout"].to(xin.dtype))[:, None]
    return out, RGLRUState(conv=win[:, 1:], h=h, pos=state.pos + 1)
