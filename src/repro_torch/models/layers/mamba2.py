"""Mamba-2 SSD layer (state-space duality, arXiv:2405.21060).

Port of ``repro.models.layers.mamba2``. The chunked SSD computes the
recurrence

    h_t = exp(dt_t A) h_{t-1} + dt_t (B_t ⊗ x_t)
    y_t = C_t . h_t + D x_t

in chunks of ``cfg.ssm.chunk`` tokens: within a chunk in its quadratic
("attention") dual form (``_ssd_intra``), across chunks by a linear scan of
the (H, N, P) state (``_ssd_states``, ``_ssd_scan``, ``_ssd_out``). The
scan is a Python loop over the chunks; everything is plain tensor
operations, as in the reference (no Pallas kernel there either).

The casts are the reference's: the projections and the conv run in the
activation's dtype, the SSD in f32, then the ``D`` skip, ``y * silu(z)``,
an RMSNorm with ``norm_scale`` and ``out_proj`` in the activation's dtype.
The einsums contract over each B/C group once where the reference repeats
B and C to every head: the products are the same, the decays are applied
to the other factor (``_ssd_states``, ``_ssd_out``), so the sums round in
another order.

Decode carries ``SSMState(conv, ssm, pos)``: O(1) a token. The reference's
``mamba2_apply`` with a state starts its scan from a zero SSM state and
drops ``state.ssm``, so a prompt continued from a carried state would be
wrong; the port raises there (``start != 0``) and equals the reference
where ``Model.prefill`` calls it, at ``start == 0``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..common import TP, P, dense_init
from .norms import apply_norm

__all__ = ["mamba2_init", "mamba2_spec", "mamba2_apply", "mamba2_decode", "SSMState", "init_ssm_state"]


class SSMState(NamedTuple):
    conv: torch.Tensor  # (B, d_conv - 1, conv_dim) the trailing conv window
    ssm: torch.Tensor  # (B, H, N, P) f32 running state
    pos: torch.Tensor  # () int32


def _dims(cfg):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    H = s.n_heads(cfg.d_model)
    conv_dim = di + 2 * s.ngroups * s.d_state
    return s, di, H, conv_dim


def init_ssm_state(cfg, batch: int, dtype=torch.float32, device="cuda") -> SSMState:
    s, _, H, conv_dim = _dims(cfg)
    return SSMState(
        conv=torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=dtype, device=device),
        ssm=torch.zeros((batch, H, s.d_state, s.head_dim), dtype=torch.float32, device=device),
        pos=torch.zeros((), dtype=torch.int32, device=device),
    )


def mamba2_init(gen: torch.Generator, cfg, dtype, device) -> dict:
    s, di, H, conv_dim = _dims(cfg)
    d = cfg.d_model
    proj_out = 2 * di + 2 * s.ngroups * s.d_state + H  # z, x, B, C, dt
    f64 = dict(dtype=torch.float64, device=device)
    return {
        "in_proj": dense_init(gen, (d, proj_out), dtype, device),
        "conv_w": dense_init(gen, (s.d_conv, conv_dim), dtype, device, scale=1.0),
        "conv_b": torch.zeros(conv_dim, dtype=dtype, device=device),
        # A_log, D and dt_bias are f32 whatever the param dtype, as the reference's
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f64)).to(torch.float32),
        "D": torch.ones(H, dtype=torch.float32, device=device),
        "dt_bias": torch.log(torch.expm1(torch.full((H,), 1e-2, **f64))).to(torch.float32),
        "norm_scale": torch.ones(di, dtype=dtype, device=device),
        "out_proj": dense_init(gen, (di, d), dtype, device, scale=1.0 / math.sqrt(2 * cfg.n_layers)),
    }


def mamba2_spec(cfg, fsdp: bool) -> dict:
    """Partition specs of ``mamba2_init``'s parameters (reference ``mamba2.py:70``)."""
    dp = "data" if fsdp else None
    return {"in_proj": P(dp, TP), "conv_w": P(None, TP), "conv_b": P(TP), "A_log": P(TP), "D": P(TP),
            "dt_bias": P(TP), "norm_scale": P(TP), "out_proj": P(TP, dp)}


def _split_proj(cfg, proj: torch.Tensor):
    """in_proj's output -> (z, xBC, dt)."""
    s, di, H, _ = _dims(cfg)
    return torch.split(proj, [di, di + 2 * s.ngroups * s.d_state, H], dim=-1)


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor, init_window=None):
    """Depthwise causal conv1d. xBC: (B, S, C); w: (K, C). The K shifted
    products are summed in the reference's order. Returns (silu(out + b),
    the last K - 1 inputs as the new window, in xBC's dtype)."""
    K, S = w.shape[0], xBC.shape[1]
    if init_window is None:
        pad = xBC.new_zeros((xBC.shape[0], K - 1, xBC.shape[2]))
    else:
        pad = init_window.to(xBC.dtype)
    xp = torch.cat([pad, xBC], dim=1)
    out = sum(xp[:, i:i + S] * w[i] for i in range(K))
    new_window = xp[:, xp.shape[1] - (K - 1):].clone()  # a view would keep all of xp alive in the state
    return F.silu(out + b), new_window


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = sum_{j<k<=i} a[..., k] for i >= j, -inf above the
    diagonal. The mask comes before any exp: exp of the unmasked upper
    triangle overflows to inf, and inf * 0 puts NaN in the backward."""
    T = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    mask = torch.ones((T, T), dtype=torch.bool, device=a.device).tril()
    return torch.where(mask, cs[..., :, None] - cs[..., None, :], -math.inf)


def _ssd_intra(a: torch.Tensor, Bc: torch.Tensor, Cc: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """Within each chunk, the quadratic dual: y[q] = sum_{k<=q} exp(A_q - A_k)
    (C_q . B_k) dx_k. a: (B, nc, Q, H) log-decays; Bc, Cc: (B, nc, Q, G, N);
    dx: (B, nc, Q, H, P). Returns (B, nc, Q, H, P)."""
    Bsz, nc, Q, H = a.shape
    G = Bc.shape[3]
    L = torch.exp(_segsum(a.transpose(-1, -2)))  # (B, nc, H, Q, Q)
    CB = torch.einsum("bcqgn,bckgn->bcgqk", Cc, Bc)  # one product a group
    scores = (L.view(Bsz, nc, G, H // G, Q, Q) * CB[:, :, :, None]).view(Bsz, nc, H, Q, Q)
    return torch.einsum("bchqk,bckhp->bcqhp", scores, dx)


def _ssd_states(Bc: torch.Tensor, cum_a: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """Each chunk's state at its end from its own tokens: sum_q
    exp(A_end - A_q) B_q ⊗ dx_q. cum_a: (B, nc, Q, H). Returns (B, nc, H, N, P)."""
    Bsz, nc, Q, H = cum_a.shape
    G, N, P = Bc.shape[3], Bc.shape[4], dx.shape[-1]
    decay = torch.exp(cum_a[:, :, -1:] - cum_a)
    xd = (dx * decay[..., None]).reshape(Bsz, nc, Q, G, (H // G) * P)
    st = torch.einsum("bcqgn,bcqgr->bcgnr", Bc, xd)
    return st.reshape(Bsz, nc, G, N, H // G, P).transpose(3, 4).reshape(Bsz, nc, H, N, P)


def _ssd_scan(states: torch.Tensor, total: torch.Tensor):
    """Across chunks from a zero state: h_{c+1} = h_c exp(total_c) + states_c.
    states: (B, nc, H, N, P); total: (B, nc, H) a chunk's summed log-decay.
    Returns (the state entering each chunk (B, nc, H, N, P), the last state)."""
    decay = torch.exp(total)[..., None, None]
    h = torch.zeros_like(states[:, 0])
    entering = []
    for c in range(states.shape[1]):
        entering.append(h)
        h = h * decay[:, c] + states[:, c]
    return torch.stack(entering, dim=1), h


def _ssd_out(Cc: torch.Tensor, cum_a: torch.Tensor, h_in: torch.Tensor) -> torch.Tensor:
    """Each token's read of the state entering its chunk, exp(A_q) C_q . h.
    Returns (B, nc, Q, H, P)."""
    Bsz, nc, Q, H = cum_a.shape
    G, N, P = Cc.shape[3], Cc.shape[4], h_in.shape[-1]
    hg = h_in.view(Bsz, nc, G, H // G, N, P).transpose(3, 4).reshape(Bsz, nc, G, N, (H // G) * P)
    y = torch.einsum("bcqgn,bcgnr->bcqgr", Cc, hg).reshape(Bsz, nc, Q, H, P)
    return y * torch.exp(cum_a)[..., None]


def _ssd_chunked(x, dt, A, Bm, Cm, chunk: int):
    """SSD scan. x: (B, S, H, P); dt: (B, S, H); A: (H,) (A_log); Bm, Cm:
    (B, S, G, N). Pads S to whole chunks. Returns (y (B, S, H, P), the
    final state (B, H, N, P))."""
    Bsz, S, H, Pd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    if pad:
        x, Bm, Cm = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, Bm, Cm))
        dt = F.pad(dt, (0, 0, 0, pad))
    xc = x.reshape(Bsz, nc, Q, H, Pd)
    dtc = dt.reshape(Bsz, nc, Q, H)
    Bc = Bm.reshape(Bsz, nc, Q, G, N)
    Cc = Cm.reshape(Bsz, nc, Q, G, N)
    a = -torch.exp(A) * dtc  # log-decay a step (B, nc, Q, H)
    dx = xc * dtc[..., None]

    y_diag = _ssd_intra(a, Bc, Cc, dx)
    cum_a = torch.cumsum(a, dim=2)
    h_in, h_last = _ssd_scan(_ssd_states(Bc, cum_a, dx), cum_a[:, :, -1])
    y = (y_diag + _ssd_out(Cc, cum_a, h_in)).reshape(Bsz, nc * Q, H, Pd)
    return y[:, :S], h_last


def _ssd_step(h, xs, dtv, A, Bm, Cm):
    """One token of the recurrence: h' = h exp(-exp(A) dt) + B ⊗ (x dt),
    y = C . h'. h: (B, H, N, P) f32; xs: (B, H, P); dtv: (B, H); Bm, Cm:
    (B, H, N). Returns (y (B, H, P), h')."""
    decay = torch.exp(-torch.exp(A) * dtv)
    upd = torch.einsum("bhn,bhp->bhnp", Bm, xs * dtv[..., None])
    h = h * decay[..., None, None] + upd
    return torch.einsum("bhn,bhnp->bhp", Cm, h), h


def mamba2_apply(params, xin: torch.Tensor, cfg, state: SSMState | None = None, start: int | None = None):
    """Full-sequence SSD. Returns (out (B, S, d), the new SSMState or None).
    With a state, ``start`` is the host position of xin's first token and
    must be 0: the scan starts from a zero SSM state (the reference's, which
    drops ``state.ssm``); a sequence continues through ``mamba2_decode``."""
    s, di, H, _ = _dims(cfg)
    Bsz, S, _ = xin.shape
    if state is not None and start != 0:
        raise ValueError(f"mamba2_apply with a state runs a prompt from position 0 (its scan starts from a zero "
                         f"SSM state), not from {start}; continue a sequence with mamba2_decode")
    dtype = xin.dtype
    proj = xin @ params["in_proj"].to(dtype)
    z, xBC, dt = _split_proj(cfg, proj)
    xBC, conv_win = _causal_conv(xBC, params["conv_w"].to(dtype), params["conv_b"].to(dtype),
                                 None if state is None else state.conv)
    gN = s.ngroups * s.d_state
    xs, Bm, Cm = torch.split(xBC, [di, gN, gN], dim=-1)
    xs = xs.reshape(Bsz, S, H, s.head_dim)
    Bm = Bm.reshape(Bsz, S, s.ngroups, s.d_state)
    Cm = Cm.reshape(Bsz, S, s.ngroups, s.d_state)
    dtv = F.softplus(dt.float() + params["dt_bias"])

    xf = xs.float()
    y, h_last = _ssd_chunked(xf, dtv, params["A_log"], Bm.float(), Cm.float(), s.chunk)
    y = y + xf * params["D"][:, None]
    y = y.reshape(Bsz, S, di).to(dtype) * F.silu(z)
    y = apply_norm({"scale": params["norm_scale"]}, y, "rmsnorm", cfg.norm_eps)
    out = y @ params["out_proj"].to(dtype)
    new_state = None
    if state is not None:
        new_state = SSMState(conv=conv_win, ssm=h_last, pos=state.pos + S)
    return out, new_state


def mamba2_decode(params, xin: torch.Tensor, cfg, state: SSMState):
    """One token. xin: (B, 1, d). Returns (out (B, 1, d), the new state)."""
    s, di, H, _ = _dims(cfg)
    Bsz, dtype = xin.shape[0], xin.dtype
    proj = xin[:, 0] @ params["in_proj"].to(dtype)
    z, xBC, dt = _split_proj(cfg, proj)
    win = torch.cat([state.conv.to(dtype), xBC[:, None]], dim=1)  # (B, K, C)
    conv_out = F.silu((win * params["conv_w"].to(dtype)).sum(dim=1) + params["conv_b"].to(dtype))
    gN, rep = s.ngroups * s.d_state, H // s.ngroups
    xs, Bm, Cm = torch.split(conv_out, [di, gN, gN], dim=-1)
    xs = xs.reshape(Bsz, H, s.head_dim).float()
    Bm = Bm.reshape(Bsz, s.ngroups, s.d_state).repeat_interleave(rep, dim=1).float()
    Cm = Cm.reshape(Bsz, s.ngroups, s.d_state).repeat_interleave(rep, dim=1).float()
    dtv = F.softplus(dt.float() + params["dt_bias"])  # (B, H)
    y, h = _ssd_step(state.ssm, xs, dtv, params["A_log"], Bm, Cm)
    y = y + xs * params["D"][:, None]
    y = y.reshape(Bsz, di).to(dtype) * F.silu(z)
    y = apply_norm({"scale": params["norm_scale"]}, y, "rmsnorm", cfg.norm_eps)
    out = (y @ params["out_proj"].to(dtype))[:, None]
    return out, SSMState(conv=win[:, 1:], ssm=h, pos=state.pos + 1)
