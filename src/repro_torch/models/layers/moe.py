"""Mixture-of-Experts layer (dbrx 16e/top-4, mixtral 8e/top-2).

Port of ``repro.models.layers.moe``. Dispatch is sort-based and
capacity-bounded, as in the reference: each token's k choices are ranked
within their expert, and a choice ranked past the capacity is dropped.

Routers:
  * ``topk`` - softmax top-k with capacity dropping.
  * ``mwu``  - the paper's technique inside the model: the token->expert
    assignment is the mixed packing/covering LP

        max <affinity, x>   s.t.  sum_t x[t,e] <= capacity     (packing)
                                  sum_e x[t,e] >= top_k        (covering)
                                  0 <= x[t,e] <= 1             (packing)

    over the implicit row- and column-sum operators below, solved by
    ``repro_torch.core.solve_lanes`` (Algorithm 2, Newton search) at a
    fixed budget of ``mwu_iters`` iterations: the graph LPs' solver, with
    its kernels on the card (softmax weights, the step direction in its
    ``g`` form, the Newton search, the axpy), inside the forward. The
    reference maps the router over ``cfg.moe_dispatch_groups`` token
    groups with ``jax.vmap``; here each group is one lane of one
    ``solve_lanes`` call, and each lane equals its own ``solve`` bit for
    bit. The fractional plan is rounded per token to the top k.

Ties: ``jax.lax.top_k`` and ``jnp.argsort`` put the lower index first, so
the port sorts stably (descending for the top k) where ``torch.topk``
promises no order. The combine sums each token's k rows in a fixed order
(no ``index_add_``, whose atomics would make a bf16 forward differ from
run to run). Sort, rank, scatter and the expert products (batched
matmuls) are plain tensor ops, as the reference leaves them to XLA.

Training: the gradient reaches the router weights through the gates (the
softmax probs at the chosen experts), with either router; the routing
itself is an integer plan, and the MWU LP takes the probs detached (its
kernels run outside autograd; ``routing_ops`` refuses probs that require
grad).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ...core import MWUOptions, OnesRow, VStack, solve_lanes
from ...core.operators import LinOp
from ..common import TP, P, dense_init

__all__ = ["ExpertCapRows", "TokenSumRows", "BoxRows", "moe_init", "moe_spec", "moe_apply", "dispatch_shape", "topk_route",
           "mwu_route", "routing_ops", "router_options", "routing_lp", "round_plan", "expert_load"]


# ----------------------------------------------------------------------
# Implicit operators for the routing LP (T tokens x E experts variables)
# ----------------------------------------------------------------------


@dataclass
class ExpertCapRows(LinOp):
    """Packing rows: (sum_t x[t,e]) / cap_e <= 1. Shape (E, T*E)."""

    inv_cap: torch.Tensor  # (E,)
    T: int = 0

    @property
    def shape(self):
        E = int(self.inv_cap.shape[0])
        return (E, self.T * E)

    def matvec(self, x):
        return x.reshape(self.T, -1).sum(dim=0) * self.inv_cap

    def rmatvec(self, w):
        return (w * self.inv_cap)[None, :].expand(self.T, -1).reshape(-1)

    def colmax(self, row_scale=None):
        s = self.inv_cap if row_scale is None else self.inv_cap * row_scale
        return s[None, :].expand(self.T, -1).reshape(-1)

    @property
    def nnz(self):
        return self.T * int(self.inv_cap.shape[0])


@dataclass
class TokenSumRows(LinOp):
    """Covering rows: (sum_e x[t,e]) / k >= 1. Shape (T, T*E)."""

    inv_k: torch.Tensor  # 0-d
    T: int = 0
    E: int = 0

    @property
    def shape(self):
        return (self.T, self.T * self.E)

    def matvec(self, x):
        return x.reshape(self.T, self.E).sum(dim=1) * self.inv_k

    def rmatvec(self, w):
        return (w * self.inv_k)[:, None].expand(-1, self.E).reshape(-1)

    def colmax(self, row_scale=None):
        if row_scale is None:
            return self.inv_k.expand(self.T * self.E)
        return self.rmatvec(row_scale)

    @property
    def nnz(self):
        return self.T * self.E


@dataclass
class BoxRows(LinOp):
    """Packing rows x[t,e] <= 1 (identity)."""

    n: int = 0
    device: Any = "cpu"  # where colmax() builds its ones (the op holds no other tensor)

    @property
    def shape(self):
        return (self.n, self.n)

    def matvec(self, x):
        return x

    def rmatvec(self, y):
        return y

    def colmax(self, row_scale=None):
        if row_scale is None:
            return torch.ones(self.n, dtype=torch.float32, device=self.device)
        return row_scale

    @property
    def nnz(self):
        return self.n


# ----------------------------------------------------------------------
# Routers
# ----------------------------------------------------------------------


def _top(v: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of v's last axis, the lower
    index first on ties (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(v, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gates(gate: torch.Tensor, dtype) -> torch.Tensor:
    return (gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)).to(dtype)


def topk_route(logits: torch.Tensor, k: int):
    """(..., E) logits -> (expert_idx (..., k), gate (..., k)) softmax-renormalized."""
    probs = torch.softmax(logits.float(), dim=-1)
    gate, idx = _top(probs, k)
    return idx, _gates(gate, logits.dtype)


def routing_ops(probs: torch.Tensor, k: int, capacity: int) -> tuple[LinOp, LinOp]:
    """(P, C) of one token group's routing LP: probs (T, E), the router's
    softmax; every constant in probs' dtype (f32 in the forward, as the
    reference builds it: ``BoxRows.colmax`` is f32, so the loop runs in f32).
    probs must not require grad: the MWU kernels are launches outside
    autograd, and the reference's LP sees ``stop_gradient(probs)``."""
    if probs.requires_grad:
        raise ValueError("routing_ops: the routing LP takes detached affinities (probs.detach()); the MWU kernels "
                         "would cut the autograd graph silently")
    T, E = probs.shape
    affin = probs.reshape(-1)  # objective weights
    P = VStack(ops=(ExpertCapRows(inv_cap=torch.full((E,), 1.0 / capacity, dtype=probs.dtype, device=probs.device),
                                  T=T),
                    BoxRows(n=T * E, device=probs.device)))
    # objective embedding: <affin, x> >= half the total affinity mass
    # (a conservative reachable bound)
    C = VStack(ops=(TokenSumRows(inv_k=torch.tensor(1.0 / k, dtype=probs.dtype, device=probs.device), T=T, E=E),
                    OnesRow(c=affin, inv_bound=1.0 / torch.clamp(affin.sum() * 0.5, min=1e-6))))
    return P, C


def router_options(mwu_iters: int) -> MWUOptions:
    """The router's solver options (reference ``moe.py:170-173``)."""
    return MWUOptions(eps=0.25, step_rule="newton", max_iter=mwu_iters, check_packing=False)


def routing_lp(logits: torch.Tensor, k: int, capacity: int, mwu_iters: int = 16):
    """The routing LP of each token group, solved at a fixed budget.

    logits: (G, T, E). Returns (probs (G, T, E) f32, differentiable where
    the logits are, the ``MWUResult`` of one ``solve_lanes`` call with one
    lane a group: ``x`` (G, T*E), outside autograd). The LP sees the probs
    detached (reference ``moe.py:156``).
    """
    probs = torch.softmax(logits.float(), dim=-1)
    affin = probs.detach()
    lanes = [(*routing_ops(p, k, capacity), None, None) for p in affin]
    with torch.no_grad():
        return probs, solve_lanes(lanes, router_options(mwu_iters))


def round_plan(x: torch.Tensor, probs: torch.Tensor, k: int, dtype):
    """Per-token top k of the fractional plan x (..., T, E), ties broken by
    affinity; gates from the router probs at the chosen experts (the
    gradient flows through the gates only, reference ``moe.py:172-177``)."""
    _, idx = _top(x + 1e-6 * probs.detach(), k)
    gate = torch.gather(probs, -1, idx)
    return idx, _gates(gate, dtype)


def mwu_route(logits: torch.Tensor, k: int, capacity: int, mwu_iters: int = 16):
    """MWU-LP router: (T, E) or (G, T, E) logits -> (expert_idx (..., T, k),
    gate (..., T, k)). Solves each group's capacity-constrained assignment LP
    (one lane a group) for a fixed iteration budget, then rounds per token
    to the top k of the fractional assignment."""
    grouped = logits.dim() == 3
    lg = logits if grouped else logits[None]
    probs, res = routing_lp(lg, k, capacity, mwu_iters)
    idx, gate = round_plan(res.x.reshape(probs.shape), probs, k, logits.dtype)
    return (idx, gate) if grouped else (idx[0], gate[0])


def expert_load(idx: torch.Tensor, E: int) -> torch.Tensor:
    """Tokens assigned per expert: load-balance diagnostic."""
    return torch.bincount(idx.reshape(-1), minlength=E)


# ----------------------------------------------------------------------
# MoE layer
# ----------------------------------------------------------------------


def moe_init(gen: torch.Generator, cfg, dtype, device) -> dict:
    d, m = cfg.d_model, cfg.moe
    return {
        "router": dense_init(gen, (d, m.n_experts), dtype, device),
        "wg": dense_init(gen, (m.n_experts, d, m.d_ff), dtype, device),
        "wu": dense_init(gen, (m.n_experts, d, m.d_ff), dtype, device),
        "wd": dense_init(gen, (m.n_experts, m.d_ff, d), dtype, device),
    }


def moe_spec(cfg, fsdp: bool) -> dict:
    """Partition specs of ``moe_init``'s parameters (reference ``moe.py:201``),
    by ``cfg.moe.ep_axis``: "data" puts the experts over data and their
    hidden dim over model (expert-parallel serving of dbrx's 16 experts);
    "matrix" shards each expert's matrices 2-D over (data, model) (mixtral:
    8 experts divide neither 16-way axis); otherwise the expert hidden dim
    over model and, with fsdp, the experts over data."""
    dp = "data" if fsdp else None
    ep = cfg.moe.ep_axis
    if ep == "data":
        e_spec, d_spec = P("data", None, TP), P("data", TP, None)
    elif ep == "matrix":
        e_spec, d_spec = P(None, "data", TP), P(None, TP, "data")
    else:
        e_spec, d_spec = P(dp, None, TP), P(dp, TP, None)
    return {"router": P(None, None), "wg": e_spec, "wu": e_spec, "wd": d_spec}


def dispatch_shape(cfg, T: int) -> tuple[int, int]:
    """(groups G, capacity a group's expert) for T tokens: the reference's
    rule (``moe.py:269-275``), G halved until it divides T."""
    m = cfg.moe
    G = max(1, cfg.moe_dispatch_groups)
    while T % G != 0:  # degenerate smoke shapes
        G //= 2
    cap = int(np.ceil(T // G * m.top_k * m.capacity_factor / m.n_experts))
    return G, max(8, ((cap + 7) // 8) * 8)  # TPU-friendly multiple


def _dispatch_group(xt, idx, E: int, cap: int):
    """Sort-based capacity dispatch for ONE token group.

    xt: (T, d); idx: (T, k). Returns (he (E, cap, d), slot (T*k,), valid
    (T*k,)), slot and valid in the order of the flat (token, choice) list:
    row ``slot`` of he's (E*cap) rows, or the scratch row E*cap where the
    choice was dropped (every dropped choice writes there; only that row
    takes duplicate indices)."""
    T, d = xt.shape
    k = idx.shape[1]
    dev = xt.device
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    start = torch.searchsorted(se, torch.arange(E, device=dev, dtype=se.dtype))
    rank_sorted = torch.arange(T * k, device=dev) - start[se]
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)  # back to (token, choice) order
    valid = rank < cap
    slot = torch.where(valid, flat_e * cap + rank, E * cap)
    buf = torch.zeros(E * cap + 1, d, dtype=xt.dtype, device=dev)
    buf[slot] = xt.repeat_interleave(k, dim=0)
    return buf[: E * cap].reshape(E, cap, d), slot, valid


def _combine_group(ho, slot, valid, gate, T: int):
    """ho: (E, cap, d) expert outputs -> (T, d): each token's k rows, times
    their gates (0 where dropped), summed in the choices' order."""
    rows = ho.reshape(-1, ho.shape[-1])
    k = gate.shape[1]
    gathered = rows[torch.clamp(slot, max=rows.shape[0] - 1)]
    w = torch.where(valid, gate.reshape(-1), 0.0).to(ho.dtype)
    contrib = (gathered * w[:, None]).reshape(T, k, -1)
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]
    return out


def moe_apply(params, x: torch.Tensor, cfg) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d). Sort-based capacity dispatch in
    ``cfg.moe_dispatch_groups`` independent token groups."""
    m = cfg.moe
    B, S, d = x.shape
    E, k = m.n_experts, m.top_k
    G, cap = dispatch_shape(cfg, B * S)
    Tg = B * S // G

    xt = x.reshape(G, Tg, d)
    logits = (xt @ params["router"].to(xt.dtype)).float()
    if m.router == "mwu":
        idx, gate = mwu_route(logits, k, cap, m.mwu_iters)
    else:
        idx, gate = topk_route(logits, k)

    groups = [_dispatch_group(xt[g], idx[g], E, cap) for g in range(G)]
    he = torch.stack([h for h, _, _ in groups])  # (G, E, cap, d)
    hg = F.silu(torch.einsum("gecd,edf->gecf", he, params["wg"].to(x.dtype)))
    hu = torch.einsum("gecd,edf->gecf", he, params["wu"].to(x.dtype))
    ho = torch.einsum("gecf,efd->gecd", hg * hu, params["wd"].to(x.dtype))

    yt = torch.stack([_combine_group(ho[g], slot, valid, gate[g], Tg) for g, (_, slot, valid) in enumerate(groups)])
    return yt.reshape(B, S, d)
