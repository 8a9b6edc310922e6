"""Loss + train_step factory.

Port of ``repro.train.step``. Cross-entropy is computed in sequence chunks
(``loss_chunk``) so the (B, S, vocab) f32 logits are never all held at once
in the forward. Microbatching accumulates gradients over ``microbatches``
backward passes, with bf16 compute over f32 master params as the config
says.

PyTorch's idiom: the parameters live in the model, and the step updates
them and the moments in place (``adamw_update``); ``TrainState`` holds the
model's own parameters by name, and the step and the optimizer's count are
host ints. A step reads nothing back from the device: its metrics are
device tensors (``loss``, ``grad_norm``) and the host's ``lr``.
``load_jax_train_state`` carries a reference ``TrainState`` across.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models.model import _by_name, _checked, load_jax_params
from .optimizer import AdamWConfig, OptState, adamw_update, init_opt_state

__all__ = ["TrainState", "make_train_state", "make_train_step", "chunked_ce_loss", "load_jax_train_state"]


class TrainState(NamedTuple):
    params: dict  # name -> the model's own parameter
    opt: OptState
    step: int


def make_train_state(model) -> TrainState:
    """The state of a fresh run: the model's parameters (as initialized, or
    loaded), zero moments, step 0."""
    params = dict(model.named_parameters())
    return TrainState(params=params, opt=init_opt_state(params), step=0)


def load_jax_train_state(model, state) -> TrainState:
    """The port's ``TrainState`` from the reference's (``repro.train.step``'s
    params, ``opt`` = (mu, nu, count), step; numpy or jax arrays): the
    parameters loaded into ``model`` (``load_jax_params``), the moments
    unstacked as the parameters, f32 on the model's device, count and step
    as host ints."""
    load_jax_params(model, state.params)
    own = dict(model.named_parameters())

    def moments(tree, what):
        return {name: torch.tensor(_checked(a, own[name], name), dtype=torch.float32, device=own[name].device)
                for name, a in _by_name(model, tree, what).items()}

    opt = OptState(mu=moments(state.opt.mu, "mu: "), nu=moments(state.opt.nu, "nu: "),
                   count=int(np.asarray(state.opt.count)))
    return TrainState(params=own, opt=opt, step=int(np.asarray(state.step)))


def chunked_ce_loss(model, batch: dict, chunk: int = 512) -> torch.Tensor:
    """Next-token CE, chunked over the sequence, as a 0-d f32 tensor. Uses
    batch['targets'] and batch['loss_mask'] (mask also covers padding).
    Each chunk's logits are ``h @ head`` in the compute dtype, then f32, with
    no pad-vocab mask (the reference's ``ce_of``; ``Model.logits`` masks)."""
    h = model(batch)  # (B, S, d)
    B, S, d = h.shape
    targets = batch["targets"].long()
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=h.device)
    chunk = min(chunk, S)
    n_chunks = S // chunk
    ct = model.dt.compute
    head = (model.embedding.T if model.cfg.tie_embeddings else model.lm_head).to(ct)

    def ce_of(hs, ts, ms):
        logits = (hs.to(ct) @ head).float()
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.take_along_dim(logits, ts[..., None], dim=-1)[..., 0]
        return torch.sum((logz - ll) * ms), torch.sum(ms)

    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    bounds = [(i * chunk, (i + 1) * chunk) for i in range(n_chunks)]
    if S > n_chunks * chunk:
        bounds.append((n_chunks * chunk, S))  # the remainder
    for a, b in bounds:
        l, c = ce_of(h[:, a:b], targets[:, a:b], mask[:, a:b])
        tot, cnt = tot + l, cnt + c
    return tot / torch.clamp(cnt, min=1.0)


def make_train_step(model, opt_cfg: AdamWConfig, microbatches: int = 1, loss_chunk: int = 512):
    """Returns train_step(state, batch) -> (state, metrics): the loss and
    its gradients (``microbatches`` backward passes, the batch split along
    its first dim, gradients summed 0 + g1 + g2 ... then divided, as the
    reference's scan), then one AdamW update in place."""
    decay = model.decayed()

    def loss_fn(batch):
        return chunked_ce_loss(model, batch, chunk=loss_chunk)

    def train_step(state: TrainState, batch: dict):
        params = state.params
        for p in params.values():
            p.grad = None
        if microbatches <= 1:
            loss = loss_fn(batch)
            loss.backward()
            loss = loss.detach()
        else:
            B = next(iter(batch.values())).shape[0]
            mb = B // microbatches
            loss = torch.zeros((), dtype=torch.float32, device=next(iter(params.values())).device)
            for i in range(microbatches):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l = loss_fn(part)
                l.backward()
                loss = loss + l.detach()
            loss = loss / microbatches
            for p in params.values():
                if p.grad is not None:
                    p.grad.div_(microbatches)
        # a parameter the loss does not reach (hubert's embedding) has a zero gradient
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad for n, p in params.items()}
        for p in params.values():
            p.grad = None
        _, opt, om = adamw_update(opt_cfg, grads, state.opt, params, decay)
        del grads
        return TrainState(params=params, opt=opt, step=state.step + 1), {"loss": loss, **om}

    return train_step
