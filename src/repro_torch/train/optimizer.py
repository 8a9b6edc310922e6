"""AdamW + warmup-cosine schedule + global-norm clipping.

Port of ``repro.train.optimizer``. Parameters, gradients and moments are
dicts of tensors keyed by parameter name; ``adamw_update`` updates the
parameters and the moments in place (plain tensor ops under
``torch.no_grad``), with f32 moments as the reference's. The schedule is
computed on the host in f32, as the reference computes it on the device,
and the step counter is a host int: an update reads nothing back from the
device.

Weight decay: the reference decays a leaf whose ndim is at least 2, and
it sees the scanned stack's leaves stacked ``(reps, ...)``, so it decays
every parameter of the first ``reps * k`` layers, norm scales and biases
too, and the tail layers' and the top level's 1-D leaves not. The port
holds one tensor a layer, so a model passes that rule as ``decay``
(``Model.decayed``); without it the rule is applied to the tensors given.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["AdamWConfig", "OptState", "init_opt_state", "adamw_update", "lr_at", "global_norm"]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    mu: dict  # name -> f32 tensor, the first moment
    nu: dict  # name -> f32 tensor, the second moment
    count: int  # updates taken


def init_opt_state(params: dict) -> OptState:
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in params.items()}
    return OptState(mu=zeros, nu={n: torch.zeros_like(z) for n, z in zeros.items()}, count=0)


def lr_at(cfg: AdamWConfig, step: int) -> np.float32:
    """The learning rate at ``step``, in f32 as the reference computes it."""
    f = np.float32
    s = f(step)
    warm = f(cfg.lr) * (s + f(1)) / f(max(cfg.warmup_steps, 1))
    t = np.clip((s - f(cfg.warmup_steps)) / f(max(cfg.total_steps - cfg.warmup_steps, 1)), f(0), f(1))
    cos = f(cfg.min_lr_frac * cfg.lr) + f(0.5 * (1 - cfg.min_lr_frac) * cfg.lr) * (f(1) + np.cos(f(np.pi) * t))
    return f(warm if step < cfg.warmup_steps else cos)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in f32; a 0-d device tensor."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tensors))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: dict, state: OptState, params: dict, decay: dict):
    """One AdamW step over ``params`` (name -> tensor), in place, and over
    the moments of ``state``, in place too. ``decay`` (name -> bool) says
    which parameters take weight decay: the reference's rule on its stacked
    leaves, ``Model.decayed()``, not the port's own tensors' ndim.
    Returns (params, the new state, metrics {"grad_norm": 0-d tensor, "lr":
    float}). Each expression rounds in the reference's order; an f32
    gradient's storage is reused as scratch, so ``grads`` is consumed."""
    gnorm = global_norm(grads.values())
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    count = state.count + 1
    f = np.float32
    b1c = float(f(1) - f(cfg.b1) ** f(count))
    b2c = float(f(1) - f(cfg.b2) ** f(count))
    lr = float(lr_at(cfg, state.count))
    for name, p in params.items():
        m, v = state.mu[name], state.nu[name]
        g = grads[name].float().mul_(scale)  # g * scale (in the gradient's storage where it is f32)
        t = g * (1 - cfg.b1)
        m.mul_(cfg.b1).add_(t)  # b1 m + (1 - b1) g
        torch.mul(g, 1 - cfg.b2, out=t).mul_(g)
        v.mul_(cfg.b2).add_(t)  # b2 v + (1 - b2) g g
        torch.div(v, b2c, out=t).sqrt_().add_(cfg.eps)
        torch.div(m, b1c, out=g).div_(t)  # (m / b1c) / (sqrt(v / b2c) + eps)
        pf = p if p.dtype == torch.float32 else p.float()
        if decay[name]:
            g.add_(torch.mul(pf, cfg.weight_decay, out=t))  # decoupled decay
        g.mul_(lr)
        if pf is p:
            p.sub_(g)
        else:
            p.copy_(pf - g)
        del g, t
    return params, OptState(mu=state.mu, nu=state.nu, count=count), {"grad_norm": gnorm, "lr": lr}
