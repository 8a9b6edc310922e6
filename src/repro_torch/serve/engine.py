"""Batched serving engine: slot-batched generation over the decode caches.

Port of ``repro.serve.engine``. ``slots`` prompts at a time share one
``Model.decode_step`` a step: each group's prompts are right-padded with
token 0 to the longest, run teacher-forced through decode steps from
empty caches (``Model.init_caches``: KV caches, rings for sliding windows,
rglru states), and then ``max_new`` tokens are sampled a slot. As in the
reference, a shorter prompt is sampled after its trailing zeros.

Sampling is greedy (argmax over the first ``vocab_size`` logits) or, with a
temperature, a draw from ``softmax(logits / temperature)`` by the Gumbel-max
rule over a ``torch.Generator`` seeded from ``ServeConfig.seed``: the same
distribution as the reference's ``jax.random.categorical``, another stream.

A step reads the host once, for the sampled tokens (the prompt steps not at
all); an MoE layer's ``mwu`` router reads it as its solver does.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..models import Model, load_jax_params

__all__ = ["ServeConfig", "Request", "Engine"]


@dataclass
class ServeConfig:
    max_len: int = 512
    slots: int = 4  # concurrent sequences
    temperature: float = 0.0  # 0 = greedy
    seed: int = 0


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new: int
    out: list = field(default_factory=list)
    done: bool = False


class Engine:
    """``Engine(cfg, sc, device="cuda")``; ``load`` it, then ``generate``."""

    def __init__(self, cfg, sc: ServeConfig, device="cuda"):
        self.cfg = cfg
        self.sc = sc
        self.device = torch.empty(0, device=device).device  # "cuda" -> "cuda:0"
        self.model: Model | None = None
        self._gen = torch.Generator(device=self.device).manual_seed(sc.seed)

    def load(self, params) -> None:
        """``params``: a built ``Model`` of this config on the engine's device,
        or the reference's parameter tree with numpy leaves (``load_jax_params``)."""
        if isinstance(params, Model):
            if params.cfg != self.cfg or params.embedding.device != self.device:
                raise ValueError(f"model of {params.cfg.name} on {params.embedding.device} does not fit the "
                                 f"engine's {self.cfg.name} on {self.device}")
            self.model = params
        else:
            self.model = load_jax_params(Model(self.cfg, device=self.device), params)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """(B, 1, V) logits -> (B,) tokens on the device."""
        lg = logits[:, -1, : self.cfg.vocab_size].float()
        if self.sc.temperature <= 0:
            return torch.argmax(lg, dim=-1)
        u = torch.rand(lg.shape, generator=self._gen, device=lg.device)
        return torch.argmax(lg / self.sc.temperature - torch.log(-torch.log(u)), dim=-1)

    def generate(self, prompts: list[np.ndarray], max_new: int = 32) -> list[list[int]]:
        """Slot-batched generation: ``max_new`` tokens for each prompt."""
        if self.model is None:
            raise RuntimeError("Engine.generate before load")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        sc, model = self.sc, self.model
        reqs = [Request(i, np.asarray(p, np.int32), max_new) for i, p in enumerate(prompts)]
        queue = list(reqs)
        with torch.inference_mode():
            while queue:
                active, queue = queue[: sc.slots], queue[sc.slots:]
                B = len(active)
                maxp = max(len(r.prompt) for r in active)
                toks = np.zeros((B, maxp), np.int32)  # right-padded with token 0, as the reference
                for i, r in enumerate(active):
                    toks[i, : len(r.prompt)] = r.prompt
                toks = torch.from_numpy(toks).to(self.device)
                caches = model.init_caches(B, sc.max_len)
                # teacher-forced pass over the prompt region
                for t in range(maxp):
                    logits, caches = model.decode_step(caches, toks[:, t: t + 1])
                cur = self._sample(logits)
                for step in range(max_new):  # the first token from the prompt's last step, as the reference
                    if step:
                        logits, caches = model.decode_step(caches, cur[:, None])
                        cur = self._sample(logits)
                    for r, tok in zip(active, cur.tolist()):  # the step's one host read
                        r.out.append(tok)
                for r in active:
                    r.done = True
        return [r.out for r in reqs]
