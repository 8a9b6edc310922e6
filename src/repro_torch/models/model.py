"""Model assembly: embeddings -> block stack -> final norm -> logits.

Port of ``repro.models.model.Model`` for the full-sequence forward of two
block kinds, the layer's kind coming from ``cfg.pattern()``:

  "attn"  - norm -> attention -> residual, norm -> mlp -> residual
            (dense, encoder and GQA decoders; recurrentgemma's MQA local attention);
  "rglru" - norm -> rglru -> residual, norm -> mlp -> residual (recurrentgemma).

The layers are the reference's in its order: ``reps`` repetitions of the
pattern unit, then the tail. The model holds one block module per layer; a
Python loop replaces ``lax.scan``, and there is no rematerialization (the
forward runs under ``torch.inference_mode``). ``audio_frames`` consumes
precomputed (B, S, d_model) frames, as in the reference.

Not ported yet (ROADMAP queue 1 item 15): the ``ssm`` block kind, MoE, the
``vision_text`` modality, and ``decode_step``, ``prefill`` and
``init_caches``; each raises ``NotImplementedError``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .common import Dtypes, dense_init
from .layers import attention as att
from .layers import mlp as mlpmod
from .layers import norms
from .layers import rglru as rg

__all__ = ["Model", "load_jax_params"]

_LATER = "ROADMAP queue 1 item 15"
# each block kind's parameter groups, in the reference's names; the second is the mixer
_GROUPS = {"attn": ("ln1", "attn", "ln2", "mlp"), "rglru": ("ln1", "rglru", "ln2", "mlp")}
_MIXER_INIT = {"attn": att.attention_init, "rglru": rg.rglru_init}


def _params(d: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False) for k, v in d.items()})


class Block(nn.Module):
    """One layer of kind ``kind``: the groups of ``_GROUPS[kind]`` (ln1, the
    mixer ``attn`` or ``rglru``, ln2, mlp), each a dict of parameters."""

    def __init__(self, kind: str, cfg, gen: torch.Generator, dtype, device):
        super().__init__()
        self.kind = kind
        self.ln1 = _params(norms.norm_init(cfg.d_model, cfg.norm_type, dtype, device))
        setattr(self, kind, _params(_MIXER_INIT[kind](gen, cfg, dtype, device)))
        self.ln2 = _params(norms.norm_init(cfg.d_model, cfg.norm_type, dtype, device))
        self.mlp = _params(mlpmod.mlp_init(gen, cfg, dtype, device))


class Model(nn.Module):
    """``Model(cfg, device="cuda", seed=0)``: random init from a seeded
    ``torch.Generator`` on ``device``; ``load_jax_params`` replaces it."""

    def __init__(self, cfg, device="cuda", seed: int = 0):
        super().__init__()
        pattern = cfg.pattern()
        if set(pattern) - set(_GROUPS):
            raise NotImplementedError(f"{cfg.name}: block kinds {sorted(set(pattern) - set(_GROUPS))} are not "
                                      f"ported yet ({_LATER})")
        if cfg.moe is not None:
            raise NotImplementedError(f"{cfg.name}: MoE is not ported yet ({_LATER})")
        if cfg.modality not in ("text", "audio_frames"):
            raise NotImplementedError(f"{cfg.name}: modality {cfg.modality!r} is not ported yet ({_LATER})")
        self.cfg = cfg
        self.dt = Dtypes(cfg)
        # the reference's layout of layers: reps repetitions of the pattern unit, then the tail
        self.pattern_unit = cfg.block_pattern or (pattern[0],)
        self.reps = cfg.n_layers // len(self.pattern_unit)

        device = torch.device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        dtp, V, d = self.dt.param, cfg.padded_vocab, cfg.d_model
        if cfg.modality == "audio_frames":
            self.frame_proj = nn.Parameter(dense_init(gen, (d, d), dtp, device), requires_grad=False)
        self.embedding = nn.Parameter(dense_init(gen, (V, d), dtp, device, scale=float(np.sqrt(d))),
                                      requires_grad=False)
        self.blocks = nn.ModuleList(Block(kind, cfg, gen, dtp, device) for kind in pattern)
        self.final_norm = _params(norms.norm_init(d, cfg.norm_type, dtp, device))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(dense_init(gen, (d, V), dtp, device), requires_grad=False)

    # ------------------------------------------------------------------

    def _apply_block(self, blk: Block, x, positions):
        cfg = self.cfg
        h = norms.apply_norm(blk.ln1, x, cfg.norm_type, cfg.norm_eps)
        if blk.kind == "attn":
            a, _ = att.attention_apply(blk.attn, h, cfg, positions=positions)
        else:
            a, _ = rg.rglru_apply(blk.rglru, h, cfg)
        x = x + a
        h = norms.apply_norm(blk.ln2, x, cfg.norm_type, cfg.norm_eps)
        return x + mlpmod.mlp_apply(blk.mlp, h, cfg)

    def embed(self, batch: dict) -> torch.Tensor:
        """batch: {'tokens': (B, S) int} or {'frames': (B, S, d_model)}."""
        ct = self.dt.compute
        if self.cfg.modality == "audio_frames":
            return batch["frames"].to(ct) @ self.frame_proj.to(ct)
        return self.embedding.to(ct)[batch["tokens"]]

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        head = (self.embedding.T if cfg.tie_embeddings else self.lm_head).to(self.dt.compute)
        out = (x @ head).to(self.dt.logit)
        if cfg.padded_vocab != cfg.vocab_size:  # mask pad-vocab slots
            pad = torch.arange(cfg.padded_vocab, device=out.device) >= cfg.vocab_size
            out = out.masked_fill(pad, -1e30)
        return out

    def forward(self, batch: dict) -> torch.Tensor:
        """Full-sequence forward -> final-norm hidden states (B, S, d)."""
        cfg = self.cfg
        x = self.embed(batch)
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        for blk in self.blocks:
            x = self._apply_block(blk, x, positions)
        return norms.apply_norm(self.final_norm, x, cfg.norm_type, cfg.norm_eps)

    def init_caches(self, batch, max_len):
        raise NotImplementedError(f"decode caches are not ported yet ({_LATER})")

    def decode_step(self, caches, tokens):
        raise NotImplementedError(f"decode_step is not ported yet ({_LATER})")

    def prefill(self, batch, max_len):
        raise NotImplementedError(f"prefill is not ported yet ({_LATER})")


def _fill(target, src, name: str) -> None:
    """Copy a numpy array into a parameter, or each entry of a dict into a ParameterDict."""
    if isinstance(target, nn.ParameterDict):
        if set(target.keys()) != set(src.keys()):
            raise ValueError(f"{name}: keys {sorted(src)} do not match the model's {sorted(target.keys())}")
        for k in target.keys():
            _fill(target[k], src[k], f"{name}.{k}")
        return
    arr = np.asarray(src)
    if tuple(arr.shape) != tuple(target.shape):
        raise ValueError(f"{name}: shape {arr.shape} does not match the model's {tuple(target.shape)}")
    with torch.no_grad():
        target.copy_(torch.tensor(arr))


def load_jax_params(model: Model, params: dict) -> Model:
    """Fill ``model`` with the reference's parameters, given as the nested
    dict of ``repro.models.Model.init`` with numpy arrays as leaves.

    The reference stacks layer ``r*k + j`` (repetition r, pattern position
    j of k) at index r of ``params["blocks"][f"b{j}"]``, and the remainder
    layers under ``params["tail"][f"t{j}"]``; this unstacks them into the
    model's one block per layer. Values are cast to the model's param dtype.
    """
    k = len(model.pattern_unit)
    for i, blk in enumerate(model.blocks):
        if i < model.reps * k:
            r, j = divmod(i, k)
            layer = {grp: {n: a[r] for n, a in leaves.items()} for grp, leaves in params["blocks"][f"b{j}"].items()}
        else:
            layer = params["tail"][f"t{i - model.reps * k}"]
        groups = _GROUPS[blk.kind]
        if set(layer) != set(groups):
            raise ValueError(f"layer {i}: groups {sorted(layer)} are not those of an {blk.kind} block")
        for grp in groups:
            _fill(getattr(blk, grp), layer[grp], f"layer {i}.{grp}")
    # the reference's top-level key -> the model's attribute
    top = {"embed": "embedding", "final_norm": "final_norm"}
    if model.cfg.modality == "audio_frames":
        top["frame_proj"] = "frame_proj"
    if not model.cfg.tie_embeddings:
        top["lm_head"] = "lm_head"
    if set(params) != set(top) | {"blocks", "tail"}:
        raise ValueError(f"top-level keys {sorted(params)} do not match the model's {sorted(top)} + blocks, tail")
    for key, attr in top.items():
        _fill(getattr(model, attr), params[key], key)
    return model
