"""Model assembly: embeddings -> block stack -> final norm -> logits.

Port of ``repro.models.model.Model`` for the full-sequence forward, prefill
and decode of two block kinds, the layer's kind coming from ``cfg.pattern()``:

  "attn"  - norm -> attention -> residual, norm -> (mlp | moe) -> residual
            (dense, encoder and GQA decoders; the MoE decoders mixtral and
            dbrx, with either router; recurrentgemma's MQA local attention);
  "rglru" - norm -> rglru -> residual, norm -> mlp -> residual (recurrentgemma).

The layers are the reference's in its order: ``reps`` repetitions of the
pattern unit, then the tail. The model holds one block module per layer; a
Python loop replaces ``lax.scan``. The parameters are trainable
(``requires_grad``); a forward with grad enabled and ``cfg.remat ==
"full"`` runs each repetition of the pattern unit under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` over the
scanned stack), the tail layers without it. Inference callers run under
``torch.inference_mode``, so nothing is saved for a backward.
``audio_frames`` consumes precomputed (B, S, d_model) frames, as in the
reference.

Training: ``decayed()`` gives the reference's weight-decay rule by
parameter name (its stacked leaves are all decayed, see
``repro_torch.train.optimizer``); ``repro_torch.train.load_jax_train_state``
carries a reference ``TrainState`` across on ``_by_name``'s unstacking.

Serving: ``init_caches`` gives one cache a layer (a ``KVCache`` for attn,
an ``RGLRUState`` for rglru) in ``DecodeCaches``, with the position as a
host int, so a decode step reads nothing from the device but what its MoE
router reads. ``prefill`` runs a prompt from position 0 and fills the
caches; ``decode_step`` runs one token a sequence (through MoE: one token
routed a sequence a step). Both return the last position's logits and new
caches, and leave the given ones as they were.

Not ported yet (ROADMAP queue 1 item 15.3): the ``ssm`` block kind and the
``vision_text`` modality; ``Model(...)`` raises ``NotImplementedError``.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .common import Dtypes, dense_init
from .layers import attention as att
from .layers import mlp as mlpmod
from .layers import moe as moemod
from .layers import norms
from .layers import rglru as rg

__all__ = ["Model", "DecodeCaches", "load_jax_params"]

_LATER = "ROADMAP queue 1 item 15.3"
_MIXER_INIT = {"attn": att.attention_init, "rglru": rg.rglru_init}


def _groups(kind: str, cfg) -> tuple:
    """A block's parameter groups, in the reference's names: ln1, the mixer
    (``attn`` or ``rglru``), ln2, and the feed-forward, ``moe`` in place of
    ``mlp`` in an attn block of an MoE config (reference ``model.py:79-85``)."""
    return ("ln1", kind, "ln2", "moe" if kind == "attn" and cfg.moe is not None else "mlp")


def _params(d: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in d.items()})


class DecodeCaches(NamedTuple):
    """One cache a layer, in the model's layer order, and the position of the next token."""

    layers: tuple  # KVCache (attn) or RGLRUState (rglru), one a layer
    pos: int  # tokens decoded so far (host int)


class Block(nn.Module):
    """One layer of kind ``kind``: the groups of ``_groups(kind, cfg)`` (ln1,
    the mixer ``attn`` or ``rglru``, ln2, ``mlp`` or ``moe``), each a dict of
    parameters."""

    def __init__(self, kind: str, cfg, gen: torch.Generator, dtype, device):
        super().__init__()
        self.kind = kind
        self.groups = _groups(kind, cfg)
        self.ln1 = _params(norms.norm_init(cfg.d_model, cfg.norm_type, dtype, device))
        setattr(self, kind, _params(_MIXER_INIT[kind](gen, cfg, dtype, device)))
        self.ln2 = _params(norms.norm_init(cfg.d_model, cfg.norm_type, dtype, device))
        ffn = self.groups[-1]
        init = moemod.moe_init if ffn == "moe" else mlpmod.mlp_init
        setattr(self, ffn, _params(init(gen, cfg, dtype, device)))


class Model(nn.Module):
    """``Model(cfg, device="cuda", seed=0)``: random init from a seeded
    ``torch.Generator`` on ``device``; ``load_jax_params`` replaces it."""

    def __init__(self, cfg, device="cuda", seed: int = 0):
        super().__init__()
        pattern = cfg.pattern()
        if set(pattern) - set(_MIXER_INIT):
            raise NotImplementedError(f"{cfg.name}: block kinds {sorted(set(pattern) - set(_MIXER_INIT))} are not "
                                      f"ported yet ({_LATER})")
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
            self.frame_proj = nn.Parameter(dense_init(gen, (d, d), dtp, device))
        self.embedding = nn.Parameter(dense_init(gen, (V, d), dtp, device, scale=float(np.sqrt(d))))
        self.blocks = nn.ModuleList(Block(kind, cfg, gen, dtp, device) for kind in pattern)
        self.final_norm = _params(norms.norm_init(d, cfg.norm_type, dtp, device))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(dense_init(gen, (d, V), dtp, device))

    # ------------------------------------------------------------------

    def _apply_block(self, blk: Block, x, positions=None, cache=None, start: int | None = None):
        """One layer -> (x, its new cache). Without a cache: the forward over
        ``positions``. With one: x's tokens from host position ``start``, a
        prompt (S > 1) or one decode step (S == 1)."""
        cfg = self.cfg
        h = norms.apply_norm(blk.ln1, x, cfg.norm_type, cfg.norm_eps)
        if blk.kind == "attn":
            a, new_cache = att.attention_apply(blk.attn, h, cfg, positions=positions, cache=cache, start=start)
        elif cache is not None and x.shape[1] == 1:
            a, new_cache = rg.rglru_decode(blk.rglru, h, cfg, cache)
        else:
            a, new_cache = rg.rglru_apply(blk.rglru, h, cfg, state=cache)
        x = x + a
        h = norms.apply_norm(blk.ln2, x, cfg.norm_type, cfg.norm_eps)
        if blk.groups[-1] == "moe":
            return x + moemod.moe_apply(blk.moe, h, cfg), new_cache
        return x + mlpmod.mlp_apply(blk.mlp, h, cfg), new_cache

    def embed(self, batch: dict) -> torch.Tensor:
        """batch: {'tokens': (B, S) int} or {'frames': (B, S, d_model)}."""
        ct = self.dt.compute
        if self.cfg.modality == "audio_frames":
            return batch["frames"].to(ct) @ self.frame_proj.to(ct)
        # F.embedding's backward sums a repeated token's rows in a fixed order (indexing's does not on the CPU)
        return F.embedding(batch["tokens"], self.embedding.to(ct))

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        head = (self.embedding.T if cfg.tie_embeddings else self.lm_head).to(self.dt.compute)
        out = (x @ head).to(self.dt.logit)
        if cfg.padded_vocab != cfg.vocab_size:  # mask pad-vocab slots
            pad = torch.arange(cfg.padded_vocab, device=out.device) >= cfg.vocab_size
            out = out.masked_fill(pad, -1e30)
        return out

    def _unit(self, r: int, x, positions):
        """Repetition r of the pattern unit: layers r*k .. r*k + k - 1."""
        k = len(self.pattern_unit)
        for blk in self.blocks[r * k:(r + 1) * k]:
            x, _ = self._apply_block(blk, x, positions)
        return x

    def forward(self, batch: dict, remat: bool | None = None) -> torch.Tensor:
        """Full-sequence forward -> final-norm hidden states (B, S, d).
        ``remat`` (default ``cfg.remat == "full"``) recomputes each
        repetition of the pattern unit in the backward; it applies only
        where grad is enabled."""
        cfg = self.cfg
        x = self.embed(batch)
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        unit = self._unit
        if (cfg.remat == "full" if remat is None else remat) and torch.is_grad_enabled():
            unit = functools.partial(checkpoint, self._unit, use_reentrant=False)
        for r in range(self.reps):
            x = unit(r, x, positions)
        for blk in self.blocks[self.reps * len(self.pattern_unit):]:
            x, _ = self._apply_block(blk, x, positions)
        return norms.apply_norm(self.final_norm, x, cfg.norm_type, cfg.norm_eps)

    def decayed(self) -> dict:
        """Parameter name -> whether AdamW decays it, by the reference's
        rule (ndim >= 2) on the reference's leaf: every parameter of the
        first ``reps * k`` layers (stacked there, so at least 2-D), else the
        parameter's own ndim."""
        n_stacked = self.reps * len(self.pattern_unit)
        out = {}
        for name, p in self.named_parameters():
            where = name.split(".")
            out[name] = (where[0] == "blocks" and int(where[1]) < n_stacked) or p.dim() >= 2
        return out

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------

    def init_caches(self, batch: int, max_len: int) -> DecodeCaches:
        """Empty caches for ``batch`` sequences of up to ``max_len`` positions:
        KV caches in the compute dtype, rglru states as the reference's."""
        dev = self.embedding.device
        layers = tuple(att.init_kv_cache(self.cfg, batch, max_len, dtype=self.dt.compute, device=dev)
                       if blk.kind == "attn" else rg.init_rglru_state(self.cfg, batch, device=dev)
                       for blk in self.blocks)
        return DecodeCaches(layers=layers, pos=0)

    def _final_logits(self, x):
        cfg = self.cfg
        return self.logits(norms.apply_norm(self.final_norm, x, cfg.norm_type, cfg.norm_eps))

    def decode_step(self, caches: DecodeCaches, tokens):
        """One decode step. tokens: (B, 1) ints (frames (B, 1, d) for audio).
        Returns (logits (B, 1, V), new caches)."""
        key = "frames" if self.cfg.modality == "audio_frames" else "tokens"
        x = self.embed({key: tokens})
        layers = []
        for blk, cache in zip(self.blocks, caches.layers):
            x, c = self._apply_block(blk, x, cache=cache, start=caches.pos)
            layers.append(c)
        return self._final_logits(x), DecodeCaches(layers=tuple(layers), pos=caches.pos + 1)

    def prefill(self, batch: dict, max_len: int):
        """Run a prompt from position 0, filling fresh caches of ``max_len``
        positions. Returns (last-token logits (B, 1, V), caches)."""
        x = self.embed(batch)
        B, S = x.shape[0], x.shape[1]
        caches = self.init_caches(B, max_len)
        layers = []
        for blk, cache in zip(self.blocks, caches.layers):
            x, c = self._apply_block(blk, x, cache=cache, start=0)
            layers.append(c)
        return self._final_logits(x[:, -1:]), DecodeCaches(layers=tuple(layers), pos=S)


def _by_name(model: Model, tree: dict, what: str = "") -> dict:
    """A tree shaped as the reference's params (``repro.models.Model.init``'s
    nested dict) -> {the model's parameter name: its leaf}.

    The reference stacks layer ``r*k + j`` (repetition r, pattern position
    j of k) at index r of ``tree["blocks"][f"b{j}"]``, and the remainder
    layers under ``tree["tail"][f"t{j}"]``; this unstacks them into the
    model's one block per layer."""
    out = {}
    k = len(model.pattern_unit)
    for i, blk in enumerate(model.blocks):
        if i < model.reps * k:
            r, j = divmod(i, k)
            layer = {grp: {n: a[r] for n, a in leaves.items()} for grp, leaves in tree["blocks"][f"b{j}"].items()}
        else:
            layer = tree["tail"][f"t{i - model.reps * k}"]
        if set(layer) != set(blk.groups):
            raise ValueError(f"{what}layer {i}: groups {sorted(layer)} are not those of an {blk.kind} block")
        for grp in blk.groups:
            names = set(getattr(blk, grp).keys())
            if set(layer[grp]) != names:
                raise ValueError(f"{what}layer {i}.{grp}: keys {sorted(layer[grp])} do not match the model's "
                                 f"{sorted(names)}")
            out.update({f"blocks.{i}.{grp}.{n}": layer[grp][n] for n in names})
    # the reference's top-level key -> the model's attribute
    top = {"embed": "embedding", "final_norm": "final_norm"}
    if model.cfg.modality == "audio_frames":
        top["frame_proj"] = "frame_proj"
    if not model.cfg.tie_embeddings:
        top["lm_head"] = "lm_head"
    if set(tree) != set(top) | {"blocks", "tail"}:
        raise ValueError(f"{what}top-level keys {sorted(tree)} do not match the model's {sorted(top)} + blocks, tail")
    for key, attr in top.items():
        target = getattr(model, attr)
        if not isinstance(target, nn.ParameterDict):
            out[attr] = tree[key]
            continue
        if set(tree[key]) != set(target.keys()):
            raise ValueError(f"{what}{key}: keys {sorted(tree[key])} do not match the model's {sorted(target.keys())}")
        out.update({f"{attr}.{n}": a for n, a in tree[key].items()})
    return out


def _checked(arr, target: torch.Tensor, name: str) -> np.ndarray:
    arr = np.asarray(arr)
    if tuple(arr.shape) != tuple(target.shape):
        raise ValueError(f"{name}: shape {arr.shape} does not match the model's {tuple(target.shape)}")
    return arr


def load_jax_params(model: Model, params: dict) -> Model:
    """Fill ``model`` with the reference's parameters, given as the nested
    dict of ``repro.models.Model.init`` with numpy arrays as leaves, each
    layer unstacked (``_by_name``). Values are cast to the model's param
    dtype."""
    own = dict(model.named_parameters())
    with torch.no_grad():
        for name, arr in _by_name(model, params).items():
            own[name].copy_(torch.tensor(_checked(arr, own[name], name)))
    return model
