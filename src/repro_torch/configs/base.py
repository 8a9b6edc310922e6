"""Model configuration schema for the architecture plane.

Every assigned architecture is a :class:`ModelConfig` in its own module
(one file per arch, exact pool numbers). ``reduced()`` derives the tiny
smoke-test variant of the same family.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

__all__ = ["ModelConfig", "MoEConfig", "SSMConfig"]


def _ceil_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int  # per-expert hidden
    router: str = "topk"  # "topk" | "mwu"  (MWU = the paper's technique)
    capacity_factor: float = 1.25
    mwu_iters: int = 16  # in-graph MWU iterations for router="mwu"
    router_jitter: float = 0.0
    # shard experts over this mesh axis ("data" enables expert-parallel
    # serving of models whose weights exceed a TP-16 shard, e.g. dbrx)
    ep_axis: str = "model"


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD hyperparameters (arXiv:2405.21060)."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256
    ngroups: int = 1  # B/C groups

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encoder | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 -> d_model // n_heads

    # attention
    rope_theta: float = 10_000.0
    qkv_bias: bool = False  # Qwen1.5 uses QKV bias
    sliding_window: Optional[int] = None  # SWA (Mixtral) / local attn (RG)
    causal: bool = True
    attn_impl: str = "chunked"  # "dense" | "chunked" | "pallas"
    attn_chunk: int = 1024  # kv-block size for chunked/flash attention

    # mlp
    mlp_type: str = "swiglu"  # "swiglu" | "gelu"

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None

    # hybrid layer pattern, e.g. ("rglru", "rglru", "attn"); None => uniform
    block_pattern: Optional[tuple] = None
    # recurrent width for rglru blocks (defaults to d_model)
    rnn_width: int = 0

    norm_type: str = "rmsnorm"  # "rmsnorm" | "layernorm"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # modality stubs (per instructions: frontends are precomputed embeddings)
    modality: str = "text"  # "text" | "audio_frames" | "vision_text"
    n_vision_patches: int = 1024  # [vlm] patch count inside the sequence

    # numerics / training
    dtype: str = "bfloat16"  # activation/compute dtype
    param_dtype: str = "float32"
    remat: str = "full"  # "none" | "full"
    logit_dtype: str = "float32"
    # pad vocab so 16-way model sharding divides it (DESIGN.md §3)
    vocab_pad_multiple: int = 256
    # MoE dispatch locality: number of independent token groups laid out
    # along the data axis (set to the DP shard count by launchers); 1 =
    # single global dispatch (only safe on one device) — EXPERIMENTS §Perf.
    moe_dispatch_groups: int = 1

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // max(self.n_heads, 1))
        if self.family == "hybrid" and self.rnn_width == 0:
            object.__setattr__(self, "rnn_width", self.d_model)

    @property
    def padded_vocab(self) -> int:
        return _ceil_to(self.vocab_size, self.vocab_pad_multiple)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head

    @property
    def is_subquadratic(self) -> bool:
        """Eligible for the long_500k cell (DESIGN.md shape-cell skips)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window is not None

    @property
    def has_decode(self) -> bool:
        return self.family != "encoder"

    def pattern(self) -> tuple:
        """Per-layer block kinds, length n_layers."""
        if self.block_pattern is None:
            kind = {"ssm": "ssm"}.get(self.family, "attn")
            return (kind,) * self.n_layers
        p = self.block_pattern
        reps = (self.n_layers + len(p) - 1) // len(p)
        return (p * reps)[: self.n_layers]

    def n_params(self) -> int:
        """Approximate parameter count (for roofline MODEL_FLOPS)."""
        d, f, L = self.d_model, self.d_ff, self.n_layers
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        per_attn = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
        if self.mlp_type == "swiglu":
            per_mlp = 3 * d * f
        else:
            per_mlp = 2 * d * f
        if self.moe is not None:
            per_mlp = self.moe.n_experts * (3 * d * self.moe.d_ff) + d * self.moe.n_experts
        total = emb
        for kind in self.pattern():
            if kind == "attn":
                total += per_attn + per_mlp
            elif kind == "ssm":
                di = self.ssm.d_inner(d)
                total += d * (2 * di + 2 * self.ssm.ngroups * self.ssm.d_state + self.ssm.n_heads(d)) + di * d
                total += per_mlp if f > 0 else 0
            elif kind == "rglru":
                w = self.rnn_width
                total += 2 * d * w + w * d + 2 * w * w // 1  # in/out + gates (block-diag approx)
                total += per_mlp
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top-k experts)."""
        if self.moe is None:
            return self.n_params()
        d, L = self.d_model, self.n_layers
        per_attn = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
        act_mlp = self.moe.top_k * 3 * d * self.moe.d_ff + d * self.moe.n_experts
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        return emb + L * (per_attn + act_mlp)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dict(
            n_layers=min(self.n_layers, 2 if self.block_pattern is None else len(self.block_pattern or (1,))),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads > 1 else 1,
            d_head=32,
            d_ff=256 if self.d_ff > 0 else 0,
            vocab_size=256,
            rnn_width=128 if self.family == "hybrid" else 0,
            sliding_window=16 if self.sliding_window else None,
            attn_chunk=16,
            n_vision_patches=8,
            dtype="float32",
            param_dtype="float32",
            remat="none",
            name=self.name + "-reduced",
        )
        if self.moe is not None:
            kw["moe"] = replace(self.moe, n_experts=4, top_k=2, d_ff=64, ep_axis="model")
        if self.ssm is not None:
            kw["ssm"] = replace(self.ssm, d_state=16, head_dim=16, chunk=8)
        if self.block_pattern is not None:
            kw["n_layers"] = len(self.block_pattern)
        return replace(self, **kw)
