"""hubert-xlarge [audio]: 48L encoder-only, d_model 1280, 16H MHA,
d_ff 5120, vocab 504 (arXiv:2106.07447) — same arch as wav2vec2.

Encoder-only: bidirectional attention, no decode cells (DESIGN.md §6);
prefill_32k lowers the encode forward. The conv feature extractor is a
STUB: input_specs() provides precomputed frames (B, S, d_model).
Vocab padded 504 -> 512.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="encoder",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_head=80,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    modality="audio_frames",
    mlp_type="gelu",
    norm_type="layernorm",
)
