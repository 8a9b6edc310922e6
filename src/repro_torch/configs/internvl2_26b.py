"""internvl2-26b [vlm]: 48L, d_model 6144, 48H GQA kv=8, d_ff 16384,
vocab 92553 (arXiv:2404.16821) — InternViT + InternLM2 backbone.

Per instructions the vision frontend is a STUB: input_specs() provides
precomputed patch embeddings (B, n_patches, d_model) concatenated before
the text tokens. Vocab padded 92553 -> 92672. Full attention.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=16384,
    vocab_size=92553,
    modality="vision_text",
    n_vision_patches=1024,
    mlp_type="swiglu",
)
