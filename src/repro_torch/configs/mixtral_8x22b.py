"""mixtral-8x22b [moe]: 56L, d_model 6144, 48H GQA kv=8, expert d_ff 16384,
vocab 32768, 8 experts top-2, sliding-window attention (arXiv:2401.04088).
SWA => sub-quadratic decode => runs the long_500k cell with an O(window)
ring cache. ``mixtral-8x22b-mwu`` selects the MWU LP router.
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=16384,
    vocab_size=32768,
    sliding_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=16384, ep_axis="matrix"),
)
