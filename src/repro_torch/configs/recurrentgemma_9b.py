"""recurrentgemma-9b [hybrid]: 38L, d_model 4096, 16H MQA kv=1,
d_ff 12288, vocab 256000 (arXiv:2402.19427) — RG-LRU + local attention,
pattern (recurrent, recurrent, local-attn). Sub-quadratic (state + 2048
window) => runs the long_500k cell.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_head=256,
    d_ff=12288,
    vocab_size=256000,
    sliding_window=2048,
    block_pattern=("rglru", "rglru", "attn"),
    rnn_width=4096,
    mlp_type="swiglu",
)
