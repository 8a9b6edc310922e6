"""mamba2-1.3b [ssm]: 48L, d_model 2048, attention-free, vocab 50280,
ssm_state=128 (arXiv:2405.21060). SSD layers only (d_ff=0). Sub-quadratic
=> runs the long_500k cell. Vocab padded 50280 -> 50432 for 16-way TP
(DESIGN.md §3).
"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    tie_embeddings=True,
)
