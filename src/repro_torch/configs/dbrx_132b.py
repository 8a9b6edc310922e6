"""dbrx-132b [moe]: 40L, d_model 6144, 48H GQA kv=8, expert d_ff 10752,
vocab 100352, 16 experts top-4 fine-grained (hf:databricks/dbrx-base).

Experts are sharded over the *data* axis for serving (a TP-16 shard of
132B bf16 exceeds v5e HBM — DESIGN.md §5); ``dbrx-132b-mwu`` selects the
MWU LP router (the paper's technique inside the model).
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=10752,
    vocab_size=100352,
    moe=MoEConfig(n_experts=16, top_k=4, d_ff=10752, ep_axis="data"),
)
