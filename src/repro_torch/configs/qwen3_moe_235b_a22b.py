"""qwen3-moe-235b-a22b [moe]: 128 experts top-8.

94L d_model=4096 64H (GQA kv=4) d_head=128 d_ff=1536 vocab=151936
[hf:Qwen/Qwen3].  Largest assigned arch: FSDP+TP training sharding,
Adafactor, 2-D expert sharding for serving.
"""
from .base import MoEConfig, ModelConfig, RULES_TP_2D

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_head=128,
    d_ff=1536,
    vocab=151936,
    moe=MoEConfig(n_experts=128, top_k=8),
    act="swiglu",
    optimizer="adafactor",
    serve_rules=dict(RULES_TP_2D),
    microbatches=16,
)
