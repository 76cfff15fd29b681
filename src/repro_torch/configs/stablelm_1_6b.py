"""stablelm-1.6b [dense]: 24L d_model=2048 32H (MHA kv=32) d_ff=5632
vocab=100352 [hf:stabilityai/stablelm-2-1_6b]."""
from .base import ModelConfig, RULES_ZERO3

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab=100352,
    act="swiglu",
    microbatches=1,
    rules=dict(RULES_ZERO3),
)
