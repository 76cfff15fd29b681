"""llama3.2-3b [dense]: 28L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=128256 [hf:meta-llama].  rope theta 500k, tied embeddings."""
from .base import ModelConfig, RULES_ZERO3

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab=128256,
    rope_theta=500000.0,
    tie_embeddings=True,
    act="swiglu",
    microbatches=1,
    rules=dict(RULES_ZERO3),
)
