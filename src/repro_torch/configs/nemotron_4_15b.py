"""nemotron-4-15b [dense]: GQA + squared-ReLU MLP.

32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000 [arXiv:2402.16819].
"""
from .base import ModelConfig, RULES_ZERO3

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab=256000,
    act="squared_relu",
    microbatches=1,
    rules=dict(RULES_ZERO3),
)
