"""rwkv6-7b [ssm] "Finch": attention-free, data-dependent decay.

32L d_model=4096 d_ff=14336 vocab=65536 [arXiv:2404.05892].  Head size 64
(64 heads); time-mix + channel-mix per layer.  Sub-quadratic -> long_500k.
"""
from .base import ModelConfig, RULES_ZERO3

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,                 # rwkv6 head size 64
    n_kv_heads=64,
    d_head=64,
    d_ff=14336,
    vocab=65536,
    block_pattern=("rwkv",),
    act="squared_relu",         # rwkv channel-mix uses relu^2 internally
    microbatches=1,
    rules=dict(RULES_ZERO3),
)
