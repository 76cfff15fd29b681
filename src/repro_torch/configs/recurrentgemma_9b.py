"""recurrentgemma-9b [hybrid]: RG-LRU + local attention, 1 attn : 2 recurrent.

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000, local window 2048
[arXiv:2402.19427].  38 = 12 full (rglru, rglru, local) supergroups + 2
tail recurrent layers.  Sub-quadratic -> long_500k runs.
"""
from .base import ModelConfig, RULES_ZERO3

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_head=256,
    d_ff=12288,
    vocab=256000,
    block_pattern=("rglru", "rglru", "local"),
    local_window=2048,
    act="swiglu",
    tie_embeddings=True,
    microbatches=1,
    rules=dict(RULES_ZERO3),
)
