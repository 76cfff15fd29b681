"""qwen1.5-32b [dense]: QKV bias, MHA-like GQA (kv=40).

64L d_model=5120 40H (kv=40) d_ff=27392 vocab=152064 [hf:Qwen/Qwen1.5].
40 heads do not divide the 16-way model axis: GSPMD pads the head axis
(visible as useful-flops ratio loss in the roofline; a hillclimb lever).
int8 KV cache keeps decode_32k under 16 GB/chip (40 kv heads x 64 layers).
"""
from .base import ModelConfig, RULES_ZERO3

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab=152064,
    qkv_bias=True,
    act="swiglu",
    kv_cache_dtype="int8",
    microbatches=1,
    rules=dict(RULES_ZERO3),
)
