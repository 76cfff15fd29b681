"""internvl2-2b [vlm]: InternViT frontend (stubbed) + InternLM2-1.8b backbone.

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553 [arXiv:2404.16821].
The vision frontend is a STUB per the assignment: input_specs() provides
precomputed patch embeddings (1024-dim InternViT features) that a learned
projector maps into the first mm_prefix positions.
"""
from .base import ModelConfig, RULES_ZERO3

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92553,
    mm_prefix=1024,
    mm_embed_dim=1024,
    act="swiglu",
    microbatches=1,
    rules=dict(RULES_ZERO3),
)
