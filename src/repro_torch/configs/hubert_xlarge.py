"""hubert-xlarge [audio]: encoder-only, bidirectional attention.

48L d_model=1280 16H (MHA kv=16) d_ff=5120 vocab=504 (k-means units)
[arXiv:2106.07447].  The CNN feature extractor is a STUB per the
assignment: input_specs() provides precomputed frame embeddings.
Encoder-only -> no decode shapes.
"""
from .base import ModelConfig, RULES_ZERO3

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="encoder",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    bidirectional=True,
    embeds_only=True,
    act="gelu",
    microbatches=1,
    rules=dict(RULES_ZERO3),
)
