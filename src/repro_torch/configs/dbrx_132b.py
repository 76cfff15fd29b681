"""dbrx-132b [moe]: 16 experts top-4, fine-grained.

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352
[hf:databricks/dbrx-base].  Adafactor for optimizer-state memory; expert
weights 2-D sharded for serving (experts->model, expert_mlp->data).
"""
from .base import MoEConfig, ModelConfig, RULES_TP_2D

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab=100352,
    moe=MoEConfig(n_experts=16, top_k=4),
    act="swiglu",
    optimizer="adafactor",
    serve_rules=dict(RULES_TP_2D),
    microbatches=16,
)
