"""Model/run configuration system.

One :class:`ModelConfig` fully describes an architecture (family, dims,
block pattern, MoE, modality stubs), its numerics (dtypes, remat, scan) and
its sharding rules (logical-axis -> mesh-axis mapping, MaxText style).  Every
assigned architecture ships a full config and a reduced ``smoke()`` config of
the same family for CPU tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Mapping, Sequence

# ---------------------------------------------------------------------------
# Sharding rule sets: logical axis -> mesh axis (or tuple / None).
# "fsdp" style additionally shards the big weight dim over the data axis.
# ---------------------------------------------------------------------------
RULES_TP = {
    "batch": ("pod", "data"),
    "seq": None,
    # decode KV-cache sequence axis: always divisible by the model axis
    # (32k/512k/window), unlike small GQA head counts -> shard it there.
    "kv_seq": "model",
    "embed": None,
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "expert_mlp": None,
    #: MoE dispatch-buffer capacity dim — sharding it over data keeps the
    #: (E, C, d) buffers from replicating across the data axis.
    "expert_capacity": "data",
    "rnn": "model",
    "layers": None,
}
RULES_FSDP_TP = dict(RULES_TP, embed="data")
#: serving variant for very large models: expert/mlp inner dim additionally
#: sharded over the data axis (2-D weight sharding).
RULES_TP_2D = dict(RULES_TP, expert_mlp="data")
#: ZeRO-3 / fully-data-parallel training: both mesh axes act as data
#: parallelism, parameters are stored fully sharded (over data+model on
#: their "embed" dim) and gathered per layer at use (weight_use), so the
#: per-layer Megatron TP activation all-reduces disappear entirely.  The
#: right regime for <=32B dense models at 4k sequence on 256 chips.
RULES_ZERO3 = {
    "batch": ("pod", "data", "model"),
    "seq": None,
    "kv_seq": "model",
    "embed": ("data", "model"),
    "vocab": None,
    "heads": None,
    "kv_heads": None,
    "head_dim": None,
    "mlp": None,
    "experts": None,
    "expert_mlp": None,
    "expert_capacity": ("data", "model"),
    "rnn": None,
    "layers": None,
}


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    router_z_weight: float = 1e-3


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | encoder | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                 # 0 -> d_model // n_heads
    moe: MoEConfig | None = None
    #: repeating block pattern; "attn" | "local" | "rglru" | "rwkv".
    block_pattern: tuple[str, ...] = ("attn",)
    bidirectional: bool = False     # encoder-only (no causal mask, no decode)
    local_window: int = 2048
    act: str = "swiglu"             # swiglu | squared_relu | gelu
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    #: RG-LRU branch width (hybrid family); 0 -> d_model.
    d_rnn: int = 0
    #: multimodal stub: first mm_prefix positions take precomputed embeddings
    #: (projected from mm_embed_dim); used by [vlm].  [audio]/encoder uses
    #: embeds-only input (no token ids) when embeds_only is set.
    mm_prefix: int = 0
    mm_embed_dim: int = 0
    embeds_only: bool = False
    # ---- numerics & memory ----
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    scan_layers: bool = True
    kv_cache_dtype: str = "bfloat16"    # or "int8"
    attn_block_q: int = 1024
    attn_block_kv: int = 1024
    # ---- distribution ----
    rules: Mapping[str, object] = field(
        default_factory=lambda: dict(RULES_FSDP_TP))
    serve_rules: Mapping[str, object] = field(
        default_factory=lambda: dict(RULES_TP))
    # ---- training ----
    microbatches: int = 1
    optimizer: str = "adamw"        # adamw | adafactor
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    z_loss: float = 1e-4

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.d_rnn == 0:
            object.__setattr__(self, "d_rnn", self.d_model)
        if self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be a multiple of n_kv_heads")
        for b in self.block_pattern:
            if b not in ("attn", "local", "rglru", "rwkv"):
                raise ValueError(f"unknown block kind {b!r}")
        if self.family == "moe" and self.moe is None:
            raise ValueError("moe family requires MoEConfig")

    # ------------------------------------------------------------------
    @property
    def layer_kinds(self) -> tuple[str, ...]:
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

    @property
    def sub_quadratic(self) -> bool:
        """True if no layer uses full (global) attention — long_500k eligible."""
        return all(k in ("local", "rglru", "rwkv") for k in self.layer_kinds)

    @property
    def has_decode(self) -> bool:
        return not self.bidirectional

    def n_params(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab
        hq, hkv, dh = self.n_heads, self.n_kv_heads, self.d_head
        total = V * d                       # embedding
        if not self.tie_embeddings:
            total += V * d                  # unembedding
        for kind in self.layer_kinds:
            if kind in ("attn", "local"):
                total += d * hq * dh + 2 * d * hkv * dh + hq * dh * d
                if self.qkv_bias:
                    total += (hq + 2 * hkv) * dh
            elif kind == "rglru":
                r = self.d_rnn
                total += 2 * d * r + r * d   # in / gate / out projections
                total += 2 * r * r           # recurrence + input gates
                total += 8 * r               # conv1d(4) + Λ + biases
            elif kind == "rwkv":
                total += 4 * d * d + d * d  # r,k,v,g,o projections
                total += 2 * d              # decay/bonus params per channel
            # channel mix / MLP
            if self.moe is not None:
                total += d * self.moe.n_experts  # router
                n_mats = 3 if self.act == "swiglu" else 2
                total += self.moe.n_experts * n_mats * d * ff
            else:
                n_mats = 3 if self.act == "swiglu" else 2
                total += n_mats * d * ff
            total += 2 * d                  # norms
        return total

    def n_active_params(self) -> int:
        """Parameters touched per token (MoE: top-k experts only)."""
        if self.moe is None:
            return self.n_params()
        full = self.n_params()
        n_mats = 3 if self.act == "swiglu" else 2
        per_layer_experts = self.moe.n_experts * n_mats * self.d_model * self.d_ff
        active = (self.moe.top_k / self.moe.n_experts) * per_layer_experts
        return int(full - self.n_layers * per_layer_experts
                   + self.n_layers * active)

    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test sibling: same family/pattern, tiny dims."""
        pat = self.block_pattern
        small = dict(
            n_layers=max(2, 2 * len(pat)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads > 1 else 1,
            d_head=16,
            d_ff=128,
            vocab=256,
            d_rnn=64,
            local_window=32,
            mm_prefix=4 if self.mm_prefix else 0,
            mm_embed_dim=32 if self.mm_embed_dim else 0,
            dtype="float32",
            param_dtype="float32",
            kv_cache_dtype="float32",
            microbatches=1,
            name=self.name + "-smoke",
        )
        if self.moe is not None:
            # generous capacity so reduced-config decode is drop-free and
            # prefill+decode consistency is exact
            small["moe"] = MoEConfig(n_experts=4, top_k=2,
                                     capacity_factor=8.0)
        small.update(overrides)
        return dataclasses.replace(self, **small)


# ---------------------------------------------------------------------------
# Input shape cells (assigned): every LM arch is paired with all four.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cell_supported(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """(runnable, reason-if-skipped) per the assignment's skip rules."""
    cell = SHAPES[shape]
    if cell.kind == "decode" and not cfg.has_decode:
        return False, "encoder-only arch has no decode step"
    if shape == "long_500k":
        if any(k == "attn" for k in cfg.layer_kinds):
            return False, ("pure full-attention arch: 512k decode requires "
                           "sub-quadratic attention")
    return True, ""
