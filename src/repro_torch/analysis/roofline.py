"""Roofline terms for one NVIDIA H100 (counterpart of
``repro/analysis/roofline.py``).

The reference takes its terms from compiled TPU dry-run artifacts, with
v5e constants.  The port's dry run (``launch/dryrun.py``) builds no
compiled program: its FLOPs come from ``FlopCounterMode`` and its bytes
from ``analytic_hbm_bytes`` below (a copy of the reference's), and these
constants are the card's:

    t_compute    = flops / PEAK_FLOPS
    t_memory     = bytes / HBM_BW
    t_collective = collective_bytes / ICI_BW

One card runs no collectives, so ``t_collective`` is 0 and the
reference's HLO collective parser (``parse_collectives``) waits for the
dry run on a mesh of cards, the port's last slice (ROADMAP queue 1 item
6).
"""
from __future__ import annotations

from dataclasses import asdict, dataclass

# NVIDIA H100 80GB HBM3 (SXM5) at its 700 W limit
PEAK_FLOPS = 989e12          # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12             # HBM3 bytes/s
ICI_BW = 450e9               # NVLink 4 bytes/s per direction (no link on one card)
HBM_BYTES = 80e9             # device memory, as the card is sold (80 GB)


@dataclass
class CollectiveStats:
    op_counts: dict
    operand_bytes: float          # Σ operand sizes (per device)
    moved_bytes: float            # ring-algorithm traffic estimate
    top: list = None              # largest ops: (op, bytes, shape)


@dataclass
class Roofline:
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    t_compute_ms: float
    t_memory_ms: float
    t_collective_ms: float
    t_dominant_ms: float
    bottleneck: str
    model_flops: float
    model_flops_ratio: float     # MODEL_FLOPS / (flops_per_chip * chips)
    roofline_fraction: float     # useful-time / dominant-term (MFU/MBU proxy)
    useful_metric: str
    collective_ops: dict
    what_would_help: str = ""


def analyze(cost: dict, coll: CollectiveStats, n_chips: int,
            model_flops: float, useful_bytes_per_chip: float | None = None,
            kind: str = "train") -> Roofline:
    flops_pd = float(cost.get("flops", 0.0))
    bytes_pd = float(cost.get("bytes accessed", 0.0))
    t_c = flops_pd / PEAK_FLOPS
    t_m = bytes_pd / HBM_BW
    t_x = coll.operand_bytes / ICI_BW
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bottleneck = max(terms, key=terms.get)
    t_dom = terms[bottleneck]
    ratio = model_flops / max(flops_pd * n_chips, 1.0)

    if kind == "decode" and useful_bytes_per_chip:
        # decode is memory-bound by nature: usefulness = model-bytes / HBM
        useful_t = useful_bytes_per_chip / HBM_BW
        metric = "MBU"
    else:
        useful_t = model_flops / (n_chips * PEAK_FLOPS)
        metric = "MFU"
    frac = useful_t / max(t_dom, 1e-30)

    help_ = {
        "compute": "reduce non-model flops (remat/padding waste) or raise "
                   "tensor-core utilization via larger tiles",
        "memory": "cut HBM traffic: fuse, microbatch less aggressively, "
                  "quantize cache/weights, better layouts",
        "collective": "reshard to shrink collective operands, overlap "
                      "collectives with compute, or move the axis to "
                      "NVLink-cheaper dims",
    }[bottleneck]
    return Roofline(
        flops_per_chip=flops_pd, bytes_per_chip=bytes_pd,
        coll_bytes_per_chip=coll.operand_bytes,
        t_compute_ms=t_c * 1e3, t_memory_ms=t_m * 1e3,
        t_collective_ms=t_x * 1e3, t_dominant_ms=t_dom * 1e3,
        bottleneck=bottleneck, model_flops=model_flops,
        model_flops_ratio=ratio, roofline_fraction=min(frac, 1.0),
        useful_metric=metric, collective_ops=coll.op_counts,
        what_would_help=help_,
    )


def to_dict(r: Roofline) -> dict:
    return asdict(r)


# ---------------------------------------------------------------------------
# Analytic HBM traffic model, the reference's: every materialized tensor
# between fused regions counted once (MaxText-napkin style).  The port's
# dry run uses it for the memory term as the reference does.
# ---------------------------------------------------------------------------

def analytic_hbm_bytes(cfg, cell) -> float:
    """Global HBM bytes per step (sum over chips)."""
    B, S = cell.global_batch, cell.seq_len
    train = cell.kind == "train"
    decode = cell.kind == "decode"
    tokens = B * (1 if decode else S)
    act_b = 2 if cfg.dtype == "bfloat16" else 4
    pd_b = 4 if cfg.param_dtype == "float32" else 2
    kv_b = 1 if cfg.kv_cache_dtype == "int8" else act_b
    M = cfg.microbatches if train else 1
    n = cfg.n_params()
    n_active = cfg.n_active_params()

    # ---- weights + optimizer streams ----
    if train:
        # read per microbatch in fwd, remat-fwd and bwd; grad write f32 and
        # all-reduced read; optimizer moment read+write; param read+write.
        opt_b = 16 if cfg.optimizer == "adamw" else 6   # m,v vs factored
        w = n * (3 * M * pd_b + 2 * 4 + opt_b + 2 * pd_b)
    elif decode:
        w = n_active * pd_b                  # active experts only
    else:
        w = n * pd_b

    # ---- per-token per-layer activation streams (fwd) ----
    d, ff = cfg.d_model, cfg.d_ff
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    per_tok = 0.0
    for kind in cfg.layer_kinds:
        per_tok += 4 * d * act_b             # residual in/out + 2 norms
        if kind in ("attn", "local"):
            qkv = (hq + 2 * hkv) * dh
            per_tok += (2 * qkv + 2 * hq * dh + d) * act_b   # proj + attn io
        elif kind == "rglru":
            r = cfg.d_rnn
            per_tok += (6 * r + d) * act_b
        elif kind == "rwkv":
            per_tok += (8 * d + d) * act_b
        if kind != "rwkv":
            eff_ff = ff * (cfg.moe.top_k if cfg.moe else 1)
            n_in = 2 if cfg.act == "swiglu" else 1
            per_tok += (d + (n_in + 1) * eff_ff + d) * act_b
            if cfg.moe:
                per_tok += 2 * cfg.moe.n_experts * 4         # router probs
        else:
            per_tok += (2 * ff + 2 * d) * act_b
    act = tokens * per_tok * (3.0 if train else 1.0)  # fwd + remat + bwd

    # ---- embeddings / logits ----
    V = cfg.vocab
    emb = tokens * d * act_b * (2 if train else 1)
    if train:
        logits = B * S * V * 4 * 2           # f32 write fwd + read bwd
    elif decode:
        logits = B * V * 4
    else:
        logits = B * V * 4                   # last-position only

    # ---- kv / state cache traffic ----
    cache = 0.0
    for kind in cfg.layer_kinds:
        if kind in ("attn", "local"):
            span = min(cfg.local_window, S) if kind == "local" else S
            if decode:
                cache += B * span * 2 * hkv * dh * kv_b      # read cache
                cache += B * 2 * hkv * dh * kv_b             # write 1 token
            elif cell.kind == "prefill":
                cache += B * span * 2 * hkv * dh * kv_b      # write cache
        elif kind == "rglru" and decode:
            cache += B * cfg.d_rnn * 4 * 4
        elif kind == "rwkv" and decode:
            H = cfg.n_heads
            cache += B * H * (d // H) ** 2 * 4 * 2
    return w + act + emb + logits + cache
