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

One card runs no collectives (``t_collective`` 0).  On a mesh the dry
run records the collectives of one pass of the tensor-parallel model on
``meta`` (``models/collectives.py``), writes them as HLO lines and reads
them with :func:`parse_collectives`, the reference's parser and per-op
formulas; ``t_collective`` is then the ring-moved bytes over ``ICI_BW``
(NVLink 4).
"""
from __future__ import annotations

import re
from dataclasses import asdict, dataclass

# NVIDIA H100 80GB HBM3 (SXM5) at its 700 W limit
PEAK_FLOPS = 989e12          # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12             # HBM3 bytes/s
ICI_BW = 450e9               # NVLink 4 bytes/s per direction
HBM_BYTES = 80e9             # device memory, as the card is sold (80 GB)


@dataclass
class CollectiveStats:
    op_counts: dict
    operand_bytes: float          # Σ operand sizes (per device)
    moved_bytes: float            # ring-algorithm traffic estimate
    top: list = None              # largest ops: (op, bytes, shape)


_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}

_COLL_RE = re.compile(
    r"=\s+(?:\()?(\w+)\[([\d,]*)\][^\s]*\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(")
_TUPLE_COLL_RE = re.compile(
    r"=\s+\(([^)]*)\)\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)")
_GROUPS_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(dtype: str, dims: str) -> float:
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


def parse_collectives(hlo_text: str) -> CollectiveStats:
    """Op counts, per-device operand bytes and ring-moved bytes of the
    collectives in HLO text (the reference's parser, line for line): an
    all-reduce of R result bytes over g ranks moves 2 R (g - 1) / g, an
    all-gather R (g - 1) / g of an R / g operand, a reduce-scatter R (g -
    1) of an R g operand, an all-to-all R (g - 1) / g."""
    counts: dict[str, int] = {}
    operand_bytes = 0.0
    moved = 0.0
    top: list = []
    for line in hlo_text.splitlines():
        if "all-reduce" not in line and "all-gather" not in line \
                and "reduce-scatter" not in line and "all-to-all" not in line \
                and "collective-permute" not in line:
            continue
        m = _COLL_RE.search(line)
        shapes = []
        if m:
            op = m.group(3)
            shapes = [(m.group(1), m.group(2))]
        else:
            mt = _TUPLE_COLL_RE.search(line)
            if not mt:
                continue
            op = mt.group(2)
            shapes = _SHAPE_RE.findall(mt.group(1))
        if line.strip().startswith("%") and "-done" in line.split("=")[0]:
            continue                    # async -done pairs with -start
        gm = _GROUPS_RE.search(line)
        gsize = int(gm.group(2)) if gm else 1
        res = sum(_shape_bytes(dt, dims) for dt, dims in shapes)
        if op == "all-reduce":
            operand = res
            ring = 2 * res * (gsize - 1) / max(gsize, 1)
        elif op == "all-gather":
            operand = res / max(gsize, 1)
            ring = res * (gsize - 1) / max(gsize, 1)
        elif op == "reduce-scatter":
            operand = res * gsize
            ring = res * (gsize - 1)
        elif op == "all-to-all":
            operand = res
            ring = res * (gsize - 1) / max(gsize, 1)
        else:                           # collective-permute
            operand = res
            ring = res
        counts[op] = counts.get(op, 0) + 1
        operand_bytes += operand
        moved += ring
        top.append((op, operand, "/".join(f"{dt}[{dims}]"
                                          for dt, dims in shapes)))
    top.sort(key=lambda t: -t[1])
    return CollectiveStats(counts, operand_bytes, moved, top[:8])


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
