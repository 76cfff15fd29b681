"""Export a model (config × input shape) as a schedulable DNN graph.

This is the bridge from the model substrate to the HaX-CoNN core: layers
are grouped into atomic units (supergroup-aligned chunks; embedding and the
logits head are their own groups since transitions there are natural
pipeline points), each carrying analytic FLOPs / HBM bytes / boundary
activation sizes — the same quantities §3.2 measures with IProfiler on the
SoC, derived here from the architecture (and cross-checked against the
dry-run probes).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.core.accelerators import Platform
from repro_torch.core.characterize import GroupCosts, characterize
from repro_torch.core.graph import DNNGraph


def _layer_flops(cfg: ModelConfig, kind: str, tokens: int, kv_len: float
                 ) -> float:
    d, ff = cfg.d_model, cfg.d_ff
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    fl = 0.0
    if kind in ("attn", "local"):
        fl += 2 * tokens * d * (hq + 2 * hkv) * dh       # qkv proj
        fl += 2 * tokens * hq * dh * d                   # out proj
        span = min(cfg.local_window, kv_len) if kind == "local" else kv_len
        fl += 4 * tokens * hq * span * dh                # QK^T + PV
    elif kind == "rglru":
        r = cfg.d_rnn
        fl += 2 * tokens * (2 * d * r + r * d + 2 * r * r) + 10 * tokens * r
    elif kind == "rwkv":
        fl += 2 * tokens * 5 * d * d
        fl += 6 * tokens * cfg.n_heads * (d // cfg.n_heads) ** 2
    if kind != "rwkv":
        n_mats = 3 if cfg.act == "swiglu" else 2
        eff = cfg.moe.top_k if cfg.moe else 1
        fl += 2 * tokens * n_mats * d * ff * eff
        if cfg.moe:
            fl += 2 * tokens * d * cfg.moe.n_experts
    else:
        fl += 2 * tokens * 2 * d * ff
    return fl


def _layer_bytes(cfg: ModelConfig, kind: str, tokens: int, kv_len: float,
                 decode: bool) -> float:
    d, ff = cfg.d_model, cfg.d_ff
    act_b = 2
    w_b = 2                                               # serving bf16
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    kv_b = 1 if cfg.kv_cache_dtype == "int8" else 2
    by = 0.0
    # weights touched once
    if kind in ("attn", "local"):
        by += ((hq + 2 * hkv) * dh * d + hq * dh * d) * w_b
    elif kind == "rglru":
        by += (3 * d * cfg.d_rnn + 2 * cfg.d_rnn ** 2) * w_b
    elif kind == "rwkv":
        by += 5 * d * d * w_b
    if kind != "rwkv":
        n_mats = 3 if cfg.act == "swiglu" else 2
        n_exp = cfg.moe.n_experts if (cfg.moe and not decode) else \
            (cfg.moe.top_k if cfg.moe else 1)
        by += n_mats * d * ff * n_exp * w_b
    else:
        by += 2 * d * ff * w_b
    # activations
    by += tokens * (8 * d + 2 * ff) * act_b
    # kv cache
    if kind in ("attn", "local"):
        span = min(cfg.local_window, kv_len) if kind == "local" else kv_len
        if decode:
            by += tokens * span * 2 * hkv * dh * kv_b
        else:
            by += tokens * 2 * hkv * dh * kv_b            # write
    return by


def export_graph(cfg: ModelConfig, cell: ShapeCell, platform: Platform,
                 layers_per_group: int | None = None,
                 name: str | None = None) -> DNNGraph:
    decode = cell.kind == "decode"
    tokens = cell.global_batch * (1 if decode else cell.seq_len)
    kv_len = cell.seq_len
    P = len(cfg.block_pattern)
    if layers_per_group is None:
        layers_per_group = max(P, (cfg.n_layers + 7) // 8 // P * P or P)
    act_out = tokens * cfg.d_model * 2                    # boundary bytes

    act_b = 2
    costs = [GroupCosts(
        name="embed",
        flops=2.0 * tokens * cfg.d_model,
        hbm_bytes=tokens * cfg.d_model * 2 + cfg.vocab * cfg.d_model * 2
        / max(1, cfg.vocab // 4096),       # gathered rows only
        shared_bytes=tokens * cfg.d_model * act_b,
        out_bytes=act_out,
    )]
    kinds = cfg.layer_kinds
    i = 0
    gi = 0
    while i < len(kinds):
        span = kinds[i:i + layers_per_group]
        fl = sum(_layer_flops(cfg, k, tokens, kv_len) for k in span)
        by = sum(_layer_bytes(cfg, k, tokens, kv_len, decode) for k in span)
        # shared (ICI) traffic: ~2 activation all-reduces per layer under
        # TP serving, plus the EP all-to-all for MoE layers.
        coll = len(span) * 2 * tokens * cfg.d_model * act_b
        if cfg.moe is not None:
            coll += len(span) * 2 * tokens * cfg.moe.top_k \
                * cfg.d_model * act_b
        costs.append(GroupCosts(
            name=f"L{i}-{i + len(span) - 1}",
            flops=fl, hbm_bytes=by, shared_bytes=coll, out_bytes=act_out,
        ))
        i += len(span)
        gi += 1
    head_tokens = cell.global_batch if cell.kind != "train" else tokens
    costs.append(GroupCosts(
        name="head",
        flops=2.0 * head_tokens * cfg.d_model * cfg.vocab,
        hbm_bytes=cfg.d_model * cfg.vocab * 2 + head_tokens * cfg.vocab * 4,
        shared_bytes=head_tokens * cfg.d_model * 4,
        out_bytes=head_tokens * cfg.vocab * 4,
    ))
    return characterize(name or f"{cfg.name}:{cell.name}", platform, costs)
