"""Peaks of one H100 and the operations and bytes of the served work,
counted from shapes.

``bound`` is copied from ``chip_smoke.py`` (``bound()``: the least time
the card could take, the larger of operations over the peak rate and
bytes over the peak bandwidth), frozen here so that a change to the
program cannot move it.  The counts are the benchmark's own: each input
byte read once and each output byte written once, and for attention only
the positions a query may see.
"""
from __future__ import annotations

import numpy as np

PEAK_BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor-core rate, 700 W
PEAK_BYTES = 3.35e12            # H100 SXM HBM3 bytes/s
BF16 = 2


def bound(flops: float, nbytes: float,
          peak_flops: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    """(milliseconds, "operations" or "bytes"): the bound and what sets it."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def layer_matmul_params(arch: dict) -> int:
    """Weights one token multiplies by in one layer (attention projections
    and MLP; norms left out)."""
    d, hq, hkv, dh, ff = (arch["d_model"], arch["n_heads"], arch["n_kv_heads"],
                          arch["d_head"], arch["d_ff"])
    mlp = (3 if arch["act"] == "swiglu" else 2) * d * ff
    return d * (hq + 2 * hkv) * dh + hq * dh * d + mlp


def attention_flops(arch: dict, queries: int, first_key_count: int) -> float:
    """Q.K^T and P.V of ``queries`` consecutive causal queries, the first
    seeing ``first_key_count`` keys, over every layer."""
    keys = queries * first_key_count + queries * (queries - 1) / 2
    return 4.0 * arch["n_heads"] * arch["d_head"] * keys * arch["n_layers"]


def head_flops(arch: dict) -> float:
    return 2.0 * arch["d_model"] * arch["vocab"]


def prefill_flops(arch: dict, S: int) -> float:
    """One prompt of ``S`` tokens: every layer's products, causal
    attention, and the head at the last position (what the engine keeps)."""
    return (2.0 * layer_matmul_params(arch) * arch["n_layers"] * S
            + attention_flops(arch, S, 1) + head_flops(arch))


def decode_flops(arch: dict, lengths) -> float:
    """One decode step of the sequences whose cached lengths are
    ``lengths`` (one new token each)."""
    lengths = np.asarray(lengths, np.float64)
    n = len(lengths)
    per_token = 2.0 * layer_matmul_params(arch) * arch["n_layers"] + head_flops(arch)
    attn = (4.0 * arch["n_heads"] * arch["d_head"] * arch["n_layers"]
            * (lengths + 1).sum())
    return n * per_token + attn


def flash_bound_ms(arch: dict, S: int) -> float:
    """The bound of one layer's causal attention over a prompt of ``S``
    tokens: ops of the causal triangle, bytes of q, k, v and o in bf16."""
    hq, hkv, dh = arch["n_heads"], arch["n_kv_heads"], arch["d_head"]
    ops = attention_flops(dict(arch, n_layers=1), S, 1)
    nbytes = (2 * S * hq * dh + 2 * S * hkv * dh) * BF16
    return bound(ops, nbytes)[0]


def decode_attention_bound_ms(arch: dict, lengths) -> float:
    """The bound of one layer's decode attention over slots whose cached
    lengths are ``lengths`` (every slot of the step, an empty one reading
    its one new row): k and v rows read, q read and o written, in bf16."""
    hq, hkv, dh = arch["n_heads"], arch["n_kv_heads"], arch["d_head"]
    rows = (np.asarray(lengths, np.int64) + 1).sum()
    nbytes = (2 * rows * hkv * dh + 2 * len(lengths) * hq * dh) * BF16
    ops = 4.0 * hq * dh * rows
    return bound(ops, nbytes)[0]
