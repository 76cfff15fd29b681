"""KV-cache storage: full or ring-buffer (local attention), bf16/f32 or
int8 (counterpart of ``repro/models/kvcache.py``).

A cache *layer view* is a dict ``{"data": (B, S, Hkv, D)}`` plus, when
quantized, ``{"scale": (B, S, Hkv, 1) float32}``; int8 quantization is
per (position, head) absmax.  Ring buffers exploit softmax permutation
invariance: slots are overwritten modulo the window and masking is by
valid count only.

Unlike the reference, whose arrays are immutable, :func:`insert` and
:func:`write_prefill` write into the tensors they are given: a decode step
then updates its cache in place instead of copying every layer's cache.
"""
from __future__ import annotations

import torch


def init_layer(batch: int, seq: int, n_kv: int, d: int, dtype: str,
               device=None):
    if dtype == "int8":
        return {"data": torch.zeros((batch, seq, n_kv, d), dtype=torch.int8,
                                    device=device),
                "scale": torch.zeros((batch, seq, n_kv, 1),
                                     dtype=torch.float32, device=device)}
    return {"data": torch.zeros((batch, seq, n_kv, d),
                                dtype=getattr(torch, dtype), device=device)}


def size(layer) -> int:
    return layer["data"].shape[1]


def select(cache: dict, row: int) -> dict:
    """Batch row ``row`` of every tensor of a cache dict, as views sharing
    its storage: a layer view, a layer's ``{"k", "v"}`` pair of them, or a
    recurrent layer's state."""
    return {name: (select(x, row) if isinstance(x, dict) else x[row:row + 1])
            for name, x in cache.items()}


def _quant(x):
    """x: (..., D) -> (int8 data, f32 scale(..., 1))."""
    xf = x.float()
    scale = xf.abs().amax(-1, keepdim=True).clamp_min(1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequant(layer):
    if "scale" in layer:
        return (layer["data"].float() * layer["scale"]).to(torch.bfloat16)
    return layer["data"]


def _store(layer, index, x):
    if "scale" in layer:
        q, s = _quant(x)
        layer["data"][index] = q
        layer["scale"][index] = s
    else:
        layer["data"][index] = x.to(layer["data"].dtype)


def insert(layer, new, lengths, window: int | None = None):
    """Insert one token's kv in place. new: (B, Hkv, D); lengths: (B,)
    tokens cached.  Returns ``layer``."""
    slot = (lengths % size(layer) if window is not None else lengths).long()
    rows = torch.arange(new.shape[0], device=new.device)
    _store(layer, (rows, slot), new)
    return layer


def write_prefill(layer, x, window: int | None = None):
    """Write prefill-computed k or v, (B, S, Hkv, D), into ``layer`` in
    place.  For local attention only the last ``size(layer)`` positions
    are kept, at slot = pos % size so later inserts line up."""
    S = x.shape[1]
    if window is not None:
        cap = size(layer)
        take = min(S, cap)
        pos = torch.arange(S - take, S, device=x.device) % cap
        _store(layer, (slice(None), pos), x[:, S - take:])
    else:
        _store(layer, (slice(None), slice(0, S)), x)
    return layer


def from_prefill(k, v, capacity: int, dtype: str, window: int | None = None):
    """Build cache layers from prefill-computed k, v: (B, S, Hkv, D)."""
    B, S, H, D = k.shape
    cap = min(window, capacity) if window is not None else capacity
    return tuple(write_prefill(init_layer(B, cap, H, D, dtype, x.device), x,
                               window) for x in (k, v))
