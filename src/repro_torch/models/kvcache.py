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

On a mesh whose rules split ``kv_seq`` (``serve_rules``: over "model") a
rank holds a :class:`Chunk`: slots ``[offset, offset + size)`` of the
cache's ``capacity`` slots, every kv head.  Slots are the one-device
cache's (a ring layer's too: slot = position % capacity), so a write
lands on the rank whose chunk holds its slot and every other rank leaves
its chunk as it was.
"""
from __future__ import annotations

import torch


class Chunk(dict):
    """A layer view holding slots ``[offset, offset + size)`` of a cache of
    ``full`` slots split by sequence over mesh ``axis``."""

    def __init__(self, tensors: dict, offset: int, full: int, axis):
        super().__init__(tensors)
        self.offset, self.full, self.axis = offset, full, axis


def new_layer(batch: int, seq: int, n_kv: int, d: int, dtype: str,
              device=None, seq_split=(None, 1, 0)):
    """:func:`init_layer`, or with ``seq_split = (axis, parts, index)``
    of more than one part, this rank's :class:`Chunk` of it."""
    axis, parts, index = seq_split
    if parts == 1:
        return init_layer(batch, seq, n_kv, d, dtype, device)
    size = seq // parts
    return Chunk(init_layer(batch, size, n_kv, d, dtype, device),
                 index * size, seq, axis)


def capacity(layer) -> int:
    """Slots of the whole cache (of every rank's chunks together)."""
    return layer.full if isinstance(layer, Chunk) else size(layer)


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
    its storage: a layer view (a :class:`Chunk` stays one), a layer's
    ``{"k", "v"}`` pair of them, or a recurrent layer's state."""
    out = {name: (select(x, row) if isinstance(x, dict) else x[row:row + 1])
           for name, x in cache.items()}
    if isinstance(cache, Chunk):
        return Chunk(out, cache.offset, cache.full, cache.axis)
    return out


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
    tokens cached.  Returns ``layer``.  A :class:`Chunk` takes the rows
    whose slot it holds and keeps its old values in the others."""
    slot = (lengths % capacity(layer) if window is not None
            else lengths).long()
    rows = torch.arange(new.shape[0], device=new.device)
    if not isinstance(layer, Chunk):
        _store(layer, (rows, slot), new)
        return layer
    local = slot - layer.offset
    mine = ((local >= 0) & (local < size(layer)))[:, None, None]
    index = (rows, local.clamp(0, size(layer) - 1))
    if "scale" in layer:
        q, s = _quant(new)
        layer["data"][index] = torch.where(mine, q, layer["data"][index])
        layer["scale"][index] = torch.where(mine, s, layer["scale"][index])
    else:
        layer["data"][index] = torch.where(
            mine, new.to(layer["data"].dtype), layer["data"][index])
    return layer


def write_prefill(layer, x, window: int | None = None):
    """Write prefill-computed k or v, (B, S, Hkv, D), into ``layer`` in
    place.  For local attention only the last ``size(layer)`` positions
    are kept, at slot = pos % size so later inserts line up.  A
    :class:`Chunk` takes the positions whose slots it holds."""
    S = x.shape[1]
    if isinstance(layer, Chunk):
        cap = layer.full
        take = min(S, cap) if window is not None else S
        pos = torch.arange(S - take, S)             # on the host
        local = pos % cap - layer.offset
        mine = (local >= 0) & (local < size(layer))
        pos, local = pos[mine].to(x.device), local[mine].to(x.device)
        _store(layer, (slice(None), local), x[:, pos])
        return layer
    if window is not None:
        cap = size(layer)
        take = min(S, cap)
        pos = torch.arange(S - take, S, device=x.device) % cap
        _store(layer, (slice(None), pos), x[:, S - take:])
    else:
        _store(layer, (slice(None), slice(0, S)), x)
    return layer


def from_prefill(k, v, capacity: int, dtype: str, window: int | None = None,
                 seq_split=None):
    """Build cache layers from prefill-computed k, v: (B, S, Hkv, D).
    ``seq_split(slots)`` gives the ``(axis, parts, index)`` of a cache of
    that many slots on a mesh (:func:`new_layer`)."""
    B, S, H, D = k.shape
    cap = min(window, capacity) if window is not None else capacity
    split = (None, 1, 0) if seq_split is None else seq_split(cap)
    return tuple(write_prefill(new_layer(B, cap, H, D, dtype, x.device,
                                         split), x, window)
                 for x in (k, v))
