"""Dispatching wrappers: one call site per op (counterpart of
``repro/kernels/ops.py``).

Backends:

  * ``cuda``  — the hand-written Hopper kernel; CUDA tensors only.
  * ``torch`` — the plain PyTorch version beside the kernel (the twin of
                ``repro``'s ``_attention_xla`` / ``_decode_xla`` /
                ``_linear_scan_xla`` / ``_rwkv6_xla``); runs on any device.
  * ``ref``   — the naive oracle in :mod:`repro_torch.kernels.ref`.
  * ``auto``  — by the tensor's device: a CUDA tensor always takes the
                kernel, a CPU tensor takes ``torch``.
  * ``stub``  — the reference's dry-run stand-in: reads every input once
                and writes the true output shapes with no matrix product
                (``launch/dryrun.py`` counts the mixers' FLOPs
                analytically).

There is no fallback: a kernel that fails to build or launch raises.  No
kernel has a backward (nor has any of ``repro``'s), so the kernel path,
by name or through ``auto``, refuses inputs that need a gradient while
grad mode is on; a training step runs the ``torch`` backend, named.
"""
from __future__ import annotations

from typing import Literal

import torch

from . import decode_attention as _dec
from . import flash_attention as _fa
from . import ref as _ref
from . import rglru as _rglru
from . import rwkv6 as _rwkv6

Backend = Literal["auto", "cuda", "torch", "ref", "stub"]
BACKENDS = ("auto", "cuda", "torch", "ref", "stub")


def _resolve(backend: str, x, *inputs) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; have {BACKENDS}")
    if backend == "auto":
        backend = "cuda" if x.is_cuda else "torch"
    elif backend == "cuda" and not x.is_cuda:
        raise ValueError("backend='cuda' needs CUDA tensors; this one is on "
                         f"{x.device}")
    if backend == "cuda" and torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in (x,) + inputs):
        raise RuntimeError(
            "the CUDA kernels have no backward, so their output would carry "
            "no gradient to these inputs; build the model with "
            "backend='torch' to train, or run under torch.no_grad()")
    return backend


def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              block_kv: int = 1024, backend: Backend = "auto"):
    """Multi-head GQA attention. q: (B,Sq,Hq,D); k,v: (B,Skv,Hkv,D).

    ``block_kv`` is the kv tile of the ``torch`` version; the kernel
    fixes its own tiles."""
    b = _resolve(backend, q, k, v)
    if b == "stub":
        kv = (k.sum(1) + v.sum(1))[:, None]            # reads k, v fully
        return (q * kv.repeat_interleave(q.shape[2] // k.shape[2], 2)
                ).to(q.dtype)
    if b == "ref":
        return _ref.attention(q, k, v, causal=causal, window=window)
    if b == "cuda":
        return _fa.flash_attention(q, k, v, causal=causal, window=window)
    return _fa.attention_torch(q, k, v, causal=causal, window=window,
                               block_kv=block_kv)


def decode_attention(q, k_cache, v_cache, lengths, *,
                     backend: Backend = "auto"):
    """One query token per sequence over a (B, S, Hkv, D) cache; sequence
    b attends over its first ``lengths[b]`` positions."""
    b = _resolve(backend, q, k_cache, v_cache)
    if b == "stub":
        kv = (k_cache.sum(1) + v_cache.sum(1))[:, None]
        scale = (1 + lengths.to(q.dtype) * 0)[:, None, None, None]
        return (q * kv.repeat_interleave(q.shape[2] // k_cache.shape[2], 2)
                * scale).to(q.dtype)
    if b == "ref":
        return _ref.attention(q, k_cache, v_cache, causal=True,
                              lengths=lengths)
    if b == "cuda":
        return _dec.decode_attention(q, k_cache, v_cache, lengths)
    return _dec.decode_attention_torch(q, k_cache, v_cache, lengths)


def decode_attention_partials(q, k_chunk, v_chunk, lengths, offset=0, *,
                              backend: Backend = "auto"):
    """The decode attention's split pass over a chunk of a cache split by
    sequence (positions ``[offset, offset + S)``): f32 ``(ml, acc)``,
    (B, Hq, J, 2) and (B, Hq, J, D), for :func:`decode_attention_combine`
    (``kernels/decode_attention.py``)."""
    b = _resolve(backend, q, k_chunk, v_chunk)
    if b == "stub":                 # the kernel's J on the card (132 SMs)
        B, _, Hq, D = q.shape
        J = _dec.decode_splits(B, k_chunk.shape[2], k_chunk.shape[1])
        kv = (k_chunk.sum(1) + v_chunk.sum(1)).float()       # reads both
        acc = (q[:, 0].float() * kv.repeat_interleave(
            Hq // k_chunk.shape[2], 1))[:, :, None].expand(B, Hq, J, D)
        ml = (acc[..., :2] + lengths.float()[:, None, None, None] * 0)
        return ml.contiguous(), acc.contiguous()
    if b == "cuda":
        return _dec.decode_attention_partials(q, k_chunk, v_chunk, lengths,
                                              offset)
    return _dec.decode_attention_partials_torch(q, k_chunk, v_chunk,
                                                lengths, offset)


def decode_attention_combine(ml, acc, dtype, *, backend: Backend = "auto"):
    """Merge partials concatenated on their J axis into (B, 1, Hq, D) of
    ``dtype``."""
    b = _resolve(backend, acc, ml)
    if b == "stub":
        return (acc.sum(2) * ml[..., :1].sum(2))[:, None].to(dtype)
    if b == "cuda":
        return _dec.decode_attention_combine(ml, acc, dtype)
    return _dec.decode_attention_combine_torch(ml, acc, dtype)


def linear_scan(a, b, h0=None, *, backend: Backend = "auto"):
    """h_t = a_t h_{t-1} + b_t over axis 1 (the RG-LRU core).  a, b:
    (B, S, D); h0: (B, D) or None.  Returns (h_all in a's dtype, h_last
    float32)."""
    be = _resolve(backend, a, b, h0)
    if be == "stub":
        h = (a * b).to(a.dtype)                        # reads a, b; writes h
        last = h[:, -1].float() + (0.0 if h0 is None else h0.float())
        return h, last
    if be == "ref":
        return _ref.linear_scan(a, b, h0)
    if be == "cuda":
        return _rglru.rglru_scan(a, b, h0)
    return _rglru.linear_scan_torch(a, b, h0)


def rwkv6(r, k, v, w, u, state0=None, *, backend: Backend = "auto"):
    """The RWKV-6 matrix-state recurrence.  r, k, w: (B, T, H, D); v:
    (B, T, H, Dv); u: (H, D); state0: (B, H, D, Dv) or None.  Returns
    (y in v's dtype, final state float32)."""
    be = _resolve(backend, r, k, v, w, u, state0)
    if be == "stub":
        g = (r + k + w + u).sum(-1, keepdim=True)      # reads r, k, w, u
        y = (v * g).to(v.dtype)                        # reads v, writes y
        B, T, H, D = r.shape
        s0 = (torch.zeros((B, H, D, v.shape[-1]), dtype=torch.float32,
                          device=r.device)
              if state0 is None else state0.float())
        sT = s0 + (k.float().mean(1)[..., None]
                   * v.float().mean(1)[..., None, :])
        return y, sT
    if be == "ref":
        return _ref.rwkv6(r, k, v, w, u, state0)
    if be == "cuda":
        return _rwkv6.rwkv6_scan(r, k, v, w, u, state0)
    return _rwkv6.rwkv6_torch(r, k, v, w, u, state0)
