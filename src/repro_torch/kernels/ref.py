"""Plain-PyTorch attention oracle (counterpart of ``repro/kernels/ref.py``).

Naive O(S^2)-memory attention in float32, no blocking: the semantic
ground truth the kernels and their plain versions are tested against.
Only the attention oracle is ported in this slice.
"""
from __future__ import annotations

import math

import torch


def _gqa_expand(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B,S,Hkv,D) -> (B,S,Hq,D) by repeating kv heads."""
    return k.repeat_interleave(n_heads // k.shape[2], dim=2)


def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              lengths=None):
    """Reference attention.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, Dk/Dv).  GQA via head repetition.
    ``window``: local attention — position i attends to [i-window+1, i]
    (combined with causal).  ``lengths``: (B,) valid kv lengths (decode).
    For Sq < Skv the queries are the *last* Sq positions (decode offset).
    Fully masked rows give 0.
    """
    b, sq, hq, d = q.shape
    skv = k.shape[1]
    k = _gqa_expand(k, hq)
    v = _gqa_expand(v, hq)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float()) / math.sqrt(d)
    dev = q.device
    q_pos = torch.arange(sq, device=dev) + (skv - sq)
    k_pos = torch.arange(skv, device=dev)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=dev)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    mask = mask[None, None].expand(logits.shape)
    if lengths is not None:
        valid = k_pos[None, :] < lengths.to(dev)[:, None]     # (B, Skv)
        mask = mask & valid[:, None, None, :]
    logits = logits.masked_fill(~mask, -math.inf)
    w = torch.nan_to_num(torch.exp(logits - logits.amax(-1, keepdim=True)))
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v.float())
    return out.to(q.dtype)
