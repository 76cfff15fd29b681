"""Plain-PyTorch oracles (counterpart of ``repro/kernels/ref.py``).

The semantic ground truth the kernels and their plain versions are tested
against: naive O(S^2)-memory attention in float32, the PCCS slowdown
surface as a hat-basis contraction, and the annealing select step.  The
recurrent-scan oracles are not ported yet.
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


def piecewise_slowdown(own, ext, own_knots, ext_knots, table):
    """Reference batched piecewise-linear PCCS slowdown surface.

    Bilinear interpolation of ``table`` over the (own, ext) grid with
    clamped extension outside, as a tensor product of 1-D hat bases:
    ``s = sum_i sum_j hat_i(own) hat_j(ext) table[i, j]``.  Zero own or
    external demand is the identity (slowdown 1).
    """
    shape = own.shape
    ho = _hat_weights(own_knots.to(own.dtype), own.reshape(-1))
    he = _hat_weights(ext_knots.to(ext.dtype), ext.reshape(-1))
    s = torch.einsum("bk,km,bm->b", ho, table.to(own.dtype), he)
    s = s.reshape(shape)
    return torch.where((own <= 0.0) | (ext <= 0.0), torch.ones_like(s), s)


def _hat_weights(knots, x):
    """(B, K) linear-interpolation hat weights of x against sorted knots.

    Row b holds the barycentric weights of ``x[b]``: for x inside
    ``[knots[i], knots[i+1]]`` exactly hats i and i+1 are non-zero and sum
    to 1; outside the grid the nearest end knot gets weight 1 (clamping).
    """
    k = knots[None, :]
    kprev = torch.cat([knots[:1], knots[:-1]])[None, :]
    knext = torch.cat([knots[1:], knots[-1:]])[None, :]
    xb = x[:, None]
    tiny = torch.tensor(1e-30, dtype=x.dtype, device=x.device)
    up = (xb - kprev) / torch.maximum(k - kprev, tiny)       # rising edge
    dn = (knext - xb) / torch.maximum(knext - k, tiny)       # falling edge
    h = torch.clamp(torch.minimum(up, dn), 0.0, 1.0)
    n = knots.shape[0]
    col = torch.arange(n, device=x.device)[None, :]
    one = torch.ones((), dtype=x.dtype, device=x.device)
    h = torch.where((col == 0) & (xb <= knots[0]), one, h)
    h = torch.where((col == n - 1) & (xb >= knots[-1]), one, h)
    return h


def anneal_select(cur, prop, best, cur_obj, prop_obj, best_obj, u, temp):
    """Reference Metropolis accept + incumbent select over a population.

    ``cur``/``prop``/``best`` are (P, L) assignment rows; ``cur_obj``/
    ``prop_obj``/``best_obj``/``u`` are (P,); ``temp`` is a scalar
    temperature.  A proposal is accepted when it does not regress, or with
    the Metropolis probability ``exp(-delta/temp)`` against the uniform
    draw ``u``; the per-chain incumbent takes every strict improvement
    (first-found wins on ties).  Chains whose proposal scored non-finite
    always reject.  Returns ``(new_cur, new_cur_obj, new_best,
    new_best_obj)``.
    """
    dt = cur_obj.dtype
    prop_obj = prop_obj.to(dt)
    best_obj = best_obj.to(dt)
    u = u.to(dt)
    temp = torch.clamp_min(torch.as_tensor(temp, dtype=dt,
                                           device=cur_obj.device), 1e-30)
    delta = prop_obj - cur_obj
    accept = (delta <= 0) | (u < torch.exp(-delta / temp))
    accept &= torch.isfinite(prop_obj)
    improved = prop_obj < best_obj
    new_cur = torch.where(accept[:, None], prop, cur)
    new_cur_obj = torch.where(accept, prop_obj, cur_obj)
    new_best = torch.where(improved[:, None], prop, best)
    new_best_obj = torch.where(improved, prop_obj, best_obj)
    return new_cur, new_cur_obj, new_best, new_best_obj
