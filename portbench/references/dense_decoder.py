"""Plain float32 forward of a dense decoder: the reference that decides
``correct`` for the configurations whose ``reference`` is
``dense_decoder`` (nemotron-4-15b, stablelm-1.6b).

It follows the layer equations as the port serves them (each departure
from the published model is listed under ``assumed`` in the
configuration's file): pre-norm residual layers; RMSNorm with
``(1 + scale)`` and eps 1e-6; rotary embedding over the whole head,
halves rotated (theta from the configuration); grouped-query attention,
causal, scaled by 1/sqrt(head size); a squared-ReLU or SwiGLU MLP; a
final RMSNorm and a float32 head.  Weights are laid out as the port
stores them (``x @ w``), and their names are the port's parameter names,
so :mod:`portbench.weights` makes the same numbers for both sides.

It imports nothing of the program and takes nothing the program made:
every weight comes from ``weight(name, shape, dtype)``, which draws it
again from the seed, one layer at a time, so the reference never holds
more than one layer and the token table or head.  It computes in float32
with TF32 off.  ``low`` (a function of a tensor and the dimension it is
scaled along) rounds every matrix and every matrix product's input to a
lower precision, and with ``round_weights`` every weight (the token
table and the norms too): that is a control (:data:`CONTROLS`).
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

EPS = 1e-6
#: queries a block of the plain attention (bounds its score matrix)
QUERY_BLOCK = 512
FP8_MAX = 448.0


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded through float8 e4m3, scaled by its absolute maximum
    along ``dim`` (per output column of a weight, per row of an input)."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def bf16(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded through bfloat16 (``dim`` is not used)."""
    return x.to(torch.bfloat16).to(torch.float32)


#: the controls that can stand in the program's place (``control.py``):
#: name -> (``low``, ``round_weights``).  ``fp8``: every matrix product
#: through float8 e4m3, the nearest precision below the configuration's
#: bfloat16.  ``bf16``: every product, the token table, the norms and the
#: head in bfloat16, the precision of the layers: it shows whether the
#: comparison sees a head, table and norms below the float32 they are
#: stored in.
CONTROLS = {"fp8": (fp8, False), "bf16": (bf16, True)}


def names(arch: dict) -> dict[str, tuple[tuple[int, ...], str]]:
    """Every weight the model has: name -> (shape, storage dtype name), in
    the order the reference uses them."""
    d, hq, hkv = arch["d_model"], arch["n_heads"], arch["n_kv_heads"]
    dh, ff, V = arch["d_head"], arch["d_ff"], arch["vocab"]
    dt, pdt = arch["dtype"], arch["param_dtype"]
    out = {"emb.tok": ((V, d), pdt)}
    for i in range(arch["n_layers"]):
        p = f"layers.{i}"
        out[f"{p}.t.ln"] = ((d,), pdt)
        out[f"{p}.t.wq"] = ((d, hq * dh), dt)
        out[f"{p}.t.wk"] = ((d, hkv * dh), dt)
        out[f"{p}.t.wv"] = ((d, hkv * dh), dt)
        out[f"{p}.t.wo"] = ((hq * dh, d), dt)
        if arch["qkv_bias"]:
            out[f"{p}.t.bq"] = ((hq * dh,), dt)
            out[f"{p}.t.bk"] = ((hkv * dh,), dt)
            out[f"{p}.t.bv"] = ((hkv * dh,), dt)
        out[f"{p}.c.ln"] = ((d,), pdt)
        if arch["act"] == "swiglu":
            out[f"{p}.c.wi_gate"] = ((d, ff), dt)
        out[f"{p}.c.wi"] = ((d, ff), dt)
        out[f"{p}.c.wo"] = ((ff, d), dt)
    out["emb.final_ln"] = ((d,), pdt)
    if not arch["tie_embeddings"]:
        out["emb.head"] = ((d, V), pdt)
    return out


def rmsnorm(x, scale):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + EPS) * (1.0 + scale)


def rope(x, theta: float):
    """x: (S, H, D) at positions 0..S-1."""
    S, _, D = x.shape
    half = D // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freq
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def attend(q, k, v):
    """Causal GQA attention in float32. q: (S, Hq, D); k, v: (S, Hkv, D)."""
    S, Hq, D = q.shape
    G = Hq // k.shape[1]
    k, v = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    out = torch.empty_like(q)
    keys = torch.arange(S, device=q.device)
    for s0 in range(0, S, QUERY_BLOCK):
        s1 = min(S, s0 + QUERY_BLOCK)
        sc = torch.einsum("qhd,khd->hqk", q[s0:s1], k[:s1]) / math.sqrt(D)
        later = keys[None, :s1] > torch.arange(s0, s1, device=q.device)[:, None]
        sc = sc.masked_fill(later[None], float("-inf"))
        out[s0:s1] = torch.einsum("hqk,khd->qhd", torch.softmax(sc, -1),
                                  v[:s1])
    return out


class Reference:
    """``weight(name, shape, dtype)`` gives a weight as the program stores
    it; ``low`` (see module docstring) turns the reference into the
    control."""

    def __init__(self, arch: dict, weight: Callable, device,
                 low: Callable | None = None, round_weights: bool = False):
        self.arch = arch
        self.weight = weight
        self.device = torch.device(device)
        self.low = low
        self.round_weights = round_weights
        self.shapes = names(arch)

    def _w(self, name):
        shape, dt = self.shapes[name]
        w = self.weight(name, shape, getattr(torch, dt)).float()
        if self.low is not None and (w.dim() == 2 or self.round_weights):
            w = self.low(w, 0)
        return w

    def _mm(self, x, w):
        if self.low is not None:
            x = self.low(x, -1)
        return x @ w

    def _layer(self, x, W, i):
        a = self.arch
        S = x.shape[0]
        hq, hkv, dh = a["n_heads"], a["n_kv_heads"], a["d_head"]
        p = f"layers.{i}"
        h = rmsnorm(x, W[f"{p}.t.ln"])
        q, k, v = (self._mm(h, W[f"{p}.t.w{n}"]) for n in "qkv")
        if a["qkv_bias"]:
            q, k, v = (t + W[f"{p}.t.b{n}"] for t, n in zip((q, k, v), "qkv"))
        q = rope(q.view(S, hq, dh), a["rope_theta"])
        k = rope(k.view(S, hkv, dh), a["rope_theta"])
        v = v.view(S, hkv, dh)
        if self.low is not None:
            k, v = self.low(k, -1), self.low(v, -1)
        x = x + self._mm(attend(q, k, v).reshape(S, hq * dh), W[f"{p}.t.wo"])
        h = rmsnorm(x, W[f"{p}.c.ln"])
        up = self._mm(h, W[f"{p}.c.wi"])
        if a["act"] == "squared_relu":
            act = torch.square(torch.relu(up))
        elif a["act"] == "swiglu":
            act = torch.nn.functional.silu(self._mm(h, W[f"{p}.c.wi_gate"])) * up
        else:
            raise ValueError(f"dense_decoder: no activation {a['act']!r}")
        return x + self._mm(act, W[f"{p}.c.wo"])

    @torch.no_grad()
    def logits(self, seqs: Sequence[torch.Tensor], starts: Sequence[int]
               ) -> list[torch.Tensor]:
        """Float32 logits of each token sequence (int64, on the device) at
        positions ``start`` to its end, one (n, vocab) tensor each."""
        prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            tok = self._table()
            xs = [tok[s] for s in seqs]
            del tok
            for i in range(self.arch["n_layers"]):
                p = f"layers.{i}."
                W = {n: self._w(n) for n in self.shapes if n.startswith(p)}
                xs = [self._layer(x, W, i) for x in xs]
                del W
            fln = self._w("emb.final_ln")
            head = (self._table().t() if self.arch["tie_embeddings"]
                    else self._w("emb.head"))
            return [self._mm(rmsnorm(x[s:], fln), head)
                    for x, s in zip(xs, starts)]
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev

    def _table(self):
        shape, dt = self.shapes["emb.tok"]
        w = self.weight("emb.tok", shape, getattr(torch, dt)).float()
        return self.low(w, 0) if self.round_weights else w
