"""Primitive layers: norms, rotary embeddings, attention and MLP blocks,
embeddings and the logits head (counterpart of ``repro/models/layers.py``).

Weights are stored once, in the dtype they are used in.  The reference
keeps f32 parameters and casts them to ``cfg.dtype`` at every use
(``layers.py:129,210-218,250``); storing the cast once gives the same
numbers and halves the bytes a bf16 decode step reads.  Norm scales, the
token table (also the tied head, used in f32) and the head stay in
``cfg.param_dtype``, as the reference uses them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from . import kvcache


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a config dtype name ("float32", "bfloat16")."""
    return getattr(torch, name)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def _normal_(p: nn.Parameter, scale: float, gen: torch.Generator) -> None:
    """Fill with N(0, 1) * scale drawn in f32 (``layers.py:23-24``)."""
    x = torch.randn(p.shape, generator=gen, dtype=torch.float32,
                    device=p.device)
    p.copy_(x.mul_(scale))          # one f32 temporary, not two


def _dense_(p: nn.Parameter, fan_in: int, gen: torch.Generator) -> None:
    _normal_(p, fan_in ** -0.5, gen)


# ---------------------------------------------------------------------------
# norms / rotary
# ---------------------------------------------------------------------------


def rmsnorm(x, scale, eps: float = 1e-6):
    """RMSNorm with ``(1 + scale)``, f32 math inside, x's dtype out.

    Where a gradient is being taken it runs as :class:`RMSNorm`, the
    reference's custom VJP (``layers.py:42-70``); otherwise (serving) the
    same forward runs as plain operations."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return RMSNorm.apply(x, scale, eps)
    return _rms(x, scale, eps)[0]


def _rms(x, scale, eps):
    xf = x.float()
    inv = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * inv * (1.0 + scale.float())).to(x.dtype), inv


class RMSNorm(torch.autograd.Function):
    """RMSNorm whose backward computes in f32 and hands back ``dx`` in x's
    dtype and ``dscale`` in the scale's (``repro``'s ``_rms_bwd``): a
    plain autodiff backward would leave f32 cotangents on the residual
    stream."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        y, inv = _rms(x, scale, eps)
        ctx.save_for_backward(x, scale, inv)
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale, inv = ctx.saved_tensors
        xf, gf = x.float(), g.float()
        n = xf * inv
        gn = gf * (1.0 + scale.float())
        dx = inv * (gn - n * (gn * n).mean(-1, keepdim=True))
        dscale = (gf * n).reshape(-1, x.shape[-1]).sum(0)
        return dx.to(x.dtype), dscale.to(scale.dtype), None


def rope(x, positions, theta: float):
    """Half-split rotary embedding in f32. x: (B, S, H, D); positions:
    (B, S) or (S,)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions.float()[..., None] * freq                 # (B,S,half)
    cos = torch.cos(ang)[..., None, :]                        # (B,S,1,half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention block (full / local / bidirectional; GQA; qkv bias)
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    """Pre-norm attention residual block (``layers.py:93-174``)."""

    def __init__(self, cfg: ModelConfig, kind: str, device=None):
        super().__init__()
        self.cfg, self.kind = cfg, kind
        d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        dt, pdt = dtype_of(cfg.dtype), dtype_of(cfg.param_dtype)
        self.ln = _param((d,), pdt, device)
        self.wq = _param((d, hq * dh), dt, device)
        self.wk = _param((d, hkv * dh), dt, device)
        self.wv = _param((d, hkv * dh), dt, device)
        self.wo = _param((hq * dh, d), dt, device)
        if cfg.qkv_bias:
            self.bq = _param((hq * dh,), dt, device)
            self.bk = _param((hkv * dh,), dt, device)
            self.bv = _param((hkv * dh,), dt, device)

    def init(self, gen: torch.Generator) -> None:
        d, hq, dh = self.cfg.d_model, self.cfg.n_heads, self.cfg.d_head
        self.ln.zero_()
        for w in (self.wq, self.wk, self.wv):
            _dense_(w, d, gen)
        _dense_(self.wo, hq * dh, gen)
        if self.cfg.qkv_bias:
            for b in (self.bq, self.bk, self.bv):
                b.zero_()

    def forward(self, x, positions, *, cache=None, lengths=None,
                backend="auto"):
        """Prefill/train: ``cache is None``; returns (y, (k, v)).
        Decode: ``cache = (k_layer, v_layer)`` views and ``lengths`` (B,)
        int32 = tokens already cached; the new token's k/v are inserted at
        ``lengths`` (in place) and attention runs over ``lengths + 1``."""
        cfg = self.cfg
        B, S, _ = x.shape
        hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        h = rmsnorm(x, self.ln).to(self.wq.dtype)
        q, k, v = h @ self.wq, h @ self.wk, h @ self.wv
        if cfg.qkv_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        q = rope(q.view(B, S, hq, dh), positions, cfg.rope_theta)
        k = rope(k.view(B, S, hkv, dh), positions, cfg.rope_theta)
        v = v.view(B, S, hkv, dh)

        window = cfg.local_window if self.kind == "local" else None
        if cache is None:
            out = ops.attention(q, k, v, causal=not cfg.bidirectional,
                                window=window, block_kv=cfg.attn_block_kv,
                                backend=backend)
            new_kv = (k, v)
        else:
            kc, vc = cache
            kvcache.insert(kc, k[:, 0], lengths, window)
            kvcache.insert(vc, v[:, 0], lengths, window)
            eff_len = lengths + 1
            if self.kind == "local":
                eff_len = eff_len.clamp_max(kvcache.size(kc))
            out = ops.decode_attention(q, kvcache.dequant(kc),
                                       kvcache.dequant(vc), eff_len,
                                       backend=backend)
            new_kv = (kc, vc)
        y = out.reshape(B, S, hq * dh) @ self.wo
        return x + y, new_kv


# ---------------------------------------------------------------------------
# MLP block (swiglu / squared_relu / gelu)
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    """Pre-norm MLP residual block (``layers.py:182-220``)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, ff = cfg.d_model, cfg.d_ff
        dt, pdt = dtype_of(cfg.dtype), dtype_of(cfg.param_dtype)
        self.ln = _param((d,), pdt, device)
        if cfg.act == "swiglu":
            self.wi_gate = _param((d, ff), dt, device)
        self.wi = _param((d, ff), dt, device)
        self.wo = _param((ff, d), dt, device)

    def init(self, gen: torch.Generator) -> None:
        self.ln.zero_()
        if self.cfg.act == "swiglu":
            _dense_(self.wi_gate, self.cfg.d_model, gen)
        _dense_(self.wi, self.cfg.d_model, gen)
        _dense_(self.wo, self.cfg.d_ff, gen)

    def forward(self, x):
        h = rmsnorm(x, self.ln).to(self.wi.dtype)
        up = h @ self.wi
        act = self.cfg.act
        if act == "swiglu":
            a = F.silu(h @ self.wi_gate) * up
        elif act == "squared_relu":
            a = torch.square(F.relu(up))
        elif act == "gelu":
            a = F.gelu(up, approximate="tanh")     # jax.nn.gelu's default
        else:
            raise ValueError(act)
        return x + a @ self.wo


# ---------------------------------------------------------------------------
# embeddings / head
# ---------------------------------------------------------------------------


class Embeddings(nn.Module):
    """Token table, multimodal projector, final norm and f32 logits head
    (``layers.py:228-268``)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        dt, pdt = dtype_of(cfg.dtype), dtype_of(cfg.param_dtype)
        if not cfg.embeds_only:
            self.tok = _param((cfg.vocab, d), pdt, device)
        self.final_ln = _param((d,), pdt, device)
        if not cfg.tie_embeddings:
            self.head = _param((d, cfg.vocab), pdt, device)
        if cfg.mm_prefix:
            self.mm_proj = _param((cfg.mm_embed_dim, d), dt, device)

    def init(self, gen: torch.Generator) -> None:
        cfg = self.cfg
        if not cfg.embeds_only:
            _normal_(self.tok, 0.02, gen)
        self.final_ln.zero_()
        if not cfg.tie_embeddings:
            _dense_(self.head, cfg.d_model, gen)
        if cfg.mm_prefix:
            _dense_(self.mm_proj, cfg.mm_embed_dim, gen)

    def embed(self, batch):
        """``batch``: {"token_ids": (B, S)} (plus optional "mm_embeds"),
        or {"embeds": (B, S, d)} for embeds-only models."""
        dt = dtype_of(self.cfg.dtype)
        if self.cfg.embeds_only:
            return batch["embeds"].to(dt)
        x = self.tok[batch["token_ids"].long()].to(dt)
        if self.cfg.mm_prefix and "mm_embeds" in batch:
            proj = batch["mm_embeds"].to(dt) @ self.mm_proj
            prefix = min(self.cfg.mm_prefix, x.shape[1])
            x[:, :prefix] = proj[:, :prefix]
        return x

    def logits(self, x):
        """f32 logits: the final norm in x's dtype, then an f32 product."""
        h = rmsnorm(x, self.final_ln).float()
        w = self.tok.t() if self.cfg.tie_embeddings else self.head
        return h @ w.float()


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def cross_entropy(cfg: ModelConfig, logits, labels, mask=None):
    """Mean token NLL + z-loss; logits f32 (B, S, V).  Returns ``(loss,
    {"nll", "z"})`` as ``repro``'s ``cross_entropy``; the loss's backward
    is :class:`CrossEntropy`'s."""
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=logits.device)
    loss, nll, z = CrossEntropy.apply(logits, labels, mask.float(),
                                      cfg.z_loss)
    return loss, {"nll": nll, "z": z}


class CrossEntropy(torch.autograd.Function):
    """``sum(mask (logz - gold + z_loss logz^2)) / max(sum(mask), 1)``.

    The backward writes ``softmax (1 + 2 z_loss logz) - onehot``, scaled
    by the mask, into one new (B, S, V) tensor: autodiff of the same
    expression would hold several logits-sized temporaries at once, and
    the logits are the largest activation of a training step."""

    @staticmethod
    def forward(ctx, logits, labels, mask, z_loss):
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels.long()[..., None])[..., 0]
        nll = logz - gold
        zl = z_loss * logz ** 2
        denom = torch.clamp(mask.sum(), min=1.0)
        ctx.save_for_backward(logits, labels, mask, logz, denom)
        ctx.z_loss = z_loss
        nll_mean = (nll * mask).sum() / denom
        z_mean = (zl * mask).sum() / denom
        ctx.mark_non_differentiable(nll_mean, z_mean)
        return ((nll + zl) * mask).sum() / denom, nll_mean, z_mean

    @staticmethod
    def backward(ctx, g, g_nll, g_z):
        logits, labels, mask, logz, denom = ctx.saved_tensors
        idx = labels.long()[..., None]
        d = torch.sub(logits, logz[..., None]).exp_()   # softmax
        d.mul_((1.0 + 2.0 * ctx.z_loss * logz)[..., None])
        d.scatter_(-1, idx, d.gather(-1, idx) - 1.0)
        d.mul_((mask * (g / denom))[..., None])
        return d, None, None, None
