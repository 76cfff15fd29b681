"""Primitive layers: norms, rotary embeddings, attention and MLP blocks,
embeddings and the logits head (counterpart of ``repro/models/layers.py``).

Weights are stored once, in the dtype they are used in.  The reference
keeps f32 parameters and casts them to ``cfg.dtype`` at every use
(``layers.py:129,210-218,250``); storing the cast once gives the same
numbers and halves the bytes a bf16 decode step reads.  Norm scales, the
token table (also the tied head, used in f32) and the head stay in
``cfg.param_dtype``, as the reference uses them.

On a mesh (a ``split``, :class:`repro_torch.models.sharding.Split`) each
weight holds this rank's block of the reference's logical axes, and the
blocks are Megatron's under ``serve_rules``: attention's q/k/v and the
MLP's inputs column-parallel over heads and ``mlp``, their outputs
row-parallel with one float32 all-reduce, the token table and head split
over the vocabulary (a masked lookup summed over the ranks; the logits
gathered).  Where an axis does not divide (a single kv head; qwen's 4 kv
heads on 8 ranks) the weight stays whole, as ``named_sharding``'s
fallback has it, and each rank uses the kv heads its query heads read.
The KV cache is split by sequence (``kv_seq``): a decode step runs the
decode kernel's split pass over each rank's chunk for every head,
gathers the partials and combines them for the rank's own heads.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from . import collectives, kvcache


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a config dtype name ("float32", "bfloat16")."""
    return getattr(torch, name)


def _param(shape, dtype, device, split=None, logical=None
           ) -> nn.Parameter:
    """A weight of the whole ``shape``.  A dim given as a tuple is several
    of the reference's dims flattened into one (``(d, (hq, dh))``: the
    reference's (d, hq, dh) ``wq`` as (d, hq * dh)); ``logical`` names
    the reference's dims.  With a ``split`` the parameter holds this
    rank's stored block (:func:`cut`) and :func:`use` gives the block it
    computes with."""
    groups = [g if isinstance(g, tuple) else (g,) for g in shape]
    full = tuple(math.prod(g) for g in groups)
    if split is None or logical is None:
        return nn.Parameter(torch.empty(full, dtype=dtype, device=device),
                            requires_grad=False)
    ref = tuple(x for g in groups for x in g)
    stored = split.stored(logical, ref)
    computed = split.computed(logical, ref)
    local = stored.shard_shape(ref)
    p = nn.Parameter(torch.empty(_merged(local, groups), dtype=dtype,
                                 device=device), requires_grad=False)
    p.whole, p.ref, p.stored, p.computed = full, ref, stored, computed
    p.logical = tuple(logical)
    p.gathers = _gathers(stored, computed, len(ref))
    p.compute_shape = _merged(computed.shard_shape(ref), groups)
    return p


#: what a split weight carries about its blocks (:func:`_param`), which
#: a training model's view of it carries too (``Model.bound``)
SPLIT_ATTRS = ("whole", "ref", "stored", "computed", "logical", "gathers",
               "compute_shape")


def _merged(ref_shape, groups) -> tuple[int, ...]:
    out, i = [], 0
    for g in groups:
        out.append(math.prod(ref_shape[i:i + len(g)]))
        i += len(g)
    return tuple(out)


def _gathers(stored, computed, ndim) -> list:
    """``(dim, axis)`` all-gathers, minor axis first, that take a stored
    block to the computed one (what ``weight_use`` does)."""
    out = []
    for d in range(ndim):
        have = _names(stored.spec, d)
        want = _names(computed.spec, d)
        if want != have[:len(want)]:
            raise NotImplementedError(
                f"a weight stored as {stored.spec} and computed as "
                f"{computed.spec}: only gathers are supported")
        out += [(d, a) for a in reversed(have[len(want):])]
    return out


def _names(spec, d) -> tuple:
    axis = spec[d] if d < len(spec) else None
    if axis is None:
        return ()
    return axis if isinstance(axis, tuple) else (axis,)


def cut(p: torch.Tensor, whole: torch.Tensor) -> torch.Tensor:
    """This rank's stored block of ``whole``, the full weight that ``p``
    holds a block of (``whole`` itself when ``p`` is not split)."""
    if getattr(p, "stored", None) is None:
        return whole
    return p.stored.shard_of(whole.reshape(p.ref)).reshape(p.shape)


def use(p: torch.Tensor) -> torch.Tensor:
    """The block of weight ``p`` a rank computes with: ``p`` itself, or
    for a weight stored split on "embed" (fsdp rules) its block gathered
    over those axes (the reference's ``weight_use``).  In training the
    gradient goes back reduce-scattered over the axes that split the
    batch rows (``p.rows``, set by ``Model.bound``), each rank's rows
    giving a partial, and as this rank's block over any other."""
    gathers = getattr(p, "gathers", None)
    if not gathers:
        return p
    rows = getattr(p, "rows", ())
    t = p.reshape(p.stored.shard_shape(p.ref))
    for dim, axis in gathers:
        t = collectives.all_gather(t, p.stored.mesh, axis, dim,
                                   back="sum" if axis in rows else "own")
    return t.reshape(p.compute_shape)


def split_of(p: torch.Tensor, dim: int) -> tuple:
    """``(axes, parts, index)`` of the reference dim ``dim`` of weight
    ``p`` as it is computed with (``(None, 1, 0)`` off a mesh)."""
    computed = getattr(p, "computed", None)
    if computed is None:
        return None, 1, 0
    return computed.block(dim)


def _normal_(p: nn.Parameter, scale: float, gen: torch.Generator) -> None:
    """Fill with N(0, 1) * scale drawn in f32 (``layers.py:23-24``); a
    split weight draws the whole weight's numbers and keeps its block."""
    x = torch.randn(getattr(p, "whole", p.shape), generator=gen,
                    dtype=torch.float32, device=p.device)
    p.copy_(cut(p, x).mul_(scale))  # one f32 temporary, not two


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

    def __init__(self, cfg: ModelConfig, kind: str, device=None,
                 split=None):
        super().__init__()
        self.cfg, self.kind = cfg, kind
        d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        dt, pdt = dtype_of(cfg.dtype), dtype_of(cfg.param_dtype)

        def P(shape, dtype, logical):
            return _param(shape, dtype, device, split, logical)
        self.ln = P((d,), pdt, ("embed",))
        self.wq = P((d, (hq, dh)), dt, ("embed", "heads", "head_dim"))
        self.wk = P((d, (hkv, dh)), dt, ("embed", "kv_heads", "head_dim"))
        self.wv = P((d, (hkv, dh)), dt, ("embed", "kv_heads", "head_dim"))
        self.wo = P(((hq, dh), d), dt, ("heads", "head_dim", "embed"))
        if cfg.qkv_bias:
            self.bq = P(((hq, dh),), dt, ("heads", "head_dim"))
            self.bk = P(((hkv, dh),), dt, ("kv_heads", "head_dim"))
            self.bv = P(((hkv, dh),), dt, ("kv_heads", "head_dim"))
        # the heads this rank computes: [h0, h0 + hq_loc) of its axis's
        # split, and the kv heads [kv_lo, kv_hi) they read
        self.mesh = None if split is None else split.mesh
        self.heads_axis, parts, index = split_of(self.wq, 1)
        kv_axis, kv_parts, _ = split_of(self.wk, 1)
        if kv_axis is not None and kv_axis != self.heads_axis:
            raise NotImplementedError(
                f"kv heads split over {kv_axis!r}, query heads over "
                f"{self.heads_axis!r}")
        self.hq_loc, self.hkv_loc = hq // parts, hkv // kv_parts
        self.h0 = index * self.hq_loc
        G = hq // hkv
        if not (self.hq_loc % G == 0 or G % self.hq_loc == 0):
            raise NotImplementedError(
                f"{self.hq_loc} query heads a rank do not map onto whole "
                f"groups of {G}")
        self.kv_lo = self.h0 // G
        self.kv_hi = (self.h0 + self.hq_loc - 1) // G + 1
        self.kv_split = kv_parts > 1

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
        """Prefill/train: ``cache is None``; returns (y, (k, v)), k and v
        this rank's kv heads (:meth:`whole_kv` gives all of them).
        Decode: ``cache = (k_layer, v_layer)`` views and ``lengths`` (B,)
        int32 = tokens already cached; the new token's k/v are inserted at
        ``lengths`` (in place) and attention runs over ``lengths + 1``."""
        cfg = self.cfg
        B, S, _ = x.shape
        hq, hkv, dh = self.hq_loc, self.hkv_loc, cfg.d_head
        wq = use(self.wq)
        h = rmsnorm(x, use(self.ln)).to(wq.dtype)
        # column-parallel over the heads: each rank's share of dh is a
        # partial (enter); k and v too where their heads split
        h_q = collectives.enter(h, self.mesh, self.heads_axis)
        h_kv = h_q if self.kv_split else h
        q, k, v = h_q @ wq, h_kv @ use(self.wk), h_kv @ use(self.wv)
        if cfg.qkv_bias:
            q, k, v = q + use(self.bq), k + use(self.bk), v + use(self.bv)
        q = rope(q.view(B, S, hq, dh), positions, cfg.rope_theta)
        k = rope(k.view(B, S, hkv, dh), positions, cfg.rope_theta)
        v = v.view(B, S, hkv, dh)

        window = cfg.local_window if self.kind == "local" else None
        if cache is None:
            kq, vq = k, v
            if not self.kv_split and self.hq_loc < cfg.n_heads:
                # every rank's whole k and v, each reading its heads' slice
                kq, vq = (collectives.enter(t, self.mesh, self.heads_axis)[
                    :, :, self.kv_lo:self.kv_hi].contiguous() for t in (k, v))
            out = ops.attention(q, kq, vq, causal=not cfg.bidirectional,
                                window=window, block_kv=cfg.attn_block_kv,
                                backend=backend)
            new_kv = (k, v)
        else:
            out = self._decode(q, k, v, cache, lengths, window, backend)
            new_kv = cache
        y = out.reshape(B, S, hq * dh) @ use(self.wo)
        y = collectives.all_reduce(y, self.mesh, self.heads_axis)
        return x + y, new_kv

    def whole_kv(self, k, v):
        """Every kv head of a prompt's k and v, (B, S, Hkv, D): this rank's
        gathered from the ranks of the heads axis (one all-gather)."""
        if not self.kv_split:
            return k, v
        kv = collectives.all_gather(torch.stack((k, v)), self.mesh,
                                    self.heads_axis, 3)
        return kv[0], kv[1]

    def _decode(self, q, k, v, cache, lengths, window, backend):
        kc, vc = cache
        chunk = isinstance(kc, kvcache.Chunk)
        split = self.hq_loc < self.cfg.n_heads
        # what the cache and the chunk's attention need: every kv head,
        # and (a cache split by sequence) every query head; one gather
        q_all = q
        if self.kv_split or (chunk and split):
            nq, nk = q.shape[2], k.shape[2]
            parts = (q, k, v) if self.kv_split else (q,)
            got = collectives.all_gather(torch.cat(parts, 2), self.mesh,
                                         self.heads_axis, 2)
            got = got.view(q.shape[0], 1, -1, sum(t.shape[2] for t in parts),
                           q.shape[3])             # (B, 1, ranks, w, D)
            q_all = got[:, :, :, :nq].flatten(2, 3)
            if self.kv_split:
                k = got[:, :, :, nq:nq + nk].flatten(2, 3)
                v = got[:, :, :, nq + nk:].flatten(2, 3)
        kvcache.insert(kc, k[:, 0], lengths, window)
        kvcache.insert(vc, v[:, 0], lengths, window)
        eff_len = lengths + 1
        if self.kind == "local":
            eff_len = eff_len.clamp_max(kvcache.capacity(kc))
        kd, vd = kvcache.dequant(kc), kvcache.dequant(vc)
        if not chunk:
            if self.hq_loc < self.cfg.n_heads:
                kd, vd = (t[:, :, self.kv_lo:self.kv_hi] for t in (kd, vd))
            return ops.decode_attention(q, kd, vd, eff_len, backend=backend)
        # the split pass over this rank's chunk for every head, the
        # partials of every chunk, the combine for this rank's heads
        ml, acc = ops.decode_attention_partials(q_all.contiguous(), kd, vd,
                                                eff_len, kc.offset,
                                                backend=backend)
        B, Hq, J, D = acc.shape
        flat = torch.cat((ml.reshape(B, -1), acc.reshape(B, -1)), 1)
        got = collectives.all_gather(flat[None], self.mesh, kc.axis, 0)
        n = got.shape[0]
        h0, h1 = (self.h0, self.h0 + self.hq_loc) if split else (0, Hq)
        ml = got[:, :, :Hq * J * 2].reshape(n, B, Hq, J, 2)[:, :, h0:h1]
        acc = got[:, :, Hq * J * 2:].reshape(n, B, Hq, J, D)[:, :, h0:h1]
        ml, acc = (t.permute(1, 2, 0, 3, 4).flatten(2, 3)
                   for t in (ml, acc))
        return ops.decode_attention_combine(ml, acc, q.dtype,
                                            backend=backend)


# ---------------------------------------------------------------------------
# MLP block (swiglu / squared_relu / gelu)
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    """Pre-norm MLP residual block (``layers.py:182-220``): on a mesh,
    ``wi``/``wi_gate`` column-parallel and ``wo`` row-parallel over
    ``mlp``, one all-reduce."""

    def __init__(self, cfg: ModelConfig, device=None, split=None):
        super().__init__()
        self.cfg = cfg
        d, ff = cfg.d_model, cfg.d_ff
        dt, pdt = dtype_of(cfg.dtype), dtype_of(cfg.param_dtype)
        self.ln = _param((d,), pdt, device, split, ("embed",))
        if cfg.act == "swiglu":
            self.wi_gate = _param((d, ff), dt, device, split,
                                  ("embed", "mlp"))
        self.wi = _param((d, ff), dt, device, split, ("embed", "mlp"))
        self.wo = _param((ff, d), dt, device, split, ("mlp", "embed"))
        self.mesh = None if split is None else split.mesh
        self.axis = split_of(self.wi, 1)[0]

    def init(self, gen: torch.Generator) -> None:
        self.ln.zero_()
        if self.cfg.act == "swiglu":
            _dense_(self.wi_gate, self.cfg.d_model, gen)
        _dense_(self.wi, self.cfg.d_model, gen)
        _dense_(self.wo, self.cfg.d_ff, gen)

    def forward(self, x):
        wi = use(self.wi)
        h = collectives.enter(rmsnorm(x, use(self.ln)).to(wi.dtype),
                              self.mesh, self.axis)
        up = h @ wi
        act = self.cfg.act
        if act == "swiglu":
            a = F.silu(h @ use(self.wi_gate)) * up
        elif act == "squared_relu":
            a = torch.square(F.relu(up))
        elif act == "gelu":
            a = F.gelu(up, approximate="tanh")     # jax.nn.gelu's default
        else:
            raise ValueError(act)
        y = collectives.all_reduce(a @ use(self.wo), self.mesh, self.axis)
        return x + y


# ---------------------------------------------------------------------------
# embeddings / head
# ---------------------------------------------------------------------------


class Embeddings(nn.Module):
    """Token table, multimodal projector, final norm and f32 logits head
    (``layers.py:228-268``); on a mesh the table and the head are split
    over the vocabulary."""

    def __init__(self, cfg: ModelConfig, device=None, split=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        dt, pdt = dtype_of(cfg.dtype), dtype_of(cfg.param_dtype)

        def P(shape, dtype, logical):
            return _param(shape, dtype, device, split, logical)
        if not cfg.embeds_only:
            self.tok = P((cfg.vocab, d), pdt, ("vocab", "embed"))
        self.final_ln = P((d,), pdt, ("embed",))
        if not cfg.tie_embeddings:
            self.head = P((d, cfg.vocab), pdt, ("embed", "vocab"))
        if cfg.mm_prefix:
            self.mm_proj = P((cfg.mm_embed_dim, d), dt, ("embed", None))
        self.mesh = None if split is None else split.mesh

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
        tok = use(self.tok)
        axis, parts, index = split_of(self.tok, 0)
        ids = batch["token_ids"].long()
        if parts > 1:           # this rank's rows of the table, summed
            n = tok.shape[0]
            local = ids - index * n
            mine = (local >= 0) & (local < n)
            x = tok[local.clamp(0, n - 1)] * mine[..., None].to(tok.dtype)
            x = collectives.all_reduce(x, self.mesh, axis).to(dt)
        else:
            x = tok[ids].to(dt)
        if self.cfg.mm_prefix and "mm_embeds" in batch:
            proj = batch["mm_embeds"].to(dt) @ use(self.mm_proj)
            prefix = min(self.cfg.mm_prefix, x.shape[1])
            x[:, :prefix] = proj[:, :prefix]
        return x

    def logits(self, x):
        """f32 logits: the final norm in x's dtype, then an f32 product;
        on a mesh every rank's vocabulary block, gathered."""
        h = rmsnorm(x, use(self.final_ln)).float()
        if self.cfg.tie_embeddings:
            w, dim = use(self.tok).t(), 0
        else:
            w, dim = use(self.head), 1
        axis = split_of(self.tok if self.cfg.tie_embeddings else self.head,
                        dim)[0]
        h = collectives.enter(h, self.mesh, axis)
        return collectives.all_gather(h @ w.float(), self.mesh, axis, -1)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def cross_entropy(cfg: ModelConfig, logits, labels, mask=None,
                  count=None):
    """Mean token NLL + z-loss; logits f32 (B, S, V).  Returns ``(loss,
    {"nll", "z"})`` as ``repro``'s ``cross_entropy``; the loss's backward
    is :class:`CrossEntropy`'s.  ``count``: the mask's sum over the whole
    batch where ``logits`` are one rank's rows of it (default: this
    mask's), so that the ranks' losses sum to the batch's mean."""
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=logits.device)
    mask = mask.float()
    if count is None:
        count = mask.sum()
    loss, nll, z = CrossEntropy.apply(logits, labels, mask, cfg.z_loss,
                                      count)
    return loss, {"nll": nll, "z": z}


class CrossEntropy(torch.autograd.Function):
    """``sum(mask (logz - gold + z_loss logz^2)) / max(sum(mask), 1)``.

    The backward writes ``softmax (1 + 2 z_loss logz) - onehot``, scaled
    by the mask, into one new (B, S, V) tensor: autodiff of the same
    expression would hold several logits-sized temporaries at once, and
    the logits are the largest activation of a training step."""

    @staticmethod
    def forward(ctx, logits, labels, mask, z_loss, count):
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels.long()[..., None])[..., 0]
        nll = logz - gold
        zl = z_loss * logz ** 2
        denom = torch.clamp(count, min=1.0)
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
        return d, None, None, None, None
