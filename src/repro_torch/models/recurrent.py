"""Token mixers without attention: RG-LRU (Griffin / recurrentgemma) and
RWKV-6 (counterpart of ``repro/models/recurrent.py``).

Both reduce to the recurrent kernels of :mod:`repro_torch.kernels`: RG-LRU
to the gated linear recurrence ``h_t = a_t h_{t-1} + b_t``
(``ops.linear_scan``), RWKV-6 to the matrix-state recurrence
(``ops.rwkv6``).  Decode carries a constant-size state.

Each block is pure: ``forward(x, state=None, backend)`` returns ``(y,
new_state)`` and never writes into ``state``; the layer stack
(``transformer.py``) copies the new state into the cache in place.  The
casts are the reference's, one for one (``recurrent.py:58-87,130-182``):
activations in ``cfg.dtype``, ``lam``, ``w0`` and the decay LoRA in
float32.  Weights are stored once, in the dtype they are used in
(``layers.py``'s rule): projections, ``conv_*``, ``mu_*`` and ``u`` in
``cfg.dtype``; ``lam``, ``w0``, ``w_lora_a`` and ``w_lora_b`` in float32;
norm scales in ``cfg.param_dtype``.

On a mesh (``split``) both blocks are split over "rnn" as the reference's
logical axes have it: RG-LRU scans this rank's ``d_rnn / tp`` channels
(its gates' ``("rnn", None)`` products summed over the ranks, then cut
to its channels) and RWKV-6 this rank's ``H / tp`` heads; their outputs
are row-parallel, one all-reduce each, and the RWKV-6 channel mix sums
``kk @ cv`` over "mlp" and gathers the receptance over "rnn".
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from . import collectives
from .layers import _dense_, _param, cut, dtype_of, rmsnorm, split_of, use

RGLRU_C = 8.0


def rwkv_heads(cfg: ModelConfig) -> int:
    """RWKV-6 heads: ``cfg.n_heads``, else one per 64 channels."""
    return cfg.n_heads if cfg.n_heads else cfg.d_model // 64


# ---------------------------------------------------------------------------
# RG-LRU residual block (Griffin / recurrentgemma)
# ---------------------------------------------------------------------------


def _causal_conv4(x, w, b, state=None):
    """Depthwise causal width-4 conv. x: (B, S, r); w: (4, r); state:
    (B, 3, r) history (zeros when None).  Returns (out, last 3 inputs)."""
    B, S, r = x.shape
    hist = (torch.zeros((B, 3, r), dtype=x.dtype, device=x.device)
            if state is None else state.to(x.dtype))
    xp = torch.cat([hist, x], dim=1)                        # (B, S+3, r)
    out = xp[:, 3:3 + S] * w[3]
    for i in (1, 2, 3):                 # the reference's summation order
        out = out + xp[:, 3 - i:3 - i + S] * w[3 - i]
    return out + b, xp[:, -3:]


class RGLRU(nn.Module):
    """Pre-norm RG-LRU residual block (``recurrent.py:24-87``).  State:
    ``{"h": (B, d_rnn) float32, "conv": (B, 3, d_rnn) cfg.dtype}``."""

    def __init__(self, cfg: ModelConfig, device=None, split=None):
        super().__init__()
        self.cfg = cfg
        d, r = cfg.d_model, cfg.d_rnn
        dt, pdt = dtype_of(cfg.dtype), dtype_of(cfg.param_dtype)

        def P(shape, dtype, logical):
            return _param(shape, dtype, device, split, logical)
        self.ln = P((d,), pdt, ("embed",))
        self.w_in = P((d, r), dt, ("embed", "rnn"))
        self.w_gate = P((d, r), dt, ("embed", "rnn"))
        self.conv_w = P((4, r), dt, (None, "rnn"))
        self.conv_b = P((r,), dt, ("rnn",))
        self.wa = P((r, r), dt, ("rnn", None))
        self.wx = P((r, r), dt, ("rnn", None))
        self.lam = P((r,), torch.float32, ("rnn",))
        self.w_out = P((r, d), dt, ("rnn", "embed"))
        self.mesh = None if split is None else split.mesh
        self.axis, parts, index = split_of(self.w_in, 1)
        self.c0, self.r_loc = index * (r // parts), r // parts

    def init(self, gen: torch.Generator) -> None:
        d, r = self.cfg.d_model, self.cfg.d_rnn
        self.ln.zero_()
        for w in (self.w_in, self.w_gate):
            _dense_(w, d, gen)
        self.conv_w.zero_()
        self.conv_b.zero_()
        for w in (self.wa, self.wx, self.w_out):
            _dense_(w, r, gen)
        # a = sigmoid(lam) spans (0.9, 0.999), as init_rglru sets it
        lin = torch.linspace(0.9, 0.999, r, dtype=torch.float32,
                             device=self.lam.device)
        self.lam.copy_(cut(self.lam, torch.log(lin / (1 - lin))))

    def forward(self, x, state=None, backend="auto"):
        w_in = use(self.w_in)
        dt = w_in.dtype
        h_in = collectives.enter(rmsnorm(x, use(self.ln)).to(dt),
                                 self.mesh, self.axis)
        gate = F.gelu(h_in @ use(self.w_gate), approximate="tanh")
        u = h_in @ w_in
        u, conv = _causal_conv4(u, use(self.conv_w), use(self.conv_b),
                                None if state is None else state["conv"])
        if self.r_loc < self.cfg.d_rnn:
            # each rank's rows of wa, wx: sum the products over the ranks
            # (one all-reduce for both), keep this rank's channels
            r = self.cfg.d_rnn
            both = collectives.all_reduce(
                torch.cat((u @ use(self.wa), u @ use(self.wx)), -1),
                self.mesh, self.axis)
            both = collectives.enter(both, self.mesh, self.axis)
            mine = slice(self.c0, self.c0 + self.r_loc)
            rgate = torch.sigmoid(both[..., :r][..., mine])
            igate = torch.sigmoid(both[..., r:][..., mine])
        else:
            rgate = torch.sigmoid(u @ use(self.wa))
            igate = torch.sigmoid(u @ use(self.wx))
        a = torch.exp(-RGLRU_C * F.softplus(use(self.lam)) * rgate.float())
        gated_in = (torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12))
                    * (igate * u).float())
        h_seq, h_last = ops.linear_scan(
            a.to(dt), gated_in.to(dt),
            None if state is None else state["h"], backend=backend)
        y = collectives.all_reduce((h_seq * gate) @ use(self.w_out),
                                   self.mesh, self.axis)
        return x + y, {"h": h_last, "conv": conv}


# ---------------------------------------------------------------------------
# RWKV-6 block: time mix + channel mix
# ---------------------------------------------------------------------------


def _token_shift(x, prev):
    """x: (B, S, d); prev: (B, d) last token of the previous chunk.
    Returns (x shifted right by one, x's last token)."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1), x[:, -1]


class RWKV(nn.Module):
    """RWKV-6 time mix and channel mix, both residual
    (``recurrent.py:94-182``).  State: ``{"S": (B, H, dh, dh) float32,
    "x_t", "x_c": (B, d) cfg.dtype}`` (the token-shift carries)."""

    def __init__(self, cfg: ModelConfig, device=None, split=None):
        super().__init__()
        self.cfg = cfg
        d, ff = cfg.d_model, cfg.d_ff
        H = rwkv_heads(cfg)
        dt, pdt = dtype_of(cfg.dtype), dtype_of(cfg.param_dtype)
        f32 = torch.float32

        def P(shape, dtype, logical):
            return _param(shape, dtype, device, split, logical)
        self.ln_t = P((d,), pdt, ("embed",))
        for name in ("wr", "wk", "wv", "wg", "cr"):
            setattr(self, name, P((d, d), dt, ("embed", "rnn")))
        self.wo_t = P((d, d), dt, ("rnn", "embed"))
        for name in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_cr", "mu_ck"):
            setattr(self, name, P((d,), dt, ("embed",)))
        self.w0 = P((d,), f32, ("rnn",))
        self.w_lora_a = P((d, 64), f32, ("embed", None))
        self.w_lora_b = P((64, d), f32, (None, "rnn"))
        self.u = P((H, d // H), dt, ("heads", "head_dim"))
        self.ln_c = P((d,), pdt, ("embed",))
        self.ck = P((d, ff), dt, ("embed", "mlp"))
        self.cv = P((ff, d), dt, ("mlp", "embed"))
        self.mesh = None if split is None else split.mesh
        self.axis, parts, _ = split_of(self.wr, 1)
        heads_axis, heads_parts, _ = split_of(self.u, 0)
        if (self.axis, parts) != (heads_axis, heads_parts):
            raise NotImplementedError(
                f"RWKV-6 channels split over {self.axis!r} ({parts}), its "
                f"{H} heads over {heads_axis!r} ({heads_parts})")
        self.mlp_axis = split_of(self.ck, 1)[0]

    def init(self, gen: torch.Generator) -> None:
        d, ff = self.cfg.d_model, self.cfg.d_ff
        for name in ("wr", "wk", "wv", "wg", "wo_t", "cr", "ck"):
            _dense_(getattr(self, name), d, gen)
        _dense_(self.cv, ff, gen)
        _dense_(self.w_lora_a, d, gen)
        for name in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_cr", "mu_ck"):
            getattr(self, name).fill_(0.5)
        self.w0.fill_(-6.0)
        for name in ("ln_t", "ln_c", "w_lora_b", "u"):
            getattr(self, name).zero_()

    def forward(self, x, state=None, backend="auto"):
        W = {name: use(p) for name, p in self.named_parameters()}
        dt = W["wr"].dtype
        B, S, d = x.shape
        H = self.u.shape[0]                    # this rank's heads
        dh = self.cfg.d_model // rwkv_heads(self.cfg)
        if state is None:
            zeros = torch.zeros((B, d), dtype=dt, device=x.device)
            state = {"S": torch.zeros((B, H, dh, dh), dtype=torch.float32,
                                      device=x.device),
                     "x_t": zeros, "x_c": zeros}

        # ---- time mix ----
        h = rmsnorm(x, W["ln_t"]).to(dt)
        shifted, x_t_last = _token_shift(h, state["x_t"].to(dt))

        def split(t):           # entering work split over "rnn"
            return collectives.enter(t, self.mesh, self.axis)

        def lerp(mu):
            return split(h * (1 - W[mu]) + shifted * W[mu])

        r = (lerp("mu_r") @ W["wr"]).reshape(B, S, H, dh)
        k = (lerp("mu_k") @ W["wk"]).reshape(B, S, H, dh)
        v = (lerp("mu_v") @ W["wv"]).reshape(B, S, H, dh)
        g = F.silu(split(h) @ W["wg"])
        xw = h * (1 - W["mu_w"]) + shifted * W["mu_w"]
        w_log = W["w0"] + split(torch.tanh(xw.float() @ W["w_lora_a"])) \
            @ W["w_lora_b"]
        w = torch.exp(-torch.exp(w_log)).reshape(B, S, H, dh)
        y, S_new = ops.rwkv6(r, k, v, w.to(dt), W["u"], state["S"],
                             backend=backend)
        x = x + collectives.all_reduce(
            (y.reshape(B, S, H * dh) * g) @ W["wo_t"], self.mesh, self.axis)

        # ---- channel mix ----
        hc = rmsnorm(x, W["ln_c"]).to(dt)
        shifted_c, x_c_last = _token_shift(hc, state["x_c"].to(dt))
        kk = collectives.enter(hc * (1 - W["mu_ck"]) + shifted_c * W["mu_ck"],
                               self.mesh, self.mlp_axis) @ W["ck"]
        kk = torch.square(F.relu(kk))
        rr = torch.sigmoid(split(hc * (1 - W["mu_cr"])
                                 + shifted_c * W["mu_cr"]) @ W["cr"])
        # cr's rnn-split receptance meets the mlp-summed kk @ cv
        rr = collectives.all_gather(rr, self.mesh, self.axis, -1)
        y2 = rr * collectives.all_reduce(kk @ W["cv"], self.mesh,
                                         self.mlp_axis)
        return x + y2, {"S": S_new, "x_t": x_t_last, "x_c": x_c_last}
