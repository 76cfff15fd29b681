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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from .layers import _dense_, _param, dtype_of, rmsnorm

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

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, r = cfg.d_model, cfg.d_rnn
        dt, pdt = dtype_of(cfg.dtype), dtype_of(cfg.param_dtype)
        self.ln = _param((d,), pdt, device)
        self.w_in = _param((d, r), dt, device)
        self.w_gate = _param((d, r), dt, device)
        self.conv_w = _param((4, r), dt, device)
        self.conv_b = _param((r,), dt, device)
        self.wa = _param((r, r), dt, device)
        self.wx = _param((r, r), dt, device)
        self.lam = _param((r,), torch.float32, device)
        self.w_out = _param((r, d), dt, device)

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
        self.lam.copy_(torch.log(lin / (1 - lin)))

    def forward(self, x, state=None, backend="auto"):
        dt = self.w_in.dtype
        h_in = rmsnorm(x, self.ln).to(dt)
        gate = F.gelu(h_in @ self.w_gate, approximate="tanh")
        u = h_in @ self.w_in
        u, conv = _causal_conv4(u, self.conv_w, self.conv_b,
                                None if state is None else state["conv"])
        rgate = torch.sigmoid(u @ self.wa)
        igate = torch.sigmoid(u @ self.wx)
        a = torch.exp(-RGLRU_C * F.softplus(self.lam) * rgate.float())
        gated_in = (torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12))
                    * (igate * u).float())
        h_seq, h_last = ops.linear_scan(
            a.to(dt), gated_in.to(dt),
            None if state is None else state["h"], backend=backend)
        y = (h_seq * gate) @ self.w_out
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

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, ff = cfg.d_model, cfg.d_ff
        H = rwkv_heads(cfg)
        dt, pdt = dtype_of(cfg.dtype), dtype_of(cfg.param_dtype)
        f32 = torch.float32
        self.ln_t = _param((d,), pdt, device)
        for name in ("wr", "wk", "wv", "wg", "wo_t", "cr"):
            setattr(self, name, _param((d, d), dt, device))
        for name in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_cr", "mu_ck"):
            setattr(self, name, _param((d,), dt, device))
        self.w0 = _param((d,), f32, device)
        self.w_lora_a = _param((d, 64), f32, device)
        self.w_lora_b = _param((64, d), f32, device)
        self.u = _param((H, d // H), dt, device)
        self.ln_c = _param((d,), pdt, device)
        self.ck = _param((d, ff), dt, device)
        self.cv = _param((ff, d), dt, device)

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
        dt = self.wr.dtype
        B, S, d = x.shape
        H = self.u.shape[0]
        dh = d // H
        if state is None:
            zeros = torch.zeros((B, d), dtype=dt, device=x.device)
            state = {"S": torch.zeros((B, H, dh, dh), dtype=torch.float32,
                                      device=x.device),
                     "x_t": zeros, "x_c": zeros}

        # ---- time mix ----
        h = rmsnorm(x, self.ln_t).to(dt)
        shifted, x_t_last = _token_shift(h, state["x_t"].to(dt))

        def lerp(mu):
            return h * (1 - mu) + shifted * mu

        r = (lerp(self.mu_r) @ self.wr).reshape(B, S, H, dh)
        k = (lerp(self.mu_k) @ self.wk).reshape(B, S, H, dh)
        v = (lerp(self.mu_v) @ self.wv).reshape(B, S, H, dh)
        g = F.silu(h @ self.wg)
        xw = lerp(self.mu_w)
        w_log = self.w0 + torch.tanh(xw.float() @ self.w_lora_a) \
            @ self.w_lora_b
        w = torch.exp(-torch.exp(w_log)).reshape(B, S, H, dh)
        y, S_new = ops.rwkv6(r, k, v, w.to(dt), self.u, state["S"],
                             backend=backend)
        x = x + (y.reshape(B, S, d) * g) @ self.wo_t

        # ---- channel mix ----
        hc = rmsnorm(x, self.ln_c).to(dt)
        shifted_c, x_c_last = _token_shift(hc, state["x_c"].to(dt))
        kk = (hc * (1 - self.mu_ck) + shifted_c * self.mu_ck) @ self.ck
        kk = torch.square(F.relu(kk))
        rr = torch.sigmoid((hc * (1 - self.mu_cr) + shifted_c * self.mu_cr)
                           @ self.cr)
        y2 = rr * (kk @ self.cv)
        return x + y2, {"S": S_new, "x_t": x_t_last, "x_c": x_c_last}
