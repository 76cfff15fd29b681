"""Mixture-of-experts channel mix: top-k routing, sort-based dispatch into
per-expert capacity, and the expert FFNs as batched products (counterpart
of ``repro/models/moe.py``).

The port runs the reference's single-device path (``moe.py:134-244``
with one dispatch block): the expert-parallel ``shard_map`` branch
(``moe.py:36-111,174-188``) waits for the port's multi-device work.

Everything here is fixed-shape and reads no device value on the host, so
the block runs inside the serving engine's captured decode step: counts
come from a one-hot compare, masks from ``torch.where``.  Two writes
differ in form from the reference's scatter-adds, with the same numbers:

* Dispatch sends a dropped entry to a spare row past the ``E * cap``
  rows the experts read, where the reference adds zeros into slot
  (0, 0): a plain copy then never races a kept entry.
* Combine gathers each token's ``k`` gated expert outputs and sums them
  in ascending expert id, starting from zero in the activation dtype,
  which is the order the reference's scatter-add applies them in.  An
  atomic ``index_add_`` would add them in another order on every run.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from .layers import _dense_, _param, dtype_of, rmsnorm


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert for ``tokens`` tokens (``moe.py:193``).  Python's
    ``round`` rounds half to even, as the reference's does: 2.5 -> 2."""
    mo = cfg.moe
    return int(max(1, round(tokens * mo.top_k * mo.capacity_factor
                            / mo.n_experts)))


class MoE(nn.Module):
    """Pre-norm mixture-of-experts residual block (``moe.py:113-244``).

    ``router`` is kept in float32, as the reference uses it; the expert
    weights ``wi_gate``/``wi`` (E, d, ff) and ``wo`` (E, ff, d) in
    ``cfg.dtype``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, ff, E = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
        dt, pdt = dtype_of(cfg.dtype), dtype_of(cfg.param_dtype)
        self.ln = _param((d,), pdt, device)
        self.router = _param((d, E), torch.float32, device)
        if cfg.act == "swiglu":
            self.wi_gate = _param((E, d, ff), dt, device)
        self.wi = _param((E, d, ff), dt, device)
        self.wo = _param((E, ff, d), dt, device)

    def init(self, gen: torch.Generator) -> None:
        """N(0, d^-1/2) router and input projections, N(0, ff^-1/2)
        output projections (``fan_in_axes=(1,)``), zero norm."""
        d, ff = self.cfg.d_model, self.cfg.d_ff
        self.ln.zero_()
        _dense_(self.router, d, gen)
        if self.cfg.act == "swiglu":
            _dense_(self.wi_gate, d, gen)
        _dense_(self.wi, d, gen)
        _dense_(self.wo, ff, gen)

    def route(self, h):
        """Router of the normed tokens ``h`` (T, d) in ``cfg.dtype``
        (``moe.py:159-164``): float32 ``(logits, probs)`` (T, E) and the
        top-k ``(gates, experts)`` (T, k), gates renormalised."""
        k = self.cfg.moe.top_k
        logits = h.float() @ self.router
        probs = torch.softmax(logits, dim=-1)
        # jax.lax.top_k: descending, the lower index first among ties
        gates, experts = probs.sort(dim=-1, descending=True, stable=True)
        gates, experts = gates[:, :k], experts[:, :k]
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        return logits, probs, gates, experts

    def forward(self, x):
        """x: (B, S, d) -> (x + y, {"moe_aux", "moe_z"}), both float32
        scalars."""
        mo = self.cfg.moe
        B, S, d = x.shape
        T, E, k = B * S, mo.n_experts, mo.top_k
        h = rmsnorm(x, self.ln).to(self.wi.dtype).reshape(T, d)
        logits, probs, gates, experts = self.route(h)

        # load-balance and router-z losses; ce adds 1/(T k) per choice,
        # as the reference's scatter does (counts / (T k) rounds otherwise)
        ce = torch.zeros(E, device=x.device).scatter_add_(
            0, experts.reshape(-1),
            torch.full((T * k,), 1.0 / (T * k), device=x.device))
        aux = mo.aux_loss_weight * E * torch.sum(probs.mean(0) * ce)
        zloss = mo.router_z_weight * torch.mean(
            torch.logsumexp(logits, dim=-1) ** 2)

        y = self._experts(h, gates, experts).reshape(B, S, d)
        return x + y, {"moe_aux": aux, "moe_z": zloss}

    def _experts(self, h, gates, experts):
        """Dispatch, expert FFNs and gated combine (``moe.py:192-241``)."""
        T, d = h.shape
        E, k = self.cfg.moe.n_experts, self.cfg.moe.top_k
        cap = capacity(self.cfg, T)
        _, perm, slot, keep = dispatch(self.cfg, experts)
        gates = gates.gather(-1, perm)

        buf = h.new_zeros(E * cap + 1, d)          # + the spare row
        buf.index_copy_(0, slot,
                        h[:, None].expand(T, k, d).reshape(T * k, d))
        x_in = buf[:E * cap].view(E, cap, d)
        up = torch.bmm(x_in, self.wi)
        act = self.cfg.act
        if act == "swiglu":
            a = F.silu(torch.bmm(x_in, self.wi_gate)) * up
        elif act == "squared_relu":
            a = torch.square(F.relu(up))
        elif act == "gelu":
            a = F.gelu(up, approximate="tanh")     # jax.nn.gelu's default
        else:
            raise ValueError(act)
        out = torch.bmm(a, self.wo).view(E * cap, d)

        got = torch.where(keep[:, None], out[torch.where(keep, slot, 0)], 0)
        contrib = (got * gates.reshape(T * k, 1).to(h.dtype)).view(T, k, d)
        y = torch.zeros_like(h)
        for j in range(k):
            y = y + contrib[:, j]
        return y


def dispatch(cfg: ModelConfig, experts):
    """Where each (token, choice) goes (``moe.py:193-207``).

    ``experts``: (T, k) chosen experts.  Returns each token's experts in
    ascending order (the combine's order) and the permutation that sorted
    them, both (T, k), and, flat over that token-major layout, each
    entry's buffer row (``e * cap + position``; ``E * cap``, the spare
    row, where dropped) and whether it was kept.  An entry's position is
    the reference's: its rank among its expert's entries in token order
    (a stable sort by expert), so the lowest token indices keep their
    places when an expert is over capacity."""
    T, k = experts.shape
    E = cfg.moe.n_experts
    cap = capacity(cfg, T)
    dev = experts.device
    experts, perm = experts.sort(dim=-1)
    flat = experts.reshape(T * k)
    order = torch.argsort(flat, stable=True)
    counts = (flat[:, None] == torch.arange(E, device=dev)).sum(0)
    starts = counts.cumsum(0) - counts
    rank = torch.empty_like(order)
    rank[order] = torch.arange(T * k, device=dev)
    pos = rank - starts[flat]
    keep = pos < cap
    slot = torch.where(keep, flat * cap + pos, E * cap)
    return experts, perm, slot, keep
