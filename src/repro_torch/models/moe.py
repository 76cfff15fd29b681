"""Mixture-of-experts channel mix: top-k routing, sort-based dispatch into
per-expert capacity, and the expert FFNs as batched products (counterpart
of ``repro/models/moe.py``).

Two paths, taken under the reference's own conditions (``moe.py:177-178``):

* the dispatch of ``moe.py:190-244``, in one block per data shard of the
  current mesh (one block off a mesh), each with its own capacity;
* on a mesh over ranks (:func:`repro_torch.launch.mesh.device_mesh`)
  whose "experts" axis has ``tp > 1`` ranks, with ``E % tp == 0`` and at
  least 2048 tokens per data shard, divisible by ``tp``: the
  expert-parallel path (``moe.py:36-111``, :meth:`MoE._experts_ep`).
  Each rank dispatches its own chunk of its shard's tokens into a
  (tp, E/tp, capacity, d) buffer grouped by owner rank, exchanges it
  with ``all_to_all_single``, runs its E/tp experts, sends the results
  back by the inverse exchange, combines, and reassembles the tokens by
  ``all_gather``.  The capacity comes from the chunk, so at a capacity
  factor that drops tokens it drops other ones than the one-device path
  (as the reference's does).  Over ``gloo`` the exchanges stage CUDA
  tensors through host memory.  It never runs inside a captured decode
  step (a decode step is far below 2048 tokens).

A block built with a mesh over ranks holds only its rank's E/tp experts
(``convert.shard_experts`` cuts the weights to that slice) and runs only
the expert-parallel path: it refuses a call below the path's conditions
(a decode step, a short prompt), since decoding on a mesh waits for the
tensor-parallel slice of the port.  A block that holds every expert
(built without a mesh, run under ``with mesh:``) takes either path.

Everything in the dispatch path is fixed-shape and reads no device value
on the host, so the block runs inside the serving engine's captured
decode step: counts come from a one-hot compare, masks from
``torch.where``.  Two writes differ in form from the reference's
scatter-adds, with the same numbers:

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
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from . import sharding
from .layers import _dense_, _param, dtype_of, rmsnorm

#: the fewest tokens per data shard that take the expert-parallel path
EP_MIN_TOKENS = 2048


def expert_slice(cfg: ModelConfig, rules, mesh) -> tuple[int, int]:
    """``(first, count)`` of the experts a rank of ``mesh`` holds: its
    E/tp experts when ``mesh`` is over ranks and the "experts" axis splits
    them evenly, else all of them."""
    E = cfg.moe.n_experts
    axis = rules.get("experts")
    if (mesh is None or mesh.device_mesh is None or not isinstance(axis, str)
            or axis not in mesh.axis_names):
        return 0, E
    tp = mesh.shape[axis]
    if tp <= 1 or E % tp:
        return 0, E
    return mesh.coordinate(axis) * (E // tp), E // tp


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
    ``cfg.dtype``.  ``rules`` (default ``cfg.rules``) and ``mesh`` (default:
    the current one, :mod:`repro_torch.models.sharding`) decide the path;
    built with a mesh over ranks, the block holds only its rank's experts
    (:func:`expert_slice`).  :attr:`ep_calls` counts the forwards that
    took the expert-parallel path."""

    def __init__(self, cfg: ModelConfig, device=None, rules=None, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.rules = dict(cfg.rules if rules is None else rules)
        self.mesh = mesh
        self.ep_calls = 0
        d, ff = cfg.d_model, cfg.d_ff
        self.first, held = expert_slice(cfg, self.rules, mesh)
        dt, pdt = dtype_of(cfg.dtype), dtype_of(cfg.param_dtype)
        self.ln = _param((d,), pdt, device)
        self.router = _param((d, cfg.moe.n_experts), torch.float32, device)
        if cfg.act == "swiglu":
            self.wi_gate = _param((held, d, ff), dt, device)
        self.wi = _param((held, d, ff), dt, device)
        self.wo = _param((held, ff, d), dt, device)

    def _expert_names(self):
        return (("wi_gate",) if self.cfg.act == "swiglu" else ()) + ("wi",
                                                                     "wo")

    def init(self, gen: torch.Generator) -> None:
        """N(0, d^-1/2) router and input projections, N(0, ff^-1/2)
        output projections (``fan_in_axes=(1,)``), zero norm.  A block
        that holds a slice of the experts draws all of them and keeps its
        slice, so it holds what the whole block would."""
        d, ff = self.cfg.d_model, self.cfg.d_ff
        self.ln.zero_()
        _dense_(self.router, d, gen)
        E = self.cfg.moe.n_experts
        for name in self._expert_names():
            p = getattr(self, name)
            fan_in = ff if name == "wo" else d
            if p.shape[0] == E:
                _dense_(p, fan_in, gen)
                continue
            x = torch.randn((E, *p.shape[1:]), generator=gen,
                            dtype=torch.float32, device=p.device)
            p.copy_(x[self.first:self.first + p.shape[0]].mul_(
                fan_in ** -0.5))

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

        mesh = self.mesh if self.mesh is not None else \
            sharding._current_mesh()
        tp = sharding.resolved_size(self.rules, "experts", mesh)
        dp = sharding.resolved_size(self.rules, "batch", mesh)
        if T % dp:
            dp = 1
        # the reference's condition (moe.py:177-178): all-to-all pays off
        # at prefill and training token counts; it needs ranks to run on
        if (mesh is not None and mesh.device_mesh is not None and tp > 1
                and E % tp == 0 and T % dp == 0
                and (T // dp) % tp == 0 and T // dp >= EP_MIN_TOKENS):
            y = self._experts_ep(h, gates, experts, mesh, tp)
        else:
            held = self.wi.shape[0]
            if held != E:
                raise ValueError(
                    f"this block holds experts [{self.first}, "
                    f"{self.first + held}) of {E}, so it runs only the "
                    f"expert-parallel path, which {T} tokens over "
                    f"{dp} data shard(s) do not take (it needs >= "
                    f"{EP_MIN_TOKENS} a shard, divisible by the {tp} "
                    f"expert ranks); decoding on a mesh waits for the "
                    f"tensor-parallel slice")
            # one dispatch block per data shard (moe.py:190-241)
            wts = {n: getattr(self, n) for n in self._expert_names()}
            y = torch.cat([self._experts(hb, gb, eb, wts) for hb, gb, eb in
                           zip(h.chunk(dp), gates.chunk(dp),
                               experts.chunk(dp))]) if dp > 1 else \
                self._experts(h, gates, experts, wts)
        return x + y.reshape(B, S, d), {"moe_aux": aux, "moe_z": zloss}

    def _ffn(self, x_in, wts):
        """The expert FFNs over (E', C, d) inputs with (E', d, ff) weights
        (``moe.py:23-33``)."""
        up = torch.bmm(x_in, wts["wi"])
        act = self.cfg.act
        if act == "swiglu":
            a = F.silu(torch.bmm(x_in, wts["wi_gate"])) * up
        elif act == "squared_relu":
            a = torch.square(F.relu(up))
        elif act == "gelu":
            a = F.gelu(up, approximate="tanh")     # jax.nn.gelu's default
        else:
            raise ValueError(act)
        return torch.bmm(a, wts["wo"])

    def _experts(self, h, gates, experts, wts):
        """Dispatch, expert FFNs and gated combine of one block of tokens
        (``moe.py:192-241``)."""
        T, d = h.shape
        E, k = self.cfg.moe.n_experts, self.cfg.moe.top_k
        cap = capacity(self.cfg, T)
        _, perm, slot, keep = dispatch(self.cfg, experts)
        buf = h.new_zeros(E * cap + 1, d)          # + the spare row
        buf.index_copy_(0, slot,
                        h[:, None].expand(T, k, d).reshape(T * k, d))
        out = self._ffn(buf[:E * cap].view(E, cap, d), wts).view(E * cap, d)
        return _combine(out, slot, keep, gates.gather(-1, perm))

    def _experts_ep(self, h, gates, experts, mesh, tp):
        """The expert-parallel path (``moe.py:36-111``) as this rank's
        part: its chunk of its data shard's tokens out to the experts'
        owners and back, then every rank's chunks gathered."""
        self.ep_calls += 1
        T, d = h.shape
        E, k = self.cfg.moe.n_experts, self.cfg.moe.top_k
        E_loc = E // tp
        axis = self.rules["experts"]
        batch_axes = tuple(a for a in (self.rules.get("batch") or ())
                           if a in mesh.axis_names)
        dp, block = 1, 0
        for a in batch_axes:                    # row-major over the axes
            dp *= mesh.shape[a]
            block = block * mesh.shape[a] + mesh.coordinate(a)
        T_loc = T // dp
        chunk = T_loc // tp
        # the capacity of the chunk each rank dispatches (moe.py:65)
        cap = capacity(self.cfg, chunk)
        lo = block * T_loc + mesh.coordinate(axis) * chunk
        h_c, g_c, e_c = (t[lo:lo + chunk] for t in (h, gates, experts))
        _, perm, slot, keep = dispatch(self.cfg, e_c, cap)
        send = h_c.new_zeros(E * cap + 1, d)
        send.index_copy_(0, slot,
                         h_c[:, None].expand(chunk, k, d).reshape(-1, d))
        group = mesh.group(axis)
        # (tp, E_loc, cap, d), grouped by owner rank: row block i goes to i
        recv = _all_to_all(send[:E * cap], group).view(tp, E_loc, cap, d)
        x_in = recv.transpose(0, 1).reshape(E_loc, tp * cap, d)
        r = mesh.coordinate(axis)
        wts = {n: getattr(self, n) for n in self._expert_names()}
        if self.wi.shape[0] == E:                  # held whole: its slice
            wts = {n: w[r * E_loc:(r + 1) * E_loc] for n, w in wts.items()}
        out = self._ffn(x_in, wts)
        back = _all_to_all(out.view(E_loc, tp, cap, d).transpose(0, 1)
                           .reshape(E * cap, d), group)
        y = _combine(back, slot, keep, g_c.gather(-1, perm))
        y = torch.cat(_all_gather(y, group))        # the shard's T_loc
        for a in reversed(batch_axes):              # minor axis first
            if mesh.shape[a] > 1:
                y = torch.cat(_all_gather(y, mesh.group(a)))
        return y


def _combine(out, slot, keep, gates):
    """Each token's ``k`` gated expert outputs (rows ``slot`` of ``out``),
    summed in ascending expert id from zero, in the activation dtype."""
    T, k = gates.shape
    got = torch.where(keep[:, None], out[torch.where(keep, slot, 0)], 0)
    contrib = (got * gates.reshape(T * k, 1).to(out.dtype)).view(T, k, -1)
    y = torch.zeros_like(contrib[:, 0])
    for j in range(k):
        y = y + contrib[:, j]
    return y


def _staged(t, group):
    """Where ``t`` crosses ranks over ``group``: host memory for a CUDA
    tensor under ``gloo`` (which carries CPU tensors), else in place."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return t.cpu()
    return t


def _all_to_all(t, group):
    """``all_to_all_single`` of ``t``'s rows, split evenly over ``group``."""
    src = _staged(t.contiguous(), group)
    dst = torch.empty_like(src)
    dist.all_to_all_single(dst, src, group=group)
    return dst.to(t.device)


def _all_gather(t, group) -> list:
    """Every rank of ``group``'s ``t``, in rank order."""
    src = _staged(t.contiguous(), group)
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    return [o.to(t.device) for o in out]


def dispatch(cfg: ModelConfig, experts, cap: int | None = None):
    """Where each (token, choice) goes (``moe.py:193-207``).

    ``experts``: (T, k) chosen experts.  Returns each token's experts in
    ascending order (the combine's order) and the permutation that sorted
    them, both (T, k), and, flat over that token-major layout, each
    entry's buffer row (``e * cap + position``; ``E * cap``, the spare
    row, where dropped) and whether it was kept.  An entry's position is
    the reference's: its rank among its expert's entries in token order
    (a stable sort by expert), so the lowest token indices keep their
    places when an expert is over capacity.  ``cap``: slots per expert
    (default: :func:`capacity` of the ``T`` tokens)."""
    T, k = experts.shape
    E = cfg.moe.n_experts
    cap = capacity(cfg, T) if cap is None else cap
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
