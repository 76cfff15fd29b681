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
(``convert.shard_experts`` cuts the weights to that slice); a block of a
model built on a mesh (``split``) holds its block of every weight as the
rules cut it, the ff dimension of each expert too where "expert_mlp" is
split (``RULES_TP_2D``: over "data").  Below the expert-parallel path's
conditions (a decode step, a short prompt) such a block takes the
reference's other path under the mesh (``moe.py:187-243``): every rank
routes every token (the batch rows gathered over "data" where they are
split, the router's logits over "experts"), dispatches them per data
block with that block's capacity, runs its own experts on its slice of
their ff dimension, combines what its experts computed, and the ranks'
combines are summed (an all-reduce over "experts" and, for a split ff
dimension, a reduce-scatter over "data" back to each rank's rows).  A
block that holds every expert (built without a mesh, run under ``with
mesh:``) takes either path as the one-device block does.

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
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from . import collectives, sharding
from .layers import _dense_, _param, dtype_of, rmsnorm, split_of, use

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

    def __init__(self, cfg: ModelConfig, device=None, rules=None, mesh=None,
                 split=None):
        super().__init__()
        self.cfg = cfg
        self.rules = dict(cfg.rules if rules is None else rules)
        self.mesh = mesh
        self.ep_calls = 0
        d, ff, E = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
        dt, pdt = dtype_of(cfg.dtype), dtype_of(cfg.param_dtype)
        self.ln = _param((d,), pdt, device, split, ("embed",))
        self.router = _param((d, E), torch.float32, device, split,
                             ("embed", "experts"))
        if split is None:               # every expert, or a block's slice
            self.first, held = expert_slice(cfg, self.rules, mesh)
            self.expert_axis = (None if held == E
                                else self.rules["experts"])
            shape = (held, d, ff), (held, ff, d)
            logical = (None, None)
        else:
            shape = (E, d, ff), (E, ff, d)
            logical = (("experts", "embed", "expert_mlp"),
                       ("experts", "expert_mlp", "embed"))
        if cfg.act == "swiglu":
            self.wi_gate = _param(shape[0], dt, device, split, logical[0])
        self.wi = _param(shape[0], dt, device, split, logical[0])
        self.wo = _param(shape[1], dt, device, split, logical[1])
        #: where the experts and their ff dimension are split (a model's
        #: block on a mesh)
        self.ff_axis = None
        self.split_mesh = None if split is None else split.mesh
        if split is not None:
            self.expert_axis, _, index = split_of(self.wi, 0)
            self.first = index * self.wi.shape[0]
            self.ff_axis = split_of(self.wi, 2)[0]

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
            if p.shape[0] == E or getattr(p, "stored", None) is not None:
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
        logits = collectives.all_gather(h.float() @ use(self.router),
                                        self.split_mesh,
                                        split_of(self.router, 1)[0], -1)
        probs = torch.softmax(logits, dim=-1)
        # jax.lax.top_k: descending, the lower index first among ties
        gates, experts = probs.sort(dim=-1, descending=True, stable=True)
        gates, experts = gates[:, :k], experts[:, :k]
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        return logits, probs, gates, experts

    def forward(self, x, rows=(None, 1, 0)):
        """x: (B, S, d) -> (x + y, {"moe_aux", "moe_z"}), both float32
        scalars.  ``rows``: ``(axes, parts, index)`` of the batch rows a
        rank of a model on a mesh holds (its block of the whole batch)."""
        mo = self.cfg.moe
        row_axis, row_parts, row_index = rows
        x_rows = x
        if row_parts > 1:               # every rank routes every token
            # (in training each rank's gradient of the others' rows is a
            # partial: its aux losses', summed back to their ranks)
            x = collectives.all_gather(x, self.split_mesh, row_axis, 0,
                                       back="sum")
        B, S, d = x.shape
        T, E, k = B * S, mo.n_experts, mo.top_k
        h = rmsnorm(x, use(self.ln)).to(self.wi.dtype).reshape(T, d)
        # the router's logits and the experts are split over "experts":
        # each rank's share of dh, and of the gates' gradient (its experts
        # combine their own entries), is a partial
        axis = self.expert_axis if self.split_mesh is not None else None
        h = collectives.enter(h, self.split_mesh, axis)
        logits, probs, gates, experts = self.route(h)
        gates = collectives.enter(gates, self.split_mesh, axis)

        # load-balance and router-z losses; ce adds 1/(T k) per choice,
        # as the reference's scatter does (counts / (T k) rounds otherwise)
        ce = torch.zeros(E, device=x.device).scatter_add_(
            0, experts.reshape(-1),
            torch.full((T * k,), 1.0 / (T * k), device=x.device))
        aux = mo.aux_loss_weight * E * torch.sum(probs.mean(0) * ce)
        zloss = mo.router_z_weight * torch.mean(
            torch.logsumexp(logits, dim=-1) ** 2)

        mesh = self.mesh or self.split_mesh or sharding._current_mesh()
        tp = sharding.resolved_size(self.rules, "experts", mesh)
        dp = sharding.resolved_size(self.rules, "batch", mesh)
        if T % dp:
            dp = 1
        wts = {n: use(getattr(self, n)) for n in self._expert_names()}
        # the reference's condition (moe.py:177-178): all-to-all pays off
        # at prefill and training token counts; it needs ranks to run on,
        # or a model planned on a mesh description (the dry run)
        if (mesh is not None and tp > 1
                and (mesh.device_mesh is not None
                     or mesh is self.split_mesh)
                and E % tp == 0 and T % dp == 0
                and (T // dp) % tp == 0 and T // dp >= EP_MIN_TOKENS):
            for n, w in wts.items():        # whole experts, as shard_map's
                wts[n] = collectives.all_gather(
                    w, self.split_mesh, self.ff_axis, 1 if n == "wo" else 2,
                    back="sum")
            y = self._experts_ep(h, gates, experts, mesh, tp, wts)
        else:
            # one dispatch block per data shard (moe.py:190-241), this
            # rank's experts on its slice of their ff dimension
            y = torch.cat([self._experts(hb, gb, eb, wts) for hb, gb, eb in
                           zip(h.chunk(dp), gates.chunk(dp),
                               experts.chunk(dp))]) if dp > 1 else \
                self._experts(h, gates, experts, wts)
            y = collectives.all_reduce(y, self.split_mesh or self.mesh,
                                       self.expert_axis)
            if (row_parts > 1 and self.ff_axis is not None
                    and self.ff_axis == row_axis):
                y = collectives.reduce_scatter(y.reshape(B, S, d),
                                               self.split_mesh,
                                               self.ff_axis, 0)
                return x_rows + y, {"moe_aux": aux, "moe_z": zloss}
            y = collectives.all_reduce(y, self.split_mesh, self.ff_axis)
        y = y.reshape(B, S, d)
        if row_parts > 1:
            n = B // row_parts
            y = y[row_index * n:(row_index + 1) * n]
        return x_rows + y, {"moe_aux": aux, "moe_z": zloss}

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
        (``moe.py:192-241``), over the experts this block holds: the
        combine of the entries they took (the rest are summed in by the
        other ranks)."""
        T, d = h.shape
        E, k = self.cfg.moe.n_experts, self.cfg.moe.top_k
        held = wts["wi"].shape[0]
        cap = capacity(self.cfg, T)
        _, perm, slot, keep = dispatch(self.cfg, experts)
        buf = h.new_zeros(E * cap + 1, d)          # + the spare row
        buf.index_copy_(0, slot,
                        h[:, None].expand(T, k, d).reshape(T * k, d))
        lo = self.first * cap
        out = self._ffn(buf[lo:lo + held * cap].view(held, cap, d),
                        wts).view(held * cap, d)
        if held < E:
            slot = slot - lo
            keep = keep & (slot >= 0) & (slot < held * cap)
        return _combine(out, slot, keep, gates.gather(-1, perm))

    def _experts_ep(self, h, gates, experts, mesh, tp, wts):
        """The expert-parallel path (``moe.py:36-111``) as this rank's
        part: its chunk of its data shard's tokens out to the experts'
        owners and back, then every rank's chunks gathered.  ``wts``: the
        expert weights, whole in their ff dimension."""
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
        # (tp, E_loc, cap, d), grouped by owner rank: row block i goes to i
        recv = collectives.all_to_all(send[:E * cap], mesh, axis).view(
            tp, E_loc, cap, d)
        x_in = recv.transpose(0, 1).reshape(E_loc, tp * cap, d)
        r = mesh.coordinate(axis)
        if self.wi.shape[0] == E:                  # held whole: its slice
            wts = {n: w[r * E_loc:(r + 1) * E_loc] for n, w in wts.items()}
        out = self._ffn(x_in, wts)
        back = collectives.all_to_all(
            out.view(E_loc, tp, cap, d).transpose(0, 1).reshape(E * cap, d),
            mesh, axis)
        y = _combine(back, slot, keep, g_c.gather(-1, perm))
        y = collectives.all_gather(y, mesh, axis, 0)   # the shard's T_loc
        for a in reversed(batch_axes):              # minor axis first
            y = collectives.all_gather(y, mesh, a, 0)
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
