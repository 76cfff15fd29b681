"""Model facade: parameters, init, prefill / decode steps, caches and
the training loss (counterpart of ``repro/models/model.py``).

``Model`` owns its parameters (an ``nn.Module``) where the reference
passes a params pytree; ``init`` fills them from an explicit
``torch.Generator`` with the reference's distributions, and
``repro_torch.models.convert`` carries the reference's own params across.

Two layouts.  ``layout="serve"`` (the default) stores each weight once
in the dtype it is used in (``layers.py``), with no gradient.
``layout="train"`` keeps the reference's float32 leaves instead:
``leaves`` maps each reference path (``"groups/0/t/wq"``) to a tensor in
the reference's shape, every block-pattern group stacked on a leading
layer axis and attention heads on their own axis, and ``grads`` holds a
gradient buffer of the same shape for each.  The layer modules then hold
no storage (they live on ``meta``); each forward binds every layer's
weights to views of the leaves, cast to ``cfg.dtype`` where the
reference casts them (``convert.leaf_map``).  The views' autograd leaves
alias the leaves and their ``.grad`` aliases ``grads``, so a backward
accumulates every layer's gradient in place into its row of the stacked
buffer.

``rules`` (default ``cfg.rules``, as the reference's; pass
``cfg.serve_rules`` to serve as the reference's dry run does) and
``mesh`` (a ``repro_torch.launch.mesh.Mesh``): a model built on a mesh
holds on each rank its block of every weight and cache as
``named_sharding`` cuts it under ``rules``
(:class:`repro_torch.models.sharding.Split`; ``convert.shard_params``
cuts a whole model's state dict, such as ``convert.params_from_jax``'s,
to a rank's), and its prefill and decode steps run tensor-parallel
(``layers``, ``recurrent``, ``moe``): every rank is given the whole
batch and returns the whole batch's logits.  On a mesh *description*
(no ranks: the dry run's) the same code runs as rank 0 and its
collectives only record.  The decode step on a mesh runs eagerly: a
collective over ``gloo`` cannot be captured in a CUDA graph.

Training on a mesh (``layout="train"``, ``rules=cfg.rules``: ZeRO-3 or
FSDP-TP) keeps on each rank its block of every float32 leaf and a
gradient buffer of that block (``leaf_shardings``, the reference's
``in_shardings``); ``convert.shard_leaves`` cuts whole leaves to them and
``convert.gather_leaves`` is its inverse.  ``loss_fn`` is given the
whole batch and runs this rank's rows of it: each layer gathers its
weights over the "embed" axes at use (``layers.use``, a reduce-scatter
back) and runs tensor-parallel where the rules split heads, "mlp",
"rnn", "vocab" or "experts", with the gradients' collectives of
:mod:`repro_torch.models.collectives`; a leaf that the rows' axes do not
split gets its gradient summed over them.  The loss it returns is this
rank's share (its rows' token losses over the whole batch's count, plus
its share of the MoE losses every rank computes); its metrics are the
batch's, summed over the ranks.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.runtime import resolve_device
from . import collectives, convert, kvcache, transformer
from .layers import SPLIT_ATTRS, Embeddings, cross_entropy, dtype_of
from .recurrent import rwkv_heads
from .sharding import Split, named_sharding

LAYOUTS = ("serve", "train")


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, backend: str = "auto",
                 device: str | torch.device | None = None,
                 layout: str = "serve", rules=None, mesh=None):
        super().__init__()
        if layout not in LAYOUTS:
            raise ValueError(f"unknown layout {layout!r}; have {LAYOUTS}")
        self.cfg = cfg
        self.rules = dict(cfg.rules if rules is None else rules)
        self.mesh = mesh
        self.backend = backend
        self.layout = layout
        self.device = resolve_device(device)
        where = self.device if layout == "serve" else torch.device("meta")
        #: how this rank holds and uses its tensors on a mesh, else None
        self.split = None if mesh is None else Split(mesh, self.rules)
        self.emb = Embeddings(cfg, where, self.split)
        self.layers = nn.ModuleList(
            transformer.Layer(cfg, kind, where, self.rules, mesh, self.split)
            for kind in cfg.layer_kinds)
        #: the mesh axes that split the batch rows of the last training
        #: pass (``loss_fn``)
        self.row_axes: tuple[str, ...] = ()
        if layout == "train":
            self._init_leaves()

    def _init_leaves(self) -> None:
        params = dict(self.named_parameters())
        shapes, self._row_of = convert.leaf_map(
            self.cfg, ((n, getattr(p, "whole", p.shape))
                       for n, p in params.items()))
        #: each leaf's whole shape and its logical axes (the reference's
        #: spec, "layers" first where stacked)
        self.leaf_shapes = shapes
        self.leaf_logical = {}
        for name, (path, row) in self._row_of.items():
            lg = getattr(params[name], "logical", None) or (None,) * len(
                shapes[path][row is not None:])
            self.leaf_logical[path] = (("layers",) if row is not None
                                       else ()) + tuple(lg)
        #: this rank's block of each leaf (None off a mesh)
        self.leaf_shardings = None
        blocks = shapes
        if self.split is not None:
            self.leaf_shardings = {
                path: named_sharding(self.mesh, self.rules,
                                     self.leaf_logical[path], shape)
                for path, shape in shapes.items()}
            blocks = {path: ns.shard_shape(shapes[path])
                      for path, ns in self.leaf_shardings.items()}
        dt = dtype_of(self.cfg.param_dtype)
        self.leaves = {path: torch.empty(shape, dtype=dt, device=self.device)
                       for path, shape in blocks.items()}
        self.grads = {path: torch.zeros_like(t)
                      for path, t in self.leaves.items()}
        self._rows = {}
        for name, (path, row) in self._row_of.items():
            leaf, grad = self.leaves[path], self.grads[path]
            if row is not None:
                leaf, grad = leaf[row], grad[row]
            p = params[name]
            if leaf.numel() != p.numel():
                raise AssertionError(f"{name}: block {tuple(leaf.shape)} of "
                                     f"leaf {path} != {tuple(p.shape)}")
            t = leaf.detach().requires_grad_()
            t.grad = grad
            self._rows[name] = t

    # ------------------------------------------------------------------
    @torch.no_grad()
    def init(self, generator: torch.Generator | None = None) -> "Model":
        """Random weights: N(0, fan_in^-1/2) projections, N(0, 0.02) token
        table, zero norms and biases (``layers.py:23-31,228-242``).  The
        generator must live on the model's device.  Both layouts draw the
        same numbers in the same order; the serving layout stores them
        cast to the dtype each weight is used in, and on a mesh each rank
        draws every weight whole, one at a time, and keeps its block."""
        gen = generator
        if gen is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
        for prefix, module in self._modules_in_order():
            with self.bound(prefix, module, cast=False):
                module.init(gen)
        return self

    def _modules_in_order(self):
        yield "emb", self.emb
        for i, layer in enumerate(self.layers):
            yield f"layers.{i}", layer

    def bound(self, prefix: str, module: nn.Module, cast: bool = True):
        """Context in which ``module`` (``prefix`` in this model) runs on
        the training layout's leaves: each parameter a view of its leaf's
        row, reshaped to the serving shape and (``cast``) cast to the
        serving dtype, which is where the reference casts it.  A no-op in
        the serving layout."""
        if self.layout == "serve":
            return contextlib.nullcontext()
        weights = {}
        for name, p in module.named_parameters():
            row = self._rows[f"{prefix}.{name}"]
            if not cast:
                row = row.detach()
            elif self.split is not None:
                # a leaf the rows' axes do not split: each rank's
                # gradient of it is its rows' partial
                gathered = {a for _, a in getattr(p, "gathers", ())}
                for a in self.row_axes:
                    if a not in gathered:
                        row = collectives.enter(row, self.mesh, a)
            w = row.reshape(p.shape)
            w = w.to(p.dtype) if cast else w
            if self.split is not None:
                for attr in SPLIT_ATTRS:
                    if hasattr(p, attr):
                        setattr(w, attr, getattr(p, attr))
                w.rows = self.row_axes
            weights[name] = w
        return _bind(module, weights)

    def weights(self) -> dict[str, torch.Tensor]:
        """The tensors that hold this model's weights: the parameters
        (serving layout) or the reference-shaped leaves (training)."""
        if self.layout == "train":
            return dict(self.leaves)
        return dict(self.named_parameters())

    @torch.no_grad()
    def zero_grads(self) -> None:
        for g in self.grads.values():
            g.zero_()

    # ------------------------------------------------------------------
    def loss_fn(self, batch):
        """Mean token NLL + z-loss + the MoE losses, with gradients
        enabled (``repro``'s ``transformer.loss_fn``).  Returns ``(loss,
        metrics)``; in the training layout a ``backward`` of the loss
        accumulates into ``grads``.  On a mesh ``batch`` is the whole
        batch, ``loss`` this rank's share of the batch's loss (its
        backward gives this rank's blocks of the batch's gradients) and
        ``metrics`` the batch's: the token terms summed over the ranks,
        the MoE losses every rank computes."""
        count = None
        if self.split is not None:
            labels = batch["labels"]
            mask = batch.get("mask")
            count = (mask.float().sum() if mask is not None else torch.tensor(
                float(labels.numel()), device=labels.device))
        batch, rows = transformer.batch_rows(self, batch)
        axis, parts, _ = rows
        # kept for the backward, whose remat recompute binds the weights
        # again
        self.row_axes = () if axis is None else (
            axis if isinstance(axis, tuple) else (axis,))
        with torch.enable_grad():
            logits, aux = transformer.train_forward(self, batch, rows)
            loss, metrics = cross_entropy(self.cfg, logits, batch["labels"],
                                          batch.get("mask"), count)
            for k, v in aux.items():
                # each rank computes the MoE losses of every row
                loss = loss + (v / parts if parts > 1 else v)
                metrics[k] = v
        metrics["loss"] = loss
        if parts > 1:
            with torch.no_grad():
                keys = ("loss", "nll", "z")
                t = torch.stack([metrics[k].detach() for k in keys])
                for a in (axis if isinstance(axis, tuple) else (axis,)):
                    t = collectives.all_reduce(t, self.mesh, a)
                metrics.update(zip(keys, t.unbind()))
        return loss, metrics

    # ------------------------------------------------------------------
    @torch.no_grad()
    def forward(self, batch, last_only: bool = False):
        """Logits (B, S or 1, V) in f32, no caches."""
        self._serving()
        logits, _, _ = transformer.forward(self, batch, last_only=last_only)
        return logits

    @torch.no_grad()
    def prefill(self, batch, capacity: int | None = None, cache_out=None):
        """Returns (last-token logits, decode caches).

        ``capacity``: cache slots to allocate (default prompt length + 64,
        as the reference).  ``cache_out``: per-layer cache views to write
        into instead of allocating (see ``transformer.forward``)."""
        self._serving()
        seq = (batch["embeds"] if self.cfg.embeds_only
               else batch["token_ids"]).shape[1]
        logits, caches, _ = transformer.forward(
            self, batch, collect_kv=True, last_only=True,
            cache_capacity=capacity or seq + 64, cache_out=cache_out)
        return logits, caches

    @torch.no_grad()
    def decode_step(self, caches, batch):
        self._serving()
        return transformer.decode_step(self, caches, batch)

    def _serving(self) -> None:
        if self.layout != "serve":
            raise ValueError("prefill, decode and forward run on the serving "
                             "layout; this model has the training layout")

    # ------------------------------------------------------------------
    def init_cache(self, batch: int, capacity: int):
        """Zeroed decode caches, one dict per layer: ``{"k", "v"}`` for
        attention, ``{"h", "conv"}`` for RG-LRU, ``{"S", "x_t", "x_c"}``
        for RWKV-6 (the shapes of ``repro/models/model.py:114-140``).  On
        a mesh, this rank's block of each (``dryrun.cache_logical``'s
        axes): its batch rows, its chunk of a KV cache split by sequence,
        its RG-LRU channels and RWKV-6 heads."""
        cfg = self.cfg
        dt = dtype_of(cfg.dtype)
        H = rwkv_heads(cfg)
        dh = cfg.d_model // H
        rows = batch
        if self.split is not None:
            rows = self.split.rows(batch).shard_shape((batch,))[0]

        def zeros(*shape, dtype=dt):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        def one(layer):
            kind = layer.kind
            if kind == "rglru":
                r = layer.t.r_loc
                return {"h": zeros(rows, r, dtype=torch.float32),
                        "conv": zeros(rows, 3, r)}
            if kind == "rwkv":
                h = layer.t.u.shape[0]
                return {"S": zeros(rows, h, dh, dh, dtype=torch.float32),
                        "x_t": zeros(rows, cfg.d_model),
                        "x_c": zeros(rows, cfg.d_model)}
            cap = (min(cfg.local_window, capacity) if kind == "local"
                   else capacity)
            split = self.kv_seq_split(batch, cap)
            return {name: kvcache.new_layer(rows, cap, cfg.n_kv_heads,
                                            cfg.d_head, cfg.kv_cache_dtype,
                                            self.device, split)
                    for name in ("k", "v")}

        return [one(layer) for layer in self.layers]

    def kv_seq_split(self, batch: int, slots: int) -> tuple:
        """``(axes, parts, index)`` of the sequence of a KV cache of
        ``batch`` x ``slots`` on this model's mesh (``kv_seq``, where the
        slots divide; ``(None, 1, 0)`` off a mesh)."""
        if self.split is None:
            return (None, 1, 0)
        cfg = self.cfg
        ns = self.split.stored(("batch", "kv_seq", "kv_heads", "head_dim"),
                               (batch, slots, cfg.n_kv_heads, cfg.d_head))
        if ns.block(2)[1] > 1:
            raise NotImplementedError(
                f"a KV cache split over its kv heads ({ns.spec}): the port "
                f"splits it by sequence only")
        return ns.block(1)


def build(cfg: ModelConfig, **kw) -> Model:
    return Model(cfg, **kw)


@contextlib.contextmanager
def _bind(module: nn.Module, weights: dict[str, torch.Tensor]):
    """Run ``module`` with ``weights`` (dotted names) in place of its
    parameters; the parameters come back on exit."""
    saved = []
    try:
        for name, w in weights.items():
            owner, _, attr = name.rpartition(".")
            owner = module.get_submodule(owner)
            saved.append((owner, attr, owner._parameters[attr]))
            owner._parameters[attr] = w
        yield module
    finally:
        for owner, attr, p in reversed(saved):
            owner._parameters[attr] = p
