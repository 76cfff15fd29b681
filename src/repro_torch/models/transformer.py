"""Layer stack: one residual layer per ``cfg.layer_kinds`` entry, and the
prefill / decode passes over it (counterpart of
``repro/models/transformer.py``).

The reference stacks the parameters of repeating block-pattern groups and
runs them under ``jax.lax.scan``; PyTorch runs eagerly, so the port keeps
one module per layer and loops.  Every layer kind is ported (``attn``,
``local``, ``rglru``, ``rwkv``), and so is the channel mix of each: the
MLP, or the mixture of experts where ``cfg.moe`` is set.

Each layer's cache is a dict: ``{"k", "v"}`` KV-cache views for
attention, ``{"h", "conv"}`` for RG-LRU, ``{"S", "x_t", "x_c"}`` for
RWKV-6 (shapes: ``Model.init_cache``).  Prefill writes into the views it
is given and a decode step updates its caches, both in place.

On a mesh (``model.split``) every pass takes the whole batch and returns
the whole batch's logits: each rank runs its block of the batch rows
(split over the "batch" axes where they divide), and the logits are
gathered back over those axes.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.configs.base import ModelConfig
from . import collectives, kvcache, layers, moe, recurrent

#: the rows split of a batch off a mesh: (axes, parts, index)
WHOLE = (None, 1, 0)

ATTENTION = ("attn", "local")
RECURRENT = ("rglru", "rwkv")


class Layer(nn.Module):
    """One residual layer: a token mixer ``t`` and a channel mix ``c``, an
    MLP or (``cfg.moe``) a mixture of experts (none for ``rwkv``, which
    carries its own).  ``rules`` and ``mesh`` reach the mixture of
    experts, the one layer that reads them (``moe.MoE``)."""

    def __init__(self, cfg: ModelConfig, kind: str, device=None,
                 rules=None, mesh=None, split=None):
        super().__init__()
        self.kind = kind
        if kind in ATTENTION:
            self.t = layers.Attention(cfg, kind, device, split)
        elif kind == "rglru":
            self.t = recurrent.RGLRU(cfg, device, split)
        elif kind == "rwkv":
            self.t = recurrent.RWKV(cfg, device, split)
        else:
            raise ValueError(f"unknown layer kind {kind!r}")
        if kind == "rwkv":
            self.c = None
        elif cfg.moe is not None:
            self.c = moe.MoE(cfg, device, rules=rules, mesh=mesh,
                             split=split)
        else:
            self.c = layers.MLP(cfg, device, split)

    def init(self, gen: torch.Generator) -> None:
        self.t.init(gen)
        if self.c is not None:
            self.c.init(gen)

    def forward(self, x, positions, *, cache=None, lengths=None,
                backend="auto", rows=WHOLE):
        """Returns ``(x, new, aux)``: for attention ``new`` is the prompt's
        ``(k, v)`` (prefill) or the updated cache views (decode); for the
        recurrent kinds it is the new state, never written into
        ``cache``.  ``aux`` holds the MoE losses (empty otherwise).
        ``rows``: the batch rows ``x`` holds on a mesh (the MoE routes
        every rank's)."""
        if self.kind in ATTENTION:
            kv = None if cache is None else (cache["k"], cache["v"])
            x, new = self.t(x, positions, cache=kv, lengths=lengths,
                            backend=backend)
        else:
            x, new = self.t(x, state=cache, backend=backend)
        aux = {}
        if isinstance(self.c, moe.MoE):
            x, aux = self.c(x, rows)
        elif self.c is not None:
            x = self.c(x)
        return x, new, aux


def forward(model, batch, *, collect_kv=False, last_only=False,
            cache_capacity=None, cache_out=None):
    """Full-sequence forward (train / prefill).

    Returns ``(logits, caches, aux)``; ``caches`` is ``None`` unless
    ``collect_kv``, else one cache dict per layer; ``aux`` sums the MoE
    losses (``moe_aux``, ``moe_z``) over the layers, as the reference's
    ``forward`` does (0.0 without experts).  ``cache_out``:
    per-layer views to write the prompt's k/v and the final recurrent
    states into in place (the serving engine passes its slot of the
    batched cache); otherwise caches of ``cache_capacity`` slots are
    allocated.
    """
    cfg = model.cfg
    batch, rows = batch_rows(model, batch)
    x = model.emb.embed(batch)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    caches = [] if collect_kv else None
    aux_total = {"moe_aux": 0.0, "moe_z": 0.0}
    for i, layer in enumerate(model.layers):
        x, new, aux = layer(x, positions, backend=model.backend, rows=rows)
        for name, v in aux.items():
            aux_total[name] = aux_total[name] + v
        if not collect_kv:
            continue
        if layer.kind in RECURRENT:
            if cache_out is not None:
                c = cache_out[i]
                for name, t in new.items():
                    c[name].copy_(t)
            else:
                c = {name: t.clone() for name, t in new.items()}
            caches.append(c)
            continue
        k, v = layer.t.whole_kv(*new)
        window = cfg.local_window if layer.kind == "local" else None
        if cache_out is not None:
            c = cache_out[i]
            kvcache.write_prefill(c["k"], k, window)
            kvcache.write_prefill(c["v"], v, window)
        else:
            kc, vc = kvcache.from_prefill(
                k, v, cache_capacity or S, cfg.kv_cache_dtype, window,
                lambda slots: model.kv_seq_split(B * rows[1], slots))
            c = {"k": kc, "v": vc}
        caches.append(c)
    if last_only:
        x = x[:, -1:]
    return whole_rows(model, model.emb.logits(x), rows), caches, aux_total


def batch_rows(model, batch):
    """This rank's rows of ``batch`` on a mesh, and their ``(axes, parts,
    index)``; off a mesh the batch and :data:`WHOLE`."""
    if model.split is None:
        return batch, WHOLE
    n = next(iter(batch.values())).shape[0]
    rows = model.split.rows(n)
    block = rows.block(0)
    if block[1] == 1:
        return batch, WHOLE
    return {k: rows.shard_of(v) for k, v in batch.items()}, block


def whole_rows(model, t, rows):
    """``t``'s rows of every rank, gathered over the batch axes."""
    axis, parts, _ = rows
    if parts == 1:
        return t
    return collectives.all_gather(t, model.split.mesh, axis, 0)


def train_forward(model, batch, rows=WHOLE):
    """Full-sequence forward with gradients, for the loss: ``(logits,
    aux)``, ``aux`` the MoE losses summed layer by layer in order, as the
    reference's scan carries them.  In the training layout each layer
    runs on its leaves (``Model.bound``).  With ``cfg.remat`` each
    block-pattern group (and each remainder layer) is a
    ``torch.utils.checkpoint`` region, as the reference checkpoints its
    scan body and tail layers: a group keeps only its input, and its
    activations and weight casts are recomputed in the backward (on a
    mesh, its weight gathers too, as GSPMD's are under remat).  On a
    mesh ``batch`` holds this rank's ``rows`` of the batch
    (:func:`batch_rows`) and the logits are theirs."""
    cfg = model.cfg
    with model.bound("emb", model.emb):
        x = model.emb.embed(batch)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)

    def run(x, aux, span):
        for li in span:
            layer = model.layers[li]
            with model.bound(f"layers.{li}", layer):
                x, _, a = layer(x, positions, backend=model.backend,
                                rows=rows)
            aux = {k: aux[k] + a[k] if k in a else aux[k] for k in aux}
        return x, aux

    aux = {"moe_aux": 0.0, "moe_z": 0.0}
    for span in remat_spans(cfg):
        if cfg.remat:
            # the whole region again, as the reference's remat: stopping
            # once the saved tensors are back would leave out collectives
            # by what each backend saves
            with set_checkpoint_early_stop(False):
                x, aux = checkpoint(run, x, aux, span, use_reentrant=False)
        else:
            x, aux = run(x, aux, span)
    with model.bound("emb", model.emb):
        logits = model.emb.logits(x)
    return logits, aux


def remat_spans(cfg: ModelConfig) -> list[range]:
    """The layers of each checkpoint region of ``train_forward``: one
    block-pattern group each (the reference's scan body), then each
    remainder layer."""
    L = cfg.n_layers
    P = len(cfg.block_pattern)
    n_scanned = (L // P) * P if cfg.scan_layers else 0
    return ([range(g, g + P) for g in range(0, n_scanned, P)]
            + [range(i, i + 1) for i in range(n_scanned, L)])


def decode_step(model, caches, batch):
    """One-token decode. batch: {"token_ids": (B, 1) or "embeds",
    "lengths": (B,) int32}.  Returns (logits (B, 1, V), caches), the
    caches updated in place; the MoE losses are dropped, as the
    reference's ``decode_step`` drops them."""
    batch, rows = batch_rows(model, batch)
    lengths = batch["lengths"]
    x = model.emb.embed(batch)
    positions = lengths[:, None]                      # (B,1) absolute pos
    for layer, c in zip(model.layers, caches):
        x, new, _ = layer(x, positions, cache=c, lengths=lengths,
                          backend=model.backend, rows=rows)
        if layer.kind in RECURRENT:
            for name, t in new.items():
                c[name].copy_(t)
    return whole_rows(model, model.emb.logits(x), rows), caches
