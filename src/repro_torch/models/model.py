"""Model facade: parameters, init, prefill / decode steps and caches
(counterpart of ``repro/models/model.py``).

``Model`` owns its parameters (an ``nn.Module``) where the reference
passes a params pytree; ``init`` fills them from an explicit
``torch.Generator`` with the reference's distributions, and
``repro_torch.models.convert`` carries the reference's own params across.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.runtime import resolve_device
from . import kvcache, transformer
from .layers import Embeddings, dtype_of
from .recurrent import rwkv_heads


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, backend: str = "auto",
                 device: str | torch.device | None = None):
        super().__init__()
        self.cfg = cfg
        self.backend = backend
        self.device = resolve_device(device)
        self.emb = Embeddings(cfg, self.device)
        self.layers = nn.ModuleList(
            transformer.Layer(cfg, kind, self.device)
            for kind in cfg.layer_kinds)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def init(self, generator: torch.Generator | None = None) -> "Model":
        """Random weights: N(0, fan_in^-1/2) projections, N(0, 0.02) token
        table, zero norms and biases (``layers.py:23-31,228-242``).  The
        generator must live on the model's device."""
        gen = generator
        if gen is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
        self.emb.init(gen)
        for layer in self.layers:
            layer.init(gen)
        return self

    # ------------------------------------------------------------------
    @torch.no_grad()
    def forward(self, batch, last_only: bool = False):
        """Logits (B, S or 1, V) in f32, no caches."""
        logits, _, _ = transformer.forward(self, batch, last_only=last_only)
        return logits

    @torch.no_grad()
    def prefill(self, batch, capacity: int | None = None, cache_out=None):
        """Returns (last-token logits, decode caches).

        ``capacity``: cache slots to allocate (default prompt length + 64,
        as the reference).  ``cache_out``: per-layer cache views to write
        into instead of allocating (see ``transformer.forward``)."""
        seq = (batch["embeds"] if self.cfg.embeds_only
               else batch["token_ids"]).shape[1]
        logits, caches, _ = transformer.forward(
            self, batch, collect_kv=True, last_only=True,
            cache_capacity=capacity or seq + 64, cache_out=cache_out)
        return logits, caches

    @torch.no_grad()
    def decode_step(self, caches, batch):
        return transformer.decode_step(self, caches, batch)

    # ------------------------------------------------------------------
    def init_cache(self, batch: int, capacity: int):
        """Zeroed decode caches, one dict per layer: ``{"k", "v"}`` for
        attention, ``{"h", "conv"}`` for RG-LRU, ``{"S", "x_t", "x_c"}``
        for RWKV-6 (the shapes of ``repro/models/model.py:114-140``)."""
        cfg = self.cfg
        dt = dtype_of(cfg.dtype)
        H = rwkv_heads(cfg)
        dh = cfg.d_model // H

        def zeros(*shape, dtype=dt):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        def one(kind):
            if kind == "rglru":
                return {"h": zeros(batch, cfg.d_rnn, dtype=torch.float32),
                        "conv": zeros(batch, 3, cfg.d_rnn)}
            if kind == "rwkv":
                return {"S": zeros(batch, H, dh, dh, dtype=torch.float32),
                        "x_t": zeros(batch, cfg.d_model),
                        "x_c": zeros(batch, cfg.d_model)}
            cap = (min(cfg.local_window, capacity) if kind == "local"
                   else capacity)
            return {name: kvcache.init_layer(batch, cap, cfg.n_kv_heads,
                                             cfg.d_head, cfg.kv_cache_dtype,
                                             self.device)
                    for name in ("k", "v")}

        return [one(kind) for kind in cfg.layer_kinds]


def build(cfg: ModelConfig, **kw) -> Model:
    return Model(cfg, **kw)
