"""Layer stack: one residual layer per ``cfg.layer_kinds`` entry, and the
prefill / decode passes over it (counterpart of
``repro/models/transformer.py``).

The reference stacks the parameters of repeating block-pattern groups and
runs them under ``jax.lax.scan``; PyTorch runs eagerly, so the port keeps
one module per layer and loops.  ``attn`` and ``local`` layers are ported;
the recurrent kinds and the MoE channel mix are not yet.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from . import kvcache, layers

#: block kinds and features not ported yet -> the ROADMAP.md queue-1 item
#: that ports them.
NOT_PORTED = {
    "rglru": "Recurrent model families (rglru, rwkv6)",
    "rwkv": "Recurrent model families (rglru, rwkv6)",
    "moe": "Mixture-of-experts channel mix",
}


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what this slice does not port."""
    for kind in cfg.layer_kinds:
        if kind in NOT_PORTED:
            raise NotImplementedError(
                f"{cfg.name}: {kind!r} layers are not ported to repro_torch "
                f"yet (ROADMAP.md queue 1: {NOT_PORTED[kind]})")
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: the MoE channel mix is not ported to repro_torch "
            f"yet (ROADMAP.md queue 1: {NOT_PORTED['moe']})")


class Layer(nn.Module):
    """One residual layer: a token mixer ``t`` and a channel mix ``c``."""

    def __init__(self, cfg: ModelConfig, kind: str, device=None):
        super().__init__()
        self.kind = kind
        self.t = layers.Attention(cfg, kind, device)
        self.c = layers.MLP(cfg, device)

    def init(self, gen: torch.Generator) -> None:
        self.t.init(gen)
        self.c.init(gen)

    def forward(self, x, positions, *, cache=None, lengths=None,
                backend="auto"):
        x, kv = self.t(x, positions, cache=cache, lengths=lengths,
                       backend=backend)
        return self.c(x), kv


def forward(model, batch, *, collect_kv=False, last_only=False,
            cache_capacity=None, cache_out=None):
    """Full-sequence forward (train / prefill).

    Returns ``(logits, caches)``; ``caches`` is ``None`` unless
    ``collect_kv``, else one ``{"k", "v"}`` layer-view dict per layer.
    ``cache_out``: per-layer views to write the prompt's k/v into in
    place (the serving engine passes its slot of the batched cache);
    otherwise caches of ``cache_capacity`` slots are allocated.
    """
    cfg = model.cfg
    x = model.emb.embed(batch)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    caches = [] if collect_kv else None
    for i, layer in enumerate(model.layers):
        x, (k, v) = layer(x, positions, backend=model.backend)
        if not collect_kv:
            continue
        window = cfg.local_window if layer.kind == "local" else None
        if cache_out is not None:
            c = cache_out[i]
            kvcache.write_prefill(c["k"], k, window)
            kvcache.write_prefill(c["v"], v, window)
        else:
            kc, vc = kvcache.from_prefill(k, v, cache_capacity or S,
                                          cfg.kv_cache_dtype, window)
            c = {"k": kc, "v": vc}
        caches.append(c)
    if last_only:
        x = x[:, -1:]
    return model.emb.logits(x), caches


def decode_step(model, caches, batch):
    """One-token decode. batch: {"token_ids": (B, 1) or "embeds",
    "lengths": (B,) int32}.  Returns (logits (B, 1, V), caches), the
    caches updated in place."""
    lengths = batch["lengths"]
    x = model.emb.embed(batch)
    positions = lengths[:, None]                      # (B,1) absolute pos
    for layer, c in zip(model.layers, caches):
        x, _ = layer(x, positions, cache=(c["k"], c["v"]), lengths=lengths,
                     backend=model.backend)
    return model.emb.logits(x), caches
