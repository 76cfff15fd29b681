"""Carry ``repro``'s parameters into a :class:`repro_torch.models.Model`.

``params_from_jax`` takes the pytree of ``repro.models.Model.init`` after
``jax.tree.map(np.asarray, ...)`` (done by the caller: this package never
imports jax) and returns a state dict for ``Model.load_state_dict``.  The
reference stacks the layers of each repeating block-pattern group on a
leading axis (``params["groups"]``) and keeps the remainder unstacked
(``params["tail"]``); here each layer is its own module, so groups are
unstacked and projections flattened to 2-D.

``load_state_dict`` casts each tensor to the dtype the port stores that
weight in: f32 projections become ``cfg.dtype``, which is the cast the
reference makes at every use, so the numbers are identical.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def _t(x) -> torch.Tensor:
    # np.float32 first: bf16 arrays arrive as ml_dtypes, which torch lacks
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _layer(cfg: ModelConfig, p, prefix: str, out: dict) -> None:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    t, c = p["t"], p["c"]
    out[f"{prefix}.t.ln"] = _t(t["ln"])
    out[f"{prefix}.t.wq"] = _t(t["wq"]).reshape(d, hq * dh)
    out[f"{prefix}.t.wk"] = _t(t["wk"]).reshape(d, hkv * dh)
    out[f"{prefix}.t.wv"] = _t(t["wv"]).reshape(d, hkv * dh)
    out[f"{prefix}.t.wo"] = _t(t["wo"]).reshape(hq * dh, d)
    if cfg.qkv_bias:
        for name in ("bq", "bk", "bv"):
            out[f"{prefix}.t.{name}"] = _t(t[name]).reshape(-1)
    for name in ("ln", "wi_gate", "wi", "wo"):
        if name in c:
            out[f"{prefix}.c.{name}"] = _t(c[name])


def params_from_jax(cfg: ModelConfig, tree) -> dict[str, torch.Tensor]:
    """State dict for ``Model(cfg)`` from ``repro``'s numpy param tree."""
    out = {f"emb.{name}": _t(x) for name, x in tree["emb"].items()}
    kinds = cfg.layer_kinds
    P = len(cfg.block_pattern)
    n_groups = len(kinds) // P if tree["groups"] else 0
    for pos, stacked in enumerate(tree["groups"]):
        for g in range(n_groups):
            one = _index(stacked, g)
            _layer(cfg, one, f"layers.{g * P + pos}", out)
    n_scanned = n_groups * P
    for i, lp in enumerate(tree["tail"]):
        _layer(cfg, lp, f"layers.{n_scanned + i}", out)
    return out


def _index(tree, i):
    """Row ``i`` of every leaf of a nested dict of stacked arrays."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]
