"""Carry ``repro``'s parameters into a :class:`repro_torch.models.Model`.

``params_from_jax`` takes the pytree of ``repro.models.Model.init`` after
``jax.tree.map(np.asarray, ...)`` (done by the caller: this package never
imports jax) and returns a state dict for ``Model.load_state_dict``.  The
reference stacks the layers of each repeating block-pattern group on a
leading axis (``params["groups"]``) and keeps the remainder unstacked
(``params["tail"]``); here each layer is its own module, so groups are
unstacked and projections flattened to 2-D.

``load_state_dict`` casts each tensor to the dtype the port stores that
weight in, which is the dtype the reference uses it in, so the numbers
are identical: f32 projections become ``cfg.dtype`` (the cast the
reference makes at every use), as do RG-LRU's ``conv_w``/``conv_b``,
RWKV-6's ``mu_*`` and ``u``, and the MoE expert weights ``wi_gate``,
``wi`` and ``wo``, which stay 3-D (E, d, ff) / (E, ff, d); RG-LRU's
``lam``, RWKV-6's ``w0``, ``w_lora_a`` and ``w_lora_b``, and the MoE
``router``, which the reference uses in float32, stay float32; norm
scales and the token table keep ``cfg.param_dtype``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def _t(x) -> torch.Tensor:
    # np.float32 first: bf16 arrays arrive as ml_dtypes, which torch lacks
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _layer(cfg: ModelConfig, kind: str, p, prefix: str, out: dict) -> None:
    t = p["t"]
    if kind in ("rglru", "rwkv"):       # same names and shapes as the port's
        for name, x in t.items():
            out[f"{prefix}.t.{name}"] = _t(x)
    else:
        d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        out[f"{prefix}.t.ln"] = _t(t["ln"])
        out[f"{prefix}.t.wq"] = _t(t["wq"]).reshape(d, hq * dh)
        out[f"{prefix}.t.wk"] = _t(t["wk"]).reshape(d, hkv * dh)
        out[f"{prefix}.t.wv"] = _t(t["wv"]).reshape(d, hkv * dh)
        out[f"{prefix}.t.wo"] = _t(t["wo"]).reshape(hq * dh, d)
        if cfg.qkv_bias:
            for name in ("bq", "bk", "bv"):
                out[f"{prefix}.t.{name}"] = _t(t[name]).reshape(-1)
    for name in ("ln", "router", "wi_gate", "wi", "wo"):
        if name in p.get("c", {}):
            out[f"{prefix}.c.{name}"] = _t(p["c"][name])


def params_from_jax(cfg: ModelConfig, tree) -> dict[str, torch.Tensor]:
    """State dict for ``Model(cfg)`` from ``repro``'s numpy param tree."""
    out = {f"emb.{name}": _t(x) for name, x in tree["emb"].items()}
    kinds = cfg.layer_kinds
    P = len(cfg.block_pattern)
    n_groups = len(kinds) // P if tree["groups"] else 0
    for pos, stacked in enumerate(tree["groups"]):
        for g in range(n_groups):
            one = _index(stacked, g)
            li = g * P + pos
            _layer(cfg, kinds[li], one, f"layers.{li}", out)
    n_scanned = n_groups * P
    for i, lp in enumerate(tree["tail"]):
        li = n_scanned + i
        _layer(cfg, kinds[li], lp, f"layers.{li}", out)
    return out


def _index(tree, i):
    """Row ``i`` of every leaf of a nested dict of stacked arrays."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]
