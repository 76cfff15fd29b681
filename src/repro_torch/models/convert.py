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

The training layout (``Model(..., layout="train")``) keeps the
reference's own leaves: ``leaf_map`` lists their shapes by path in the
reference's tree order and says which leaf, and which row of a stacked
leaf, holds each of the serving layout's parameters, the inverse of
``params_from_jax``; ``leaves_from_jax`` flattens the reference's params
onto those paths.  On a mesh ``shard_leaves`` cuts whole leaves to the
blocks a rank holds and ``gather_leaves`` gathers them back.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

ATTENTION = ("attn", "local")
#: attention projections whose heads the reference keeps on their own axis
_HEADS = ("t.wq", "t.wk", "t.wv", "t.wo", "t.bq", "t.bk", "t.bv")


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


def shard_params(cfg: ModelConfig, state: dict, rules, mesh) -> dict:
    """``state`` (a whole model's, such as ``params_from_jax``'s) with each
    tensor cut to the block this rank of ``mesh`` holds of it under
    ``rules``, for ``Model(cfg, mesh=mesh, rules=rules)``: the blocks of
    the reference's logical axes (its spec trees, ``layers._param``),
    with ``named_sharding``'s divisibility fallback.  The generalisation
    of :func:`shard_experts`, which cuts the experts alone."""
    from .layers import cut
    from .model import Model
    shapes = dict(Model(cfg, device="meta", rules=rules,
                        mesh=mesh).named_parameters())
    return {k: cut(shapes[k], v) for k, v in state.items()}


def shard_leaves(model, leaves: dict) -> dict[str, torch.Tensor]:
    """Whole training leaves (``leaves_from_jax``'s numpy arrays, or a
    one-device model's ``leaves``) cut to the blocks this rank of a
    training model on a mesh holds (``model.leaf_shardings``); a model
    off a mesh takes them whole."""
    out = {}
    for path, v in leaves.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(v))
        ns = None if model.leaf_shardings is None \
            else model.leaf_shardings[path]
        out[path] = t if ns is None else ns.shard_of(t)
    return out


def gather_leaves(model, blocks: dict | None = None
                  ) -> dict[str, torch.Tensor]:
    """The inverse of :func:`shard_leaves`: every rank's blocks (default
    the model's leaves) gathered into whole leaves, on every rank."""
    blocks = model.leaves if blocks is None else blocks
    if model.leaf_shardings is None:
        return dict(blocks)
    return {path: model.leaf_shardings[path].gather(t)
            for path, t in blocks.items()}


def shard_experts(cfg: ModelConfig, state: dict, rules, mesh) -> dict:
    """``state`` (a whole model's, such as ``params_from_jax``'s, or one
    MoE block's with names relative to it) with each expert weight cut to
    the experts this rank of ``mesh`` holds (``moe.expert_slice``); the
    rest is every rank's."""
    from .moe import expert_slice
    if cfg.moe is None:
        return dict(state)
    first, n = expert_slice(cfg, rules, mesh)
    names = ("wi_gate", "wi", "wo")
    return {k: (v[first:first + n] if k.rsplit(".", 1)[-1] in names
                and (k.count(".") == 0 or ".c." in f".{k}") else v)
            for k, v in state.items()}


def _index(tree, i):
    """Row ``i`` of every leaf of a nested dict of stacked arrays."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _layer_slots(cfg: ModelConfig) -> list[tuple[str, int | None]]:
    """For each layer, its reference subtree and row: ``("groups/<pos>",
    g)`` for a layer of a stacked group, ``("tail/<i>", None)`` for the
    remainder (``transformer.init_stack``)."""
    kinds = cfg.layer_kinds
    P = len(cfg.block_pattern)
    n_groups = len(kinds) // P if cfg.scan_layers else 0
    n_scanned = n_groups * P
    return [(f"groups/{li % P}", li // P) if li < n_scanned
            else (f"tail/{li - n_scanned}", None)
            for li in range(len(kinds))]


def _reference_shape(cfg: ModelConfig, kind: str | None, name: str,
                    shape: tuple[int, ...]) -> tuple[int, ...]:
    """The reference's shape of the serving parameter ``name`` (relative
    to its layer, e.g. ``"t.wq"``; ``kind`` None for the embeddings):
    attention projections keep their heads on an axis of their own."""
    if kind not in ATTENTION or name not in _HEADS:
        return tuple(shape)
    dh = cfg.d_head
    if name == "t.wo":                                  # (H dh, d)
        return (shape[0] // dh, dh, shape[1])
    if name.startswith("t.b"):                          # (H dh,)
        return (shape[0] // dh, dh)
    return (shape[0], shape[1] // dh, dh)               # (d, H dh)


def leaf_map(cfg: ModelConfig, named_shapes) -> tuple[dict, dict]:
    """``named_shapes``: (serving name, shape) pairs of a ``Model``'s
    parameters.  Returns ``(leaves, rows)``: the reference's leaf shapes
    by path in its tree order (dict keys sorted at every level, groups and
    tail by index), and for each serving name its ``(path, row)``, row
    None where the leaf is not stacked."""
    slots = _layer_slots(cfg)
    kinds = cfg.layer_kinds
    found, rows = {}, {}
    for name, shape in named_shapes:
        head, _, rest = name.partition(".")
        if head == "emb":
            path, row, kind = f"emb/{rest}", None, None
        else:
            li, _, rest = rest.partition(".")
            (path, row), kind = slots[int(li)], kinds[int(li)]
            path = f"{path}/{rest.replace('.', '/')}"
        rshape = _reference_shape(cfg, kind, rest, tuple(shape))
        if row is not None:
            found.setdefault(path, [0, rshape])[0] += 1
        else:
            found[path] = [None, rshape]
        rows[name] = (path, row)
    leaves = {path: (tuple(shape) if n is None else (n,) + tuple(shape))
              for path, (n, shape) in found.items()}
    return {k: leaves[k] for k in sorted(leaves, key=_tree_key)}, rows


def _tree_key(path: str):
    """Sort key of a leaf path in ``jax.tree`` order: dict keys sorted as
    strings, sequence indices as numbers."""
    return [(0, int(p), "") if p.isdigit() else (1, 0, p)
            for p in path.split("/")]


def leaves_from_jax(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """``repro``'s params (or any nested dict/tuple of arrays) as a flat
    ``{path: float32 array}`` in tree order, the training layout's keys."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(leaves_from_jax(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(leaves_from_jax(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.array(tree, dtype=np.float32)
    return out
