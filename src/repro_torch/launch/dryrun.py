"""Memory and FLOP dry run for one NVIDIA H100 (counterpart of
``repro/launch/dryrun.py``).

The reference lowers and compiles every (arch x shape x mesh) cell for a
TPU pod and reads XLA's memory and cost analyses.  One card has no mesh,
so for every (arch, shape) of ``SHAPES`` that ``cell_supported`` admits
this says, in seconds and without running a kernel:

* **bytes**, from the model's own parameter shapes, built on ``meta``:
  weights in the layout the cell runs (serving: each weight in the dtype
  it is used in; training: the reference's float32 leaves), gradients,
  the optimizer state (AdamW's moments or Adafactor's factored ones),
  the KV or recurrent caches, and an estimate of the activations
  (``train_memory`` / ``serve_memory`` say what is counted);
* **the verdict**: the peak estimate, whether it fits ``HBM_BYTES``, the
  deepest depth that fits at the cell's batch and the largest batch
  that fits at full depth;
* **FLOPs**: matrix-product FLOPs from ``FlopCounterMode`` over a forward
  (and, for ``train``, a backward) on ``meta`` tensors through the
  ``stub`` mixers, which do no matrix product (the reference's probes
  stub them too), plus ``mixer_flops`` for one card; ``flops_executed``
  adds the forward the backward recomputes under ``cfg.remat``;
* **roofline terms** on the card's constants (``analysis/roofline.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --out artifacts/dryrun_h100

writes one JSON record per cell, ``<arch>_<shape>_h100.json``, with the
reference's keys where they mean the same thing.  As the reference's, it
skips a cell whose record is already there (``[cached]``) unless
``--force``, and a cell that raises is printed ``[FAIL]`` with its
traceback while the run goes on; it then lists the failures and exits 1.

``--mesh single|multi|both`` plans the serving cells per device on the
reference's meshes, (data 16, model 16) and (pod 2, data 16, model 16),
as descriptions (``mesh_cell``; the Python API takes any mesh): the
tensor-parallel model under ``cfg.serve_rules`` built on ``meta``, its
per-device bytes of params, caches and batch at the reference's
``build_cell`` dtypes (``sharded_bytes``: the shard shapes of
``named_sharding``), the port's own per-device peak and deepest depth
(``mesh_serve_memory``), and the collectives of one prefill or decode
step on ``meta`` (``mesh_pass``), counted by ``parse_collectives``'s
formulas, beside the roofline with ``t_collective`` = ring-moved bytes
over NVLink.  A training cell on a mesh plans the ZeRO-3 / FSDP-TP step
under ``cfg.rules``: the training model on the mesh description, its
per-device bytes of leaves, gradients, optimizer state and batch at the
reference's dtypes (``train_sharded_bytes``: ``build_cell``'s
``state_sh``, the optimizer's by ``_opt_shardings``' rule), the port's
per-rank peak and deepest depth (``mesh_train_memory``), and the
collectives and matrix-product FLOPs of one train step
(``mesh_train_step``: the forward, the remat recompute and the backward
of each microbatch on ``meta``, extrapolated over depth as
``matmul_flops`` is, and the optimizer's reductions at full depth).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import time
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.analysis import roofline
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeCell, \
    cell_supported
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import Model, collectives, transformer
from repro_torch.models.layers import dtype_of
from repro_torch.models.moe import capacity
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.checkpoint import flatten

ARTIFACTS = (pathlib.Path(__file__).resolve().parents[3] / "artifacts"
             / "dryrun_h100")
MESH = "h100"
META = torch.device("meta")


def _model(cfg: ModelConfig, layout: str) -> Model:
    return Model(cfg, backend="stub", device=META, layout=layout)


def _nbytes(tensors) -> int:
    return int(sum(t.numel() * t.element_size() for t in tensors))


def _size(dtype: str) -> int:
    return torch.empty((), dtype=dtype_of(dtype)).element_size()


# ---------------------------------------------------------------------------
# bytes
# ---------------------------------------------------------------------------

def weight_bytes(cfg: ModelConfig, layout: str) -> int:
    """Bytes of the weights of ``Model(cfg, layout=layout)``."""
    return _nbytes(_model(cfg, layout).weights().values())


def cache_bytes(cfg: ModelConfig, batch: int, capacity_: int) -> int:
    """Bytes of ``Model.init_cache(batch, capacity_)``."""
    caches = _model(cfg, "serve").init_cache(batch, capacity_)
    return _nbytes(flatten(caches).values())


def optimizer_bytes(cfg: ModelConfig, leaves) -> int:
    opt = opt_lib.make(cfg.optimizer, cfg.learning_rate)
    return _nbytes(flatten(opt.init(leaves)).values())


def _spans(cfg: ModelConfig) -> list[tuple[str, ...]]:
    """The kinds of each checkpoint region of a training forward."""
    kinds = cfg.layer_kinds
    return [tuple(kinds[i] for i in span)
            for span in transformer.remat_spans(cfg)]


def layer_activation_bytes(cfg: ModelConfig, kind: str, batch: int,
                           seq: int, train: bool) -> float:
    """Activation bytes one layer holds at once: for ``train``, what its
    recompute saves for the backward plus the backward's largest
    temporaries (the ``torch`` backend's operations); for serving, a
    prefill's temporaries through the kernels."""
    T = batch * seq
    a = _size(cfg.dtype)
    d, ff = cfg.d_model, cfg.d_ff
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    total = T * d * (4 * a + 8)                     # norms, residual
    if kind in ("attn", "local"):
        qkv = (hq + 2 * hkv) * dh
        total += T * (qkv * a + (hq + hkv) * dh * 4 * 2 + hq * dh * (a + 4))
        if train:       # attention_torch: scores over every kv tile
            kb = min(cfg.attn_block_kv, seq)
            total += T * hkv * dh * 4 * 2                   # f32 k, v
            total += 4 * batch * hq * seq * (2 * seq + 2 * kb)
    elif kind == "rglru":
        r = cfg.d_rnn
        total += T * r * (6 * a + 6 * 4) * (2 if train else 1)
    elif kind == "rwkv":
        H = cfg.n_heads if cfg.n_heads else d // 64
        dr = d // H
        total += T * d * (8 * a + 4 * 4) + T * ff * a * 3
        if train:       # rwkv6_torch keeps each step's state terms
            total += 3 * T * H * dr * dr * 4
    if kind != "rwkv":
        mult = 6 if train else 3
        if cfg.moe is None:
            total += T * ff * a * mult
        else:
            total += moe_activation_bytes(cfg, T, train)
    return float(total)


def moe_activation_bytes(cfg: ModelConfig, T: int, train: bool) -> float:
    """The mixture of experts' part of :func:`layer_activation_bytes` at
    ``T`` tokens: the router's f32 logits and probabilities, the dispatch
    buffer and the expert FFNs' temporaries, the gather and combine."""
    a = _size(cfg.dtype)
    mo, d = cfg.moe, cfg.d_model
    mult = 6 if train else 3
    slots = mo.n_experts * capacity(cfg, T)
    return float(T * mo.n_experts * 4 * 2                   # router
                 + slots * (2 * d + cfg.d_ff * mult) * a
                 + T * mo.top_k * d * a * 3)                # gather, combine


def _layer_casts(cfg: ModelConfig, model: Model, kinds) -> tuple[int, int]:
    """(bytes of a span's weights cast away from the leaves' dtype, the
    largest cast weight's element count)."""
    pdt = dtype_of(cfg.param_dtype)
    total, largest = 0, 0
    for kind in kinds:
        layer = next(m for m in model.layers if m.kind == kind)
        for p in layer.parameters():
            if p.dtype != pdt:
                total += p.numel() * p.element_size()
                largest = max(largest, p.numel())
    return total, largest


def _largest_draw(model: Model) -> int:
    """Bytes of the largest f32 draw ``Model.init`` makes (``_normal_``
    draws each weight in f32, then casts it into place)."""
    return max((p.numel() * 4 for p in model.parameters()), default=0)


def train_memory(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """Peak bytes of one training step (``train.trainer``) at ``cell``:
    ``run_bytes`` once the model is built, ``peak_bytes`` the larger of
    that and ``build_bytes``.

    Resident: the float32 leaves, their gradient buffers and the optimizer
    state, and under remat one checkpoint input per region.  On top, the
    largest of three phases (and no less than building: the leaves, the
    buffers and ``init``'s largest f32 draw): the loss (the f32 logits and their gradient,
    ``layers.CrossEntropy``, and the head's f32 weight gradient); one
    region's backward (its recomputed activations and weight casts, and
    the largest weight gradient in ``cfg.dtype`` and in f32); the
    optimizer's temporaries of its largest leaf (two for AdamW, one for
    Adafactor: ``train/optimizer.py``)."""
    M = cfg.microbatches
    if cell.global_batch % M:
        raise ValueError(f"global batch {cell.global_batch} does not divide "
                         f"into {M} microbatches")
    b, S = cell.global_batch // M, cell.seq_len
    T = b * S
    serve, train = _model(cfg, "serve"), _model(cfg, "train")
    W = _nbytes(train.leaves.values())
    O = optimizer_bytes(cfg, train.leaves)
    a = _size(cfg.dtype)
    spans = _spans(cfg)
    if cfg.remat:
        saved = len(spans) * T * cfg.d_model * a
    else:
        saved = sum(layer_activation_bytes(cfg, k, b, S, True)
                    for k in cfg.layer_kinds)
    loss = 2 * T * cfg.vocab * 4 + cfg.d_model * cfg.vocab * 4
    region = 0.0
    for kinds in set(spans):
        casts, largest = _layer_casts(cfg, serve, kinds)
        region = max(region, casts + largest * (a + 4) + sum(
            layer_activation_bytes(cfg, k, b, S, True) for k in kinds))
    biggest = max((t.numel() * 4 for t in train.leaves.values()), default=0)
    opt_phase = (2 if cfg.optimizer == "adamw" else 1) * biggest
    build = 2 * W + _largest_draw(serve)
    run = 2 * W + O + saved + max(loss, region, opt_phase)
    return dict(weights_bytes=W, grads_bytes=W, optimizer_bytes=O,
                cache_bytes=0, saved_bytes=float(saved),
                loss_phase_bytes=float(loss), region_phase_bytes=region,
                optimizer_phase_bytes=float(opt_phase),
                build_bytes=float(build), run_bytes=float(run),
                peak_bytes=max(build, run))


def serve_memory(cfg: ModelConfig, slots: int, capacity_: int,
                 prefill_batch: int = 1, prefill_len: int | None = None
                 ) -> dict:
    """Peak bytes of serving ``cfg``: its weights in the serving layout,
    caches for ``slots`` sequences of ``capacity_``, and the largest
    layer's temporaries while a prefill of ``prefill_batch`` x
    ``prefill_len`` tokens (``capacity_`` when None) runs through the
    kernels, plus its prompt's k/v and last-token logits; and no less than
    building the model (its weights and ``init``'s largest f32 draw)."""
    S = capacity_ if prefill_len is None else prefill_len
    model = _model(cfg, "serve")
    W = _nbytes(model.parameters())
    C = cache_bytes(cfg, slots, capacity_)
    kinds = set(cfg.layer_kinds)
    act = max((layer_activation_bytes(cfg, k, prefill_batch, S, False)
               for k in kinds), default=0.0)
    kv = (prefill_batch * S * 2 * cfg.n_kv_heads * cfg.d_head
          * _size(cfg.kv_cache_dtype if cfg.kv_cache_dtype != "int8"
                  else cfg.dtype))
    logits = max(prefill_batch, slots) * cfg.vocab * 4
    build = W + _largest_draw(model)
    run = W + C + act + kv + logits
    return dict(weights_bytes=W, grads_bytes=0, optimizer_bytes=0,
                cache_bytes=C, activation_bytes=act + kv + logits,
                build_bytes=float(build), run_bytes=float(run),
                peak_bytes=max(build, run))


def memory(cfg: ModelConfig, cell: ShapeCell) -> dict:
    if cell.kind == "train":
        return train_memory(cfg, cell)
    if cell.kind == "prefill":
        return serve_memory(cfg, cell.global_batch, cell.seq_len,
                            cell.global_batch, cell.seq_len)
    return serve_memory(cfg, cell.global_batch, cell.seq_len,
                        prefill_batch=1, prefill_len=1)


def fits(peak: float, limit: float = roofline.HBM_BYTES) -> bool:
    return peak <= limit


def deepest_depth(cfg: ModelConfig, peak_of, limit=roofline.HBM_BYTES
                  ) -> int:
    """The most layers (0 to ``cfg.n_layers``) whose ``peak_of(cfg at that
    depth)`` fits ``limit``; -1 when not even the embeddings fit."""
    def ok(n):
        return fits(peak_of(dataclasses.replace(cfg, n_layers=n)), limit)
    if not ok(0):
        return -1
    lo, hi = 0, cfg.n_layers
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if ok(mid) else (lo, mid - 1)
    return lo


def largest_batch(cfg: ModelConfig, cell: ShapeCell,
                  limit=roofline.HBM_BYTES) -> int:
    """The largest global batch (a multiple of the microbatches, for
    ``train``) that fits at full depth; 0 when none does."""
    step = cfg.microbatches if cell.kind == "train" else 1

    def ok(n):
        c = dataclasses.replace(cell, global_batch=n * step)
        return fits(memory(cfg, c)["peak_bytes"], limit)
    if not ok(1):
        return 0
    hi = 1
    while ok(hi * 2) and hi < 1 << 20:
        hi *= 2
    lo, hi = hi, hi * 2 - 1
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if ok(mid) else (lo, mid - 1)
    return lo * step


# ---------------------------------------------------------------------------
# FLOPs
# ---------------------------------------------------------------------------

def _count(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


def _probe(cfg: ModelConfig, cell: ShapeCell, backward: bool) -> int:
    """Matrix-product FLOPs of one pass of ``cfg`` at ``cell`` on meta."""
    B, S = cell.global_batch, cell.seq_len
    if cell.kind == "train":
        m = _model(dataclasses.replace(cfg, remat=False), "train")
        batch = _inputs(cfg, B, S)
        batch["labels"] = torch.zeros((B, S), dtype=torch.int32,
                                      device=META)

        def run():
            loss, _ = m.loss_fn(batch)
            if backward:
                loss.backward()
        return _count(run)
    m = _model(cfg, "serve")
    if cell.kind == "prefill":
        batch = _inputs(cfg, B, S)
        return _count(lambda: m.prefill(batch, capacity=S))
    caches = m.init_cache(B, S)
    batch = _inputs(cfg, B, 1, decode=True)
    batch["lengths"] = torch.zeros((B,), dtype=torch.int32, device=META)
    return _count(lambda: m.decode_step(caches, batch))


def _inputs(cfg: ModelConfig, B: int, S: int, decode: bool = False):
    act = dtype_of(cfg.dtype)
    if cfg.embeds_only:
        return {"embeds": torch.empty((B, S, cfg.d_model), dtype=act,
                                      device=META)}
    batch = {"token_ids": torch.zeros((B, S), dtype=torch.int32,
                                      device=META)}
    if cfg.mm_prefix and not decode:
        batch["mm_embeds"] = torch.empty(
            (B, cfg.mm_prefix, cfg.mm_embed_dim), dtype=act, device=META)
    return batch


def matmul_flops(cfg: ModelConfig, cell: ShapeCell,
                 backward: bool = True) -> float:
    """Matrix-product FLOPs of a step at ``cell``, from probes of one
    microbatch at one block-pattern group (``C1``), two groups (``C2``)
    and one group plus the remainder layers (``Ct``), as the reference
    reconstructs a step from its unrolled probes: ``M * (C1 + (G - 1) *
    (C2 - C1) + (Ct - C1))`` for ``G`` full groups."""
    P = len(cfg.block_pattern)
    train = cell.kind == "train"
    M = cfg.microbatches if train else 1
    mb = dataclasses.replace(cell, global_batch=max(1, cell.global_batch
                                                    // M))

    def probe(n):
        return _probe(dataclasses.replace(cfg, n_layers=n), mb, backward)

    G, tail = divmod(cfg.n_layers, P)
    if G == 0:
        return M * probe(cfg.n_layers)
    c1 = probe(P)
    total = c1
    if G > 1:
        total += (G - 1) * (probe(2 * P) - c1)
    if tail:
        total += probe(P + tail) - c1
    return float(M * total)


def mixer_flops(cfg: ModelConfig, cell: ShapeCell) -> float:
    """The reference's analytic FLOPs of the temporal-mix kernels, for
    one card: attention 4 B Hq Sq kv_len d_head (QK^T + PV; causal halves
    kv_len, local caps it at the window); rwkv ~6 H D Dv per token; rglru
    ~10 r per token; train x4 (forward, backward twice, the remat
    recompute)."""
    B, S = cell.global_batch, cell.seq_len
    train = cell.kind == "train"
    mult = 4.0 if train else 1.0
    sq = 1 if cell.kind == "decode" else S
    total = 0.0
    H, dh = cfg.n_heads, cfg.d_head
    for kind in cfg.layer_kinds:
        if kind == "attn":
            kv_len = S if cfg.bidirectional else (
                S if cell.kind == "decode" else S / 2)
            total += 4.0 * B * H * sq * kv_len * dh
        elif kind == "local":
            kv_len = min(cfg.local_window, S)
            total += 4.0 * B * H * sq * kv_len * dh
        elif kind == "rwkv":
            d_head_r = cfg.d_model // H
            total += 6.0 * B * sq * H * d_head_r * d_head_r
        elif kind == "rglru":
            total += 10.0 * B * sq * cfg.d_rnn
    return mult * total


def decode_state_bytes(cfg: ModelConfig, cell: ShapeCell) -> float:
    """The reference's live KV / recurrent state a decode step reads."""
    per_tok = 0
    kv_b = 1 if cfg.kv_cache_dtype == "int8" else 2
    for kind in cfg.layer_kinds:
        if kind == "attn":
            per_tok += 2 * cfg.n_kv_heads * cfg.d_head * kv_b * cell.seq_len
        elif kind == "local":
            per_tok += (2 * cfg.n_kv_heads * cfg.d_head * kv_b
                        * min(cfg.local_window, cell.seq_len))
        elif kind == "rglru":
            per_tok += 4 * cfg.d_rnn * 4
        elif kind == "rwkv":
            H = cfg.n_heads
            per_tok += H * (cfg.d_model // H) ** 2 * 4
    return per_tok * cell.global_batch


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape: str,
             out_dir: pathlib.Path | None = None) -> dict:
    cfg = configs.get(arch)
    rec = {"arch": arch, "shape": shape, "mesh": MESH, "tag": ""}
    ok, why = cell_supported(cfg, shape)
    if not ok:
        rec.update(status="skip", reason=why)
        return _write(rec, out_dir)
    cell = SHAPES[shape]
    t0 = time.perf_counter()
    mem = memory(cfg, cell)
    depth = deepest_depth(cfg, lambda c: memory(c, cell)["peak_bytes"])
    batch = largest_batch(cfg, cell)
    train = cell.kind == "train"
    mm = matmul_flops(cfg, cell, backward=train)
    flops = mm + mixer_flops(cfg, cell)
    executed = flops
    if train and cfg.remat:     # the backward recomputes each forward
        executed += matmul_flops(cfg, cell, backward=False)
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode"
                                  else 1)
    n = cfg.n_active_params() if cfg.moe else cfg.n_params()
    model_flops = (6 if train else 2) * n * tokens
    useful = None
    if cell.kind == "decode":
        useful = decode_state_bytes(cfg, cell) + 2 * n
    hbm = roofline.analytic_hbm_bytes(cfg, cell)
    rl = roofline.analyze(
        {"flops": executed, "bytes accessed": hbm},
        roofline.CollectiveStats({}, 0.0, 0.0), 1, model_flops, useful,
        cell.kind)
    rec.update(
        status="ok", n_chips=1, probe_s=round(time.perf_counter() - t0, 3),
        memory=dict(mem, peak_estimate_gb=round(mem["peak_bytes"] / 1e9, 3),
                    limit_bytes=roofline.HBM_BYTES,
                    fits=fits(mem["peak_bytes"]), deepest_depth=depth,
                    n_layers=cfg.n_layers, largest_batch=batch,
                    global_batch=cell.global_batch),
        cost={"flops": flops, "flops_executed": executed,
              "flops_matmul": mm, "bytes accessed": hbm},
        roofline=roofline.to_dict(rl))
    return _write(rec, out_dir)


def _write(rec: dict, out_dir: pathlib.Path | None) -> dict:
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        name = f"{rec['arch']}_{rec['shape']}_{rec['mesh']}.json"
        (out_dir / name).write_text(json.dumps(rec, indent=1))
    return rec


# ---------------------------------------------------------------------------
# cells on a mesh
# ---------------------------------------------------------------------------

#: the meshes of ``--mesh``: the reference's two, as descriptions
MESHES = {"single": lambda: make_production_mesh(),
          "multi": lambda: make_production_mesh(multi_pod=True)}


def serve_config(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` as ``build_cell`` serves it: bfloat16 parameters."""
    if cfg.param_dtype == "bfloat16":
        return cfg
    return dataclasses.replace(cfg, param_dtype="bfloat16")


def mesh_model(cfg: ModelConfig, mesh, rules=None,
               backend: str = "stub") -> Model:
    """The tensor-parallel serving model of ``cfg`` on ``mesh`` (a
    description: rank 0's blocks) under ``rules`` (default
    ``cfg.serve_rules``), on ``meta``."""
    return Model(cfg, backend=backend, device=META, mesh=mesh,
                 rules=cfg.serve_rules if rules is None else rules)


def batch_inputs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """The reference's ``input_specs(cell)`` on ``meta``."""
    B, S = cell.global_batch, cell.seq_len
    if cell.kind == "prefill":
        return _inputs(cfg, B, S)
    batch = _inputs(cfg, B, 1, decode=True)
    batch["lengths"] = torch.zeros((B,), dtype=torch.int32, device=META)
    return batch


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    else:
        yield tree


def sharded_bytes(cfg: ModelConfig, cell: ShapeCell, mesh,
                  rules=None) -> dict:
    """Per-device bytes of ``build_cell``'s params, caches (decode) and
    batch for a serving cell on ``mesh``: each tensor's shard shape under
    ``rules`` (default ``cfg.serve_rules``) with the divisibility
    fallback, at ``build_cell``'s dtypes (params in bfloat16)."""
    cfg = serve_config(cfg)
    model = mesh_model(cfg, mesh, rules)
    size = _size(cfg.param_dtype)
    params = sum(p.numel() for p in model.parameters()) * size
    caches = 0
    if cell.kind == "decode":
        caches = _nbytes(_tensors(model.init_cache(cell.global_batch,
                                                   cell.seq_len)))
    batch = transformer.batch_rows(model, batch_inputs(cfg, cell))[0]
    return dict(params_bytes=int(params), cache_bytes=int(caches),
                batch_bytes=_nbytes(batch.values()),
                total_bytes=int(params + caches + _nbytes(batch.values())))


#: bytes a rank's peak holds beyond its tensors: the caching allocator
#: rounds every block up (a 1.58 GB draw and a few hundred weights came to
#: 2 MB over their sizes on the card) and cuBLAS takes a workspace
ALLOC_SLACK = 64 << 20


def mesh_serve_memory(cfg: ModelConfig, mesh, slots: int, capacity_: int,
                      prefill_batch: int = 1,
                      prefill_len: int | None = None, rules=None) -> dict:
    """A rank's peak bytes serving ``cfg`` on ``mesh``, as
    :func:`serve_memory` counts one card's: its blocks of the weights
    (the port's dtypes) and of caches for ``slots`` sequences of
    ``capacity_``, plus a prefill's temporaries (bounded by the whole
    layer's at the rank's rows), the prompt's k/v of every kv head and
    the logits, local and gathered; and no less than building (its
    weights and the largest whole f32 draw ``init`` cuts its block
    from).  Both add :data:`ALLOC_SLACK`."""
    S = capacity_ if prefill_len is None else prefill_len
    model = mesh_model(cfg, mesh, rules)
    W = _nbytes(model.parameters())
    C = _nbytes(_tensors(model.init_cache(slots, capacity_)))
    rows = model.split.rows(prefill_batch).shard_shape((prefill_batch,))[0]
    act = max((layer_activation_bytes(cfg, k, rows, S, False)
               for k in set(cfg.layer_kinds)), default=0.0)
    kv = (rows * S * 2 * cfg.n_kv_heads * cfg.d_head
          * _size(cfg.kv_cache_dtype if cfg.kv_cache_dtype != "int8"
                  else cfg.dtype))
    logits = 2 * max(prefill_batch, slots) * cfg.vocab * 4
    draw = max((math.prod(getattr(p, "whole", p.shape)) * 4
                for p in model.parameters()), default=0)
    build = W + draw + ALLOC_SLACK
    run = W + C + act + kv + logits + ALLOC_SLACK
    return dict(weights_bytes=W, cache_bytes=C,
                activation_bytes=act + kv + logits,
                build_bytes=float(build), run_bytes=float(run),
                peak_bytes=max(build, run))


def mesh_pass(cfg: ModelConfig, cell: ShapeCell, mesh, rules=None
              ) -> tuple[list, int]:
    """The collectives (``models.collectives.records``) and matrix-product
    FLOPs of one rank's prefill or decode step of ``cfg`` at ``cell`` on
    ``mesh``, run on ``meta`` through the ``stub`` mixers."""
    model = mesh_model(cfg, mesh, rules)
    batch = batch_inputs(cfg, cell)
    collectives.reset()
    with FlopCounterMode(display=False) as fc:
        if cell.kind == "prefill":
            model.prefill(batch, capacity=cell.seq_len)
        else:
            caches = model.init_cache(cell.global_batch, cell.seq_len)
            model.decode_step(caches, batch)
    recs = list(collectives.records)
    collectives.reset()
    return recs, int(fc.get_total_flops())


def serve_collectives(cfg: ModelConfig, mesh, slots: int, capacity_: int,
                      prompt_lens, steps: int, rules=None) -> list:
    """The collectives a rank issues serving ``prompt_lens`` (one prefill
    each into its slot of ``slots`` x ``capacity_`` caches) and then
    ``steps`` decode steps of all slots, planned on ``meta``."""
    model = mesh_model(cfg, mesh, rules)
    caches = model.init_cache(slots, capacity_)
    collectives.reset()
    from repro_torch.models import kvcache
    for i, n in enumerate(prompt_lens):
        views = [kvcache.select(c, i) for c in caches]
        model.prefill(_inputs(cfg, 1, n), capacity=capacity_,
                      cache_out=views)
    batch = _inputs(cfg, slots, 1, decode=True)
    batch["lengths"] = torch.zeros((slots,), dtype=torch.int32, device=META)
    for _ in range(steps):
        model.decode_step(caches, batch)
    recs = list(collectives.records)
    collectives.reset()
    return recs


# ---------------------------------------------------------------------------
# training cells on a mesh
# ---------------------------------------------------------------------------

def mesh_train_model(cfg: ModelConfig, mesh, rules=None,
                     backend: str = "stub") -> Model:
    """The training model of ``cfg`` on ``mesh`` (a description: rank 0's
    blocks) under ``rules`` (default ``cfg.rules``), on ``meta``."""
    return Model(cfg, backend=backend, device=META, layout="train",
                 mesh=mesh, rules=cfg.rules if rules is None else rules)


def train_inputs(cfg: ModelConfig, B: int, S: int) -> dict:
    """The reference's training ``input_specs`` on ``meta``."""
    batch = _inputs(cfg, B, S)
    batch["labels"] = torch.zeros((B, S), dtype=torch.int32, device=META)
    return batch


def mesh_optimizer(cfg: ModelConfig, model: Model):
    return opt_lib.for_model(opt_lib.make(cfg.optimizer, cfg.learning_rate),
                             model)


def train_sharded_bytes(cfg: ModelConfig, cell: ShapeCell, mesh,
                        rules=None) -> dict:
    """Per-device bytes of ``build_cell``'s training state and batch on
    ``mesh``: the float32 leaves' blocks (and their gradients', the same),
    the optimizer state's blocks by the reference's ``_opt_shardings``,
    and the batch's rows."""
    model = mesh_train_model(cfg, mesh, rules)
    params = _nbytes(model.leaves.values())
    opt = _nbytes(_tensors(mesh_optimizer(cfg, model).init(model.leaves)))
    batch = transformer.batch_rows(
        model, train_inputs(cfg, cell.global_batch, cell.seq_len))[0]
    nb = _nbytes(batch.values())
    return dict(params_bytes=params, grads_bytes=params, optimizer_bytes=opt,
                batch_bytes=nb, total_bytes=2 * params + opt + nb)


def _compute_bytes(p) -> int:
    """Bytes of the block a rank computes with of weight ``p`` (the
    gathered one of an fsdp-stored weight)."""
    return math.prod(getattr(p, "compute_shape", p.shape)) * p.element_size()


def mesh_train_memory(cfg: ModelConfig, mesh, cell: ShapeCell,
                      rules=None) -> dict:
    """A rank's peak bytes in one train step of ``cfg`` at ``cell`` on
    ``mesh``, as :func:`train_memory` counts one card's, from its blocks:
    resident, the leaves' blocks, their gradients' and the optimizer
    state's (the reference's blocks), the whole batch (every rank is
    given it) and under remat one checkpoint input per region at the
    rank's rows of a microbatch; on top, the largest of the loss phase
    (the gathered f32 logits and their gradient, the rank's vocabulary
    block of them, the head's gathered f32 block, its gradient and the
    reduce-scatter's f32 copy), one region's backward (its weights cast
    and gathered, the largest gathered weight's gradient in ``cfg.dtype``
    and in f32, and the whole layer's activations at the rank's rows,
    at every row where the MoE routes every row) and the optimizer's
    temporaries (a leaf updated whole holds its whole gradient, leaf,
    state and update); and no less than building (the leaves, the
    buffers and the largest whole f32 draw ``init`` cuts a block from).
    Both add :data:`ALLOC_SLACK`."""
    M = cfg.microbatches
    if cell.global_batch % M:
        raise ValueError(f"global batch {cell.global_batch} does not divide "
                         f"into {M} microbatches")
    mb, S = cell.global_batch // M, cell.seq_len
    model = mesh_train_model(cfg, mesh, rules)
    W = _nbytes(model.leaves.values())
    opt = mesh_optimizer(cfg, model)
    O = _nbytes(_tensors(opt.init(model.leaves)))
    rows = model.split.rows(mb)
    r = rows.shard_shape((mb,))[0]
    routed = mb if rows.block(0)[1] > 1 else r      # the MoE's rows
    T = r * S
    a = _size(cfg.dtype)
    spans = _spans(cfg)
    if cfg.remat:
        saved = len(spans) * T * cfg.d_model * a
    else:
        saved = sum(layer_activation_bytes(cfg, k, r, S, True)
                    for k in cfg.layer_kinds)
    batch = _nbytes(train_inputs(cfg, cell.global_batch, S).values())
    emb = model.emb
    head = emb.tok if cfg.tie_embeddings else getattr(emb, "head", None)
    head_b = 0 if head is None else math.prod(head.compute_shape) * 4
    vocab_parts = model.split.computed(("vocab",), (cfg.vocab,)).block(0)[1]
    local = 0 if vocab_parts == 1 else T * cfg.vocab * 4 // vocab_parts
    loss = 2 * T * cfg.vocab * 4 + local + 3 * head_b
    region = 0.0
    for kinds in set(spans):
        casts, largest = 0, 0
        for kind in kinds:
            layer = next(m for m in model.layers if m.kind == kind)
            for p in layer.parameters():
                casts += p.numel() * p.element_size() + _compute_bytes(p)
                largest = max(largest, math.prod(getattr(
                    p, "compute_shape", p.shape)))
        act = sum(layer_activation_bytes(cfg, k, r, S, True)
                  for k in kinds)
        if cfg.moe is not None:     # every row routed on every rank
            act += sum(moe_activation_bytes(cfg, routed * S, True)
                       - moe_activation_bytes(cfg, T, True)
                       for k in kinds if k != "rwkv")
        region = max(region, casts + largest * (a + 4) + act)
    opt_phase = 0.0
    for path, t in model.leaves.items():
        if path in opt.whole:
            n = math.prod(model.leaf_shapes[path])
            slots = len(opt.opt.slot(opt.shardings, path))
            opt_phase = max(opt_phase, (3 + slots) * n * 4)
        else:
            opt_phase = max(opt_phase, (2 if cfg.optimizer == "adamw"
                                        else 1) * t.numel() * 4)
    draw = max((math.prod(getattr(p, "whole", p.shape)) * 4
                for p in model.parameters()), default=0)
    build = 2 * W + draw + ALLOC_SLACK
    run = (2 * W + O + batch + saved + max(loss, region, opt_phase)
           + ALLOC_SLACK)
    return dict(weights_bytes=W, grads_bytes=W, optimizer_bytes=O,
                batch_bytes=batch, rows=r, saved_bytes=float(saved),
                loss_phase_bytes=float(loss), region_phase_bytes=region,
                optimizer_phase_bytes=float(opt_phase),
                build_bytes=float(build), run_bytes=float(run),
                peak_bytes=max(build, run))


def _train_pass(cfg: ModelConfig, mesh, rules, B: int, S: int
                ) -> tuple[list, int]:
    """The collectives and matrix-product FLOPs of one microbatch of ``B``
    x ``S`` (its loss and backward) on ``mesh``."""
    model = mesh_train_model(cfg, mesh, rules)
    batch = train_inputs(cfg, B, S)
    collectives.reset()
    with FlopCounterMode(display=False) as fc:
        loss, _ = model.loss_fn(batch)
        loss.backward()
    recs = list(collectives.records)
    collectives.reset()
    return recs, int(fc.get_total_flops())


def _optimizer_pass(cfg: ModelConfig, mesh, rules) -> list:
    """The collectives of the step's clip and update on ``mesh``."""
    model = mesh_train_model(cfg, mesh, rules)
    opt = mesh_optimizer(cfg, model)
    state = opt.init(model.leaves)
    collectives.reset()
    grads, _ = opt.clip_by_global_norm(model.grads, cfg.grad_clip)
    opt.apply_(grads, state, model.leaves, 0)
    recs = list(collectives.records)
    collectives.reset()
    return recs


def mesh_train_step(cfg: ModelConfig, cell: ShapeCell, mesh, rules=None,
                    extrapolate: bool = True) -> tuple[list, float]:
    """The collectives (``models.collectives.records``) and matrix-product
    FLOPs (the remat recompute included) of one rank's train step of
    ``cfg`` at ``cell`` on ``mesh``, run on ``meta`` through the ``stub``
    mixers.  ``extrapolate``: from microbatch passes at one block-pattern
    group, two and one plus the remainder layers (as ``matmul_flops``),
    the records as a multiset; else the step itself
    (``train.trainer.make_train_step``), in the order issued."""
    from repro_torch.train.trainer import TrainState, make_train_step
    from collections import Counter
    M = cfg.microbatches
    mb, S = max(1, cell.global_batch // M), cell.seq_len
    if not extrapolate:
        model = mesh_train_model(cfg, mesh, rules)
        opt = mesh_optimizer(cfg, model)
        state = TrainState(0, model.leaves, opt.init(model.leaves))
        step = make_train_step(model, opt, M)
        collectives.reset()
        with FlopCounterMode(display=False) as fc:
            step(state, train_inputs(cfg, M * mb, S))
        recs = list(collectives.records)
        collectives.reset()
        return recs, float(fc.get_total_flops())
    P = len(cfg.block_pattern)

    def probe(n):
        recs, fl = _train_pass(dataclasses.replace(cfg, n_layers=n), mesh,
                               rules, mb, S)
        return Counter(recs), fl

    G, tail = divmod(cfg.n_layers, P)
    if G == 0:
        per, flops = probe(cfg.n_layers)
    else:
        c1, f1 = probe(P)
        per, flops = Counter(c1), f1
        if G > 1:
            c2, f2 = probe(2 * P)
            for k, n in (c2 - c1).items():
                per[k] += (G - 1) * n
            flops += (G - 1) * (f2 - f1)
        if tail:
            ct, ft = probe(P + tail)
            per.update(ct - c1)
            flops += ft - f1
    recs = []
    for k, n in per.items():
        recs += [k] * (n * M)
    return recs + _optimizer_pass(cfg, mesh, rules), float(M * flops)


def mesh_train_cell(cfg: ModelConfig, cell: ShapeCell, mesh, rec: dict,
                    rules=None) -> dict:
    """``rec`` filled with a training cell on ``mesh``."""
    t0 = time.perf_counter()
    n_chips = mesh.size
    shards = train_sharded_bytes(cfg, cell, mesh, rules)
    mem = mesh_train_memory(cfg, mesh, cell, rules)
    depth = deepest_depth(cfg, lambda c: mesh_train_memory(
        c, mesh, cell, rules)["peak_bytes"])
    recs, mm = mesh_train_step(cfg, cell, mesh, rules)
    coll = roofline.parse_collectives(collectives.hlo_text(recs))
    flops = mm + mixer_flops(cfg, cell) / n_chips
    tokens = cell.global_batch * cell.seq_len
    n = cfg.n_active_params() if cfg.moe else cfg.n_params()
    hbm = roofline.analytic_hbm_bytes(cfg, cell) / n_chips
    rl = roofline.analyze(
        {"flops": flops, "bytes accessed": hbm},
        roofline.CollectiveStats(coll.op_counts, coll.moved_bytes,
                                 coll.moved_bytes), n_chips, 6 * n * tokens,
        None, cell.kind)
    rec.update(
        status="ok", n_chips=n_chips, mesh_shape=mesh.shape,
        probe_s=round(time.perf_counter() - t0, 3), per_device=shards,
        memory=dict(mem, peak_estimate_gb=round(mem["peak_bytes"] / 1e9, 3),
                    limit_bytes=roofline.HBM_BYTES,
                    fits=fits(mem["peak_bytes"]), deepest_depth=depth,
                    n_layers=cfg.n_layers, global_batch=cell.global_batch),
        collectives=dict(op_counts=coll.op_counts,
                         operand_bytes=coll.operand_bytes,
                         moved_bytes=coll.moved_bytes, top=coll.top),
        cost={"flops": flops, "flops_matmul": mm, "bytes accessed": hbm},
        roofline=roofline.to_dict(rl))
    return rec


def mesh_cell(arch: str, shape: str, mesh, mesh_name: str,
              out_dir: pathlib.Path | None = None, rules=None) -> dict:
    """One cell per device on ``mesh`` (see the module's doc)."""
    cfg = configs.get(arch)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "tag": ""}
    ok, why = cell_supported(cfg, shape)
    cell = SHAPES[shape]
    if not ok:
        rec.update(status="skip", reason=why)
        return _write(rec, out_dir)
    if cell.kind == "train":
        return _write(mesh_train_cell(cfg, cell, mesh, rec, rules), out_dir)
    t0 = time.perf_counter()
    n_chips = mesh.size
    scfg = serve_config(cfg)
    shards = sharded_bytes(cfg, cell, mesh, rules)
    if cell.kind == "prefill":
        def peak_of(c):
            return mesh_serve_memory(c, mesh, cell.global_batch,
                                     cell.seq_len, cell.global_batch,
                                     cell.seq_len, rules)["peak_bytes"]
    else:
        def peak_of(c):
            return mesh_serve_memory(c, mesh, cell.global_batch,
                                     cell.seq_len, 1, 1, rules)["peak_bytes"]
    mem = mesh_serve_memory(
        scfg, mesh, cell.global_batch, cell.seq_len,
        cell.global_batch if cell.kind == "prefill" else 1,
        cell.seq_len if cell.kind == "prefill" else 1, rules)
    depth = deepest_depth(scfg, peak_of)
    recs, mm = mesh_pass(scfg, cell, mesh, rules)
    coll = roofline.parse_collectives(collectives.hlo_text(recs))
    flops = mm + mixer_flops(cfg, cell) / n_chips
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode"
                                  else 1)
    n = cfg.n_active_params() if cfg.moe else cfg.n_params()
    useful = None
    if cell.kind == "decode":
        useful = (decode_state_bytes(cfg, cell) + 2 * n) / n_chips
    hbm = roofline.analytic_hbm_bytes(cfg, cell) / n_chips
    rl = roofline.analyze(
        {"flops": flops, "bytes accessed": hbm},
        roofline.CollectiveStats(coll.op_counts, coll.moved_bytes,
                                 coll.moved_bytes), n_chips, 2 * n * tokens,
        useful, cell.kind)
    rec.update(
        status="ok", n_chips=n_chips, mesh_shape=mesh.shape,
        probe_s=round(time.perf_counter() - t0, 3), per_device=shards,
        memory=dict(mem, peak_estimate_gb=round(mem["peak_bytes"] / 1e9, 3),
                    limit_bytes=roofline.HBM_BYTES,
                    fits=fits(mem["peak_bytes"]), deepest_depth=depth,
                    n_layers=cfg.n_layers, global_batch=cell.global_batch),
        collectives=dict(op_counts=coll.op_counts,
                         operand_bytes=coll.operand_bytes,
                         moved_bytes=coll.moved_bytes, top=coll.top),
        cost={"flops": flops, "flops_matmul": mm, "bytes accessed": hbm},
        roofline=roofline.to_dict(rl))
    return _write(rec, out_dir)


def run(archs, shapes, out_dir=None, log=print, mesh: str = MESH,
        force: bool = False) -> list[dict]:
    """Every (arch, shape, mesh) cell, as the reference's ``main`` walks
    them.  A cell whose artifact is already in ``out_dir`` is read back
    and logged ``[cached]`` unless ``force``.  A cell that raises is
    logged ``[FAIL]`` with its traceback, writes nothing, and the walk
    goes on: its record has ``status`` "fail" and the traceback under
    ``error``."""
    recs = []
    names = [MESH] if mesh == MESH else (
        list(MESHES) if mesh == "both" else [mesh])
    for arch in archs:
        for shape in shapes:
            for name in names:
                label = f"{arch} x {shape} x {name}"
                art = (None if out_dir is None else
                       pathlib.Path(out_dir) / f"{arch}_{shape}_{name}.json")
                if art is not None and art.exists() and not force:
                    rec = json.loads(art.read_text())
                    log(f"[cached] {label}: {rec.get('status')}")
                    recs.append(rec)
                    continue
                try:
                    if name == MESH:
                        rec = run_cell(arch, shape, out_dir)
                    else:
                        rec = mesh_cell(arch, shape, MESHES[name](), name,
                                        out_dir)
                except Exception:
                    error = traceback.format_exc()
                    log(f"[FAIL] {label}\n{error}")
                    recs.append({"arch": arch, "shape": shape, "mesh": name,
                                 "tag": "", "status": "fail",
                                 "error": error})
                    continue
                recs.append(rec)
                _log(rec, log)
    return recs


def _log(rec: dict, log) -> None:
    label = f"{rec['arch']} x {rec['shape']} x {rec['mesh']}"
    if rec["status"] == "skip":
        log(f"[skip] {label}: {rec['reason']}")
        return
    m, r = rec["memory"], rec["roofline"]
    extra = (f"largest batch {m['largest_batch']}" if "largest_batch" in m
             else f"collectives {rec['collectives']['op_counts']}")
    log(f"[ok] {label}: peak {m['peak_estimate_gb']} GB "
        f"({'fits' if m['fits'] else 'does not fit'} "
        f"{roofline.HBM_BYTES / 1e9:.0f} GB), deepest depth "
        f"{m['deepest_depth']} of {m['n_layers']}, {extra}; "
        f"bound={r['bottleneck']} frac={r['roofline_fraction']:.3f} "
        f"({rec['probe_s']} s)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default=MESH,
                    choices=[MESH, "single", "multi", "both"])
    ap.add_argument("--out", default=str(ARTIFACTS))
    ap.add_argument("--force", action="store_true",
                    help="recompute existing artifacts")
    args = ap.parse_args(argv)
    archs = list(configs.ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    recs = run(archs, shapes, pathlib.Path(args.out), mesh=args.mesh,
               force=args.force)
    failures = [f"{r['arch']} x {r['shape']} x {r['mesh']}" for r in recs
                if r["status"] == "fail"]
    if failures:
        print("FAILURES:", failures)
        return 1
    print("dry-run complete.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
