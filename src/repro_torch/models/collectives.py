"""Collectives over a mesh axis: the sums and gathers of tensor-parallel
serving and of training on a mesh (what GSPMD inserts for the reference
under ``cfg.serve_rules`` and ``cfg.rules``).

``all_reduce``, ``all_gather``, ``reduce_scatter`` and ``all_to_all``
(the expert-parallel MoE's) run over the process
group of this rank's line along one mesh axis (or several, given as a
tuple: on a mesh over ranks only one of them may have more than one
rank).  An axis of one rank is no collective: the tensor comes back as
it is and nothing is recorded.

* Transport.  Over ``gloo`` (ranks sharing a card, or the CPU) a CUDA
  tensor crosses through host memory; over ``nccl`` it stays on the card.
* Sums are float32 (float64 for float64 tensors): a bf16 partial is
  cast up before the reduction and the result back after, so a split sum
  rounds once more than the one-device product, not once per rank, and
  no backend's bf16 reduction is relied on.
* Records.  Every call appends ``(op, dtype, result shape, group size)``
  to :data:`records` (:func:`reset` clears it), as the kernel wrappers
  count their launches, and a call over ranks adds its host time to
  :data:`seconds`; :func:`hlo_text` writes them as lines of HLO,
  which ``analysis.roofline.parse_collectives`` reads as it reads the
  reference's compiled modules.
* On a mesh *description* (no ranks: the dry run's meshes) a call records
  and returns a tensor of the result's shape without communicating: the
  input itself for a sum or an all-to-all, its copies for a gather, its
  first block for a reduce-scatter.
* A failed collective raises (``torch.distributed``'s own error, or its
  timeout); nothing falls back to computing locally.
* Gradients.  Where a gradient is being taken through its input, each
  collective runs as an ``autograd.Function`` whose backward is the
  collective its consumers call for, and records it too: a sum of
  partials (``all_reduce``, Megatron's row-parallel exit) goes back as
  the identity, a reduce-scatter as an all-gather, an all-to-all as the
  inverse all-to-all (the same exchange), and a gather as a
  reduce-scatter where its result feeds work split over that axis
  (``back="sum"``: ZeRO-3's weight gather, each rank then on its own
  batch rows) or as this rank's own block where it feeds work every rank
  repeats (``back="own"``: logits gathered over the vocabulary).
  :func:`enter` is the conjugate of the sum: the identity forward, an
  all-reduce backward, where a replicated tensor enters work split over
  an axis (a column-parallel product, this rank's slice).  Getting one of
  these wrong scales a gradient by the size of an axis.
"""
from __future__ import annotations

import math
import time

import torch
import torch.distributed as dist

#: (op, dtype, result shape, group size) of every collective since reset
records: list[tuple[str, torch.dtype, tuple[int, ...], int]] = []
#: host seconds spent in collectives over ranks since reset (the staging
#: copies and the wait for the other ranks included)
seconds = 0.0

_HLO_DTYPE = {torch.float32: "f32", torch.bfloat16: "bf16",
              torch.float16: "f16", torch.float64: "f64",
              torch.int32: "s32", torch.int64: "s64", torch.int8: "s8",
              torch.uint8: "u8", torch.bool: "pred"}


def reset() -> None:
    global seconds
    records.clear()
    seconds = 0.0


class _timed:
    """Adds the block's host seconds to :data:`seconds`."""

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        global seconds
        seconds += time.perf_counter() - self.t0


def _axes(mesh, axis) -> tuple[str, ...]:
    """The mesh axes of ``axis`` (a name or a tuple of them) with more
    than one rank."""
    names = axis if isinstance(axis, tuple) else (axis,)
    return tuple(a for a in names if a is not None and mesh.shape[a] > 1)


def group_size(mesh, axis) -> int:
    return math.prod(mesh.shape[a] for a in _axes(mesh, axis))


def _group(mesh, axes):
    if len(axes) != 1:
        raise NotImplementedError(
            f"a collective over mesh axes {axes} of mesh {mesh.shape}: on "
            f"ranks the port runs collectives over one axis at a time")
    return mesh.group(axes[0])


def _record(op: str, t: torch.Tensor, size: int) -> None:
    records.append((op, t.dtype, tuple(t.shape), size))


def _staged(t: torch.Tensor, group) -> torch.Tensor:
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return t.cpu()
    return t.contiguous()


def _summand(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the dtype its sum is taken in: float32, or float64 for a
    float64 ``x``."""
    return x if x.dtype == torch.float64 else x.float()


def _graded(x: torch.Tensor) -> bool:
    """Whether a gradient is being taken through ``x``."""
    return torch.is_grad_enabled() and x.requires_grad


def _index(mesh, axes) -> int:
    """This rank's block index over ``axes``, row-major (0 on a
    description)."""
    index = 0
    for a in axes:
        index = index * mesh.shape[a] + mesh.coordinate(a)
    return index


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axis), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, back):
        ctx.args = (mesh, axis, dim, back)
        return _all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim, back = ctx.args
        if back == "sum":
            return _reduce_scatter(g, mesh, axis, dim), None, None, None, None
        axes = _axes(mesh, axis)
        size = g.shape[dim] // group_size(mesh, axes)
        own = g.narrow(dim, _index(mesh, axes) * size, size)
        return own, None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return _reduce_scatter(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, *ctx.args), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return _all_to_all(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.args), None, None


def all_reduce(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``axis``, in float32, returned
    in ``x``'s dtype; its gradient is the identity (each rank's partial
    gets the replicated sum's gradient)."""
    if _axes(mesh, axis) and _graded(x):
        return _AllReduce.apply(x, mesh, axis)
    return _all_reduce(x, mesh, axis)


def enter(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """``x``, replicated over ``axis``, entering work split over it: the
    identity, whose gradient is summed over the ranks of ``axis``."""
    if _axes(mesh, axis) and _graded(x):
        return _Enter.apply(x, mesh, axis)
    return x


def all_gather(x: torch.Tensor, mesh, axis, dim: int,
               back: str = "own") -> torch.Tensor:
    """Every rank's ``x`` over ``axis``, concatenated on ``dim`` in rank
    order.  ``back``: the gradient's collective, ``"sum"`` (a
    reduce-scatter) where the result feeds work split over ``axis``,
    ``"own"`` (this rank's block) where every rank repeats it."""
    if back not in ("sum", "own"):
        raise ValueError(f"back={back!r}: 'sum' or 'own'")
    if _axes(mesh, axis) and _graded(x):
        return _AllGather.apply(x, mesh, axis, dim % x.dim(), back)
    return _all_gather(x, mesh, axis, dim)


def all_to_all(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """``x``'s rows split evenly over the ranks of ``axis``, block i sent
    to rank i; returns the blocks received, in rank order
    (``all_to_all_single``).  Its gradient goes back by the same
    exchange."""
    if _axes(mesh, axis) and _graded(x):
        return _AllToAll.apply(x, mesh, axis)
    return _all_to_all(x, mesh, axis)


def reduce_scatter(x: torch.Tensor, mesh, axis, dim: int) -> torch.Tensor:
    """This rank's block on ``dim`` of the sum of every rank's ``x`` over
    ``axis``, summed in float32, in ``x``'s dtype; its gradient is
    all-gathered."""
    if _axes(mesh, axis) and _graded(x):
        return _ReduceScatter.apply(x, mesh, axis, dim % x.dim())
    return _reduce_scatter(x, mesh, axis, dim)


def _all_reduce(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    axes = _axes(mesh, axis)
    if not axes:
        return x
    n = group_size(mesh, axes)
    y = _summand(x)
    _record("all-reduce", y, n)
    if mesh.device_mesh is not None:
        with _timed():
            group = _group(mesh, axes)
            buf = _staged(y, group)
            if buf.data_ptr() == x.data_ptr():      # never sum into x
                buf = buf.clone()
            dist.all_reduce(buf, group=group)
            y = buf.to(x.device)
    return y.to(x.dtype)


def _all_gather(x: torch.Tensor, mesh, axis, dim: int) -> torch.Tensor:
    axes = _axes(mesh, axis)
    if not axes:
        return x
    n = group_size(mesh, axes)
    dim = dim % x.dim()
    shape = list(x.shape)
    shape[dim] *= n
    if mesh.device_mesh is None:
        out = torch.cat([x] * n, dim)
    else:
        with _timed():
            group = _group(mesh, axes)
            src = _staged(x.contiguous(), group)
            parts = [torch.empty_like(src) for _ in range(n)]
            dist.all_gather(parts, src, group=group)
            out = torch.cat(parts, dim).to(x.device)
    records.append(("all-gather", x.dtype, tuple(shape), n))
    return out


def _all_to_all(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    axes = _axes(mesh, axis)
    if not axes:
        return x
    n = group_size(mesh, axes)
    records.append(("all-to-all", x.dtype, tuple(x.shape), n))
    if mesh.device_mesh is None:
        return x
    with _timed():
        group = _group(mesh, axes)
        src = _staged(x.contiguous(), group)
        dst = torch.empty_like(src)
        dist.all_to_all_single(dst, src, group=group)
        return dst.to(x.device)


def _reduce_scatter(x: torch.Tensor, mesh, axis, dim: int
                    ) -> torch.Tensor:
    axes = _axes(mesh, axis)
    if not axes:
        return x
    n = group_size(mesh, axes)
    dim = dim % x.dim()
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    size = x.shape[dim] // n
    y = _summand(x)
    if mesh.device_mesh is None:
        out = y.narrow(dim, 0, size)
    else:
        with _timed():
            group = _group(mesh, axes)
            parts = [_staged(p.contiguous(), group)
                     for p in y.split(size, dim)]
            out = torch.empty_like(parts[0])
            dist.reduce_scatter(out, parts, group=group)
            out = out.to(x.device)
    _record("reduce-scatter", out, n)
    return out.to(x.dtype)


def hlo_text(recs=None) -> str:
    """``recs`` (default :data:`records`) as lines of HLO, one collective
    each: the result's type and shape, the op, and ``replica_groups=[1,
    n]`` for groups of ``n`` ranks, the form ``parse_collectives`` reads
    in the reference's compiled modules."""
    lines = []
    for i, (op, dtype, shape, n) in enumerate(records if recs is None
                                              else recs):
        ty = f"{_HLO_DTYPE[dtype]}[{','.join(map(str, shape))}]"
        layout = "{" + ",".join(map(str, range(len(shape) - 1, -1, -1))) \
            + "}"
        lines.append(f"  %{op}.{i} = {ty}{layout} {op}(%p.{i}), "
                     f"replica_groups=[1,{n}]<=[{n}]")
    return "\n".join(lines)
