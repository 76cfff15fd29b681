"""Fault-tolerant checkpointing: atomic, in the reference's format
(counterpart of ``repro/train/checkpoint.py``).

Checkpoints store host-side numpy arrays keyed by tree path (``step``,
``params/<leaf path>``, ``opt/<state path>``), plus ``__step__``, in a
single .npz written atomically (tmp + rename) with a rolling ``latest``
pointer and configurable keep count.  The paths and shapes are the
reference's (the training layout keeps its leaves), so a checkpoint that
either package writes restores in the other.  Arrays stay whole on disk:
``save(..., shardings=)`` from the ranks of a mesh gathers each block
into its whole array and rank 0 of the mesh alone writes, and
``restore`` reads one array at a time and hands each to ``place`` (under
``shardings=``, on a mesh of ranks), so either package's checkpoint
restores onto any mesh.
"""
from __future__ import annotations

import dataclasses
import math
import os
import pathlib
import re
import tempfile
from typing import Any, Callable

import numpy as np
import torch


def _children(tree):
    """(key, child) pairs of a tree node, in the reference's tree order:
    a dataclass's fields, a dict's keys sorted, a sequence's indices;
    None for a leaf (a sharding is one)."""
    from ..models.sharding import NamedSharding
    if isinstance(tree, NamedSharding):
        return None
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def flatten(tree, prefix: str = "") -> dict[str, Any]:
    """``{path: leaf}``, paths joined with "/" as ``_path_key`` joins
    them."""
    kids = _children(tree)
    if kids is None:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in kids:
        out.update(flatten(v, f"{prefix}{k}/"))
    return out


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, int):           # the step: the reference's int32
        return np.asarray(leaf, dtype=np.int32)
    return np.asarray(leaf)


#: bytes of a whole array that a save on ranks gathers at a time
GATHER_BYTES = 1 << 27


def save(ckpt_dir: str | pathlib.Path, step: int, state: Any,
         keep: int = 3, shardings: Any | None = None) -> pathlib.Path:
    """Atomic save of ``state`` (dataclasses, dicts, sequences of tensors
    or numbers) at ``step``.  ``shardings``: on the ranks of a mesh, a
    tree matching ``state`` whose ``NamedSharding`` leaves say which
    block of each tensor this rank holds.  Every rank calls ``save`` at
    the same step and takes part in every gather, one tensor at a time
    and each in pieces of about :data:`GATHER_BYTES` of the whole array
    (:func:`_gathered`), each piece dropped before the next gather; rank
    0 of the mesh keeps the whole arrays on the host and writes them
    while the others wait for it at a barrier, so that a rank that does
    not write holds no whole array."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    final = ckpt_dir / f"ckpt_{step:08d}.npz"
    if shardings is not None:
        where = flatten(shardings)
        mesh = next((ns.mesh for ns in where.values() if ns is not None),
                    None)
        writer = mesh is None or not any(mesh.coordinate(a)
                                         for a in mesh.axis_names)
        flat = {}
        for k, v in flatten(state).items():
            ns = where.get(k)
            if not (isinstance(v, torch.Tensor) and ns is not None):
                if writer:
                    flat[k] = _to_numpy(v)
                continue
            dim, pieces = _gathered(ns, v)
            arrays = []
            for piece in pieces:
                if writer:
                    arrays.append(_to_numpy(piece))
                del piece               # before the next piece's gather
            if writer:
                flat[k] = (arrays[0] if len(arrays) == 1
                           else np.concatenate(arrays, dim))
        if writer:
            _write(ckpt_dir, step, flat, keep)
        if mesh is not None and mesh.device_mesh is not None:
            import torch.distributed as dist
            dist.barrier()
        return final
    return _write(ckpt_dir, step, {k: _to_numpy(v)
                                   for k, v in flatten(state).items()}, keep)


def _gathered(ns, block: torch.Tensor):
    """``(dim, pieces)``: the whole tensor of this rank's ``block`` as
    consecutive pieces along ``dim``, the longest dim no mesh axis
    splits, of about :data:`GATHER_BYTES` each; each piece is gathered
    over the mesh (``ns.gather``) when the iterator reaches it.  One
    piece, the whole tensor, when it is no larger or every dim is
    split."""
    parts = [ns.block(d)[1] for d in range(block.dim())]
    whole = block.numel() * block.element_size() * math.prod(parts)
    free = [d for d in range(block.dim()) if parts[d] == 1]
    if whole <= GATHER_BYTES or not free:
        return None, (ns.gather(b) for b in (block,))
    dim = max(free, key=lambda d: block.shape[d])
    rows = max(1, block.shape[dim] * GATHER_BYTES // whole)
    return dim, (ns.gather(p) for p in block.split(rows, dim))


def _write(ckpt_dir: pathlib.Path, step: int, flat: dict,
           keep: int) -> pathlib.Path:
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    flat["__step__"] = np.asarray(step)
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        final = ckpt_dir / f"ckpt_{step:08d}.npz"
        os.replace(tmp, final)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    (ckpt_dir / "latest.tmp").write_text(final.name)
    os.replace(ckpt_dir / "latest.tmp", ckpt_dir / "latest")
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: pathlib.Path, keep: int):
    ckpts = sorted(ckpt_dir.glob("ckpt_*.npz"))
    for old in ckpts[:-keep]:
        old.unlink()


def latest_step(ckpt_dir: str | pathlib.Path) -> int | None:
    ckpt_dir = pathlib.Path(ckpt_dir)
    ptr = ckpt_dir / "latest"
    if not ptr.exists():
        return None
    m = re.match(r"ckpt_(\d+)\.npz", ptr.read_text().strip())
    return int(m.group(1)) if m else None


def restore(ckpt_dir: str | pathlib.Path, like: Any,
            shardings: Any | None = None, step: int | None = None,
            place: Callable[[str, torch.Tensor], Any] | None = None):
    """Restore into the structure of ``like``; returns ``(state, step)``.

    Each tensor leaf of ``like`` gives the dtype and device of its
    restored tensor (a ``meta`` leaf restores on the CPU); a number leaf
    restores as a Python number.  A shape that differs from ``like``'s
    raises (after the arrays before it in tree order have been placed).
    The arrays are read one at a time, in tree order, each whole tensor
    handed to ``place(path, whole)``, whose result the restored tree
    holds, and dropped before the next is read.  ``shardings`` (in
    place of ``place``): a tree matching ``like`` whose tensor leaves
    are ``sharding.NamedSharding`` (``sharding.tree_shardings``): each
    tensor is placed under its sharding (a DTensor of this rank's block,
    on the mesh's device type), as the reference re-places arrays on a
    new mesh (elastic rescale)."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    if shardings is not None:
        where = flatten(shardings)

        def place(path, whole):
            if where.get(path) is None:
                raise ValueError(f"shardings have no entry for {path}")
            return where[path].place(whole)
    # np.load's NpzFile reads a member only when it is indexed
    with np.load(ckpt_dir / f"ckpt_{step:08d}.npz") as data:
        return _rebuild(like, data, "", place), step


def _rebuild(like, data, prefix: str, place):
    kids = _children(like)
    if kids is None:
        key = prefix[:-1]
        arr = data[key]
        shape = tuple(like.shape) if isinstance(like, torch.Tensor) else ()
        if tuple(arr.shape) != shape:
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != model "
                             f"shape {shape}")
        if not isinstance(like, torch.Tensor):
            return type(like)(arr.item())
        dev = "cpu" if like.device.type == "meta" else like.device
        whole = torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=dev, dtype=like.dtype)
        return whole if place is None else place(key, whole)
    built = {k: _rebuild(v, data, f"{prefix}{k}/", place) for k, v in kids}
    if dataclasses.is_dataclass(like):
        return dataclasses.replace(like, **built)
    if isinstance(like, dict):
        return {k: built[str(k)] for k in like}
    return type(like)(built[str(i)] for i in range(len(like)))
