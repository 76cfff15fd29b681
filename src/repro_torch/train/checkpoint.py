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
``restore(..., shardings=)`` places each one under its sharding on a
mesh of ranks, so either package's checkpoint restores onto any mesh.
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
import re
import tempfile
from typing import Any

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


def save(ckpt_dir: str | pathlib.Path, step: int, state: Any,
         keep: int = 3, shardings: Any | None = None) -> pathlib.Path:
    """Atomic save of ``state`` (dataclasses, dicts, sequences of tensors
    or numbers) at ``step``.  ``shardings``: on the ranks of a mesh, a
    tree matching ``state`` whose ``NamedSharding`` leaves say which
    block of each tensor this rank holds; every rank calls ``save``, the
    blocks are gathered (one tensor at a time) and rank 0 of the mesh
    writes the whole arrays while the others wait for it."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    final = ckpt_dir / f"ckpt_{step:08d}.npz"
    if shardings is not None:
        where = flatten(shardings)
        flat, mesh = {}, None
        for k, v in flatten(state).items():
            ns = where.get(k)
            if isinstance(v, torch.Tensor) and ns is not None:
                mesh = ns.mesh
                v = ns.gather(v)
            flat[k] = _to_numpy(v)
        writer = mesh is None or not any(mesh.coordinate(a)
                                         for a in mesh.axis_names)
        if writer:
            _write(ckpt_dir, step, flat, keep)
        if mesh is not None and mesh.device_mesh is not None:
            import torch.distributed as dist
            dist.barrier()
        return final
    return _write(ckpt_dir, step, {k: _to_numpy(v)
                                   for k, v in flatten(state).items()}, keep)


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
            shardings: Any | None = None, step: int | None = None):
    """Restore into the structure of ``like``; returns ``(state, step)``.

    Each tensor leaf of ``like`` gives the dtype and device of its
    restored tensor (a ``meta`` leaf restores on the CPU); a number leaf
    restores as a Python number.  A shape that differs from ``like``'s
    raises.  ``shardings``: a tree matching ``like`` whose tensor leaves
    are ``sharding.NamedSharding`` (``sharding.tree_shardings``): each
    tensor is restored whole and placed under its sharding (a DTensor of
    this rank's block, on the mesh's device type), as the reference
    re-places arrays on a new mesh (elastic rescale)."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    with np.load(ckpt_dir / f"ckpt_{step:08d}.npz") as data:
        state = _rebuild(like, data, "")
    if shardings is None:
        return state, step
    where = flatten(shardings)
    missing = [k for k, v in flatten(state).items()
               if isinstance(v, torch.Tensor) and k not in where]
    if missing:
        raise ValueError(f"shardings have no entry for {missing[0]}")
    placed = {k: where[k].place(v) if isinstance(v, torch.Tensor) else v
              for k, v in flatten(state).items()}
    return _rebuild(state, placed, ""), step


def _rebuild(like, data, prefix: str):
    kids = _children(like)
    if kids is None:
        key = prefix[:-1]
        arr = data[key]
        if not isinstance(arr, np.ndarray):     # already restored
            return arr
        shape = tuple(like.shape) if isinstance(like, torch.Tensor) else ()
        if tuple(arr.shape) != shape:
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != model "
                             f"shape {shape}")
        if not isinstance(like, torch.Tensor):
            return type(like)(arr.item())
        dev = "cpu" if like.device.type == "meta" else like.device
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=dev, dtype=like.dtype)
    built = {k: _rebuild(v, data, f"{prefix}{k}/") for k, v in kids}
    if dataclasses.is_dataclass(like):
        return dataclasses.replace(like, **built)
    if isinstance(like, dict):
        return {k: built[str(k)] for k in like}
    return type(like)(built[str(i)] for i in range(len(like)))
