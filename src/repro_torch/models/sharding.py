"""Logical-axis sharding (MaxText-style rules; counterpart of
``repro/models/sharding.py``).

Parameters and activations are annotated with *logical* axis names
("embed", "heads", "mlp", ...); a per-config rule table maps each logical
axis to a physical mesh axis (or a tuple, or None).  Rules are resolved
against whatever mesh is current, so the same code resolves on the
single-pod (data, model) mesh, the multi-pod (pod, data, model) mesh and
the one-device host mesh.

The rule resolution is the reference's, line for line.  The meshes are
:class:`repro_torch.launch.mesh.Mesh` (``with mesh:`` makes one current,
as in the reference, through :class:`use_mesh`); :func:`spec` returns the
port's :class:`PartitionSpec`, a tuple, and :func:`named_sharding` a
:class:`NamedSharding` whose ``placements`` are DTensor's.
:func:`constrain` and :func:`weight_use` do nothing outside a mesh or on
a plain tensor, as the reference's do off a mesh; on a DTensor they
``redistribute``.

A model built on a mesh (``Model(..., mesh=, rules=)``) holds plain
tensors, not DTensors: :class:`Split` says which block of each of its
weights, caches and batches a rank holds (``named_sharding``'s, with the
divisibility fallback) and which it computes with (the same under the
rules with "embed" unsplit, what ``weight_use`` gathers), and the layers
call :mod:`repro_torch.models.collectives` where GSPMD would insert a
collective for the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Sequence

import torch

#: the meshes entered with ``with mesh:``, innermost last
_MESHES: list = []


class PartitionSpec(tuple):
    """Per tensor dimension: a mesh axis name, a tuple of them, or None
    (``jax.sharding.PartitionSpec``'s role)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _resolve_axis(rule, mesh_axes: tuple[str, ...]):
    """Map one logical axis's rule onto the axes present in the mesh."""
    if rule is None:
        return None
    if isinstance(rule, str):
        return rule if rule in mesh_axes else None
    # tuple of candidate axes: keep those present (e.g. batch over pod+data)
    present = tuple(a for a in rule if a in mesh_axes)
    if not present:
        return None
    return present if len(present) > 1 else present[0]


class use_mesh:
    """``with use_mesh(mesh):`` makes ``mesh`` the current one until the
    block ends (what ``with mesh:`` does, for any mesh object)."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        _MESHES.append(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        if not _MESHES or _MESHES[-1] is not self.mesh:
            raise RuntimeError("meshes left in another order than entered")
        _MESHES.pop()


def _current_mesh():
    """The mesh installed by ``with mesh:``, or None."""
    return _MESHES[-1] if _MESHES else None


def spec(rules: Mapping[str, object], logical: Sequence[str | None],
         mesh=None) -> PartitionSpec:
    """PartitionSpec for an array whose dims carry ``logical`` axis names."""
    mesh = mesh or _current_mesh()
    mesh_axes = tuple(mesh.axis_names) if mesh is not None else ()
    out, used = [], set()
    for name in logical:
        if name is None:
            out.append(None)
            continue
        axis = _resolve_axis(rules.get(name), mesh_axes)
        # a physical mesh axis may appear at most once in a PartitionSpec
        if axis is None:
            out.append(None)
        elif isinstance(axis, tuple):
            fresh = tuple(a for a in axis if a not in used)
            used.update(fresh)
            out.append(fresh if fresh else None)
        elif axis in used:
            out.append(None)
        else:
            used.add(axis)
            out.append(axis)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= mesh.shape[a]
        return n
    return mesh.shape[axis]


@dataclass(frozen=True)
class NamedSharding:
    """A :class:`PartitionSpec` on a mesh (``jax.sharding.NamedSharding``'s
    role)."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        """DTensor placements, one per mesh axis: ``Shard(d)`` where the
        spec splits tensor dim ``d`` over that axis, else
        ``Replicate()``.  A dim split over several axes is split over
        them in mesh order, major to minor, as the reference splits it."""
        from torch.distributed.tensor import Replicate, Shard
        dim_of = {}
        for d, axis in enumerate(self.spec):
            for a in (axis if isinstance(axis, tuple) else (axis,)):
                if a is not None:
                    dim_of[a] = d
        return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                     for a in self.mesh.axis_names)

    def shard_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        """The shape of one rank's block of a tensor of ``shape``
        (``jax.sharding.NamedSharding.shard_shape``)."""
        out = list(shape)
        for d, axis in enumerate(self.spec):
            n = _axis_size(self.mesh, axis)
            if out[d] % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                                 f"evenly over mesh axes {axis!r}")
            out[d] //= n
        return tuple(out)

    def block(self, dim: int) -> tuple[Any, int, int]:
        """``(axes, parts, index)`` of tensor dim ``dim``: the mesh axes
        that split it (None when none does), into how many blocks, and
        which of them this rank holds (row-major over the axes; 0 on a
        description)."""
        axis = self.spec[dim] if dim < len(self.spec) else None
        if axis is None:
            return None, 1, 0
        index = 0
        for a in (axis if isinstance(axis, tuple) else (axis,)):
            index = index * self.mesh.shape[a] + self.mesh.coordinate(a)
        return axis, _axis_size(self.mesh, axis), index

    def shard_of(self, tensor: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole ``tensor`` (which every rank
        holds): the spec's dims split evenly, by this rank's coordinate
        on each mesh axis."""
        out = tensor
        for d, axis in enumerate(self.spec):
            for a in (axis if isinstance(axis, tuple) else (axis,)):
                if a is None:
                    continue
                n = self.mesh.shape[a]
                if out.shape[d] % n:
                    raise ValueError(
                        f"dim {d} of {tuple(tensor.shape)} does not split "
                        f"evenly over mesh axis {a!r} of size {n}")
                size = out.shape[d] // n
                out = out.narrow(d, self.mesh.coordinate(a) * size, size)
        return out

    def axes(self) -> tuple[str, ...]:
        """The mesh axes this sharding splits some dim over."""
        return tuple(a for d in range(len(self.spec))
                     for a in _names(self.spec, d))

    def gather(self, block: torch.Tensor) -> torch.Tensor:
        """The whole tensor from this rank's ``block`` of it: all-gathered
        over each split dim's axes, minor axis first (the inverse of
        :meth:`shard_of`; on a description, rank 0's block repeated)."""
        from . import collectives
        out = block
        for d in range(len(self.spec)):
            for a in reversed(_names(self.spec, d)):
                out = collectives.all_gather(out, self.mesh, a, d)
        return out

    def place(self, tensor: torch.Tensor):
        """``tensor`` (whole, on every rank) as a DTensor under this
        sharding, built from this rank's block with no communication, on
        the mesh's device type.  The block is a copy: the DTensor keeps
        no view of the whole tensor alive."""
        from torch.distributed.tensor import DTensor
        dm = self.mesh.device_mesh
        if dm is None:
            raise ValueError(f"mesh {self.mesh.shape} is a description; "
                             f"placing a tensor needs a mesh over ranks")
        local = self.shard_of(tensor).to(
            dm.device_type, memory_format=torch.contiguous_format, copy=True)
        return DTensor.from_local(local, self.mesh.device_mesh,
                                  self.placements, run_check=False)


def _names(spec, d) -> tuple:
    axis = spec[d] if d < len(spec) else None
    if axis is None:
        return ()
    return axis if isinstance(axis, tuple) else (axis,)


def named_sharding(mesh, rules: Mapping[str, object],
                   logical: Sequence[str | None],
                   shape: Sequence[int] | None = None) -> NamedSharding:
    """NamedSharding for logical axes; with ``shape`` given, mesh axes that
    do not divide the corresponding dim are dropped (inputs must split
    evenly: qwen1.5's 40 heads cannot split 16 ways, so the head axis
    falls back to replication)."""
    s = spec(rules, logical, mesh)
    if shape is not None:
        parts = []
        for i, axis in enumerate(s):
            if i < len(shape) and shape[i] % _axis_size(mesh, axis) != 0:
                parts.append(None)
            else:
                parts.append(axis)
        s = P(*parts)
    return NamedSharding(mesh, s)


def constrain(x, rules: Mapping[str, object],
              logical: Sequence[str | None]):
    """Redistribute a DTensor to its logical axes' sharding; a no-op
    outside a mesh, on a one-device mesh or on a plain tensor."""
    from torch.distributed.tensor import DTensor
    mesh = _current_mesh()
    if mesh is None or mesh.size <= 1 or not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh.device_mesh,
                          named_sharding(mesh, rules, logical).placements)


def _is_logical(x):
    # NB: the empty tuple is a container (e.g. an empty "tail"), not a
    # scalar spec: scalar params don't occur in the model trees.
    return isinstance(x, tuple) and len(x) > 0 and all(
        isinstance(e, (str, type(None))) for e in x)


def _tree_map(fn, tree, *rest):
    """``fn`` over the logical-tuple leaves of ``tree`` (dicts, lists and
    tuples), with the matching nodes of ``rest`` beside each."""
    if _is_logical(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    raise TypeError(f"not a logical-axis tree node: {tree!r}")


def tree_shardings(mesh, rules: Mapping[str, object], spec_tree,
                   shape_tree=None):
    """Map a tree of logical-axis tuples to NamedShardings.

    ``shape_tree``: the matching tree of tensors (anything with
    ``.shape``) enabling the divisibility fallback."""
    if shape_tree is None:
        return _tree_map(lambda lg: named_sharding(mesh, rules, lg),
                         spec_tree)
    return _tree_map(lambda lg, x: named_sharding(mesh, rules, lg, x.shape),
                     spec_tree, shape_tree)


def weight_use(w, rules: Mapping[str, object],
               logical: Sequence[str | None]):
    """FSDP weight-gather: constrain a *stored-sharded* weight to its
    compute sharding (tensor-parallel axes only) at the use site, so a
    contraction over an fsdp-sharded ("embed"->data) dim gathers the
    weight instead of all-reducing the activations."""
    rules2 = dict(rules)
    rules2["embed"] = None
    return constrain(w, rules2, logical)


def resolved_size(rules: Mapping[str, object], logical: str,
                  mesh=None) -> int:
    """Product of mesh-axis sizes a logical axis resolves to on ``mesh``
    (default: the current one; 1 off-mesh)."""
    mesh = mesh or _current_mesh()
    if mesh is None:
        return 1
    axis = _resolve_axis(rules.get(logical), tuple(mesh.axis_names))
    return _axis_size(mesh, axis)


class Split:
    """How a model built on ``mesh`` under ``rules`` holds and uses its
    tensors (the port's stand-in for the reference's ``in_shardings`` and
    ``weight_use``).

    A tensor whose dims carry ``logical`` axes is *stored* as this rank's
    block under ``named_sharding(mesh, rules, logical, shape)`` and
    *computed with* as its block under the same rules with "embed" left
    whole, which is what ``weight_use`` gathers an fsdp-stored weight to
    (under ``serve_rules`` the two agree: "embed" is never split)."""

    def __init__(self, mesh, rules: Mapping[str, object]):
        self.mesh = mesh
        self.rules = dict(rules)
        self._compute = dict(rules, embed=None)

    def stored(self, logical, shape) -> NamedSharding:
        return named_sharding(self.mesh, self.rules, logical, shape)

    def computed(self, logical, shape) -> NamedSharding:
        return named_sharding(self.mesh, self._compute, logical, shape)

    def rows(self, batch: int) -> NamedSharding:
        """The sharding of a batch of ``batch`` sequences: its rows split
        over the "batch" axes where they divide."""
        return self.stored(("batch",), (batch,))
