"""Meshes (counterpart of ``repro/launch/mesh.py``).

``make_production_mesh`` and ``make_host_mesh`` keep the reference's
shapes and axis names, and, like the reference's, touch no device: they
return a :class:`Mesh` *description* (axis names and sizes) that
:mod:`repro_torch.models.sharding` resolves rules against.  A mesh over
ranks that exist is :func:`device_mesh`: the same description holding a
``torch.distributed`` ``DeviceMesh``.  The ranks themselves start in
:mod:`repro_torch.ranks` (``init_ranks``, ``share_devices``,
``RankPool``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.distributed as dist

from ..models import sharding
from ..runtime import resolve_device


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named mesh axes and their sizes; ``device_mesh`` is the
    ``DeviceMesh`` over the ranks when the mesh is real, else ``None``.
    ``with mesh:`` makes it the current mesh of
    :mod:`repro_torch.models.sharding`, as ``with mesh:`` does in the
    reference."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    device_mesh: Any = None

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 on a description)."""
        if self.device_mesh is None:
            return 0
        return self.device_mesh.get_coordinate()[
            self.axis_names.index(axis)]

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        if self.device_mesh is None:
            raise ValueError(f"mesh {self.shape} is a description; it has "
                             f"no ranks (build one with device_mesh)")
        return self.device_mesh.get_group(axis)

    def __enter__(self):
        return sharding.use_mesh(self).__enter__()

    def __exit__(self, *exc):
        sharding.use_mesh(self).__exit__(*exc)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """256 chips as (data=16, model=16); two pods as (pod=2, data=16,
    model=16): the reference's shapes, as a description."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh() -> Mesh:
    """The one-device mesh of tests and examples (same axis names)."""
    return Mesh(("data", "model"), (1, 1))


def device_mesh(sizes, axis_names=("data", "model"),
                device: str | torch.device | None = None) -> Mesh:
    """A mesh over the ranks of the initialized process group, whose world
    size must be the product of ``sizes``, on ``device``'s type: the card
    by default (``runtime.resolve_device``, which raises without one);
    ``device="cpu"`` on the host."""
    from torch.distributed.device_mesh import init_device_mesh
    device = resolve_device(device)
    sizes, axis_names = tuple(sizes), tuple(axis_names)
    world = dist.get_world_size()
    if math.prod(sizes) != world:
        raise ValueError(f"a mesh of {sizes} needs {math.prod(sizes)} "
                         f"ranks; the process group has {world}")
    dm = init_device_mesh(device.type, sizes,
                          mesh_dim_names=axis_names)
    return Mesh(axis_names, sizes, dm)
