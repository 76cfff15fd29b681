"""The dry run's training cells on a mesh against ``repro``'s.

For ``train_4k`` of every architecture, the port's per-device bytes of
float32 leaves, optimizer state and batch
(``dryrun.train_sharded_bytes``) equal the sum of the reference's shard
shapes over ``build_cell``'s training state and batch (``state_sh``, its
optimizer state by ``_opt_shardings``) on the (2, 2) and (16, 16)
meshes, taken as ``tests/test_torch_tensor_parallel_dryrun.py`` takes
them (jax's ``AbstractMesh``).  The cells' plans, the CLI and the
sharded optimizer are ``tests/test_torch_mesh_train_parts.py``'s.
"""
import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro.launch import dryrun as jdry
from repro.launch.dryrun import batch_logical
from repro.models import sharding as jsharding
from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh

MESHES = ((2, 2), (16, 16))
NAMES = ("data", "model")


def _bytes(tree, shardings) -> int:
    return int(sum(np.prod(s.shard_shape(x.shape)) * x.dtype.itemsize
                   for x, s in zip(jax.tree.leaves(tree),
                                   jax.tree.leaves(shardings))))


def reference_bytes(arch: str) -> dict:
    """Per mesh, ``build_cell``'s leaves, optimizer state and batch bytes
    a device holds in ``train_4k``."""
    out = {}
    for sizes in MESHES:
        mesh = AbstractMesh(sizes, NAMES)
        _, (state, batch), (state_sh, _), model = jdry.build_cell(
            arch, "train_4k", mesh)
        b_sh = jsharding.tree_shardings(mesh, model.rules,
                                        batch_logical(batch), batch)
        out[sizes] = dict(params_bytes=_bytes(state.params, state_sh.params),
                          optimizer_bytes=_bytes(state.opt, state_sh.opt),
                          batch_bytes=_bytes(batch, b_sh))
    return out


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_train_bytes_equal_the_reference_shard_shapes(arch):
    want = reference_bytes(arch)
    for sizes in MESHES:
        got = dryrun.train_sharded_bytes(tconfigs.get(arch),
                                         dryrun.SHAPES["train_4k"],
                                         tmesh.Mesh(NAMES, sizes))
        for k, v in want[sizes].items():
            assert got[k] == v, (sizes, k)
        assert got["grads_bytes"] == got["params_bytes"]
