"""The dry run on a mesh against ``repro``'s cells.

For every serving cell (``prefill_32k``, ``decode_32k``, ``long_500k``
where ``cell_supported`` admits it) of every architecture, the port's
per-device bytes of params, caches and batch (``dryrun.sharded_bytes``)
equal the sum of the reference's shard shapes
(``NamedSharding.shard_shape``) over ``build_cell``'s own arguments at
its dtypes (serving cells take bfloat16 params), on the (2, 2) mesh and
the production (16, 16) one.  The CLI writes per-device records.
"""
import json

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.configs.base import cell_supported
from repro.launch import dryrun as jdry
from repro.launch.dryrun import batch_logical, cache_logical
from repro.models import sharding as jsharding
from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh

SERVE = ("prefill_32k", "decode_32k", "long_500k")
MESHES = ((2, 2), (16, 16))


def _bytes(tree, shardings) -> int:
    return int(sum(np.prod(s.shard_shape(x.shape)) * x.dtype.itemsize
                   for x, s in zip(jax.tree.leaves(tree),
                                   jax.tree.leaves(shardings))))


def reference_bytes(arch: str, shape: str) -> dict:
    """Per mesh, ``build_cell``'s params, caches and batch bytes a device
    holds; the (16, 16) shardings are ``build_cell``'s own calls on its
    arguments at the (2, 2) mesh (they do not depend on the mesh)."""
    names = ("data", "model")
    _, args, shardings, model = jdry.build_cell(
        arch, shape, AbstractMesh(MESHES[0], names))
    out = {MESHES[0]: [_bytes(a, s) for a, s in zip(args, shardings)]}
    mesh = AbstractMesh(MESHES[1], names)
    rules = model.rules
    params, batch = args[0], args[-1]
    sh = [jsharding.tree_shardings(mesh, rules, model.specs(), params)]
    if len(args) == 3:
        sh.append(jsharding.tree_shardings(mesh, rules, cache_logical(model),
                                           args[1]))
    sh.append(jsharding.tree_shardings(mesh, rules, batch_logical(batch),
                                       batch))
    out[MESHES[1]] = [_bytes(a, s) for a, s in zip(args, sh)]
    return {sizes: dict(params_bytes=b[0],
                        cache_bytes=b[1] if len(b) == 3 else 0,
                        batch_bytes=b[-1]) for sizes, b in out.items()}


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_per_device_bytes_equal_the_reference_shard_shapes(arch):
    for shape in SERVE:
        if not cell_supported(jconfigs.get(arch), shape)[0]:
            continue
        want = reference_bytes(arch, shape)
        for sizes in MESHES:
            got = dryrun.sharded_bytes(tconfigs.get(arch),
                                       dryrun.SHAPES[shape],
                                       tmesh.Mesh(("data", "model"), sizes))
            for k, v in want[sizes].items():
                assert got[k] == v, (shape, sizes, k)


def test_cli_writes_per_device_records(tmp_path):
    assert dryrun.main(["--arch", "llama3.2-3b,dbrx-132b", "--shape",
                        "decode_32k,train_4k", "--mesh", "single",
                        "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "llama3.2-3b_decode_32k_single.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["n_chips"] == 256
    assert rec["memory"]["fits"] and rec["memory"]["deepest_depth"] == 28
    assert rec["collectives"]["op_counts"]["all-gather"] > 0
    r = rec["roofline"]
    assert r["t_collective_ms"] == pytest.approx(
        rec["collectives"]["moved_bytes"] / 450e9 * 1e3)
    train = json.loads((tmp_path / "dbrx-132b_train_4k_single.json")
                       .read_text())
    assert train["status"] == "ok" and train["n_chips"] == 256
    assert train["collectives"]["op_counts"]["all-to-all"] > 0
    # the one-card records keep their name
    assert dryrun.run(["stablelm-1.6b"], ["decode_32k"], tmp_path,
                      log=lambda s: None)[0]["mesh"] == "h100"
    assert (tmp_path / "stablelm-1.6b_decode_32k_h100.json").exists()
