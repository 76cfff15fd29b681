"""Port parity of training on a mesh, recurrent: the ZeRO-3 train step
(``RULES_ZERO3``, AdamW) of rwkv6-7b and recurrentgemma-9b on ``gloo``
ranks against ``repro``'s GSPMD step (``tests/_mesh_train.py`` says how
each side runs; the limits are ``tests/test_torch_mesh_train.py``'s).

Reduced float32 configs, two steps from seeded leaves (the leaves that
init at zero redrawn): rwkv6-7b at meshes (1, 2) and (2, 2),
recurrentgemma-9b at (2, 2).  Both hold leaves without an "embed" dim
(``u``, ``w0``, ``lam``, ``conv_b``...), whose gradients are summed over
the rows' axes, and leaves whose state the reference's
``_opt_shardings`` blocks otherwise than the leaf (matched by shape
alone), which the optimizer updates whole.
"""
import pytest

import _mesh_train as mt

#: (name, arch, mesh, batch, sequence, microbatches, config fields)
CASES = (("rwkv12", "rwkv6-7b", (1, 2), 4, 16, 1, None),
         ("rwkv22", "rwkv6-7b", (2, 2), 4, 16, 1, None),
         ("rgemma22", "recurrentgemma-9b", (2, 2), 4, 16, 1, None))
NAMES = [c[0] for c in CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return mt.run_cases(CASES, tmp_path_factory)


@pytest.mark.parametrize("name", NAMES)
def test_mesh_train_step_equals_the_reference(name, runs):
    mt.check_step(name, runs, CASES)


@pytest.mark.parametrize("name", NAMES)
def test_the_ranks_issue_the_planned_collectives(name, runs):
    mt.check_plan(name, runs, CASES)


def test_some_leaves_are_updated_whole(runs):
    """``_opt_shardings`` matches a state to the first leaf of its shape:
    rwkv6-7b's ``w0`` takes a norm's blocks, recurrentgemma-9b's ``wa``
    a blocked (d, d) leaf's, so both are updated whole."""
    assert "groups/0/t/w0" in runs[1][(2, 2)][0]["rwkv22"]["whole"]
    assert "groups/0/t/wa" in runs[1][(2, 2)][0]["rgemma22"]["whole"]
