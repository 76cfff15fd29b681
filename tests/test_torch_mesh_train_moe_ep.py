"""Port parity of training on a mesh, mixture of experts above the
expert-parallel threshold: dbrx-132b's FSDP-TP train step
(``RULES_FSDP_TP``, Adafactor) at 2048 tokens a data shard, where the
block takes the all-to-all path (the reference's ``moe.py:174-189``), on
``gloo`` ranks against ``repro``'s GSPMD step at meshes (1, 2) and
(2, 2) (``tests/_mesh_train.py`` says how each side runs; the limits are
``tests/test_torch_mesh_train.py``'s).  The two all-to-alls go back by
the same exchange and the tokens' gathers as each rank's own block.
"""
import pytest

import _mesh_train as mt
from repro_torch.models.moe import EP_MIN_TOKENS

ARCH = "dbrx-132b"
#: (name, arch, mesh, batch, sequence, microbatches, config fields)
CASES = (("dbrx12_ep", ARCH, (1, 2), 2, EP_MIN_TOKENS // 2, 1, None),
         ("dbrx22_ep", ARCH, (2, 2), 2, EP_MIN_TOKENS, 1, None))
NAMES = [c[0] for c in CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return mt.run_cases(CASES, tmp_path_factory)


@pytest.mark.parametrize("name", NAMES)
def test_mesh_train_step_equals_the_reference(name, runs):
    mt.check_step(name, runs, CASES)


@pytest.mark.parametrize("name", NAMES)
def test_the_ranks_issue_the_planned_collectives(name, runs):
    """The step's all-to-alls, forward and back, are planned too."""
    plan = mt.check_plan(name, runs, CASES)
    assert sum(op == "all-to-all" for op, *_ in plan) > 0
