"""Port parity of training on a mesh, mixture of experts: the FSDP-TP
train step (``RULES_FSDP_TP``, Adafactor) of dbrx-132b on ``gloo`` ranks
against ``repro``'s GSPMD step (``tests/_mesh_train.py`` says how each
side runs).

Reduced float32 dbrx-132b, two steps from seeded leaves, at meshes
(1, 2) and (2, 2) below the expert-parallel threshold (the block-local
dispatch, every rank routing every row; above it:
``tests/test_torch_mesh_train_moe_ep.py``), and at (1, 2) with one kv
head, a leaf the model axis does not divide (replicated; each rank
reads its query heads' kv head).  The limits are
``tests/test_torch_mesh_train.py``'s.
A planted fault, the vocabulary gather's gradient summed over the model
axis where it is this rank's block, doubles the gradients, and the check
sees it.
"""
import numpy as np
import pytest

import _mesh_train as mt

ARCH = "dbrx-132b"
#: (name, arch, mesh, batch, sequence, microbatches, config fields)
CASES = (("dbrx12", ARCH, (1, 2), 4, 16, 1, None),
         ("dbrx22", ARCH, (2, 2), 4, 16, 1, None),
         ("dbrx12_kv1", ARCH, (1, 2), 4, 16, 1, {"n_kv_heads": 1}))
NAMES = [c[0] for c in CASES]
PLANTED = ("dbrx12",)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return mt.run_cases(CASES, tmp_path_factory, PLANTED)


@pytest.mark.parametrize("name", NAMES)
def test_mesh_train_step_equals_the_reference(name, runs):
    mt.check_step(name, runs, CASES)


@pytest.mark.parametrize("name", NAMES)
def test_the_ranks_issue_the_planned_collectives(name, runs):
    plan = mt.check_plan(name, runs, CASES)
    assert not any(op == "all-to-all" for op, *_ in plan)


def test_a_planted_gradient_fault_fails_the_check(runs):
    """The planted run's loss is the same, its gradients twice the
    reference's: the check above would fail, by far."""
    out, ranks = runs
    want = mt.reference(out, "dbrx12")
    planted = ranks[(1, 2)][0]["dbrx12"]["planted"]
    worst = max(mt.rel(planted[k], g) for k, g in want["grad"].items())
    assert worst > 100 * mt.GRAD_RTOL
    ratio = np.linalg.norm(planted["emb/head"]) / np.linalg.norm(
        want["grad"]["emb/head"])
    assert ratio == pytest.approx(2.0, rel=1e-4)
