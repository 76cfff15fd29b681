"""Port parity of training on a mesh, dense: the ZeRO-3 train step
(``RULES_ZERO3``, AdamW) of llama3.2-3b on ``gloo`` ranks against
``repro``'s GSPMD step (``tests/_mesh_train.py`` says how each side
runs).

Reduced float32 llama3.2-3b, two steps from seeded leaves, at meshes
(1, 2) and (2, 2), and with two microbatches at (2, 2) (each
microbatch a slice of the batch, as the reference's scan takes them,
split over every rank).  Every rank reports the reference's loss
(``LOSS_RTOL``) and gradient norm (``GRAD_RTOL``) at each step, bit for
bit the same on every rank; the first step's gradients (``GRAD_RTOL``),
the leaves (``TRAIN_RTOL``) and the optimizer state (``OPT_RTOL``) after
the second, gathered whole, are the reference's; the collectives the
ranks issued in the first step are those ``dryrun.mesh_train_step``
plans for it.
"""
import numpy as np
import pytest

import _mesh_train as mt

#: (name, arch, mesh, batch, sequence, microbatches, config fields)
CASES = (("llama12", "llama3.2-3b", (1, 2), 4, 16, 1, None),
         ("llama22", "llama3.2-3b", (2, 2), 4, 16, 1, None),
         ("llama22_mb2", "llama3.2-3b", (2, 2), 8, 16, 2, None))
NAMES = [c[0] for c in CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return mt.run_cases(CASES, tmp_path_factory)


@pytest.mark.parametrize("name", NAMES)
def test_mesh_train_step_equals_the_reference(name, runs):
    mt.check_step(name, runs, CASES)


@pytest.mark.parametrize("name", NAMES)
def test_the_ranks_issue_the_planned_collectives(name, runs):
    plan = mt.check_plan(name, runs, CASES)
    assert {op for op, *_ in plan} >= {"all-gather", "reduce-scatter",
                                       "all-reduce"}


def test_the_ranks_hold_the_same_whole_state(runs):
    """Gathered whole, every rank's leaves equal rank 0's bit for bit."""
    for got in runs[1].values():
        for name in got[0]:
            for res in got[1:]:
                for k, v in got[0][name]["leaves"].items():
                    np.testing.assert_array_equal(res[name]["leaves"][k], v)
    assert runs[1][(2, 2)][0]["llama22"]["whole"] == set()
