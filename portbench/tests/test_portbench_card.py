"""Each cell, run on the card as ``BENCHMARK.json``'s command runs it:
a short window, ``correct`` true, the result line's keys.  Skips
without a card."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
from conftest import ROOT

from portbench import spec

CELLS = [w["name"] for w in spec.benchmark(ROOT)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card_is_correct(card, cell, trace):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "2147483999", "--seconds", "8", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert res["metrics"]
