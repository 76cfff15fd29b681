"""The port's search on its own: determinism and optimality.

Within ``repro_torch.core.search_torch`` (``tests/test_search.py``'s
``TestDeterminism`` and ``TestOptimality``): the same seed gives the
bit-identical incumbent whatever the chunking and the select backend; the
device objective matches a scalar re-run (1e-6 relative in float64, 1e-3
in float32, as ``tests/test_search.py``); on an exhaustively enumerable
problem the search finds the true optimum (1e-9).
"""
import itertools

import numpy as np
import pytest

from repro_torch.core import search_torch
from repro_torch.core.solver_bb import enumerate_assignments

from test_torch_core import one_thread  # noqa: F401
from test_torch_search import (KW, scalar_objective, tiny_problem,
                               xavier_pair)


# ---------------------------------------------------------------------------
# the search within the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tables():
    _, (tp, tg, tm) = xavier_pair("pccs")
    return search_torch.build_tables(tp, tg, tm, 2)


class TestDeterminism:
    def test_same_seed_bit_identical(self, tables):
        a = search_torch.anneal_search(tables, device="cpu", **KW)
        b = search_torch.anneal_search(tables, device="cpu", **KW)
        assert (a.assignment, a.objective, a.chain) == \
            (b.assignment, b.objective, b.chain)

    @pytest.mark.parametrize("chunk", [8, 16])
    def test_chunk_invariance(self, tables, chunk):
        ref = search_torch.anneal_search(tables, chunk=32, device="cpu",
                                         **KW)
        out = search_torch.anneal_search(tables, chunk=chunk, device="cpu",
                                         **KW)
        assert (out.assignment, out.objective, out.chain) == \
            (ref.assignment, ref.objective, ref.chain)

    @pytest.mark.parametrize("backend", ["torch", "ref"])
    def test_select_backend_invariance(self, tables, backend):
        ref = search_torch.anneal_search(tables, device="cpu", **KW)
        out = search_torch.anneal_search(tables, backend=backend,
                                         device="cpu", **KW)
        assert (out.assignment, out.objective) == (ref.assignment,
                                                   ref.objective)

    def test_one_device_runs_ring_migration(self, tables):
        out = search_torch.anneal_search(tables, devices=1, device="cpu",
                                         **KW)
        assert out.migrate == "ring" and out.devices == 1
        assert np.isfinite(out.objective)

    @pytest.mark.parametrize("precision,rtol", [("x64", 1e-6),
                                                ("float32", 1e-3)])
    def test_device_objective_matches_scalar_rerun(self, tables, precision,
                                                   rtol):
        _, (tp, tg, tm) = xavier_pair("pccs")
        out = search_torch.anneal_search(tables, precision=precision,
                                         device="cpu", **KW)
        host = scalar_objective(tp, tg, tm, out.assignment)
        assert out.objective == pytest.approx(host, rel=rtol)


class TestOptimality:
    @pytest.mark.parametrize("objective", ["latency", "throughput"])
    def test_finds_bruteforce_optimum(self, objective):
        platform, graphs, model = tiny_problem()
        its = [1, 2]
        best = min(
            scalar_objective(platform, graphs, model, asgs, objective, its)
            for asgs in itertools.product(*(
                enumerate_assignments(g, platform.names, 2)
                for g in graphs)))
        tables = search_torch.build_tables(platform, graphs, model, 2,
                                           iterations=its)
        out = search_torch.anneal_search(tables, objective=objective, seed=0,
                                         population=64, steps=64, island=16,
                                         device="cpu")
        host = scalar_objective(platform, graphs, model, out.assignment,
                                objective, its)
        assert host == pytest.approx(best, rel=1e-9, abs=1e-9)


def test_search_spans_as_the_reference(tables):
    """search_jax.py:731-789's spans: one ``anneal_search`` around one
    ``anneal.chunk`` per chunk, and an ``anneal.incumbent`` instant
    whenever a chunk improves the incumbent."""
    from repro_torch.obs import Tracer, set_tracer
    tracer = Tracer()
    prev = set_tracer(tracer)
    try:
        out = search_torch.anneal_search(tables, chunk=16, device="cpu",
                                         **KW)
    finally:
        set_tracer(prev)
    names = [e["name"] for e in tracer.events()]
    assert names.count("anneal_search") == 1
    assert names.count("anneal.chunk") == 2
    assert 1 <= names.count("anneal.incumbent") <= 2
    top = next(e for e in tracer.events() if e["name"] == "anneal_search")
    assert top["args"]["chain"] == out.chain
    assert top["args"]["evaluated"] == out.evaluated
