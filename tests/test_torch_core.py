"""Port parity: the framework-free copies in ``repro_torch.core`` behave as
``repro.core``.

The copies are mechanical (imports rewritten), so everything here is
exact: identical request hashes, identical greedy and branch-and-bound
plans, identical scalar and NumPy batch timelines, identical lowered
arrays.  The differences the port allows are checked too: the ``torch``
evaluator in place of ``jax``, the ``device`` knob that never enters a
request, and the unported entry points that raise.
"""
import pathlib

import numpy as np
import pytest
import torch

from _prop import random_scenario, spec_from_seed

from repro.core import Plan as JPlan
from repro.core import Scheduler as JScheduler
from repro.core import plan as jplan
from repro.core import registry as jreg
from repro.core.lowering import lower_workloads as jlower
from repro.core.simulate import simulate as jsimulate
from repro.core.simulate_batch import simulate_spec as jsimulate_spec
from repro_torch.core import Accelerator as TAccelerator
from repro_torch.core import Plan as TPlan
from repro_torch.core import Platform as TPlatform
from repro_torch.core import Scheduler as TScheduler
from repro_torch.core import plan as tplan
from repro_torch.core import registry as treg
from repro_torch.core.lowering import lower_workloads as tlower
from repro_torch.core.simulate import Workload as TWorkload
from repro_torch.core.simulate import simulate as tsimulate
from repro_torch.core.simulate_batch import simulate_spec as tsimulate_spec

@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tests run thousands of small ops, which
    threads only slow down, and the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FIXTURES = sorted(
    (pathlib.Path(__file__).parent / "fixtures" / "plans").glob("*.json"))
SEEDS = [0, 1, 2, 3, 5, 8, 13, 21, 34, 55]
ARRAYS = ("acc", "dur", "dem", "tau", "ngroups", "iters", "dep", "arrival",
          "domshare", "model_of_acc")


# repro objects -> repro_torch objects, through the shared JSON forms
def port_platform(p):
    """Field by field: ``platform_to_dict`` sorts the domains, and the
    first domain of an accelerator picks its contention model."""
    return TPlatform(
        name=p.name, accelerators=tuple(
            TAccelerator(**vars(a)) for a in p.accelerators),
        transition_bw=p.transition_bw, domains=dict(p.domains),
        domain_bw=dict(p.domain_bw), epsilon_ms=p.epsilon_ms)


def port_graph(g):
    return tplan.graph_from_dict(jplan.graph_to_dict(g))


def port_model(m):
    return treg.decode_model(jreg.encode_model(m))


def port_workloads(wls):
    return [TWorkload(port_graph(w.graph), tuple(w.assignment),
                      iterations=w.iterations, depends_on=w.depends_on,
                      arrival_ms=w.arrival_ms) for w in wls]


def port_spec(seed):
    """``_prop.spec_from_seed``, lowered by the port from the same
    scenario."""
    import random

    from _prop import random_model, random_platform, random_workloads
    rng = random.Random(seed)
    platform = random_platform(rng)
    model = random_model(rng, platform)
    batch = [random_workloads(rng, platform)
             for _ in range(rng.randint(1, 4))]
    w = min(len(b) for b in batch)
    return tlower(port_platform(platform),
                  [port_workloads(b[:w]) for b in batch], port_model(model))


class TestPlans:
    @pytest.mark.parametrize("path", FIXTURES, ids=lambda p: p.stem)
    def test_load_gives_the_same_request_hash(self, path):
        j, t = JPlan.load(path), TPlan.load(path)
        assert t.request.request_hash() == j.request.request_hash()
        assert t.request_hash == j.request_hash
        assert t.assignments == j.assignments
        assert t.objective == j.objective

    @pytest.mark.parametrize("path", FIXTURES, ids=lambda p: p.stem)
    @pytest.mark.parametrize("solver", ["greedy", "bb"])
    def test_scheduler_solves_identically(self, path, solver):
        jreq = JPlan.load(path).request
        treq = TPlan.load(path).request
        kw = dict(solver=solver, max_transitions=jreq.max_transitions,
                  iterations=list(jreq.iterations),
                  depends_on=list(jreq.depends_on))
        j = JScheduler(jreq.platform, model=jreq.model).solve(
            list(jreq.graphs), jreq.objective, **kw)
        t = TScheduler(treq.platform, model=treq.model, device="cpu").solve(
            list(treq.graphs), treq.objective, **kw)
        assert t.assignments == j.assignments
        assert t.objective == j.objective
        assert t.request_hash == j.request_hash
        assert (t.solver, t.evaluator) == (j.solver, j.evaluator)

    def test_greedy_through_the_torch_evaluator(self):
        """evaluator="torch" steers the search, never the answer."""
        treq = TPlan.load(FIXTURES[0]).request
        kw = dict(solver="greedy", max_transitions=treq.max_transitions,
                  iterations=list(treq.iterations),
                  depends_on=list(treq.depends_on))
        batch = TScheduler(treq.platform, model=treq.model,
                           device="cpu").solve(list(treq.graphs),
                                               treq.objective, **kw)
        torch_ = TScheduler(treq.platform, model=treq.model,
                            evaluator="torch", device="cpu").solve(
            list(treq.graphs), treq.objective, **kw)
        assert torch_.evaluator == "torch"
        assert torch_.assignments == batch.assignments
        assert torch_.objective == batch.objective


class TestSimulators:
    @pytest.mark.parametrize("seed", SEEDS)
    def test_scalar_simulate_is_exact(self, seed):
        platform, wls, model = random_scenario(seed)
        j = jsimulate(platform, wls, model, record_timeline=False)
        t = tsimulate(port_platform(platform), port_workloads(wls),
                      port_model(model), record_timeline=False)
        assert t.makespan == j.makespan
        assert t.finish_times == j.finish_times
        assert t.iteration_latencies == j.iteration_latencies
        assert t.contention_ms == j.contention_ms
        assert t.busy_ms == j.busy_ms

    @pytest.mark.parametrize("seed", SEEDS)
    def test_lowered_arrays_and_batch_timelines_are_equal(self, seed):
        j, t = spec_from_seed(seed), port_spec(seed)
        assert (t.n, t.w, t.gmax, t.amax) == (j.n, j.w, j.gmax, j.amax)
        assert t.acc_names == j.acc_names
        for name in ARRAYS:
            a, b = getattr(j, name), getattr(t, name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(b, a, err_msg=name)
        assert tuple(map(repr, t.surfaces)) == tuple(map(repr, j.surfaces))
        bj, bt = jsimulate_spec(j), tsimulate_spec(t)
        for field in ("makespan", "finish_times", "iteration_latencies",
                      "contention_ms", "busy_ms"):
            np.testing.assert_array_equal(getattr(bt, field),
                                          getattr(bj, field), err_msg=field)

    def test_lowered_fixture_arrays_are_equal(self):
        for path in FIXTURES:
            jp, tp = JPlan.load(path), TPlan.load(path)
            j = jlower(jp.request.platform, [jp.solution.workloads],
                       jp.request.model)
            t = tlower(tp.request.platform, [tp.solution.workloads],
                       tp.request.model)
            for name in ARRAYS:
                np.testing.assert_array_equal(getattr(t, name),
                                              getattr(j, name),
                                              err_msg=f"{path.stem} {name}")


class TestRegistry:
    def test_names_match_apart_from_the_torch_evaluator(self):
        assert treg.solver_names() == jreg.solver_names()
        assert [("jax" if n == "torch" else n)
                for n in treg.evaluator_names()] == list(
            jreg.evaluator_names())
        assert treg.resolve_evaluator("auto").name == \
            jreg.resolve_evaluator("auto").name == "batch"
        # the reference's anneal entry is available only where its jax
        # search imports; the port's always is
        assert [e.name for e in treg.auto_order()] == [
            e.name for e in jreg.auto_order() if e.name != "anneal"] \
            + ["anneal"]
        assert treg.ANNEAL_KNOBS == jreg.ANNEAL_KNOBS
        assert treg.contention_model_names() == \
            tuple(n for n in jreg.contention_model_names() if n != "scaled")
        assert treg.baseline_names() == jreg.baseline_names()

    def test_anneal_knobs_validated_as_in_the_reference(self):
        with pytest.raises(treg.UnknownEntryError, match="valid knobs"):
            treg.validate_solver_knobs("anneal", {"populaton": 3})
        with pytest.raises(treg.UnknownEntryError, match="explicit solver"):
            treg.validate_solver_knobs("auto", {"population": 3})
        treg.validate_solver_knobs("anneal", {"population": 64,
                                              "precision": "x64"})

    def test_device_never_enters_the_request(self):
        treq = TPlan.load(FIXTURES[0]).request
        a = TScheduler(treq.platform, model=treq.model, device="cpu")
        b = TScheduler(treq.platform, model=treq.model,
                       device=torch.device("cpu"), evaluator="torch")
        kw = dict(solver="anneal", population=64, precision="x64")
        ra = a.request(list(treq.graphs), treq.objective, **kw)
        rb = b.request(list(treq.graphs), treq.objective, **kw)
        assert ra.request_hash() == rb.request_hash()
        assert "device" not in ra.to_dict()
        assert "device" not in dict(ra.solver_knobs)

    def test_bound_evaluator_keeps_its_name(self):
        entry = treg.resolve_evaluator(treg.bind_device("torch", "cpu"))
        assert entry.name == "torch"
        assert treg.bind_device("batch", "cpu") == "batch"
        assert treg.bind_device("torch", None) == "torch"

    def test_unported_entry_points_raise(self):
        # from_bundle is ported (it loads the bundle): only the file is
        # missing here
        with pytest.raises(FileNotFoundError):
            TScheduler.from_bundle("no-such-bundle.json")
        with pytest.raises(treg.UnknownEntryError, match="not ported yet"):
            treg.decode_model({"kind": "scaled", "factor": 1.5,
                               "base": {"kind": "proportional",
                                        "capacity": 1.0,
                                        "sensitivity": 1.0}})

    def test_scheduler_defaults_to_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            TScheduler("xavier-agx")
        assert TScheduler("xavier-agx", device="cpu").device.type == "cpu"
