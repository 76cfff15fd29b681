"""Differential tests: the port's torch evaluator against the reference.

``repro_torch.core.simulate_torch.simulate_spec(device="cpu")`` against
``repro``'s XLA evaluator ``simulate_jax.simulate_spec`` and its NumPy
``simulate_batch``, on the seeded scenario generators of
``tests/_prop.py`` (proportional and piecewise surfaces, per-domain
mappings, transition delays, ``depends_on`` pipelines, arrivals,
multi-iteration workloads) and on the three golden Table-6 fixtures, in
float64 and float32.  Tolerance: ``JAX_TOL = 1e-5``, the jax evaluator's
cross-backend contract (``tests/test_simulate_differential.py:43``);
float32 against float64 at 1e-3 relative, as that file does.

The reference's evaluator does not import under this JAX (its module asks
for ``jax.experimental.enable_x64``, which JAX 0.9 moved to
``jax.enable_x64``), so the ``reference`` fixture switches it on for the
test with ``monkeypatch``; nothing in ``repro`` changes.
"""
import pathlib
import random

import jax
import numpy as np
import pytest

from _prop import (random_model, random_platform, random_scenario,
                   random_workloads, spec_from_seed)

from repro.core import Plan as JPlan
from repro.core import simulate_jax
from repro.core.contention import PiecewiseModel as JPiecewise
from repro.core.simulate import simulate as jsimulate
from repro.core.simulate_batch import simulate_batch as jsimulate_batch
from repro_torch.core import Plan as TPlan
from repro_torch.core import simulate_torch
from repro_torch.core.accelerators import Accelerator, Platform
from repro_torch.core.contention import (PiecewiseModel,
                                         ProportionalShareModel)
from repro_torch.core.graph import DNNGraph, LayerGroup
from repro_torch.core.lowering import lower_workloads
from repro_torch.core.simulate import Workload
from repro_torch.core.simulate import simulate as tsimulate

from test_torch_core import (one_thread, port_model,  # noqa: F401
                             port_platform, port_spec, port_workloads)

JAX_TOL = 1e-5
FIXTURES = sorted(
    (pathlib.Path(__file__).parent / "fixtures" / "plans").glob("*.json"))
SEEDS = [0, 1, 2, 3, 5, 8, 13, 21, 34, 55, 89, 144]
PCCS = ((0.1, 0.3, 0.5, 0.7, 0.9), (0.1, 0.3, 0.5, 0.7, 0.9),
        ((1.00, 1.02, 1.06, 1.12, 1.20), (1.02, 1.08, 1.18, 1.32, 1.50),
         (1.05, 1.15, 1.32, 1.55, 1.82), (1.08, 1.24, 1.48, 1.80, 2.18),
         (1.12, 1.34, 1.64, 2.05, 2.60)))
FIELDS = ("makespan", "finish_times", "iteration_latencies", "contention_ms",
          "busy_ms")


@pytest.fixture
def reference(monkeypatch):
    """``repro.core.simulate_jax`` with its JAX import repaired."""
    monkeypatch.setattr(simulate_jax, "HAVE_JAX", True)
    monkeypatch.setattr(simulate_jax, "enable_x64", jax.enable_x64,
                        raising=False)
    return simulate_jax


def assert_timelines(got, want, tol=JAX_TOL, context=""):
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   atol=tol, rtol=0, err_msg=f"{context} {f}")
    np.testing.assert_array_equal(got.iterations, want.iterations)
    assert got.acc_names == want.acc_names


class TestSpecParity:
    @pytest.mark.parametrize("seed", SEEDS)
    def test_spec_vs_jax_and_numpy(self, reference, seed):
        jspec, tspec = spec_from_seed(seed), port_spec(seed)
        from repro.core.simulate_batch import simulate_spec as np_spec
        want_np = np_spec(jspec)
        want_jax = reference.simulate_spec(jspec)
        got = simulate_torch.simulate_spec(tspec, device="cpu")
        assert_timelines(got, want_jax, context=f"seed={seed} vs jax")
        assert_timelines(got, want_np, context=f"seed={seed} vs numpy")
        f32 = simulate_torch.simulate_spec(tspec, precision="float32",
                                           device="cpu")
        want32 = reference.simulate_spec(jspec, precision="float32")
        np.testing.assert_allclose(f32.makespan, want_np.makespan, rtol=1e-3)
        np.testing.assert_allclose(f32.makespan, want32.makespan, rtol=1e-5)

    @pytest.mark.parametrize("seed", SEEDS[:6])
    def test_scenario_vs_scalar(self, seed):
        platform, wls, model = random_scenario(seed)
        ref = jsimulate(platform, wls, model, record_timeline=False)
        got = simulate_torch.simulate_batch(
            port_platform(platform), [port_workloads(wls)],
            port_model(model), device="cpu").result(0)
        assert got.makespan == pytest.approx(ref.makespan, abs=JAX_TOL)
        assert got.finish_times == pytest.approx(ref.finish_times,
                                                 abs=JAX_TOL)
        assert got.contention_ms == pytest.approx(ref.contention_ms,
                                                  abs=JAX_TOL)
        for a, b in zip(got.iteration_latencies, ref.iteration_latencies):
            assert a == pytest.approx(b, abs=JAX_TOL)

    def test_population_members_are_independent(self, reference):
        rng = random.Random(7)
        platform = random_platform(rng)
        model = random_model(rng, platform)
        batch = [random_workloads(rng, platform) for _ in range(6)]
        w = min(len(b) for b in batch)
        batch = [b[:w] for b in batch]
        tplat, tmodel = port_platform(platform), port_model(model)
        got = simulate_torch.simulate_batch(
            tplat, [port_workloads(b) for b in batch], tmodel, device="cpu")
        alone = [simulate_torch.simulate_batch(
            tplat, [port_workloads(b)], tmodel, device="cpu").result(0)
            for b in batch]
        for i, one in enumerate(alone):
            assert got.result(i).makespan == pytest.approx(one.makespan,
                                                           abs=1e-12)
        chunked = simulate_torch.simulate_spec(
            lower_workloads(tplat, [port_workloads(b) for b in batch],
                            tmodel), chunk=2, device="cpu")
        np.testing.assert_array_equal(chunked.finish_times, got.finish_times)


class TestGoldenFixtures:
    @pytest.mark.parametrize("path", FIXTURES, ids=lambda p: p.stem)
    @pytest.mark.parametrize("surface", ["fixture", "pccs"])
    def test_three_way_on_golden_fixtures(self, reference, path, surface):
        jplan, tplan = JPlan.load(path), TPlan.load(path)
        jmodel, tmodel = jplan.request.model, tplan.request.model
        if surface == "pccs":
            jmodel, tmodel = JPiecewise(*PCCS), PiecewiseModel(*PCCS)
        jw, tw = jplan.solution.workloads, tplan.solution.workloads
        plat_j, plat_t = jplan.request.platform, tplan.request.platform
        want_np = jsimulate_batch(plat_j, [jw], jmodel)
        want_jax = reference.simulate_batch(plat_j, [jw], jmodel)
        got = simulate_torch.simulate_batch(plat_t, [tw], tmodel,
                                            device="cpu")
        assert_timelines(got, want_jax, context=path.stem)
        assert_timelines(got, want_np, context=path.stem)
        scalar = tsimulate(plat_t, tw, tmodel, record_timeline=False)
        assert got.result(0).makespan == pytest.approx(scalar.makespan,
                                                       abs=JAX_TOL)
        if surface == "fixture":
            assert got.objective(jplan.request.objective)[0] == \
                pytest.approx(jplan.objective, rel=1e-6)
        f32 = simulate_torch.simulate_batch(plat_t, [tw], tmodel,
                                            precision="float32",
                                            device="cpu")
        np.testing.assert_allclose(f32.makespan, want_np.makespan,
                                   rtol=1e-3)


def two_acc_platform():
    return Platform(
        name="t", accelerators=(
            Accelerator("A", 1e12, 1e11, transition_in_ms=0.01,
                        transition_out_ms=0.02),
            Accelerator("B", 1e12, 1e11, transition_in_ms=0.03,
                        transition_out_ms=0.04)),
        transition_bw=1e11, domains={"EMC": ("A", "B")},
        domain_bw={"EMC": 1e11})


def graph(name):
    return DNNGraph(name, (LayerGroup("g", {"A": 1.0, "B": 1.5},
                                      {"A": 0.8, "B": 0.8}),))


class TestErrors:
    """The scalar simulator's exceptions, in the reference's order."""

    def test_unmodelled_accelerator_is_a_key_error(self):
        plat = two_acc_platform()
        wls = [Workload(graph("a"), ("A",)), Workload(graph("b"), ("B",))]
        model = {"OTHER": ProportionalShareModel()}
        with pytest.raises(KeyError):
            tsimulate(plat, wls, model)
        with pytest.raises(KeyError, match="no contention model covers"):
            simulate_torch.simulate_batch(plat, [wls], model, device="cpu")

    def test_deadlock_is_a_runtime_error(self):
        plat = two_acc_platform()
        wls = [Workload(graph("a"), ("A",), depends_on=1),
               Workload(graph("b"), ("B",), depends_on=0)]
        model = ProportionalShareModel()
        with pytest.raises(RuntimeError, match="deadlock"):
            tsimulate(plat, wls, model)
        with pytest.raises(RuntimeError, match="deadlock"):
            simulate_torch.simulate_batch(plat, [wls], model, device="cpu")

    def test_unlowerable_model_is_a_value_error(self):
        class Odd:
            def slowdown(self, own, external):
                return 1.0 + 0.25 * own * external

        plat = two_acc_platform()
        wls = [Workload(graph("a"), ("A",)), Workload(graph("b"), ("B",))]
        with pytest.raises(ValueError, match="register_surface_lowering"):
            simulate_torch.simulate_batch(plat, [wls], Odd(), device="cpu")

    def test_unknown_precision_and_missing_card(self, monkeypatch):
        plat = two_acc_platform()
        wls = [Workload(graph("a"), ("A",))]
        model = ProportionalShareModel()
        with pytest.raises(ValueError, match="precision"):
            simulate_torch.simulate_batch(plat, [wls], model,
                                          precision="bf16", device="cpu")
        import torch
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            simulate_torch.simulate_batch(plat, [wls], model)

    def test_empty_batch(self):
        bt = simulate_torch.simulate_batch(two_acc_platform(), [],
                                           ProportionalShareModel())
        assert len(bt) == 0


# ---------------------------------------------------------------------------
# a fixed budget of waves, then overflow waves (the search's graphs)
# ---------------------------------------------------------------------------
def machine_args(spec, precision):
    """The event machine's arguments for a lowered spec on the CPU, as
    ``simulate_spec`` builds them."""
    import torch

    dt = simulate_torch.dtype_of(precision)
    i64 = torch.int64

    def t(a, dtype):
        return simulate_torch._tensor(a, dtype, "cpu")

    return (t(spec.acc, i64), t(spec.dur, dt), t(spec.dem, dt),
            t(spec.tau, dt), t(spec.ngroups, i64), t(spec.iters, i64),
            t(spec.dep, i64), t(spec.arrival, dt), t(spec.domshare, dt),
            t(spec.model_of_acc, i64),
            tuple(simulate_torch.surface_params(s, dt, "cpu")
                  for s in spec.surfaces))


def golden_spec(path):
    plan = TPlan.load(path)
    req = plan.request
    from repro_torch.core.lowering import lower_assignments
    return lower_assignments(
        req.platform, list(req.graphs), [list(plan.assignments)] * 3,
        PiecewiseModel(*PCCS), iterations=list(req.iterations),
        depends_on=list(req.depends_on))


class TestWaveBudget:
    @pytest.mark.parametrize("source", [f"seed{s}" for s in SEEDS[:6]]
                             + [p.stem for p in FIXTURES])
    @pytest.mark.parametrize("precision", ["x64", "float32"])
    @pytest.mark.parametrize("record", [True, False])
    def test_budget_then_overflow_equals_the_checked_loop(
            self, source, precision, record):
        """The search graphs' wave loop (``_Chains.run``: any budget W of
        untested waves, then waves in steps of CHECK_EVERY until no lane
        is active) ends in the state the loop that tests every
        CHECK_EVERY waves reaches: the same finish times and errors (and
        the recorded fields) bit for bit."""
        spec = (port_spec(int(source[4:])) if source.startswith("seed")
                else golden_spec(FIXTURES[[p.stem for p in FIXTURES]
                                          .index(source)]))
        machine = simulate_torch.make_event_machine(
            tuple(s.kind for s in spec.surfaces), int(spec.iters.max()),
            record=record)
        args = machine_args(spec, precision)
        checked = machine.start(*args)
        checked.drive()
        want = [x.numpy() for x in checked.result()]
        assert checked.count % simulate_torch.CHECK_EVERY == 0
        for budget in (0, 1, 3, checked.count - 1, checked.count,
                       checked.count + 5):
            waves = machine.start(*args)
            for _ in range(max(budget, 0)):
                waves.wave()
            while waves.active().any():
                for _ in range(simulate_torch.CHECK_EVERY):
                    waves.wave()
            assert not waves.active().any()
            for got, w in zip(waves.result(), want):
                np.testing.assert_array_equal(got.numpy(), w)
        np.testing.assert_array_equal(machine(*args)[0].numpy(), want[0])
