"""Port parity: ``repro_torch.core.{dynamic,grouping,api}`` vs ``repro``'s.

The three modules are copies: ``dynamic`` and ``grouping`` word for word,
``api`` with ``repro`` renamed and a keyword-only ``device`` (the port's
``Scheduler`` runs on ``cuda`` unless asked otherwise).  Each case runs
both packages on the same inputs and asks for the same answer exactly:

* ``SlowdownMonitor`` on ``tests/test_recalibrate.py``'s streams (poisoned
  samples, warm-up, patience, cooldown) and on seeded streams;
* ``quantize_severity`` over NaN, infinities and ``MAX_SEVERITY``;
* ``ScaledContentionModel``: its slowdown, its lowered surface (scaled of
  scaled too) and the vectorized path;
* ``group_layers`` on ``tests/test_core_profiles.py``'s layers and on
  seeded ones;
* the deprecated ``api`` shims on the CPU;
* plans from ``reschedule_plan`` load in the other package with the same
  model, factor and request hash;
* an anneal solve under ``ScaledContentionModel(pccs, 1.5)`` with the
  torch evaluator on the CPU gives the reference's plan.
"""
import math
import random
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import Plan as JPlan
from repro.core import Scheduler as JScheduler
from repro.core import api as japi
from repro.core import dynamic as jdyn
from repro.core import grouping as jgrp
from repro.core import plan as jplan
from repro.core import registry as jreg
from repro.core.contention import PiecewiseModel as JPiecewise
from repro.core.contention import ProportionalShareModel as JProportional
from repro.core.lowering import lower_surface as jlower_surface
from repro.core.lowering import slowdown_array as jslowdown_array
from repro.core.lowering import surface_slowdown as jsurface_slowdown
from repro_torch.core import Plan as TPlan
from repro_torch.core import Scheduler as TScheduler
from repro_torch.core import api as tapi
from repro_torch.core import dynamic as tdyn
from repro_torch.core import grouping as tgrp
from repro_torch.core import plan as tplan
from repro_torch.core import registry as treg
from repro_torch.core.lowering import lower_surface as tlower_surface
from repro_torch.core.lowering import slowdown_array as tslowdown_array
from repro_torch.core.lowering import surface_slowdown as tsurface_slowdown

from test_torch_core import (one_thread, port_graph,  # noqa: F401
                             port_model, port_platform)
from test_torch_search import reference  # noqa: F401
from test_torch_simulate import PCCS

ROOT = Path(__file__).resolve().parents[1]
NAN, INF = float("nan"), float("inf")


def source(pkg, name):
    return (ROOT / "src" / pkg / "core" / f"{name}.py").read_text()


@pytest.mark.parametrize("name", ["dynamic", "grouping"])
def test_copied_verbatim(name):
    """Word for word, as the port's copies of the configs are."""
    want = source("repro", name).replace("repro.", "repro_torch.")
    assert source("repro_torch", name) == want


# ---------------------------------------------------------------------------
# SlowdownMonitor and quantize_severity
# ---------------------------------------------------------------------------
def monitor_state(m):
    return (m.ratio, m.strikes, m.fired, m._holdoff)


def run_both(stream, **kw):
    """Feed ``stream`` to both packages' monitors; every answer and every
    state after each sample must agree bit for bit."""
    jm, tm = jdyn.SlowdownMonitor(**kw), tdyn.SlowdownMonitor(**kw)
    assert monitor_state(jm) == monitor_state(tm)
    fired = []
    for observed, predicted in stream:
        a = jm.observe(observed, predicted)
        b = tm.observe(observed, predicted)
        assert a is b
        assert monitor_state(jm) == monitor_state(tm)
        fired.append(b)
    jm.reset()
    tm.reset()
    assert monitor_state(jm) == monitor_state(tm)
    return fired


#: tests/test_recalibrate.py:38-45 (a monitor mid-deviation) and :47-51
HOT = [(2.0, 1.0)] * 3
BAD = [(NAN, 1.0), (1.0, NAN), (INF, 1.0), (1.0, INF), (-INF, 1.0),
       (-1.0, 1.0), (1.0, 0.0), (1.0, -2.0)]
RECAL = dict(threshold=1.5, patience=3, cooldown=4, warmup=0)


class TestSlowdownMonitor:
    @pytest.mark.parametrize("observed,predicted", BAD)
    def test_bad_sample_is_ignored(self, observed, predicted):
        fired = run_both(HOT + [(observed, predicted)], **RECAL)
        assert fired[-1] is False

    def test_poisoned_stream(self):
        fired = run_both(HOT + [(NAN, 1.0), (2.0, 1.0)], **RECAL)
        assert fired[-1] is True

    def test_clean_stream(self):
        fired = run_both([(2.0, 1.0)] * 5, **RECAL)
        assert fired == [False, False, False, True, False]

    @pytest.mark.parametrize("kw", [
        {}, dict(warmup=0), dict(warmup=7, patience=1, cooldown=0),
        dict(threshold=1.2, patience=5, cooldown=2, alpha=0.25),
        dict(threshold=3.0, patience=2, cooldown=30, warmup=1, alpha=0.9)])
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_seeded_streams(self, kw, seed):
        """Calm, sustained-deviation and recovering stretches with bad
        samples sprinkled in: warm-up, patience and cooldown all act."""
        rng = random.Random(seed)
        stream = []
        for level in (1.0, 2.5, 1.1, 4.0, 0.5, 1.8):
            for _ in range(rng.randint(5, 40)):
                predicted = rng.uniform(0.5, 20.0)
                stream.append((predicted * level * rng.uniform(0.8, 1.25),
                               predicted))
                if rng.random() < 0.1:
                    stream.append(rng.choice(BAD))
        fired = run_both(stream, **kw)
        assert len(fired) == len(stream)


SEVERITIES = [NAN, INF, -INF, 1e308, -1e308, 0.0, -3.0, 0.5, 0.99, 1.0,
              1.03, 1.3, 1.6, 2.5, 17.03125, 63.96, jdyn.MAX_SEVERITY,
              jdyn.MAX_SEVERITY + 1.0, 1e4]


def test_max_severity_copied():
    assert tdyn.MAX_SEVERITY == jdyn.MAX_SEVERITY == 64.0


@pytest.mark.parametrize("factor", SEVERITIES + [
    random.Random(5).uniform(0.0, 80.0) for _ in range(8)])
def test_quantize_severity(factor):
    """Equal answers; where the reference raises (-inf and -1e308 overflow
    ``round(factor * 16.0)``), the port raises the same."""
    try:
        want = jdyn.quantize_severity(factor)
    except OverflowError:
        assert factor * 16.0 == -INF
        with pytest.raises(OverflowError):
            tdyn.quantize_severity(factor)
        return
    got = tdyn.quantize_severity(factor)
    assert type(got) is type(want)
    assert got == want and 1.0 <= got <= tdyn.MAX_SEVERITY


# ---------------------------------------------------------------------------
# ScaledContentionModel
# ---------------------------------------------------------------------------
BASES = {"proportional": JProportional(capacity=1.0, sensitivity=2.0),
         "pccs": JPiecewise(*PCCS)}


def scaled_pair(base, factors):
    jm = BASES[base]
    for f in factors:
        jm = jdyn.ScaledContentionModel(jm, f)
    return jm, port_model(jm)


POINTS = [(0.0, 0.0), (0.2, 0.9), (0.9, 0.9), (0.4, 1.1), (1.2, 0.3),
          (0.5, 0.5), (1e-9, 3.0)]


class TestScaledModel:
    @pytest.mark.parametrize("base", list(BASES))
    @pytest.mark.parametrize("factors", [(1.0,), (1.5,), (2.0, 1.5),
                                         (0.5, 3.0, 1.25)])
    def test_slowdown_and_surface(self, base, factors):
        jm, tm = scaled_pair(base, factors)
        assert isinstance(tm, tdyn.ScaledContentionModel)
        for own, ext in POINTS:
            assert tm.slowdown(own, ext) == jm.slowdown(own, ext)
        js, ts = jlower_surface(jm), tlower_surface(tm)
        assert (ts.kind, ts.factor) == (js.kind, js.factor)
        assert js.factor == pytest.approx(math.prod(factors))
        own = np.array([p[0] for p in POINTS])
        ext = np.array([p[1] for p in POINTS])
        np.testing.assert_array_equal(tsurface_slowdown(ts, own, ext),
                                      jsurface_slowdown(js, own, ext))
        np.testing.assert_array_equal(tslowdown_array(tm, own, ext),
                                      jslowdown_array(jm, own, ext))

    def test_opaque_base_takes_the_vectorized_path(self):
        class Odd:
            def slowdown(self, own, external):
                return 1.0 + own * external

        jm = jdyn.ScaledContentionModel(Odd(), 2.0)
        tm = tdyn.ScaledContentionModel(Odd(), 2.0)
        assert jlower_surface(jm) is None and tlower_surface(tm) is None
        own, ext = np.array([0.4, 0.9]), np.array([0.8, 0.2])
        np.testing.assert_array_equal(tslowdown_array(tm, own, ext),
                                      jslowdown_array(jm, own, ext))

    def test_codec_round_trip(self):
        jm, tm = scaled_pair("pccs", (2.0, 1.5))
        assert treg.encode_model(tm) == jreg.encode_model(jm)
        assert treg.decode_model(jreg.encode_model(jm)) == tm
        assert "scaled" in treg.contention_model_names()


# ---------------------------------------------------------------------------
# group_layers
# ---------------------------------------------------------------------------
#: tests/test_core_profiles.py:102-110 and :121-122
LAYER_CASES = {
    "rules": [dict(name="conv1", kind="conv", times={"A": 1.0},
                   fuse_with_next=True),
              dict(name="bn1", kind="norm", times={"A": 0.1}),
              dict(name="elt", kind="eltwise", times={"A": 0.2},
                   no_transition_after=True),
              dict(name="conv2", kind="conv", times={"A": 1.0},
                   reformat_after=True),
              dict(name="pool", kind="pool", times={"A": 0.3}),
              dict(name="fc", kind="fc", times={"A": 0.5})],
    "totals": [dict(name=f"l{i}", kind="conv", times={"A": 0.5, "B": 1.0},
                    fuse_with_next=(i % 2 == 0)) for i in range(6)],
}


def random_layers(seed):
    rng = random.Random(seed)
    kinds = ("conv", "pool", "globalpool", "fc", "norm", "eltwise", "attn")
    out = []
    for i in range(rng.randint(1, 24)):
        accs = ["GPU"] + (["DLA"] if rng.random() < 0.85 else [])
        out.append(dict(
            name=f"l{i}", kind=rng.choice(kinds),
            times={a: rng.uniform(0.01, 2.0) for a in accs},
            mem_demand={a: rng.uniform(0.0, 1.0) for a in accs
                        if rng.random() < 0.8},
            out_bytes=rng.uniform(0, 1e6),
            fuse_with_next=rng.random() < 0.3,
            no_transition_after=rng.random() < 0.15,
            reformat_after=rng.random() < 0.3))
    return out


@pytest.mark.parametrize("case", list(LAYER_CASES) + [f"seed{s}"
                                                     for s in range(12)])
def test_group_layers(case):
    layers = (LAYER_CASES[case] if case in LAYER_CASES
              else random_layers(int(case[4:])))
    try:
        want = jgrp.group_layers(case, [jgrp.RawLayer(**k) for k in layers])
    except ValueError as exc:
        with pytest.raises(ValueError, match=str(exc)):
            tgrp.group_layers(case, [tgrp.RawLayer(**k) for k in layers])
        return
    got = tgrp.group_layers(case, [tgrp.RawLayer(**k) for k in layers])
    assert tplan.graph_to_dict(got) == jplan.graph_to_dict(want)


def test_group_layers_refuses_as_the_reference():
    assert tgrp.CHEAP_BOUNDARY_KINDS == jgrp.CHEAP_BOUNDARY_KINDS
    for mod in (jgrp, tgrp):
        with pytest.raises(ValueError, match="no layers"):
            mod.group_layers("net", [])
        with pytest.raises(ValueError, match="no common accelerator"):
            mod.group_layers("net", [
                mod.RawLayer("a", "conv", {"A": 1.0}, fuse_with_next=True),
                mod.RawLayer("b", "conv", {"B": 1.0})])


# ---------------------------------------------------------------------------
# the deprecated api shims
# ---------------------------------------------------------------------------
DNNS = ["googlenet", "resnet18"]


def sim_fields(res):
    return (res.makespan, res.finish_times, res.iteration_latencies,
            res.contention_ms, res.busy_ms, res.objective("latency"),
            res.objective("throughput"))


class TestApi:
    def test_schedule(self):
        with pytest.deprecated_call(match="repro.core.api.schedule"):
            want = japi.schedule(DNNS, "xavier-agx", "latency",
                                 max_transitions=2)
        with pytest.deprecated_call(match="repro_torch.core.api.schedule"):
            got = tapi.schedule(DNNS, "xavier-agx", "latency",
                                max_transitions=2, device="cpu")
        assert got.assignments == want.assignments
        assert got.objective == want.objective
        assert sim_fields(got.result) == sim_fields(want.result)

    @pytest.mark.parametrize("name", jreg.baseline_names())
    def test_evaluate_baseline(self, name):
        with pytest.deprecated_call():
            jw, jr = japi.evaluate_baseline(name, DNNS, "agx-orin")
        with pytest.deprecated_call(
                match="repro_torch.core.api.evaluate_baseline"):
            tw, tr = tapi.evaluate_baseline(name, DNNS, "agx-orin",
                                            device="cpu")
        assert [w.assignment for w in tw] == [w.assignment for w in jw]
        assert sim_fields(tr) == sim_fields(jr)

    def test_compare(self):
        with pytest.deprecated_call():
            want = japi.compare(DNNS, "xavier-agx", deadline_s=5.0)
        with pytest.deprecated_call(match="repro_torch.core.api.compare"):
            got = tapi.compare(DNNS, "xavier-agx", deadline_s=5.0,
                               device="cpu")
        assert sorted(got) == sorted(want)
        assert got["haxconn"].assignments == want["haxconn"].assignments
        assert got["haxconn"].objective == want["haxconn"].objective
        for name in jreg.baseline_names():
            assert sim_fields(got[name]) == sim_fields(want[name])

    def test_shared_scheduler_is_keyed_by_device(self, monkeypatch):
        a = tapi.shared_scheduler("xavier-agx", device="cpu")
        assert a is tapi.shared_scheduler("xavier-agx",
                                          device=torch.device("cpu"))
        assert a.device.type == "cpu"
        assert tapi.__all__ == japi.__all__
        # like the Scheduler, the shims run on the card unless asked
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            with pytest.raises(RuntimeError, match="CUDA"):
                tapi.schedule(DNNS, "xavier-agx")
        with pytest.raises(RuntimeError, match="CUDA"):
            tapi.shared_scheduler("xavier-agx")


# ---------------------------------------------------------------------------
# reschedule_plan: the reference's plans load in the port, and back
# ---------------------------------------------------------------------------
RESCHEDULE = (["vgg19", "resnet152"], 1.6)   # observed factor -> 1.625


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_rescheduled_plan_loads_in_the_other_package(direction, tmp_path):
    """One package rescales and saves a plan; the other loads it with the
    same model, factor, base, request hash, assignments and objective."""
    graphs, observed = RESCHEDULE
    if direction == "reference_to_port":
        sched, dyn, reg = JScheduler("agx-orin"), jdyn, jreg
        load, back_reg = TPlan.load, treg
        model_type = tdyn.ScaledContentionModel
    else:
        sched, dyn, reg = TScheduler("agx-orin", device="cpu"), tdyn, treg
        load, back_reg = JPlan.load, jreg
        model_type = jdyn.ScaledContentionModel
    want = dyn.reschedule_plan(sched, sched.graphs(graphs), observed)
    path = tmp_path / "plan.json"
    want.save(path)
    back = load(path)
    model = back.request.model
    assert type(model) is model_type
    assert model.factor == want.request.model.factor
    assert model.factor == jdyn.quantize_severity(observed) == 1.625
    assert type(model.base).__name__ == "ProportionalShareModel"
    assert (back_reg.encode_model(model.base)
            == reg.encode_model(want.request.model.base))
    assert back.request_hash == want.request_hash
    assert back.request.request_hash() == want.request_hash
    assert back.assignments == want.assignments
    assert back.objective == want.objective


# ---------------------------------------------------------------------------
# an anneal solve under the scaled PCCS surface
# ---------------------------------------------------------------------------
@pytest.fixture
def reference_solver(reference, monkeypatch):
    """The reference's search switched on (``reference``), and its
    registry's cached probe of it cleared."""
    monkeypatch.setattr(jreg, "_JAX_OK", True)


@pytest.mark.parametrize("precision", ["x64", "float32"])
def test_anneal_under_scaled_pccs(reference_solver, precision):
    jsched = JScheduler("xavier-agx")
    jgraphs = jsched.graphs(["googlenet", "resnet18"])
    jm = jdyn.ScaledContentionModel(JPiecewise(*PCCS), 1.5)
    kw = dict(solver="anneal", precision=precision, population=32,
              steps=24, seed=7, island=8, exchange_every=4,
              max_transitions=2)
    want = JScheduler(jsched.platform, model=jm, evaluator="jax").solve(
        jgraphs, "latency", **kw)
    got = TScheduler(port_platform(jsched.platform), model=port_model(jm),
                     evaluator="torch", device="cpu").solve(
        [port_graph(g) for g in jgraphs], "latency", **kw)
    assert type(got.request.model) is tdyn.ScaledContentionModel
    assert got.request_hash == want.request_hash
    assert got.assignments == want.assignments
    assert got.objective == want.objective
    if precision == "x64":
        assert got.solver_params == want.solver_params
    else:
        assert got.solver_params["device_objective"] == pytest.approx(
            want.solver_params["device_objective"], rel=1e-6)
