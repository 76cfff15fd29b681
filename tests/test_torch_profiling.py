"""Port parity: ``repro_torch.profiling`` against ``repro.profiling``.

The profile → calibrate → bundle → solve loop of the paper's §4.1-4.2,
driven through both packages on the same seeded inputs at a small size:

* the harness discipline and the virtual SoC are copies, so timings,
  measured graphs and co-run samples are equal **exactly**;
* the calibration is rewritten in PyTorch (float32, as the reference runs
  it with x64 off): the lstsq-only fit agrees within 1e-5 of the JAX fit
  (QR against SVD in float32); the Adam fit passes the reference's own 5%
  acceptance gates (``tests/test_profiling.py:149-170``) and predicts
  within 2e-2 of the JAX fit (Adam normalizes near-zero gradients to
  steps of ``lr`` = 0.01); the proportional fit's parameters agree within
  1e-3 relative;
* bundles written by either package load in the other with the same
  content hash;
* the CPU path of the port's ``measure_arch`` yields the reference's
  ``GroupCosts`` exactly, with measured times > 0.
"""
import json

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import profiling as jprof
from repro.configs.base import ShapeCell as JShapeCell
from repro.core import Scheduler as JScheduler
from repro.core.accelerators import xavier_agx as j_xavier
from repro.core.characterize import GroupCosts as JGroupCosts
from repro.core.characterize import characterize as jcharacterize
from repro.core.contention import ProportionalShareModel as JProportional
from repro.core.plan import graph_to_dict as j_graph_to_dict
from repro.core.profiles import get_graph as j_get_graph
from repro.models.graph_export import export_graph as j_export_graph
from repro.obs import timeline as jtimeline
from repro.profiling import calibrate as jcal
from repro_torch import configs as tconfigs
from repro_torch import profiling as tprof
from repro_torch.configs.base import ShapeCell as TShapeCell
from repro_torch.core import Scheduler as TScheduler
from repro_torch.core.accelerators import xavier_agx as t_xavier
from repro_torch.core.characterize import GroupCosts as TGroupCosts
from repro_torch.core.characterize import characterize as tcharacterize
from repro_torch.core.contention import PiecewiseModel as TPiecewise
from repro_torch.core.plan import graph_to_dict as t_graph_to_dict
from repro_torch.core.profiles import get_graph as t_get_graph
from repro_torch.models.graph_export import export_graph as t_export_graph
from repro_torch.obs import timeline as ttimeline
from repro_torch.profiling import calibrate as tcal

from test_torch_core import one_thread  # noqa: F401

DNNS = ("vgg19", "resnet101")
LSTSQ_TOL = 1e-5
ADAM_PRED_TOL = 2e-2
PROPORTIONAL_RTOL = 1e-3
GATE = 0.05                     # tests/test_profiling.py:149-170
CPU = "cpu"


def vsocs(seed=0, noise=0.003, outlier_rate=0.05):
    jp, tp = j_xavier(), t_xavier()
    j = jprof.VirtualSoC(jp, [j_get_graph(d, jp) for d in DNNS],
                         noise=noise, outlier_rate=outlier_rate, seed=seed)
    t = tprof.VirtualSoC(tp, [t_get_graph(d, tp) for d in DNNS],
                         noise=noise, outlier_rate=outlier_rate, seed=seed)
    return j, t


def graphs_json(graphs, to_dict):
    return json.dumps([to_dict(g) for g in graphs], sort_keys=True)


@pytest.fixture(scope="module")
def pipelines():
    """One profile → calibrate → bundle run through each package."""
    (jv, tv) = vsocs()
    return (jv, jprof.run_pipeline(jv)), (tv, tprof.run_pipeline(tv, device=CPU))


# ---------------------------------------------------------------------------
# timing discipline (copies: exact)
# ---------------------------------------------------------------------------
TIMES = [[1.0, 1.02, 0.99, 1.01, 1.0, 5.0, 0.98],
         [1.0, 10.0, 100.0],
         [2.0, 2.0, 2.0, 9.0],
         list(np.random.default_rng(4).lognormal(0.0, 0.6, 25))]


@pytest.mark.parametrize("times", TIMES)
@pytest.mark.parametrize("outlier_z,min_kept", [(3.5, 3), (1.0, 2)])
def test_reject_outliers_equal(times, outlier_z, min_kept):
    assert (tprof.reject_outliers(times, outlier_z=outlier_z,
                                  min_kept=min_kept)
            == jprof.reject_outliers(times, outlier_z=outlier_z,
                                     min_kept=min_kept))


def test_measure_samples_equal():
    seq = [7.0, 7.0, 1.0, 1.0, 1.02, 0.98, 1.0, 42.0, 1.01]
    timer_j = jprof.TimerConfig(warmup=2, repeats=7)
    timer_t = tprof.TimerConfig(**timer_j.to_dict())
    it_j, it_t = iter(seq), iter(seq)
    mj = jprof.measure_samples(lambda: next(it_j), timer=timer_j, name="s")
    mt = tprof.measure_samples(lambda: next(it_t), timer=timer_t, name="s")
    assert (mt.kept_ms, mt.rejected_ms) == (mj.kept_ms, mj.rejected_ms)
    assert mt.median_ms == mj.median_ms and mt.std_ms == mj.std_ms


def test_timer_config_round_trip_and_validation():
    t = tprof.TimerConfig(warmup=1, repeats=5)
    assert tprof.TimerConfig.from_dict(t.to_dict()) == t
    assert t.to_dict() == jprof.TimerConfig(warmup=1, repeats=5).to_dict()
    with pytest.raises(ValueError):
        tprof.TimerConfig(repeats=0)


def test_measure_wallclock_cpu():
    x = torch.ones(64, 64)
    m = tprof.measure_wallclock(lambda: x @ x,
                                timer=tprof.TimerConfig(warmup=1, repeats=3),
                                name="matmul")
    assert m.median_ms > 0.0 and m.n_total == 3


# ---------------------------------------------------------------------------
# virtual SoC, measured graphs, co-run samples (copies: exact)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 7])
def test_virtual_soc_sequences_equal(seed):
    jv, tv = vsocs(seed=seed)
    for ext in (0.0, 0.5, 0.9, 1.05):
        for gi in (0, 1, 3):
            assert (tv.run_group("vgg19", gi, "GPU", ext)
                    == jv.run_group("vgg19", gi, "GPU", ext))
            assert (tv.read_demand("resnet101", gi, "DLA")
                    == jv.read_demand("resnet101", gi, "DLA"))
    assert tv.describe() == jv.describe()


def test_profile_graphs_and_corun_sweep_equal():
    jv, tv = vsocs(seed=3)
    timer_j = jprof.TimerConfig(warmup=1, repeats=5)
    timer_t = tprof.TimerConfig(warmup=1, repeats=5)
    jg = jprof.profile_graphs(jv, timer=timer_j)
    tg = tprof.profile_graphs(tv, timer=timer_t)
    assert graphs_json(tg, t_graph_to_dict) == graphs_json(jg,
                                                           j_graph_to_dict)
    levels = (0.2, 0.6, 1.0)
    assert (tprof.corun_sweep(tv, tg, ext_levels=levels, timer=timer_t)
            == jprof.corun_sweep(jv, jg, ext_levels=levels, timer=timer_j))


def test_pipeline_samples_and_graphs_equal(pipelines):
    (_, jb), (_, tb) = pipelines
    assert tb.samples == jb.samples
    assert graphs_json(tb.graphs, t_graph_to_dict) == graphs_json(
        jb.graphs, j_graph_to_dict)
    pj, pt = dict(jb.provenance), dict(tb.provenance)
    assert pj.pop("fit").keys() == pt.pop("fit").keys()
    assert pt == pj


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------
def exact_surface_samples(n=400, seed=1):
    truth = jprof.paper_like_pccs()
    rng = np.random.default_rng(seed)
    own = rng.uniform(0.1, 0.95, n)
    ext = rng.uniform(0.1, 0.95, n)
    return truth, [(o, e, truth.slowdown(o, e)) for o, e in zip(own, ext)]


def passes_the_gates(result, samples, truth):
    """The reference's acceptance (tests/test_profiling.py:149-170): the
    fit's residuals and its prediction of the generating surface, each
    within 5%."""
    r = result.report
    return (0.0 <= r.max_rel_err < GATE and r.rmse < GATE
            and all(abs(result.model.slowdown(o, e) / truth(o, e) - 1.0)
                    < GATE for o, e, _ in samples))


@pytest.mark.parametrize("n,seed", [(400, 1), (100, 3), (200, 4),
                                    (1000, 6), (50, 7), (60, 2), (25, 5)])
def test_fit_piecewise_exact_surface(n, seed):
    """Both fits take the same path.  Where the lstsq optimum is feasible
    (steps == 0) the tables agree within 1e-5; where it is not (the two
    smallest sample sets) both Adam fits pass the reference's 5% gates and
    their predictions agree within 2e-2."""
    truth, samples = exact_surface_samples(n, seed)
    kw = dict(own_knots=truth.own_knots, ext_knots=truth.ext_knots)
    rj = jcal.fit_piecewise(samples, **kw)
    rt = tcal.fit_piecewise(samples, device=CPU, **kw)
    assert rt.report.steps == rj.report.steps
    assert rt.model.own_knots == rj.model.own_knots
    assert rt.model.ext_knots == rj.model.ext_knots
    if rj.report.steps == 0:
        np.testing.assert_allclose(np.asarray(rt.model.table),
                                   np.asarray(rj.model.table),
                                   atol=LSTSQ_TOL, rtol=0)
    else:
        assert passes_the_gates(rj, samples, truth.slowdown)
        assert passes_the_gates(rt, samples, truth.slowdown)
        pred_t = [rt.model.slowdown(o, e) for o, e, _ in samples]
        pred_j = [rj.model.slowdown(o, e) for o, e, _ in samples]
        np.testing.assert_allclose(pred_t, pred_j, atol=ADAM_PRED_TOL,
                                   rtol=0)


def test_fit_piecewise_default_knots_equal():
    _, samples = exact_surface_samples(200, 9)
    rj = jcal.fit_piecewise(samples)
    rt = tcal.fit_piecewise(samples, device=CPU)
    assert rt.model.own_knots == rj.model.own_knots
    assert rt.model.ext_knots == rj.model.ext_knots


def test_pipeline_fit_passes_the_gates(pipelines):
    """The virtual SoC's co-run samples: the lstsq optimum is feasible for
    both packages, so the tables agree within 1e-5 and both pass the
    reference's 5% gates against the generating model."""
    (jv, jb), (tv, tb) = pipelines
    assert jb.provenance["fit"]["steps"] == tb.provenance["fit"]["steps"]
    for vsoc, bundle in ((jv, jb), (tv, tb)):
        fit = bundle.provenance["fit"]
        assert 0.0 <= fit["max_rel_err"] < GATE and fit["rmse"] < GATE
        for own, ext, _ in bundle.samples:
            assert bundle.model.slowdown(own, ext) == pytest.approx(
                vsoc.true_slowdown("GPU", own, ext), rel=GATE)
    if jb.provenance["fit"]["steps"] == 0:
        np.testing.assert_allclose(np.asarray(tb.model.table),
                                   np.asarray(jb.model.table),
                                   atol=LSTSQ_TOL, rtol=0)


def test_fit_piecewise_noisy_nonmonotone_adam():
    truth = jprof.paper_like_pccs()
    rng = np.random.default_rng(3)
    own = rng.uniform(0.1, 0.9, 150)
    ext = rng.uniform(0.1, 0.9, 150)
    sd = np.maximum(1.0, [truth.slowdown(o, e) * (1 + 0.08 * z)
                          for o, e, z in
                          zip(own, ext, rng.standard_normal(150))])
    samples = list(zip(own, ext, sd))
    rj = jcal.fit_piecewise(samples)
    rt = tcal.fit_piecewise(samples, device=CPU)
    assert rt.report.steps == rj.report.steps == 300
    tab = np.asarray(rt.model.table)
    assert (tab >= 1.0).all()
    assert (np.diff(tab, axis=0) >= 0).all()
    assert (np.diff(tab, axis=1) >= 0).all()
    pred_t = [rt.model.slowdown(o, e) for o, e in zip(own, ext)]
    pred_j = [rj.model.slowdown(o, e) for o, e in zip(own, ext)]
    np.testing.assert_allclose(pred_t, pred_j, atol=ADAM_PRED_TOL, rtol=0)
    assert rt.report.rmse == pytest.approx(rj.report.rmse, abs=1e-3)


@pytest.mark.parametrize("cap,sens,seed", [(1.0, 3.0, 2), (0.8, 2.5, 12)])
def test_fit_proportional_parameters(cap, sens, seed):
    truth = JProportional(capacity=cap, sensitivity=sens)
    rng = np.random.default_rng(seed)
    own = rng.uniform(0.05, 1.0, 300)
    ext = rng.uniform(0.05, 1.0, 300)
    samples = [(o, e, truth.slowdown(o, e)) for o, e in zip(own, ext)]
    rj = jcal.fit_proportional(samples)
    rt = tcal.fit_proportional(samples, device=CPU)
    assert rt.model.capacity == pytest.approx(rj.model.capacity,
                                              rel=PROPORTIONAL_RTOL)
    assert rt.model.sensitivity == pytest.approx(rj.model.sensitivity,
                                                 rel=PROPORTIONAL_RTOL)


@pytest.mark.parametrize("cap,sens", [(1.0, 1.5), (0.7, 3.0), (0.9, 2.0)])
def test_proportional_predict_matches_scalar(cap, sens):
    rng = np.random.default_rng(11)
    # a dense grid, own = 0 against any ext, and total == capacity
    edge = cap * np.asarray([0.1, 0.5, 1.0, 0.3])
    own = np.concatenate([rng.uniform(0.0, 1.2, 500), np.zeros(5), edge])
    ext = np.concatenate([rng.uniform(0.0, 1.2, 500),
                          [0.0, 0.5, 1.0, 2.0, 10.0], cap - edge])
    model = JProportional(capacity=cap, sensitivity=sens)
    scalar = np.asarray([model.slowdown(o, e) for o, e in zip(own, ext)])
    vec = tcal.proportional_predict(torch.from_numpy(own),
                                    torch.from_numpy(ext), cap, sens)
    np.testing.assert_allclose(vec.numpy(), scalar, rtol=1e-6, atol=1e-6)


def test_fit_rejects_bad_samples():
    with pytest.raises(ValueError):
        tcal.fit_piecewise([], device=CPU)
    with pytest.raises(ValueError):
        tcal.fit_piecewise([(0.5, 0.5, 0.2)], device=CPU)
    with pytest.raises(ValueError):
        tcal.fit([(0.5, 0.5, 1.2)], "gaussian-process", device=CPU)


@pytest.mark.parametrize("kind", ["piecewise", "proportional"])
def test_fit_defaults_to_cuda(kind, monkeypatch):
    """The fits are entry points: without ``device`` they run on ``cuda``
    and raise where no card is visible."""
    _, samples = exact_surface_samples(25, 5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcal.fit(samples, kind)


# ---------------------------------------------------------------------------
# bundles: equal payloads, cross-loading, solving
# ---------------------------------------------------------------------------
def test_equal_models_give_equal_hashes(pipelines):
    (_, jb), (_, tb) = pipelines
    same = tprof.ProfileBundle(
        platform=tb.platform, graphs=tb.graphs,
        model=TPiecewise(jb.model.own_knots, jb.model.ext_knots,
                         jb.model.table),
        samples=tb.samples, provenance=tb.provenance)
    assert same.bundle_hash() == jb.bundle_hash()
    assert same.payload_dict() == json.loads(json.dumps(jb.payload_dict()))


def test_port_bundle_loads_in_reference(pipelines, tmp_path):
    (_, _), (_, tb) = pipelines
    path = tb.save(tmp_path / "port.json")
    back = jprof.ProfileBundle.load(path)
    assert back.bundle_hash() == tb.bundle_hash()
    assert back.model.table == tb.model.table
    child = tb.derive(model=tb.model, samples=tb.samples[:5])
    assert jprof.ProfileBundle.load(
        child.save(tmp_path / "child.json")).parent_hash == tb.bundle_hash()


def test_reference_bundle_loads_in_port(pipelines, tmp_path):
    (_, jb), (_, _) = pipelines
    path = jb.save(tmp_path / "ref.json")
    back = tprof.ProfileBundle.load(path)
    assert back.bundle_hash() == jb.bundle_hash()
    assert back.graph_names == jb.graph_names
    with pytest.raises(ValueError, match="corrupt|incompatible"):
        d = json.loads(path.read_text())
        d["graphs"][0]["groups"][0]["times"]["GPU"] *= 1.5
        tprof.ProfileBundle.from_dict(d)


def test_scheduler_from_bundle_within_five_percent(pipelines, tmp_path):
    (_, jb), (_, tb) = pipelines
    sched = TScheduler.from_bundle(tb.save(tmp_path / "b.json"),
                                   device=CPU, evaluator="torch")
    assert sched.model == tb.model and sched.evaluator == "torch"
    plan = sched.solve(list(tb.graphs), "latency", max_transitions=2,
                       deadline_s=20.0)
    tp = t_xavier()
    truth = TScheduler(tp, model=tprof.paper_like_pccs(), device=CPU).solve(
        [t_get_graph(d, tp) for d in DNNS], "latency", max_transitions=2,
        deadline_s=20.0)
    assert plan.objective == pytest.approx(truth.objective, rel=GATE)
    ref = JScheduler.from_bundle(jb).solve(list(jb.graphs), "latency",
                                           max_transitions=2,
                                           deadline_s=20.0)
    assert plan.objective == pytest.approx(ref.objective, rel=GATE)


def test_plan_timeline_copy_renders_alike(pipelines):
    (_, jb), (_, tb) = pipelines
    kw = dict(max_transitions=2, deadline_s=20.0, solver="bb")
    jplan = JScheduler.from_bundle(jb).solve(list(jb.graphs), "latency",
                                             **kw)
    # the reference's model, so both packages solve the same problem
    tplan = TScheduler.from_bundle(
        tb, device=CPU, model=TPiecewise(jb.model.own_knots,
                                         jb.model.ext_knots,
                                         jb.model.table)).solve(
        list(tb.graphs), "latency", **kw)
    assert tplan.assignments == jplan.assignments
    assert ttimeline.plan_ascii(tplan) == jtimeline.plan_ascii(jplan)
    assert tplan.request_hash == jplan.request_hash
    # equal but for the module that names itself as the trace's producer
    got = json.dumps(ttimeline.plan_chrome(tplan), sort_keys=True)
    assert got.replace("repro_torch.obs", "repro.obs") == json.dumps(
        jtimeline.plan_chrome(jplan), sort_keys=True)


# ---------------------------------------------------------------------------
# measured kernel workloads
# ---------------------------------------------------------------------------
def test_measure_arch_cpu_costs_equal():
    cell_j = JShapeCell("prefill_64", 64, 1, "prefill")
    cell_t = TShapeCell("prefill_64", 64, 1, "prefill")
    mj = jprof.measure_arch(jconfigs.get("stablelm-1.6b").reduced(), cell_j,
                            backend="xla",
                            timer=jprof.TimerConfig(warmup=1, repeats=3))
    mt = tprof.measure_arch(tconfigs.get("stablelm-1.6b").reduced(), cell_t,
                            timer=tprof.TimerConfig(warmup=1, repeats=3),
                            device=CPU)
    assert len(mt) == len(mj) == 2
    for a, b in zip(mt, mj):
        assert vars(a.costs) == vars(b.costs)
        assert a.ms > 0.0 and a.measurement.n_total == 3


def test_measure_arch_decode_cpu():
    cell = TShapeCell("decode_32", 32, 2, "decode")
    mt = tprof.measure_arch(tconfigs.get("stablelm-1.6b").reduced(), cell,
                            timer=tprof.TimerConfig(warmup=1, repeats=3),
                            max_groups=1, device=CPU)
    mj = jprof.measure_arch(jconfigs.get("stablelm-1.6b").reduced(),
                            JShapeCell("decode_32", 32, 2, "decode"),
                            backend="xla",
                            timer=jprof.TimerConfig(warmup=1, repeats=3),
                            max_groups=1)
    assert vars(mt[0].costs) == vars(mj[0].costs) and mt[0].ms > 0.0


@pytest.mark.parametrize("span,cell", [
    (("attn", "attn"), ("prefill_16", 16, 2, "prefill")),
    (("attn",), ("decode_24", 24, 2, "decode"))])
def test_group_runner_runs_the_ops_path(span, cell, monkeypatch):
    """One group call of the port (its plain attention, eager torch) equals
    the reference's jitted group (XLA attention) on the same operands:
    both runners draw x, w1, w2, q and the caches in the same order, here
    from one seeded NumPy stream each (float32, CPU; the attention
    tolerance of tests/test_kernels.py, 2e-5)."""
    import jax
    import jax.numpy as jnp

    from repro.profiling.harness import _group_runner as j_group_runner
    from repro_torch.profiling import harness as tharness

    def numpy_normal():
        rng = np.random.default_rng(21)
        return lambda *shape: rng.standard_normal(shape).astype(np.float32)

    t_draw, j_draw = numpy_normal(), numpy_normal()
    monkeypatch.setattr(
        tharness, "_seeded_normal",
        lambda device: lambda *shape: torch.from_numpy(t_draw(*shape)))
    monkeypatch.setattr(
        jax.random, "normal",
        lambda key, shape, dtype=jnp.float32: jnp.asarray(j_draw(*shape)))
    tcfg = tconfigs.get("stablelm-1.6b").reduced()
    jcfg = jconfigs.get("stablelm-1.6b").reduced()
    got = tharness._group_runner(tcfg, span, TShapeCell(*cell), "torch",
                                 CPU)()
    want = j_group_runner(jcfg, span, JShapeCell(*cell), "xla")()
    S = 1 if cell[3] == "decode" else cell[1]
    assert got.shape == (2, S, tcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("arch,span", [("recurrentgemma-9b", ("rglru",)),
                                       ("rwkv6-7b", ("rwkv",))])
@pytest.mark.parametrize("cell", [("prefill_16", 16, 2, "prefill"),
                                  ("decode_24", 24, 2, "decode")])
def test_group_runner_runs_the_recurrent_ops_path(arch, span, cell,
                                                  monkeypatch):
    """The rglru and rwkv branches of the port's group runner (its plain
    scans) equal the reference's (XLA scans) on the same operands, drawn
    in the reference's order from one seeded NumPy stream each (float32,
    CPU, 2e-5)."""
    import jax
    import jax.numpy as jnp

    from repro.profiling.harness import _group_runner as j_group_runner
    from repro_torch.profiling import harness as tharness

    def numpy_normal():
        rng = np.random.default_rng(22)
        return lambda *shape: rng.standard_normal(shape).astype(np.float32)

    t_draw, j_draw = numpy_normal(), numpy_normal()
    monkeypatch.setattr(
        tharness, "_seeded_normal",
        lambda device: lambda *shape: torch.from_numpy(t_draw(*shape)))
    monkeypatch.setattr(
        jax.random, "normal",
        lambda key, shape, dtype=jnp.float32: jnp.asarray(j_draw(*shape)))
    tcfg = tconfigs.get(arch).reduced()
    jcfg = jconfigs.get(arch).reduced()
    got = tharness._group_runner(tcfg, span, TShapeCell(*cell), "torch",
                                 CPU)()
    want = j_group_runner(jcfg, span, JShapeCell(*cell), "xla")()
    S = 1 if cell[3] == "decode" else cell[1]
    assert got.shape == (2, S, tcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_measure_arch_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tprof.measure_arch(tconfigs.get("stablelm-1.6b").reduced(),
                           TShapeCell("prefill_8", 8, 1, "prefill"))


def test_graph_from_measurements_equal():
    jp, tp = j_xavier(), t_xavier()
    jm, tm = [], []
    for i in range(3):
        kw = dict(name=f"g{i}", flops=1e9 * (i + 1), hbm_bytes=1e7 * (i + 1),
                  shared_bytes=1e7 * (i + 1), out_bytes=1e5)
        times = (0.5 + 0.1 * i,)
        jm.append(jprof.MeasuredGroup(JGroupCosts(**kw),
                                      jprof.Measurement(f"g{i}", times)))
        tm.append(tprof.MeasuredGroup(TGroupCosts(**kw),
                                      tprof.Measurement(f"g{i}", times)))
    assert (t_graph_to_dict(tprof.graph_from_measurements("m", tp, tm))
            == j_graph_to_dict(jprof.graph_from_measurements("m", jp, jm)))


@pytest.mark.parametrize("arch,cell", [
    ("stablelm-1.6b", ("prefill_256", 256, 2, "prefill")),
    ("llama3.2-3b", ("decode_2k", 2048, 4, "decode")),
    ("qwen1.5-32b", ("prefill_1k", 1024, 1, "prefill"))])
def test_export_graph_and_characterize_equal(arch, cell):
    jc, tc = jconfigs.get(arch), tconfigs.get(arch)
    js, ts = JShapeCell(*cell), TShapeCell(*cell)
    assert (t_graph_to_dict(t_export_graph(tc, ts, t_xavier()))
            == j_graph_to_dict(j_export_graph(jc, js, j_xavier())))
    costs = dict(name="x", flops=3e10, hbm_bytes=2e8, shared_bytes=5e7,
                 out_bytes=1e6)
    assert (t_graph_to_dict(tcharacterize("c", t_xavier(),
                                          [TGroupCosts(**costs)], 0.7))
            == j_graph_to_dict(jcharacterize("c", j_xavier(),
                                             [JGroupCosts(**costs)], 0.7)))


def test_local_device_provenance_cpu():
    prov = tprof.harness.local_device_provenance(CPU)
    assert prov["torch_backend"] == "cpu" and prov["n_devices"] == 1


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def test_cli_virtual_pipeline_with_solve(tmp_path, capsys):
    from repro_torch.launch.profile import main
    out = tmp_path / "bundle.json"
    rc = main(["--platform", "xavier-agx", "--dnns", "vgg19", "resnet101",
               "--out", str(out), "--solve", "--repeats", "5",
               "--device", "cpu", "--trace-out", str(tmp_path / "t.json")])
    assert rc == 0
    text = capsys.readouterr().out
    assert "round-trip verified" in text and "rel-diff" in text
    b = jprof.ProfileBundle.load(out)       # the reference reads it
    assert b.graph_names == ("vgg19", "resnet101")
    assert json.loads((tmp_path / "t.json").read_text())["traceEvents"]


def test_cli_torch_executor_reduced_cpu(tmp_path, capsys):
    from repro_torch.launch.profile import main
    out = tmp_path / "torch.json"
    rc = main(["--executor", "torch", "--reduced", "--device", "cpu",
               "--seq", "32", "--batch", "1", "--repeats", "3",
               "--warmup", "1", "--ext-levels", "0.5,1.0", "--fit",
               "piecewise", "--out", str(out), "--solve"])
    assert rc == 0
    text = capsys.readouterr().out
    assert "round-trip verified" in text and "solved from measured" in text
    b = tprof.ProfileBundle.load(out)
    prov = b.provenance
    assert prov["executor"] == "torch-harness"
    assert prov["config"] == "stablelm-1.6b-smoke"
    assert len(b.graphs[0]) == len(prov["groups"]) == 2
    assert [c["ext"] for c in prov["corun"]] == [0.5, 1.0]
    assert all(c["probe_passes"] > 0 for c in prov["corun"])
    assert all(s[2] >= 1.0 for s in b.samples)
    assert isinstance(b.model, TPiecewise)


@pytest.mark.parametrize("argv,match", [
    (["--ext-levels", "0.5,-1.0"], None),
    (["--solver", "anneal", "--devices", "0"], "devices=1"),
    (["--devices", "1"], "require --solver anneal"),
    (["--trace-out", "x.json"], "requires --solve"),
])
def test_cli_refuses(argv, match, capsys):
    from repro_torch.launch.profile import main
    with pytest.raises(SystemExit):
        main(argv + ["--device", "cpu"])
    if match:
        assert match in capsys.readouterr().err


def test_cli_defaults_to_cuda(monkeypatch):
    from repro_torch.launch.profile import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--executor", "torch", "--reduced"])
