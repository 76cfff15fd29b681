"""Port parity: the schedule search of ``repro_torch.core`` vs ``repro``'s.

* ``repro_torch.core.prng`` reproduces ``jax.random`` bit for bit
  (``PRNGKey``, ``fold_in``, ``split``, int32 and x64 ``randint``, float32
  ``uniform``) over several seeds, chains and steps;
* the port's ``anneal_search(device="cpu", precision="x64")`` explores the
  reference's chains: on ``tests/test_search.py``'s ``xavier_pair`` with
  its ``TestDeterminism.KW``, under the proportional model and the PCCS
  surface, it returns the same assignment from the same chain with the
  objective within 1e-9 relative (where two different assignments tie
  within 1e-9, the same objective is enough: see ``same_incumbent``);
* the knob rejections of ``tests/test_search.py``'s ``TestValidation``,
  with the same messages.

``tests/test_torch_search_determinism.py`` holds the port's own
determinism and optimality checks, ``tests/test_torch_search_golden.py``
the golden fixtures.

The reference search does not import under this JAX (its module asks for
``jax.experimental.enable_x64``, which JAX 0.9 moved to
``jax.enable_x64``), so the ``reference`` fixture switches it on for the
test with ``monkeypatch``; nothing in ``repro`` changes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Scheduler as JScheduler
from repro.core import search_jax, simulate_jax
from repro.core.contention import PiecewiseModel as JPiecewise
from repro_torch.core import prng
from repro_torch.core import search_torch, simulate_torch
from repro_torch.core.accelerators import Accelerator, Platform
from repro_torch.core.contention import ProportionalShareModel
from repro_torch.core.graph import DNNGraph, LayerGroup
from repro_torch.core.simulate import Workload, simulate

from test_torch_core import (one_thread, port_graph,  # noqa: F401
                             port_model, port_platform)
from test_torch_simulate import PCCS

KW = dict(objective="latency", seed=7, population=32, steps=24, island=8,
          exchange_every=4)                  # tests/test_search.py:172-173


@pytest.fixture
def reference(monkeypatch):
    """``repro.core.search_jax`` with its JAX import repaired."""
    for m in (simulate_jax, search_jax):
        monkeypatch.setattr(m, "HAVE_JAX", True)
        monkeypatch.setattr(m, "enable_x64", jax.enable_x64, raising=False)
    return search_jax


def xavier_pair(model="proportional"):
    """tests/test_search.py:86-90, as (reference, port) problems."""
    sched = JScheduler("xavier-agx")
    graphs = sched.graphs(["googlenet", "resnet18"])
    jmodel = sched.model if model == "proportional" else JPiecewise(*PCCS)
    return ((sched.platform, graphs, jmodel),
            (port_platform(sched.platform), [port_graph(g) for g in graphs],
             port_model(jmodel)))


def scalar_objective(platform, graphs, model, assignment, objective="latency",
                     its=None, deps=None):
    its = its or [1] * len(graphs)
    deps = deps or [None] * len(graphs)
    wls = [Workload(g, tuple(a), iterations=it, depends_on=dep)
           for g, a, it, dep in zip(graphs, assignment, its, deps)]
    return simulate(platform, wls, model,
                    record_timeline=False).objective(objective)


def same_incumbent(port, ref, platform, graphs, model):
    """Same chain and assignment, objective within 1e-9 relative; where
    the assignments differ they must tie within 1e-9 under the scalar
    simulator (a tie the two float orders may break differently)."""
    assert port.objective == pytest.approx(ref.objective, rel=1e-9)
    if port.assignment != ref.assignment:
        a = scalar_objective(platform, graphs, model, port.assignment)
        b = scalar_objective(platform, graphs, model, ref.assignment)
        assert a == pytest.approx(b, rel=1e-9)
    else:
        assert port.chain == ref.chain


# ---------------------------------------------------------------------------
# random draws
# ---------------------------------------------------------------------------

class TestPrng:
    @pytest.mark.parametrize("x64", [False, True])
    @pytest.mark.parametrize("seed", [0, 7, 123456, 2 ** 31 + 5])
    def test_draws_match_jax_random_bit_for_bit(self, x64, seed):
        if seed >= 2 ** 31 and not x64:
            pytest.skip("seeds of 2^31 and more need x64 in jax")
        chains = np.array([0, 1, 5, 31, 1000, 2 ** 20 + 3])
        with jax.enable_x64(x64):
            base = jax.random.PRNGKey(seed)
            np.testing.assert_array_equal(
                np.asarray(base), [int(k[0]) for k in prng.key(seed)])
            ck = jax.vmap(lambda i: jax.random.fold_in(base, i))(
                jnp.asarray(chains, jnp.int32))
            tck = prng.fold_in(prng.key(seed, len(chains)),
                               torch.tensor(chains))
            np.testing.assert_array_equal(np.asarray(ck)[:, 0], tck[0])
            np.testing.assert_array_equal(np.asarray(ck)[:, 1], tck[1])
            for step in (0, 3, 17, 191):
                keys = jax.vmap(lambda k: jax.random.fold_in(k, step))(ck)
                ks = jax.vmap(lambda k: jax.random.split(k, 2))(keys)
                tkm, tku = prng.split(prng.fold_in(tck, step))
                np.testing.assert_array_equal(np.asarray(ks[:, 0, 0]), tkm[0])
                np.testing.assert_array_equal(np.asarray(ks[:, 1, 1]), tku[1])
                for span in (1, 2, 7, 61, 100_000, 2 ** 30 + 1):
                    want = np.asarray(jax.vmap(
                        lambda k: jax.random.randint(k, (), 0, span))(
                        ks[:, 0]))
                    got = prng.randint(tkm, 0, span, bits=64 if x64 else 32)
                    np.testing.assert_array_equal(want, got.numpy())
                # a per-chain bound, as the mutation's second draw
                his = jnp.asarray([1, 2, 3, 4, 5, 0], jnp.int32)
                want = np.asarray(jax.vmap(
                    lambda k, h: jax.random.randint(k, (), 0, h))(
                    ks[:, 0], his))
                got = prng.randint(tkm, 0, torch.tensor(np.asarray(his)),
                                   bits=64 if x64 else 32)
                np.testing.assert_array_equal(want, got.numpy())
                want = np.asarray(jax.vmap(
                    lambda k: jax.random.uniform(k, (), jnp.float32))(
                    ks[:, 1]))
                got = prng.uniform_f32(tku)
                assert got.dtype == torch.float32
                np.testing.assert_array_equal(want.view(np.int32),
                                              got.numpy().view(np.int32))

    def test_threefry_known_answer(self):
        """Threefry-2x32 test vector (Salmon et al., SC'11; the one
        ``jax``'s own tests use): key and counter all ones."""
        m = prng.M32
        k = (torch.tensor([m]), torch.tensor([m]))
        a, b = prng.threefry2x32(k, torch.tensor([m]), torch.tensor([m]))
        assert (int(a[0]), int(b[0])) == (0x1CB996FC, 0xBB002BE7)


# ---------------------------------------------------------------------------
# the search against the reference
# ---------------------------------------------------------------------------

class TestReferenceChains:
    @pytest.mark.parametrize("model", ["proportional", "pccs"])
    def test_x64_search_returns_the_reference_incumbent(self, reference,
                                                        model):
        (jp, jg, jm), (tp, tg, tm) = xavier_pair(model)
        ref = reference.anneal_search(
            reference.build_tables(jp, jg, jm, 2), precision="x64", **KW)
        got = search_torch.anneal_search(
            search_torch.build_tables(tp, tg, tm, 2), precision="x64",
            device="cpu", **KW)
        same_incumbent(got, ref, tp, tg, tm)
        assert got.evaluated == ref.evaluated == 32 * (KW["steps"] + 1)

    def test_float32_search_matches_too(self, reference):
        (jp, jg, jm), (tp, tg, tm) = xavier_pair("pccs")
        ref = reference.anneal_search(
            reference.build_tables(jp, jg, jm, 2), precision="float32",
            **KW)
        got = search_torch.anneal_search(
            search_torch.build_tables(tp, tg, tm, 2), precision="float32",
            device="cpu", **KW)
        assert got.objective == pytest.approx(ref.objective, rel=1e-6)

    def test_tables_and_initial_population_are_identical(self, reference):
        (jp, jg, jm), (tp, tg, tm) = xavier_pair("pccs")
        jt = reference.build_tables(jp, jg, jm, 2)
        tt = search_torch.build_tables(tp, tg, tm, 2)
        for f in ("dur_t", "dem_t", "allowed", "n_allowed", "legal_after",
                  "move_ms", "tau_pair", "ngroups", "domshare",
                  "model_of_acc"):
            np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f))
        row = search_torch.default_init(tt)
        np.testing.assert_array_equal(row, reference.default_init(jt))
        np.testing.assert_array_equal(
            search_torch._scatter_population(tt, row, 64, 7),
            reference._scatter_population(jt, row, 64, 7))


def tiny_problem():
    """tests/test_search.py:60-83 in the port's types."""
    def acc(name, tin, tout):
        return Accelerator(name, peak_flops=1e12, mem_bw=1e11,
                           transition_in_ms=tin, transition_out_ms=tout)

    platform = Platform(
        name="tiny", accelerators=(acc("GPU", 0.02, 0.03),
                                   acc("DLA", 0.05, 0.01)),
        transition_bw=1e11, domains={"EMC": ("GPU", "DLA")},
        domain_bw={"EMC": 1e11})

    def grp(i, tg, td, dg, dd):
        return LayerGroup(name=f"g{i}", times={"GPU": tg, "DLA": td},
                          mem_demand={"GPU": dg, "DLA": dd},
                          out_bytes=2e7, can_transition_after=True)

    graphs = [
        DNNGraph("a", (grp(0, 1.0, 1.6, 0.7, 0.4), grp(1, 2.0, 1.1, 0.5, 0.6),
                       grp(2, 0.8, 1.9, 0.9, 0.3))),
        DNNGraph("b", (grp(0, 1.4, 0.9, 0.6, 0.5), grp(1, 0.7, 1.5, 0.8, 0.2),
                       grp(2, 1.8, 1.0, 0.4, 0.7))),
    ]
    return platform, graphs, ProportionalShareModel(capacity=1.0,
                                                    sensitivity=2.0)


class TestValidation:
    """tests/test_search.py:295-349, same messages."""

    @pytest.fixture(scope="class")
    def tiny(self):
        platform, graphs, model = tiny_problem()
        return search_torch.build_tables(platform, graphs, model, 2)

    @pytest.mark.parametrize("kw,match", [
        (dict(objective="energy"), "objective"),
        (dict(precision="bf16"), "precision"),
        (dict(island=32, chunk=48), "island"),
        (dict(population=16, island=32), "island=16"),
        (dict(population=100, island=32), "population=96"),
        (dict(population=64, island=32, chunk=96), "chunk=64"),
        (dict(devices=4), "devices=1"),
        (dict(migrate="ring"), "migrate='island'"),
        (dict(fanout="pmap"), "fanout='auto'"),
    ])
    def test_rejections_name_the_nearest_legal_value(self, tiny, kw, match):
        with pytest.raises(ValueError, match=match):
            search_torch.anneal_search(tiny, device="cpu", **kw)

    def test_rejects_illegal_init(self):
        bad = np.zeros((2, 4), dtype=np.int32)
        bad[0, 0] = 1
        bad[0, 2] = 1
        tables0 = search_torch.build_tables(*tiny_problem(),
                                            max_transitions=0)
        with pytest.raises(ValueError, match="legal"):
            search_torch.anneal_search(tables0, init_assignment=bad,
                                       device="cpu")

    def test_unlowerable_model_refused_with_guidance(self):
        platform, graphs, _ = tiny_problem()

        class Opaque:
            def slowdown(self, acc, own, ext):  # pragma: no cover
                return 1.0

        with pytest.raises(ValueError, match="surface"):
            search_torch.build_tables(platform, graphs, Opaque(), 2)

    def test_encode_decode_round_trip(self, tiny):
        asg = (("GPU", "DLA", "DLA"), ("DLA", "GPU", "GPU"))
        row = tiny.encode(asg)
        assert tiny.decode(row) == asg
        assert tiny.legal(row)

    def test_defaults_to_cuda(self, tiny, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            search_torch.anneal_search(tiny, population=32)


# ---------------------------------------------------------------------------
# the steps as captured graphs (static buffers, device step and temperature)
# ---------------------------------------------------------------------------

def golden_tables(name="scenario4-exp8-orin-resnet101-googlenet-inception"):
    """A golden Table-6 fixture under the PCCS surface, as search tables."""
    import pathlib

    from repro_torch.core import Plan
    from repro_torch.core.contention import PiecewiseModel

    req = Plan.load(pathlib.Path(__file__).parent / "fixtures" / "plans"
                    / f"{name}.json").request
    return search_torch.build_tables(
        req.platform, list(req.graphs), PiecewiseModel(*PCCS),
        req.max_transitions, list(req.iterations), list(req.depends_on))


def host_loop(chains, chain_idx, asg0, seed, n_steps, ex_every, t0, t1):
    """The steps as one plain eager host loop over ``chains``' own
    methods (the evaluation tests for a finished population every
    CHECK_EVERY waves, the temperature is a host float): the oracle the
    graphs' step functions are held to."""
    from repro_torch.kernels.search import anneal_select

    dt = chains.tb["dur_t"].dtype
    P = asg0.shape[0]
    L = chains.tables.w * chains.tables.gmax
    chain_keys = prng.fold_in(prng.key(seed, P, asg0.device), chain_idx)
    temps = search_torch.temperature_schedule(t0, t1, n_steps, dt)
    cur_obj, _ = chains.evaluate(asg0)
    cur = best = asg0
    best_obj = cur_obj
    for step in range(n_steps):
        km, ku = prng.split(prng.fold_in(chain_keys, step))
        prop = chains.mutate(km, cur)
        prop_obj, _ = chains.evaluate(prop)
        u = prng.uniform_f32(ku).to(dt)
        c, cur_obj, b, best_obj = anneal_select(
            cur.reshape(P, L), prop.reshape(P, L), best.reshape(P, L),
            cur_obj, prop_obj, best_obj, u, temps[step],
            backend=chains.backend)
        cur, best = c.reshape(asg0.shape), b.reshape(asg0.shape)
        if (step + 1) % ex_every == 0:
            cur_i, obj_i, elite, elite_obj = chains.fold(cur, cur_obj, best,
                                                         best_obj)
            if chains.migrate == "ring":        # wrapped on this rank
                chains.ring(cur_i, obj_i, elite, elite_obj, elite[-1:],
                            elite_obj[-1:])
            cur, cur_obj = cur_i.reshape(cur.shape), obj_i.reshape(-1)
    return best_obj, best


def chains_of(tables, precision, device, island=8, migrate="island"):
    """``anneal_search``'s ``_Chains`` and scattered start for ``tables``
    at population 64 (seed 7, latency)."""
    dt = simulate_torch.dtype_of(precision)
    chains = search_torch._Chains(
        tables, search_torch._device_tables(tables, dt, device), "latency",
        island, migrate, "auto", bits=64 if precision == "x64" else 32)
    asg0 = torch.as_tensor(search_torch._scatter_population(
        tables, search_torch.default_init(tables), 64, 7), device=device)
    return chains, torch.arange(64, device=device), asg0


class TestGraphSteps:
    @pytest.mark.parametrize("precision", ["x64", "float32"])
    @pytest.mark.parametrize("problem", ["xavier", "orin"])
    def test_graph_path_equals_host_loop_bitwise(self, precision, problem):
        """The graphs' step functions (fixed wave budget plus overflow
        waves, select with the device temperature, the device step folded
        into the keys, migration into static buffers), run eagerly on the
        CPU, give every chain the plain host loop's incumbent and
        objective bit for bit."""
        if problem == "xavier":
            _, (tp, tg, tm) = xavier_pair("pccs")
            tables = search_torch.build_tables(tp, tg, tm, 2)
        else:
            tables = golden_tables()
        chains, idx, asg0 = chains_of(tables, precision, "cpu")
        args = (idx, asg0, 7, 20, 4, 0.5, 5e-4)
        want_obj, want = host_loop(chains, *args)
        got_obj, got = chains.run(*args, eager=False)
        assert chains.stats["graph"] is False
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert got_obj.numpy().tobytes() == want_obj.numpy().tobytes()

    @pytest.mark.parametrize("dt", [torch.float32, torch.float64])
    @pytest.mark.parametrize("n_steps", [1, 2, 24, 64])
    def test_temperature_schedule_is_the_host_values(self, dt, n_steps):
        """Each entry equals the step's host computation bit for bit, and
        survives the trip through a tensor of the objectives' dtype."""
        t0, t1 = 0.1 * 4.37, 1e-4 * 4.37
        got = search_torch.temperature_schedule(t0, t1, n_steps, dt)
        t0_, t1_ = (torch.tensor(v, dtype=dt) for v in (t0, t1))
        denom = torch.tensor(max(n_steps - 1, 1), dtype=dt)
        for step, temp in enumerate(got):
            frac = torch.tensor(step, dtype=dt) / denom
            want = float(t0_ * (t1_ / t0_) ** frac)
            assert np.float64(temp).tobytes() == np.float64(want).tobytes()
        dev = torch.tensor(got, dtype=dt)
        assert [float(x) for x in dev] == got

    def test_graph_stats_in_the_trace(self):
        from repro_torch.obs import Tracer, set_tracer

        tracer = Tracer()
        prev = set_tracer(tracer)
        try:
            search_torch.anneal_search(golden_tables(), device="cpu",
                                       **dict(KW, population=32, steps=6))
        finally:
            set_tracer(prev)
        (chunk,) = [e["args"] for e in tracer.events()
                    if e["name"] == "anneal.chunk"]
        assert chunk["graph"] is False and chunk["waves"] > 0
        assert chunk["waves"] % simulate_torch.CHECK_EVERY == 0
        assert chunk["overflow_replays"] >= 0
        assert chunk["launches_per_graph"] == {
            "head": {}, "more": {}, "tail": {}, "fold": {}}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built with nvcc "
                    "for sm_90a)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["x64", "float32"])
def test_graph_steps_equal_host_loop_on_the_card(cuda_device, precision):
    """On the orin fixture: the captured graphs give every chain the
    plain host loop's incumbent and objective bit for bit on the card,
    where the loop hands the select kernel a host-float temperature."""
    chains, idx, asg0 = chains_of(golden_tables(), precision, cuda_device)
    args = (idx, asg0, 7, 20, 4, 0.5, 5e-4)
    want_obj, want = host_loop(chains, *args)
    got_obj, got = chains.run(*args, eager=False)
    assert chains.stats["graph"] is True
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (got_obj.cpu().numpy().tobytes()
            == want_obj.cpu().numpy().tobytes())


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["x64", "float32"])
def test_graph_search_equals_eager_search_on_the_card(cuda_device,
                                                      precision):
    """On the orin fixture: the captured graphs and the same step
    functions run eagerly on the card return the same incumbent bit for
    bit; the graphs replay the select kernel once a step and the
    slowdown kernel in every wave."""
    from repro_torch.kernels import search as tsearch
    from repro_torch.obs import Tracer, set_tracer

    tables = golden_tables()
    kw = dict(KW, population=256, steps=16, precision=precision,
              device=cuda_device)
    eager = search_torch.anneal_search(tables, eager=True, **kw)
    tracer = Tracer()
    prev = set_tracer(tracer)
    try:
        before = tsearch.launches
        graph = search_torch.anneal_search(tables, **kw)
        launched = tsearch.launches - before
    finally:
        set_tracer(prev)
    assert graph == eager
    (chunk,) = [e["args"] for e in tracer.events()
                if e["name"] == "anneal.chunk"]
    per = chunk["launches_per_graph"]
    assert per["tail"] == {"search": 1}
    assert per["head"]["slowdown"] > 0 and per["more"]["slowdown"] > 0
    assert launched == kw["steps"] + 1          # + the warm-up's
