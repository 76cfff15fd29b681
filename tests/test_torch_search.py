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
from repro_torch.core import search_torch
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
