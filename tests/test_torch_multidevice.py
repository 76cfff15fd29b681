"""Port parity of the multi-device paths: the anneal search's ring over
``torch.distributed`` ranks, the mesh and logical-axis rules, the MoE
expert-parallel dispatch, and batches and checkpoints on a mesh.

The ranks are ``gloo`` processes on the CPU (``tests/_ranks.py``: a
``FileStore`` under ``tmp_path``, a timeout on the rendezvous, on every
collective and on the join).  ``repro``'s own multi-device runs happen in
one subprocess with four emulated host devices
(``--xla_force_host_platform_device_count``), with the ``enable_x64``
shim of ``tests/test_torch_search.py`` applied inside it.

* The search: at ``devices`` 2 and 4, from inside a process group and
  from a plain process (helper ranks), under the reference's ``KW``
  (``tests/test_search_multidevice.py:63``) in float64 on the
  reference's xavier problem and on the orin golden fixture under PCCS
  (where the ring changes the winner), the port returns ``devices=1``'s
  assignment, objective and chain, and ``repro``'s ``devices=1`` and
  ``devices=2``'s, bit for bit.
* The specs: ``spec`` and ``named_sharding`` equal ``repro``'s for the
  four rule tables on meshes (1,1), (1,2), (2,2) and (2,16,16), over every
  logical tuple ``repro``'s models use (their params' spec trees at full
  width and every literal tuple of logical names in ``repro/models``).
* The expert-parallel block: on 2 ranks (mesh (1,2)) and 4 ranks (mesh
  (2,2)) against ``repro``'s ``_moe_ep_shardmap`` on as many emulated
  devices, at capacity factors 8.0 and 1.25, within
  ``tests/test_torch_moe.py``'s atol = rtol = 1e-5; below 2048 tokens a
  shard the path is not taken, in either package, and a block holding a
  slice of the experts takes the other path over them.  A model built on
  the mesh prefills through the path and decodes, as ``repro`` does.
"""
import ast
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import _ranks
from repro import configs as jconfigs
from repro.core import Scheduler as JScheduler
from repro.models import build as jbuild
from repro.models import sharding as jsharding
from repro.train import checkpoint as jckpt
from repro_torch import configs as tconfigs
from repro_torch.core import Plan as TPlan
from repro_torch.core import Scheduler as TScheduler
from repro_torch.core import search_torch, solver_anneal
from repro_torch.core.contention import PiecewiseModel as TPiecewise
from repro_torch import ranks as tranks
from repro_torch.launch import mesh as tmesh
from repro_torch.models import moe as tmoe
from repro_torch.models import sharding as tsharding
from repro_torch.train import checkpoint as tckpt

from test_torch_core import one_thread, port_graph, port_platform  # noqa: F401
from test_torch_core import port_model
from test_torch_simulate import PCCS

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: tests/test_search_multidevice.py:63-64, in float64
KW = dict(objective="latency", seed=7, population=64, steps=24, island=8,
          exchange_every=4, precision="x64")
ORIN = "scenario4-exp8-orin-resnet101-googlenet-inception"
TOL = dict(atol=1e-5, rtol=1e-5)                 # tests/test_torch_moe.py
MOE_ARCH = "dbrx-132b"
#: (name, capacity factor, x shape, mesh (data, model)): T // data >= 2048
#: takes the expert-parallel path, "short" does not
MOE_CASES = (("ep8", 8.0, (2, 2048), (1, 2)),
             ("ep125", 1.25, (2, 2048), (1, 2)),
             ("ep05", 0.5, (2, 2048), (1, 2)),
             ("short", 8.0, (1, 1024), (1, 2)),
             ("dp2", 1.25, (4, 2048), (2, 2)))


key = _ranks.outcome_key


def xavier_tables():
    """tests/test_search_multidevice.py:55-60, in the port."""
    sched = JScheduler("xavier-agx")
    return search_torch.build_tables(
        port_platform(sched.platform),
        [port_graph(g) for g in sched.graphs(["googlenet", "resnet18"])],
        port_model(sched.model), 2)


def orin_tables():
    req = TPlan.load(ROOT / "tests" / "fixtures" / "plans"
                     / f"{ORIN}.json").request
    return search_torch.build_tables(
        req.platform, list(req.graphs), TPiecewise(*PCCS),
        req.max_transitions, iterations=list(req.iterations),
        depends_on=list(req.depends_on))


@pytest.fixture(scope="module")
def problems():
    return [(xavier_tables(), KW), (orin_tables(), KW)]


@pytest.fixture(scope="module")
def one_device(problems):
    torch.set_num_threads(1)
    return [key(search_torch.anneal_search(t, devices=1, device="cpu", **kw))
            for t, kw in problems]


# ---------------------------------------------------------------------------
# repro on emulated devices, in a subprocess
# ---------------------------------------------------------------------------

_REFERENCE = r"""
import dataclasses, json, pathlib, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro import configs
from repro.core import Plan, Scheduler, search_jax, simulate_jax
from repro.core.contention import PiecewiseModel
from repro.models import build, moe
for m in (simulate_jax, search_jax):       # the enable_x64 shim
    m.HAVE_JAX = True
    m.enable_x64 = jax.enable_x64
out, root = pathlib.Path(sys.argv[1]), pathlib.Path(sys.argv[2])
args = json.loads(sys.argv[3])
kw, pccs, cases = args["kw"], args["pccs"], args["cases"]
res = {"device_count": jax.device_count()}

def key(o):
    return [[list(a) for a in o.assignment], o.objective, o.chain]

sched = Scheduler("xavier-agx")
xav = search_jax.build_tables(
    sched.platform, sched.graphs(["googlenet", "resnet18"]), sched.model, 2)
req = Plan.load(root / "tests/fixtures/plans" / (args["orin"] + ".json")
                ).request
orin = search_jax.build_tables(
    req.platform, list(req.graphs), PiecewiseModel(*pccs),
    req.max_transitions, iterations=list(req.iterations),
    depends_on=list(req.depends_on))
res["search"] = {
    "xavier": {d: key(search_jax.anneal_search(xav, devices=d, **kw))
               for d in (1, 2)},
    "orin": {1: key(search_jax.anneal_search(orin, devices=1, **kw))}}

cfg0 = configs.get(args["arch"]).reduced()
params = build(cfg0).init(jax.random.PRNGKey(0))
p = jax.tree.map(lambda a: a[0], params["groups"][0])["c"]
calls = []
shardmap = moe._moe_ep_shardmap
def counted(*a, **k):
    calls.append(1)
    return shardmap(*a, **k)
moe._moe_ep_shardmap = counted
for name, cf, shape, sizes in cases:
    cfg = dataclasses.replace(cfg0, moe=dataclasses.replace(
        cfg0.moe, capacity_factor=cf))
    x = np.random.default_rng(len(name)).standard_normal(
        (*shape, cfg.d_model)).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:sizes[0] * sizes[1]]).reshape(
        sizes), ("data", "model"))
    before = len(calls)
    with mesh:
        y, aux = jax.jit(lambda p, x: moe.moe_block(cfg, p, cfg.rules, x))(
            p, jnp.asarray(x))
    np.savez(out / f"{name}.npz", x=x, y=np.asarray(y),
             ep=len(calls) - before,
             **{k: np.asarray(v, np.float32) for k, v in aux.items()},
             **{k: np.asarray(v, np.float32) for k, v in p.items()})

# a model of EP_MIN_TOKENS tokens a data shard: its prefill and a decode
# step on one device (at capacity factor 8.0 nothing drops, so the
# expert-parallel path computes the same)
from repro_torch import configs as tconfigs
from repro_torch.models.convert import params_from_jax
cfg = dataclasses.replace(cfg0, moe=dataclasses.replace(
    cfg0.moe, capacity_factor=8.0))
model = build(cfg)
params = model.init(jax.random.PRNGKey(0))
state = params_from_jax(dataclasses.replace(
    tconfigs.get(args["arch"]).reduced(), moe=dataclasses.replace(
        tconfigs.get(args["arch"]).reduced().moe, capacity_factor=8.0)),
    params)
for rows in (1, 2):
    ids = np.random.default_rng(rows).integers(
        0, cfg.vocab, (rows, 2048)).astype(np.int32)
    logits, caches = jax.jit(lambda p, b: model.prefill(
        p, b, capacity=2049))(params, {"token_ids": ids})
    step, _ = jax.jit(model.decode_step)(
        params, caches, {"token_ids": ids[:, :1],
                         "lengths": np.full((rows,), 2048, np.int32)})
    np.savez(out / f"decode{rows}.npz", ids=ids, prefill=np.asarray(logits),
             decode=np.asarray(step),
             **{f"state.{k}": v.numpy() for k, v in state.items()})
(out / "reference.json").write_text(json.dumps(res))
"""


class _Reference:
    """``repro``'s run in a subprocess, started with the module so that it
    runs beside the tests that do not read it; :meth:`result` waits."""

    def __init__(self, out):
        self.out, self._result = out, None
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   PYTHONPATH=os.pathsep.join(
                       [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
        args = dict(kw=dict(KW, precision="x64"), pccs=PCCS, orin=ORIN,
                    arch=MOE_ARCH, cases=MOE_CASES)
        self.log = open(out / "reference.log", "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _REFERENCE, str(out), str(ROOT),
             json.dumps(args)], env=env, stdout=self.log,
            stderr=subprocess.STDOUT)

    def result(self) -> dict:
        if self._result is None:
            rc = self.proc.wait(timeout=300)
            assert rc == 0, (self.out / "reference.log").read_text()[-4000:]
            res = json.loads((self.out / "reference.json").read_text())
            assert res["device_count"] == 4

            def tup(k):
                return (tuple(tuple(a) for a in k[0]), k[1], k[2])
            res["search"] = {p: {int(d): tup(k) for d, k in v.items()}
                             for p, v in res["search"].items()}
            res["dir"] = self.out
            self._result = res
        return self._result

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self.log.close()


@pytest.fixture(scope="module", autouse=True)
def reference_run(tmp_path_factory):
    run = _Reference(tmp_path_factory.mktemp("reference"))
    yield run
    run.close()


@pytest.fixture(scope="module")
def reference(reference_run):
    """``repro`` at devices 1 and 2 (the search) and its MoE block on
    meshes of 2 and 4 emulated host devices."""
    return reference_run.result()


def moe_cases(reference, sizes):
    return [(cf, str(reference["dir"] / f"{name}.npz"))
            for name, cf, _, s in MOE_CASES if s == sizes]


def moe_names(sizes):
    return [name for name, _, _, s in MOE_CASES if s == sizes]


def run_world(world, problems, reference_run, store, data=None):
    """Everything a group of ``world`` ranks computes, by rank: the search
    (and ``data``) started first, beside ``repro``'s run, then the
    expert-parallel block once the reference's inputs exist."""
    sizes = (1, 2) if world == 2 else (2, 2)
    group = _ranks.start(_ranks.group_ranks, world, store / "g", problems,
                         data)
    try:
        moe = _ranks.spawn(_ranks.moe_ranks, world, store / "m", MOE_ARCH,
                           sizes, moe_cases(reference_run.result(), sizes))
    except BaseException:
        _ranks.stop(group)
        raise
    got = _ranks.collect(group)
    return dict(search=[r["search"] for r in got],
                data=[r.get("data") for r in got], moe=moe)


@pytest.fixture(scope="module")
def world2(problems, reference_run, tmp_path_factory):
    """Everything the 2-rank group computes, by rank."""
    rules = dict(tconfigs.get(MOE_ARCH).rules)
    batch = {"token_ids": np.arange(4 * 6, dtype=np.int32).reshape(4, 6),
             "embeds": np.arange(4 * 6 * 3, dtype=np.float32).reshape(
                 4, 6, 3)}
    ckpts = [checkpoints(tmp_path_factory.mktemp(pkg), pkg)
             for pkg in ("torch", "jax")]
    out = run_world(2, problems, reference_run,
                    tmp_path_factory.mktemp("store2"),
                    (rules, batch, [c[:3] for c in ckpts]))
    return dict(out, batch=batch, ckpts=ckpts)


@pytest.fixture(scope="module")
def world4(problems, reference_run, tmp_path_factory):
    return run_world(4, problems, reference_run,
                     tmp_path_factory.mktemp("store4"))


@pytest.fixture(scope="module")
def worlds(world2, world4):
    return {2: world2, 4: world4}


class TestKnobs:
    @pytest.fixture(scope="class")
    def tables(self):
        return xavier_tables()

    @pytest.mark.parametrize("kw,match", [
        (dict(devices=0), r"devices \(0\) must be >= 1"),
        (dict(devices=2), "exceeds the 1 visible cpu device"),
        (dict(devices=2), "share_devices"),
        (dict(devices=1, fanout="shard_map"), "fanout='ranks'"),
        (dict(devices=1, fanout="pmap"), "fanout='ranks'"),
        (dict(fanout="nope"), "one of auto, ranks"),
        (dict(migrate="ring"), "migrate='island'"),
    ])
    def test_rejections(self, tables, kw, match, monkeypatch):
        monkeypatch.delenv(tranks.SHARE_ENV, raising=False)
        with pytest.raises(ValueError, match=match):
            search_torch.anneal_search(tables, device="cpu", **kw)

    def test_population_quantum_is_island_times_devices(self, tables,
                                                        monkeypatch):
        monkeypatch.setenv(tranks.SHARE_ENV, "3")
        with pytest.raises(ValueError,
                           match=r"island\*devices \(24\); nearest legal "
                                 r"value: population=72"):
            search_torch.anneal_search(tables, devices=3, population=64,
                                       island=8, device="cpu")

    def test_share_devices_is_the_opt_in(self, monkeypatch):
        monkeypatch.delenv(tranks.SHARE_ENV, raising=False)
        assert tranks.rank_capacity("cpu") == 1
        env = {}
        assert tranks.share_devices(4, env=env) == 4
        assert env == {tranks.SHARE_ENV: "4"}
        monkeypatch.setenv(tranks.SHARE_ENV, "4")
        assert tranks.rank_capacity("cpu") == 4
        with pytest.raises(ValueError, match=">= 1"):
            tranks.share_devices(0, env=env)

    def test_devices_1_resolves_the_ring(self, tables):
        out = search_torch.anneal_search(tables, devices=1, device="cpu",
                                         population=16, steps=2, island=8)
        assert (out.devices, out.migrate, out.fanout) == (1, "ring",
                                                          "ranks")
        legacy = search_torch.anneal_search(tables, device="cpu",
                                            population=16, steps=2, island=8)
        assert (legacy.devices, legacy.migrate, legacy.fanout) == (
            None, "island", None)


# ---------------------------------------------------------------------------
# meshes and backends
# ---------------------------------------------------------------------------

def test_meshes_keep_the_reference_shapes():
    assert tmesh.make_production_mesh().shape == {"data": 16, "model": 16}
    assert tmesh.make_production_mesh(multi_pod=True).shape == {
        "pod": 2, "data": 16, "model": 16}
    host = tmesh.make_host_mesh()
    assert host.shape == {"data": 1, "model": 1} and host.size == 1
    assert host.device_mesh is None and host.coordinate("model") == 0


def test_backend_is_chosen_explicitly(monkeypatch):
    assert tranks.choose_backend(2, "cpu") == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tranks.choose_backend(4, "cuda") == "nccl"
    assert tranks.choose_backend(8, "cuda") == "gloo"      # ranks share
    assert tranks.choose_backend(2, "cpu") == "gloo"


def test_the_new_modules_are_the_ports():
    """tests/test_torch_package.py walks both (no jax, no repro)."""
    import test_torch_package
    assert {"repro_torch.launch.mesh", "repro_torch.models.sharding",
            "repro_torch.ranks"} <= \
        set(test_torch_package.MODULES)


# ---------------------------------------------------------------------------
# the sharding rules
# ---------------------------------------------------------------------------

RULE_TABLES = ("RULES_TP", "RULES_FSDP_TP", "RULES_TP_2D", "RULES_ZERO3")
MESHES = {(1, 1): ("data", "model"), (1, 2): ("data", "model"),
          (2, 2): ("data", "model"), (2, 16, 16): ("pod", "data", "model")}


def _literal_logicals():
    """Every literal tuple of logical axis names in repro's models."""
    names = set(jconfigs.RULES_TP) | set(jconfigs.RULES_ZERO3)
    out = set()
    for path in (ROOT / "src" / "repro" / "models").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if not isinstance(node, ast.Tuple) or not node.elts:
                continue
            vals = [e.value for e in node.elts
                    if isinstance(e, ast.Constant)]
            if (len(vals) == len(node.elts)
                    and all(v is None or v in names for v in vals)
                    and any(v is not None for v in vals)):
                out.add(tuple(vals))
    return out


@pytest.fixture(scope="module")
def model_specs():
    """(logical tuple, shape) of every param of every full config, and
    every literal logical tuple (no shape)."""
    pairs = set()
    for arch in jconfigs.ARCHS:
        m = jbuild(jconfigs.get(arch))
        specs, shapes = m.specs(), m.abstract_params()
        flat_s, tree = jax.tree.flatten(specs, is_leaf=jsharding._is_logical)
        for lg, x in zip(flat_s, tree.flatten_up_to(shapes)):
            pairs.add((lg, tuple(x.shape)))
    literal = _literal_logicals()
    assert ("batch", "seq", "embed") in literal and len(literal) > 10
    return sorted(pairs, key=str), sorted(literal, key=str)


@pytest.mark.parametrize("sizes", list(MESHES), ids=str)
@pytest.mark.parametrize("table", RULE_TABLES)
def test_spec_and_named_sharding_equal_the_reference(table, sizes,
                                                     model_specs):
    rules = getattr(jconfigs, table)
    assert rules == getattr(tconfigs, table)
    names = MESHES[sizes]
    jm, tm = AbstractMesh(sizes, names), tmesh.Mesh(names, sizes)
    params, literal = model_specs
    for lg in literal + [lg for lg, _ in params]:
        assert tuple(tsharding.spec(rules, lg, tm)) == tuple(
            jsharding.spec(rules, lg, jm)), lg
        assert tuple(tsharding.named_sharding(tm, rules, lg).spec) == tuple(
            jsharding.named_sharding(jm, rules, lg).spec), lg
    for lg, shape in params:
        assert tuple(tsharding.named_sharding(tm, rules, lg, shape).spec) \
            == tuple(jsharding.named_sharding(jm, rules, lg, shape).spec), \
            (lg, shape)


@pytest.mark.parametrize("arch", ["qwen1.5-32b", "dbrx-132b"])
def test_tree_shardings_equal_the_reference(arch):
    """The divisibility fallback over a whole param tree on the 512-chip
    mesh (under dbrx's rules its 8 KV heads cannot split 16 ways; qwen1.5
    runs RULES_ZERO3, which splits no head axis)."""
    jm_ = jbuild(jconfigs.get(arch))
    specs, shapes = jm_.specs(), jm_.abstract_params()
    sizes, names = (2, 16, 16), ("pod", "data", "model")
    rules = jm_.rules
    want = jax.tree.leaves(jsharding.tree_shardings(
        AbstractMesh(sizes, names), rules, specs, shapes))
    got = tsharding.tree_shardings(tmesh.Mesh(names, sizes), rules, specs,
                                   shapes)
    got = jax.tree.leaves(got, is_leaf=lambda x: isinstance(
        x, tsharding.NamedSharding))
    assert [tuple(g.spec) for g in got] == [tuple(w.spec) for w in want]
    unfit = jax.tree.leaves(tsharding.tree_shardings(
        tmesh.Mesh(names, sizes), rules, specs), is_leaf=lambda x:
        isinstance(x, tsharding.NamedSharding))
    dropped = sum(tuple(g.spec) != tuple(u.spec) for g, u in zip(got, unfit))
    assert (dropped > 0) == (arch == "dbrx-132b")


def test_the_integration_cases():
    """tests/test_integration.py:70-101, on the port."""
    m = tmesh.make_host_mesh()
    rules = {"batch": ("pod", "data"), "embed": "data", "seq": None}
    assert tsharding.spec(rules, ("batch", "seq", "embed"), m) == \
        tsharding.P("data")
    assert tsharding.spec({"batch": ("pod", "data")}, ("batch",), m) == \
        tsharding.P("data")
    ns = tsharding.named_sharding(m, {"heads": "model"}, ("heads", None),
                                  shape=(40, 128))
    assert isinstance(ns.spec, tsharding.PartitionSpec)
    for name in ("heads", "mlp", "vocab", "kv_heads"):
        assert tsharding.spec(tconfigs.RULES_ZERO3, (name,), m) == \
            tsharding.P()


def test_placements_and_the_current_mesh():
    from torch.distributed.tensor import Replicate, Shard
    m = tmesh.Mesh(("pod", "data", "model"), (2, 16, 16))
    rules = tconfigs.RULES_ZERO3
    s = tsharding.named_sharding(m, rules, ("batch", "seq", "embed"))
    assert tuple(s.spec) == (("pod", "data", "model"),)
    assert s.placements == (Shard(0), Shard(0), Shard(0))
    s = tsharding.named_sharding(m, tconfigs.RULES_TP, ("embed", "mlp"))
    assert s.placements == (Replicate(), Replicate(), Shard(1))
    assert tsharding.resolved_size(rules, "batch") == 1      # off-mesh
    x = torch.ones(3)
    with m:
        assert tsharding._current_mesh() is m
        assert tsharding.resolved_size(rules, "batch") == 512
        assert tsharding.resolved_size(tconfigs.RULES_TP, "experts") == 16
        # plain tensors pass through, as the reference's off a mesh
        assert tsharding.constrain(x, rules, ("embed",)) is x
        assert tsharding.weight_use(x, rules, ("embed",)) is x
    assert tsharding._current_mesh() is None


# ---------------------------------------------------------------------------
# the ring search
# ---------------------------------------------------------------------------

class TestRingSearch:
    @pytest.mark.parametrize("world", [2, 4])
    def test_in_a_group_every_rank_equals_one_device(self, worlds, world,
                                                     one_device, reference):
        for res in worlds[world]["search"]:
            assert res["keys"] == one_device
            assert res["resolved"] == [(world, "ring", "ranks")] * 2
        assert one_device[0] == reference["search"]["xavier"][2]

    @pytest.mark.parametrize("world", [2, 4])
    def test_in_a_group_devices_must_be_the_world_size(self, worlds, world):
        for res in worlds[world]["search"]:
            assert (f"devices ({2 * world}) is not the world size ({world})"
                    in res["wrong_devices"])
            assert f"nearest legal value: devices={world}" in \
                res["wrong_devices"]

    @pytest.mark.parametrize("world", [2, 4])
    def test_a_failed_rank_fails_every_rank(self, worlds, world,
                                            one_device):
        for res in worlds[world]["search"]:
            assert "failed on rank(s)" in res["failure"]
            assert "1: Traceback" in res["failure"]
            assert "injected fault on rank 1" in res["failure"]
            assert res["after_failure"] == one_device[0]

    def test_one_device_equals_reference(self, one_device, reference):
        assert one_device[0] == reference["search"]["xavier"][1]
        assert one_device[1] == reference["search"]["orin"][1]

    def test_reference_devices_2_equals_its_devices_1(self, reference):
        """repro's own contract, on two emulated host devices."""
        got = reference["search"]["xavier"]
        assert got[2] == got[1]

    def test_ring_changes_the_orin_winner(self, problems, one_device):
        """The orin case is one where the ring matters: island migration
        ends elsewhere, so a seam that went astray would show."""
        tables, kw = problems[1]
        island = search_torch.anneal_search(tables, device="cpu", **kw)
        assert key(island) != one_device[1]
        assert one_device[1][2] != 0


@pytest.fixture
def pool(monkeypatch):
    """Helper ranks for this process; the pool is closed afterwards."""
    monkeypatch.setenv(tranks.SHARE_ENV, "4")
    yield
    tranks.close_pool()
    assert tranks._POOL is None and not torch.distributed.is_initialized()


class TestFromAPlainProcess:
    @pytest.mark.parametrize("devices", [2, 4])
    def test_helper_ranks_equal_one_device(self, pool, problems, one_device,
                                           devices, reference):
        for (tables, kw), want in zip(problems, one_device):
            out = search_torch.anneal_search(tables, devices=devices,
                                             device="cpu", **kw)
            assert key(out) == want
            assert (out.devices, out.migrate, out.fanout) == (devices,
                                                              "ring",
                                                              "ranks")
        assert one_device[0] == reference["search"]["xavier"][2]

    def test_island_migration_sends_no_seam(self, pool, problems):
        """With migrate="island" nothing crosses ranks (the reference
        skips its ppermute): 2 ranks equal one rank's island search."""
        tables, kw = problems[1]
        got = {d: search_torch.anneal_search(tables, devices=d,
                                             migrate="island",
                                             device="cpu", **kw)
               for d in (1, 2)}
        assert key(got[2]) == key(got[1])
        assert got[2].migrate == "island"

    def test_helper_ranks_start_once(self, pool, problems):
        tables, kw = problems[0]
        search_torch.anneal_search(tables, devices=2, device="cpu", **kw)
        first = tranks._POOL
        search_torch.anneal_search(tables, devices=2, device="cpu", **kw)
        assert tranks._POOL is first and first.backend == "gloo"
        assert all(p.poll() is None for p in first.procs)

    def test_scheduler_solve_on_two_ranks(self, pool):
        """solver_anneal passes devices through (the island x devices
        quantum, and devices/migrate/fanout in the plan's params)."""
        sched = JScheduler("xavier-agx")
        graphs = [port_graph(g) for g in sched.graphs(["googlenet",
                                                        "resnet18"])]
        ts = TScheduler(port_platform(sched.platform),
                        model=port_model(sched.model), device="cpu")
        plans = {d: ts.solve(graphs, "latency", solver="anneal",
                             max_transitions=2, devices=d, steps=8,
                             population=64, island=8, precision="x64")
                 for d in (1, 2)}
        assert plans[1].assignments == plans[2].assignments
        p = plans[2].solver_params
        assert (p["devices"], p["migrate"], p["fanout"]) == (2, "ring",
                                                             "ranks")
        assert solver_anneal.auto_tune(
            search_torch.build_tables(ts.platform, graphs, ts.model, 2),
            budget_ms=1.0, steps=4, island=8, devices=2).population % 16 == 0

    def test_compile_seconds_accepts_devices(self, pool, problems):
        tables, _ = problems[0]
        assert search_torch.compile_seconds(
            tables, population=64, island=8, devices=2, device="cpu") > 0


# ---------------------------------------------------------------------------
# the expert-parallel MoE block
# ---------------------------------------------------------------------------

def _moe_check(reference, results, sizes):
    """Every rank's blocks against the reference's on the same mesh: the
    block holding every expert and the block holding a slice, on every
    case; below the expert-parallel path's conditions the sliced block
    takes the reference's other path over its experts, the ranks' combines
    summed."""
    E = _ranks.moe_config(MOE_ARCH, 8.0).moe.n_experts
    for rank_res in results:
        for (name, case) in zip(moe_names(sizes), rank_res["cases"]):
            with np.load(reference["dir"] / f"{name}.npz") as z:
                ep = int(z["ep"])
                for which in ("whole", "sliced"):
                    got = case[which]
                    np.testing.assert_allclose(got["y"], z["y"], **TOL,
                                               err_msg=f"{name} {which}")
                    for k, v in got["aux"].items():
                        np.testing.assert_allclose(v, z[k], atol=0,
                                                   rtol=1e-5)
                    assert got["ep_calls"] == ep, (name, which)
                assert case["whole"]["held"] == E


@pytest.mark.parametrize("world", [2, 4])
def test_expert_parallel_block_equals_the_reference(worlds, world,
                                                    reference):
    sizes = (1, 2) if world == 2 else (2, 2)
    _moe_check(reference, worlds[world]["moe"], sizes)
    # E = 4 experts over the 2 ranks of the model axis: 2 each
    for r, rank_res in enumerate(worlds[world]["moe"]):
        assert {(c["sliced"]["held"], c["sliced"]["first"])
                for c in rank_res["cases"] if "y" in c["sliced"]} == {
            (2, 2 * (r % 2))}


@pytest.mark.parametrize("world", [2, 4])
def test_a_model_on_a_mesh_prefills_and_decodes(worlds, world, reference):
    """A model built on a mesh (under its training rules: on (2, 2) the
    weights are stored split on "embed" and gathered at use) holds a
    slice of each block's experts: its prefill of 2048 tokens a data
    shard takes the expert-parallel path in every MoE layer, and its
    decode step runs on the mesh; both give ``repro``'s logits."""
    n_moe = len(_ranks.moe_config(MOE_ARCH, 8.0).layer_kinds)
    rows = 1 if world == 2 else 2
    with np.load(reference["dir"] / f"decode{rows}.npz") as z:
        want = (z["prefill"], z["decode"])
    for rank_res in worlds[world]["moe"]:
        got = rank_res["decode"]
        assert got["ep_calls"] == n_moe
        for g, w in zip((got["prefill"], got["decode"]), want):
            np.testing.assert_allclose(g, w, **TOL)


def test_a_mesh_description_stays_on_one_device(reference):
    """Under a mesh with no ranks (a description, such as
    ``make_production_mesh``'s) a block meets the path's token
    conditions but has no ranks to run it on: it takes the one-device
    path."""
    mesh = tmesh.Mesh(("data", "model"), (1, 2))
    block = tmoe.MoE(_ranks.moe_config(MOE_ARCH, 8.0), "cpu")
    with np.load(reference["dir"] / "ep8.npz") as z:
        block.load_state_dict(_ranks.moe_state(z))
        with mesh, torch.no_grad():
            y, _ = block(torch.from_numpy(z["x"]))
        assert int(z["ep"]) == 1
        np.testing.assert_allclose(y.numpy(), z["y"], **TOL)
    assert block.ep_calls == 0


def test_the_path_is_taken_only_at_2048_tokens_a_shard(reference):
    taken = {}
    for name, *_ in MOE_CASES:
        with np.load(reference["dir"] / f"{name}.npz") as z:
            taken[name] = int(z["ep"])
    assert taken == {"ep8": 1, "ep125": 1, "ep05": 1, "short": 0, "dp2": 1}
    assert tmoe.EP_MIN_TOKENS == 2048


def test_shard_experts_cuts_only_the_expert_weights():
    """A model's state dict: each rank keeps its E/tp rows of every
    expert weight and all of everything else (the attention's ``t.wo``
    included)."""
    from repro_torch.models.convert import shard_experts

    class Ranks:                      # rank 1 of the model axis
        def get_coordinate(self):
            return [0, 1]
    cfg = tconfigs.get(MOE_ARCH).reduced()
    m = tmesh.Mesh(("data", "model"), (1, 2), Ranks())
    E = cfg.moe.n_experts
    state = {"layers.0.c.wi": torch.arange(E * 3.).reshape(E, 3),
             "layers.0.c.wo": torch.arange(E * 3.).reshape(E, 3),
             "layers.0.c.router": torch.ones(3, E),
             "layers.0.t.wo": torch.ones(E, 3), "emb.table": torch.ones(2)}
    got = shard_experts(cfg, state, cfg.rules, m)
    for name in ("layers.0.c.wi", "layers.0.c.wo"):
        assert torch.equal(got[name], state[name][E // 2:])
    for name in ("layers.0.c.router", "layers.0.t.wo", "emb.table"):
        assert got[name] is state[name]
    assert tmoe.expert_slice(cfg, cfg.rules, m) == (E // 2, E // 2)
    assert tmoe.expert_slice(cfg, cfg.rules, tmesh.make_host_mesh()) == (
        0, E)


def _one_device(path, cf):
    """The one-device block on the npz's weights and ``x``, and the
    reference's output there."""
    block = tmoe.MoE(_ranks.moe_config(MOE_ARCH, cf), "cpu")
    with np.load(path) as z:
        block.load_state_dict(_ranks.moe_state(z))
        with torch.no_grad():
            y, _ = block(torch.from_numpy(z["x"]))
        return y.numpy(), z["y"]


def test_one_device_agrees_where_nothing_drops(reference, worlds):
    """Where nothing drops (capacity factor 8.0, and 1.25 under this
    router) the expert-parallel output is the one-device block's; at 0.5
    each chunk's capacity drops other tokens than the whole block's does,
    which is why the expert-parallel path is held to the reference's
    expert-parallel output and not to the one-device block."""
    d = reference["dir"]
    y, want = _one_device(d / "ep8.npz", 8.0)
    np.testing.assert_allclose(y, want, **TOL)
    y, want = _one_device(d / "short.npz", 8.0)
    np.testing.assert_allclose(y, want, **TOL)
    # below 2048 tokens a block on the mesh that holds every expert takes
    # the one-device path; one that holds 2 of the 4 takes it over its
    # experts, the ranks' combines summed, with the same numbers
    short = worlds[2]["moe"][0]["cases"][moe_names((1, 2)).index("short")]
    assert short["whole"]["ep_calls"] == 0
    np.testing.assert_allclose(short["whole"]["y"], y, **TOL)
    assert short["sliced"]["held"] == 2 and short["sliced"]["ep_calls"] == 0
    np.testing.assert_allclose(short["sliced"]["y"], y, **TOL)
    y, want = _one_device(d / "ep125.npz", 1.25)
    np.testing.assert_allclose(y, want, **TOL)
    y, want = _one_device(d / "ep05.npz", 0.5)
    assert np.abs(y - want).max() > 1e-3


# ---------------------------------------------------------------------------
# batches and checkpoints on a mesh
# ---------------------------------------------------------------------------

def test_device_put_batch(world2):
    from torch.distributed.tensor import Replicate, Shard
    shard0, rep = str(Shard(0)), str(Replicate())
    batch = world2["batch"]
    for r, res in enumerate(world2["data"]):
        for sizes, placed in res["batch"].items():
            for k, (local, placements, whole) in placed.items():
                np.testing.assert_array_equal(whole, batch[k])
                # "batch" -> ("pod", "data"): dim 0 over the data axis
                assert placements == (shard0, rep)
                if sizes == (2, 1):
                    np.testing.assert_array_equal(local,
                                                  batch[k][2 * r:2 * r + 2])
                else:                 # the data axis has one rank
                    np.testing.assert_array_equal(local, batch[k])


def checkpoints(tmp, pkg):
    """A checkpoint at step 5 written by ``pkg``, the ``like`` tree to
    restore it into, its logical axes, and the arrays."""
    rng = np.random.default_rng(3)
    arrays = {"wi": rng.standard_normal((4, 6, 8)).astype(np.float32),
              "emb": rng.standard_normal((10, 6)).astype(np.float32)}
    if pkg == "torch":
        tckpt.save(tmp, 5, {k: torch.from_numpy(v) for k, v in
                            arrays.items()})
    else:
        jckpt.save(tmp, 5, {k: jnp.asarray(v) for k, v in arrays.items()})
    like = {k: torch.zeros(v.shape) for k, v in arrays.items()}
    logical = {"wi": ("experts", "embed", "expert_mlp"),
               "emb": ("vocab", "embed")}
    return str(tmp), like, logical, arrays


def test_restore_onto_a_mesh(world2):
    """dbrx's rules (RULES_FSDP_TP) on (data=1, model=2): the experts and
    the vocab split over the model axis, bit for bit, from a checkpoint
    of either package."""
    for r, res in enumerate(world2["data"]):
        for (_, _, _, arrays), got in zip(world2["ckpts"], res["ckpt"]):
            assert got["step"] == 5
            for k, (local, whole) in got["local"].items():
                np.testing.assert_array_equal(whole, arrays[k])
                half = arrays[k].shape[0] // 2
                np.testing.assert_array_equal(
                    local, arrays[k][r * half:(r + 1) * half])


# ---------------------------------------------------------------------------
# the launchers' --devices
# ---------------------------------------------------------------------------

@pytest.fixture
def small_search(monkeypatch):
    """The anneal solver's defaults cut to a CPU test's size."""
    monkeypatch.setattr(solver_anneal, "DEFAULT_POPULATION", 64)
    monkeypatch.setattr(solver_anneal, "DEFAULT_STEPS", 8)
    monkeypatch.setattr(solver_anneal, "PROBE_STEPS", 1)


def test_serve_devices_2_plans_what_devices_1_plans(pool, small_search,
                                                     tmp_path):
    from repro_torch.launch import serve as tserve
    plans = {}
    for n in (1, 2):
        path = tmp_path / f"plan{n}.json"
        assert tserve.main([
            "--gateway", "--arch", "stablelm-1.6b", "--co-arch",
            "llama3.2-3b", "--reduced", "--device", "cpu", "--solver",
            "anneal", "--devices", str(n), "--plan-only", "--save-plan",
            str(path)]) == 0
        plans[n] = TPlan.load(path)
    assert plans[1].assignments == plans[2].assignments
    p = plans[2].solver_params
    assert (p["devices"], p["migrate"], p["fanout"]) == (2, "ring", "ranks")
    assert tranks._POOL.world == 2 and os.environ[tranks.SHARE_ENV] == "2"


def test_profile_devices_2(pool, small_search, tmp_path, capsys):
    from repro_torch.launch import profile as tprofile
    out = tmp_path / "virtual.json"
    assert tprofile.main(["--executor", "virtual", "--device", "cpu",
                          "--solve", "--solver", "anneal", "--devices", "2",
                          "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "anneal-search throughput" in text
    from repro_torch.profiling import ProfileBundle
    assert ProfileBundle.load(out).provenance["search_devices"] == 2
    assert tranks._POOL.world == 2
