"""Port parity: ``repro_torch.models.moe`` against ``repro.models.moe`` and
the MoE models, engine and gateway built on it.

Weights come from ``repro``'s ``Model.init`` and are carried across by
``params_from_jax``; inputs are made with numpy from a seed.  Everything
runs in float32 on the CPU.  Tolerances:

* block and model outputs: atol = rtol = 1e-5, the reference's own
  ``tests/test_models.py::TestMoE`` tolerance (the two packages sum the
  expert products in possibly different orders);
* the aux losses: rtol = 1e-5 (means and sums of float32 values in
  another order; ``ce`` itself adds the same 1/(T k) increments);
* greedy tokens, plans and admissions: equal.

The capacity factors are the reduced configs' 8.0 (drop-free), the full
configs' 1.25 and 0.01 (nearly everything dropped).  At 1.25 a request's
tokens depend on its slot and its batch-mates (ROADMAP queue 3 B7); the
port mirrors that, so the engine cases compare the same slots and the
same batch-mates in both packages.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import Scheduler as JScheduler
from repro.core.accelerators import tpu_pod_split as jsplit
from repro.models import build as jbuild
from repro.models import moe as jmoe
from repro.serve import engine as jengine
from repro.serve import gateway as jgw
from repro_torch import configs as tconfigs
from repro_torch.core import Scheduler as TScheduler
from repro_torch.core.accelerators import tpu_pod_split as tsplit
from repro_torch.models import build as tbuild
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttransformer
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import engine as tengine
from repro_torch.serve import gateway as tgw

TOL = dict(atol=1e-5, rtol=1e-5)
AUX_TOL = dict(atol=0, rtol=1e-5)
ARCHS = ("dbrx-132b", "qwen3-moe-235b-a22b")
CAPACITY_FACTORS = (8.0, 1.25, 0.01)


def cfgs(arch, cf=8.0, **over):
    """The reduced config of ``arch`` in both packages, at capacity factor
    ``cf``."""
    out = []
    for configs in (jconfigs, tconfigs):
        cfg = configs.get(arch).reduced(**over)
        out.append(dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf)))
    return out


def pair(arch, cf=8.0, seed=0, **over):
    """(jax Model, its params, port Model with the same weights)."""
    jcfg, tcfg = cfgs(arch, cf, **over)
    jm = jbuild(jcfg)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = tbuild(tcfg, device="cpu")
    tm.load_state_dict(params_from_jax(tcfg, jax.tree.map(np.asarray,
                                                          params)))
    return jm, params, tm


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def first_moe(params):
    """Layer 0's MoE parameters of a reference param tree."""
    return jax.tree.map(lambda a: a[0], params["groups"][0])["c"]


def both_blocks(jm, params, tm, x, router=None):
    """Layer 0's MoE block of each package on ``x`` (optionally with its
    router replaced in both); returns ((y, aux) reference, (y, aux) port)."""
    p = first_moe(params)
    block = tm.layers[0].c
    if router is not None:
        p = dict(p, router=jnp.asarray(router))
        with torch.no_grad():
            block.router.copy_(torch.from_numpy(router))
    want = jmoe.moe_block(jm.cfg, p, {}, jnp.asarray(x))
    with torch.no_grad():
        got = block(torch.from_numpy(x))
    return want, got


def assert_block(want, got):
    (wy, waux), (gy, gaux) = want, got
    assert gy.dtype == torch.float32 and gy.shape == wy.shape
    np.testing.assert_allclose(np32(gy), np32(wy), **TOL)
    assert set(gaux) == set(waux) == {"moe_aux", "moe_z"}
    for name in waux:
        np.testing.assert_allclose(float(gaux[name]), float(waux[name]),
                                   **AUX_TOL)


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(2, 9), (4, 1)], ids=["prefill", "step"])
@pytest.mark.parametrize("act", ["swiglu", "squared_relu", "gelu"])
@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
@pytest.mark.parametrize("arch", ARCHS)
def test_block(arch, cf, act, shape):
    """``MoE`` against ``moe_block``: the output and both aux losses, at a
    prefill's and a 4-slot decode step's token counts."""
    jm, params, tm = pair(arch, cf, act=act)
    assert isinstance(tm.layers[0].c, tmoe.MoE)
    assert hasattr(tm.layers[0].c, "wi_gate") == (act == "swiglu")
    x = np.random.default_rng(1).standard_normal(
        (*shape, jm.cfg.d_model)).astype(np.float32)
    assert_block(*both_blocks(jm, params, tm, x))


def test_capacity_rounds_half_to_even():
    """A 4-slot decode step of reduced dbrx-132b at 1.25: 4 x 2 x 1.25 / 4
    = 2.5 slots, which the reference's Python ``round`` makes 2 (floor(x +
    .5) would give 3).  The block at that size is held to the reference's
    by ``test_block[dbrx-132b-1.25-*-step]``."""
    _, tcfg = cfgs("dbrx-132b", 1.25)
    assert tmoe.capacity(tcfg, 4) == 2 != math.floor(2.5 + 0.5)
    assert tmoe.capacity(tcfg, 1) == 1            # max(1, round(0.625))


def test_tied_probabilities_take_the_lower_expert():
    """Expert 3 first for every token and experts 0-2 tied for second:
    ``jax.lax.top_k`` takes expert 0, and so must the port."""
    jm, params, tm = pair("dbrx-132b", 8.0)
    d = jm.cfg.d_model
    x = np.random.default_rng(3).standard_normal((2, 9, d)).astype(
        np.float32)
    x[..., 0] = np.abs(x[..., 0]) + 1.0           # h[:, 0] > 0 everywhere
    router = np.zeros((d, 4), np.float32)
    router[0, 3] = 1.0
    want, got = both_blocks(jm, params, tm, x, router)
    assert_block(want, got)
    # the same block routed to expert 3 and the next tie (expert 1)
    # instead gives another output
    p = first_moe(params)
    moved = np.zeros((d, 4), np.float32)
    moved[0, 3], moved[0, 0] = 1.0, -1.0
    other, _ = jmoe.moe_block(jm.cfg, dict(p, router=jnp.asarray(moved)), {},
                              jnp.asarray(x))
    assert not np.allclose(np32(other), np32(want[0]), **TOL)


def test_stable_order_decides_the_drops():
    """Every probability tied, so every token picks experts 0 and 1; at
    1.25 each expert keeps round(18 x 2 x 1.25 / 4) = 11 of its 18
    entries.  The reference's stable argsort keeps the lowest token
    indices: tokens 0-10 get both experts' outputs, tokens 11-17 only the
    residual."""
    jm, params, tm = pair("dbrx-132b", 1.25)
    d = jm.cfg.d_model
    x = np.random.default_rng(4).standard_normal((2, 9, d)).astype(
        np.float32)
    want, got = both_blocks(jm, params, tm, x, np.zeros((d, 4), np.float32))
    assert_block(want, got)
    cap = tmoe.capacity(tm.cfg, 18)
    assert cap == 11
    y = np32(got[0]).reshape(18, d)
    moved = np.abs(y - x.reshape(18, d)).max(-1)
    assert (moved[:cap] > 1e-3).all() and (moved[cap:] == 0).all()


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_aux_and_logits(arch, cf):
    """``transformer.forward`` returns the reference's logits and its aux
    losses summed over the layers; ``Model.forward`` keeps returning the
    logits alone."""
    jm, params, tm = pair(arch, cf)
    ids = np.random.default_rng(5).integers(0, jm.cfg.vocab, (2, 10))
    want, waux = jm.forward(params, {"token_ids": jnp.asarray(ids,
                                                              jnp.int32)})
    with torch.no_grad():
        got, caches, gaux = ttransformer.forward(
            tm, {"token_ids": torch.from_numpy(ids)})
    assert caches is None
    np.testing.assert_allclose(np32(got), np32(want), **TOL)
    assert set(gaux) == set(waux) == {"moe_aux", "moe_z"}
    for name in waux:
        assert float(gaux[name]) > 0
        np.testing.assert_allclose(float(gaux[name]), float(waux[name]),
                                   **AUX_TOL)
    np.testing.assert_array_equal(
        np32(tm({"token_ids": torch.from_numpy(ids)})), np32(got))


def test_dense_forward_aux_is_zero():
    jcfg = jconfigs.get("stablelm-1.6b").reduced()
    tm = tbuild(tconfigs.get("stablelm-1.6b").reduced(), device="cpu")
    tm.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        _, _, aux = ttransformer.forward(
            tm, {"token_ids": torch.zeros((1, 4), dtype=torch.long)})
    jm = jbuild(jcfg)
    _, jaux = jm.forward(jm.init(jax.random.PRNGKey(0)),
                         {"token_ids": jnp.zeros((1, 4), jnp.int32)})
    assert aux == {"moe_aux": 0.0, "moe_z": 0.0} == jaux


@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_prefill_and_decode(cf):
    """Prefill logits and caches, then three 2-sequence decode steps, at
    the reduced configs' capacity factor and at the full configs'."""
    jm, params, tm = pair("qwen3-moe-235b-a22b", cf)
    cfg = jm.cfg
    rng = np.random.default_rng(6)
    ids = rng.integers(0, cfg.vocab, (2, 11)).astype(np.int32)
    jl, jc = jm.prefill(params, {"token_ids": jnp.asarray(ids)}, capacity=24)
    tl, tc = tm.prefill({"token_ids": torch.from_numpy(ids)}, capacity=24)
    np.testing.assert_allclose(np32(tl), np32(jl), **TOL)
    lengths = np.array([11, 11], np.int32)
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        jl, jc = jm.decode_step(params, jc, {"token_ids": jnp.asarray(tok),
                                             "lengths": jnp.asarray(lengths)})
        tl, tc = tm.decode_step(tc, {"token_ids": torch.from_numpy(tok),
                                     "lengths": torch.from_numpy(lengths)})
        np.testing.assert_allclose(np32(tl), np32(jl), **TOL)
        lengths = lengths + 1


def test_init_distributions():
    """``MoE.init``: zero norm, N(0, d^-1/2) router (float32) and input
    projections, N(0, ff^-1/2) output projections (``cfg.dtype``)."""
    cfg = tconfigs.get("dbrx-132b").reduced(d_model=256, d_ff=512)
    tm = tbuild(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    c = tm.layers[0].c
    assert isinstance(c, tmoe.MoE) and not c.ln.any()
    assert c.router.shape == (256, 4) and c.router.dtype == torch.float32
    assert c.wi.shape == c.wi_gate.shape == (4, 256, 512)
    assert c.wo.shape == (4, 512, 256)
    for w, fan_in in ((c.router, 256), (c.wi_gate, 256), (c.wi, 256),
                      (c.wo, 512)):
        assert w.std().item() == pytest.approx(fan_in ** -0.5, rel=0.05)


def test_full_width_weights_dtypes():
    """At full width the experts are bf16 and the router float32."""
    cfg = dataclasses.replace(tconfigs.get("qwen3-moe-235b-a22b"),
                              n_layers=1, vocab=512, d_model=256, d_ff=64)
    c = tbuild(cfg, device="cpu").layers[0].c
    assert c.wi.dtype == c.wi_gate.dtype == c.wo.dtype == torch.bfloat16
    assert c.router.dtype == c.ln.dtype == torch.float32
    assert c.wi.shape == (128, 256, 64)


# ---------------------------------------------------------------------------
# the engine: B7 mirrored
# ---------------------------------------------------------------------------
B7_NEW = 12


def serve_both(jm, params, tm, prompts):
    """Both packages' engines (4 slots) over ``prompts``, admitted in
    order into slots 0, 1, ...; their tokens by request id."""
    out = []
    for eng in (jengine.ServingEngine(jm, params, max_slots=4, capacity=64),
                tengine.ServingEngine(tm, max_slots=4, capacity=64)):
        for p in prompts:
            eng.submit(p, max_new=B7_NEW)
        eng.run_until_drained()
        out.append({r.rid: list(r.tokens) for r in eng.completed})
    return out


def test_b7_slot_and_batch_mates_mirrored():
    """Reduced dbrx-132b at 1.25: a prompt decoded in slot 3 beside three
    others, and the same prompt served alone in slot 0.  Its tokens differ
    between the two (capacity couples a step's tokens: B7), and the port
    gives the reference's tokens in both."""
    jm, params, tm = pair("dbrx-132b", 1.25)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jm.cfg.vocab, size=8) for _ in range(4)]
    want, got = serve_both(jm, params, tm, prompts)
    assert got == want and all(len(t) == B7_NEW for t in got.values())
    want_alone, got_alone = serve_both(jm, params, tm, prompts[3:])
    assert got_alone == want_alone
    assert want_alone[0] != want[3]                 # B7 shows


# ---------------------------------------------------------------------------
# the gateway
# ---------------------------------------------------------------------------
GW = {"stable": "stablelm-1.6b", "moe": "dbrx-132b"}


def gateway_run(side, cf):
    """One package's gateway over reduced stablelm-1.6b and reduced
    dbrx-132b (at ``cf``) on ``tpu_pod_split(2, 2)``: served, then under a
    one-slot KV budget, every step given the same observed ms."""
    configs, split, gw_mod, Scheduler, device = side
    specs = []
    for name, arch in GW.items():
        cfg = configs.get(arch).reduced()
        if cfg.moe is not None:
            cfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
        specs.append(gw_mod.TenantSpec(name, cfg, max_slots=2, capacity=32,
                                       prompt_len=5, max_new=4))
    plat = split(2, 2, name="v5e-2x2-test")
    gcfg = gw_mod.GatewayConfig(platform=plat, max_transitions=1,
                                body_groups=1)
    return gw_mod.MultiTenantGateway(specs, gcfg,
                                     scheduler=Scheduler(plat, **device),
                                     **device)


def drive(gw, seed, per_tenant):
    rng = np.random.default_rng(seed)
    for name in gw.specs:
        for _ in range(per_tenant):
            gw.submit(name, rng.integers(0, 256, size=5))
    steps = []
    while gw.has_work and gw.total_steps < 200:
        rep = gw.step(observed_ms={n: 1.0 for n in gw.specs})
        steps.append((rep.step, rep.active, rep.kv_bytes_in_use, rep.fired,
                      rep.rescheduled))
    return steps


@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_gateway_with_a_moe_tenant(cf):
    """Plans, steps, budgeted admissions and every request's tokens equal
    the reference's."""
    runs = []
    for side in ((jconfigs, jsplit, jgw, JScheduler, {}),
                 (tconfigs, tsplit, tgw, TScheduler, {"device": "cpu"})):
        gw = gateway_run(side, cf)
        if runs:
            for name, eng in runs[0]["gw"].engines.items():
                model = gw.engines[name].model
                model.load_state_dict(params_from_jax(
                    model.cfg, jax.tree.map(np.asarray, eng.params)))
        rec = {"gw": gw, "plan": gw.plan, "serve": drive(gw, 0, 3)}
        one_slot = max(s.kv_bytes_per_slot for s in gw.specs.values())
        gw.gcfg = dataclasses.replace(gw.gcfg, memory_budget_bytes=one_slot)
        rec["budget"] = drive(gw, 1, 2)
        rec["deferred"] = gw.deferred_admissions
        rec["tokens"] = {n: {r.rid: list(r.tokens) for r in e.completed}
                         for n, e in gw.engines.items()}
        runs.append(rec)
    a, b = runs
    assert a["plan"].plan.request_hash == b["plan"].plan.request_hash
    assert a["plan"].solution.assignments == b["plan"].solution.assignments
    assert a["plan"].solution.objective == b["plan"].solution.objective
    assert a["plan"].summary() == b["plan"].summary()
    assert b["serve"] == a["serve"] and b["budget"] == a["budget"]
    assert b["deferred"] == a["deferred"] > 0
    assert b["tokens"] == a["tokens"]
    assert all(len(reqs) == 5 for reqs in b["tokens"].values())


# ---------------------------------------------------------------------------
# card only
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built with nvcc "
                    "for sm_90a)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_graph_engine_matches_eager_on_the_card(cuda_device, cf):
    """Reduced dbrx-132b on the card: the captured decode step gives the
    eager engine's tokens, and each replay adds one decode launch per
    layer."""
    from repro_torch.kernels import decode_attention as tdec
    from repro_torch.kernels import graph as tgraph

    _, tcfg = cfgs("dbrx-132b", cf)
    tm = tbuild(tcfg, device=cuda_device).init(
        torch.Generator(device=cuda_device).manual_seed(0))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, tcfg.vocab, size=n) for n in (5, 9, 17, 33)]
    tokens = []
    for eager in (False, True):
        eng = tengine.ServingEngine(tm, max_slots=4, capacity=64,
                                    eager=eager)
        assert isinstance(eng.graph.graph,
                          tgraph.Eager if eager else tgraph.Graph)
        for p in prompts:
            eng.submit(p, max_new=B7_NEW)
        before = tdec.launches
        eng.run_until_drained()
        torch.cuda.synchronize()
        assert tdec.launches - before == tcfg.n_layers * eng.steps
        tokens.append({r.rid: list(r.tokens) for r in eng.completed})
    assert tokens[0] == tokens[1] and len(tokens[0]) == len(prompts)
