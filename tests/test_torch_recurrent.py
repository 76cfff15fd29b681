"""Port parity: the recurrent families of repro_torch (RG-LRU and RWKV-6
layers, models and serving) against repro.

The blocks, the reduced models (prefill, decode) and the serving engines
run in both packages on the same weights and inputs, made with numpy from
a seed, in float32 on the CPU, at atol = rtol = 1e-4 (the tolerance of
``tests/test_torch_models.py``); the engines' greedy tokens must be
identical.  The scans themselves are in ``tests/test_torch_scans.py``.

``init_rglru`` and ``init_rwkv`` leave ``conv_w``, ``conv_b``, ``u`` and
``w_lora_b`` at zero, which makes every RG-LRU layer pass its input
through and RWKV-6's decay one constant: a check on such weights would
pass with a scan that returned zeros.  So the numpy parameter tree gets
seeded non-zero values there before both packages use it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build as jbuild
from repro.models import recurrent as jrec
from repro.serve import engine as jengine
from repro_torch import configs as tconfigs
from repro_torch.models import build as tbuild
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import engine as tengine

MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ("recurrentgemma-9b", "rwkv6-7b")
#: parameters init leaves at zero -> their dimensions per layer; each gets
#: seeded values drawn as the reference's dense_init draws a tensor of
#: that shape, N(0, 1 / fan_in) with fan_in its first axis
PERTURBED = {"conv_w": 2, "conv_b": 1, "u": 2, "w_lora_b": 2}


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------------------
# blocks, models, engines (reduced configs, float32)
# ---------------------------------------------------------------------------
def perturb(tree, rng):
    """The numpy param tree with PERTURBED leaves redrawn from ``rng``
    (a stacked leaf's first axis is its group: fan_in is counted from the
    layer's own dimensions)."""
    if isinstance(tree, dict):
        return {k: ((rng.standard_normal(np.shape(v))
                     * np.shape(v)[-PERTURBED[k]] ** -0.5).astype(np.float32)
                    if k in PERTURBED else perturb(v, rng))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(perturb(v, rng) for v in tree)
    return tree


def pair(arch, **over):
    """(jax Model, its perturbed params as jax arrays, the numpy tree, port
    Model carrying the same weights)."""
    jcfg = jconfigs.get(arch).reduced(**over)
    tcfg = tconfigs.get(arch).reduced(**over)
    jm = jbuild(jcfg)
    tree = perturb(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))),
                   np.random.default_rng(7))
    tm = tbuild(tcfg, device="cpu")
    tm.load_state_dict(params_from_jax(tcfg, tree))
    return jm, jax.tree.map(jnp.asarray, tree), tree, tm


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    return request.param, pair(request.param)


def first_layer(params):
    return jax.tree.map(lambda a: a[0], params["groups"][0])


def random_state(kind, cfg, B, rng):
    if kind == "rglru":
        return {"h": rng.standard_normal((B, cfg.d_rnn)).astype(np.float32),
                "conv": rng.standard_normal((B, 3, cfg.d_rnn))
                .astype(np.float32)}
    H = cfg.n_heads or cfg.d_model // 64
    dh = cfg.d_model // H
    return {"S": (rng.standard_normal((B, H, dh, dh)) * 0.1)
            .astype(np.float32),
            "x_t": rng.standard_normal((B, cfg.d_model)).astype(np.float32),
            "x_c": rng.standard_normal((B, cfg.d_model)).astype(np.float32)}


@pytest.mark.parametrize("with_state", [False, True])
def test_block(models, with_state):
    """``RGLRU`` / ``RWKV`` against ``rglru_block`` / ``rwkv_block``:
    output and every entry of the new state."""
    arch, (jm, params, _, tm) = models
    cfg = jm.cfg
    kind = cfg.block_pattern[0]
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    state = random_state(kind, cfg, 2, rng) if with_state else None
    block = jrec.rglru_block if kind == "rglru" else jrec.rwkv_block
    want, want_state = block(
        cfg, first_layer(params)["t"], {}, jnp.asarray(x),
        state=None if state is None else jax.tree.map(jnp.asarray, state),
        backend="xla")
    got, got_state = tm.layers[0].t(
        torch.from_numpy(x),
        state=None if state is None else {k: torch.from_numpy(v)
                                          for k, v in state.items()},
        backend="torch")
    np.testing.assert_allclose(np32(got), np32(want), **MODEL_TOL)
    assert set(got_state) == set(want_state)
    for name in want_state:
        np.testing.assert_allclose(np32(got_state[name]),
                                   np32(want_state[name]), **MODEL_TOL)


def test_perturbed_parameters_matter(models):
    """With the seeded values the scans see a non-trivial input: RG-LRU's
    scan input and RWKV-6's decay vary, so a scan returning zeros or one
    constant decay would fail the parity tests."""
    arch, (jm, _, _, tm) = models
    rng = np.random.default_rng(9)
    x = torch.from_numpy(
        rng.standard_normal((1, 6, jm.cfg.d_model)).astype(np.float32))
    block = tm.layers[0].t
    y, _ = block(x, backend="torch")
    names = [n for n in PERTURBED if hasattr(block, n)]
    assert names
    for name in names:
        p = getattr(block, name)
        assert p.std() > 0.5 * p.shape[0] ** -0.5, name
        with torch.no_grad():
            saved = p.clone()
            p.zero_()
            y0, _ = block(x, backend="torch")
            p.copy_(saved)
        assert (y0 - y).abs().max() > 1e-3, name


def jax_layer_caches(cfg, caches):
    """repro's stacked {"groups", "tail"} caches as one dict per layer."""
    P = len(cfg.block_pattern)
    out = {}
    groups = caches["groups"] or ()
    n_groups = len(cfg.layer_kinds) // P if groups else 0
    for pos, c in enumerate(groups):
        for g in range(n_groups):
            out[g * P + pos] = jax.tree.map(lambda a, g=g: a[g], c)
    for i, c in enumerate(caches["tail"]):
        out[n_groups * P + i] = c
    return [out[i] for i in range(len(cfg.layer_kinds))]


def assert_caches_equal(cfg, jcaches, tcaches):
    for kind, jl, tl in zip(cfg.layer_kinds,
                            jax_layer_caches(cfg, jcaches), tcaches):
        assert set(jl) == set(tl), kind
        for name in jl:
            want = jl[name]["data"] if isinstance(jl[name], dict) else jl[name]
            got = tl[name]["data"] if isinstance(tl[name], dict) else tl[name]
            np.testing.assert_allclose(np32(got), np32(want), **MODEL_TOL)


def test_forward_logits(models):
    arch, (jm, params, _, tm) = models
    ids = np.random.default_rng(10).integers(0, jm.cfg.vocab, (2, 12))
    want, _ = jm.forward(params, {"token_ids": jnp.asarray(ids, jnp.int32)})
    got = tm({"token_ids": torch.from_numpy(ids)})
    np.testing.assert_allclose(np32(got), np32(want), **MODEL_TOL)


def test_prefill_and_decode(models):
    """Prefill logits and caches past the reduced 32-token window, then
    three decode steps, against ``repro.models.Model``."""
    arch, (jm, params, _, tm) = models
    cfg = jm.cfg
    rng = np.random.default_rng(11)
    ids = rng.integers(0, cfg.vocab, (2, 37)).astype(np.int32)
    jl, jc = jm.prefill(params, {"token_ids": jnp.asarray(ids)}, capacity=48)
    tl, tc = tm.prefill({"token_ids": torch.from_numpy(ids)}, capacity=48)
    np.testing.assert_allclose(np32(tl), np32(jl), **MODEL_TOL)
    assert_caches_equal(cfg, jc, tc)
    lengths = np.array([37, 37], np.int32)
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        jl, jc = jm.decode_step(params, jc, {"token_ids": jnp.asarray(tok),
                                             "lengths": jnp.asarray(lengths)})
        tl, tc = tm.decode_step(tc, {"token_ids": torch.from_numpy(tok),
                                     "lengths": torch.from_numpy(lengths)})
        np.testing.assert_allclose(np32(tl), np32(jl), **MODEL_TOL)
        lengths = lengths + 1
    assert_caches_equal(cfg, jc, tc)


@pytest.mark.parametrize("n", [1, 2, 34])
def test_prefill_then_decode_equals_longer_prefill(models, n):
    """prefill(n + 1) == prefill(n) + one decode step: the carried
    recurrent state (and the conv / token-shift history) is complete."""
    arch, (jm, _, _, tm) = models
    ids = np.random.default_rng(12).integers(0, jm.cfg.vocab, (1, n + 1))
    ids_t = torch.from_numpy(ids.astype(np.int32))
    want, _ = tm.prefill({"token_ids": ids_t})
    _, caches = tm.prefill({"token_ids": ids_t[:, :n]}, capacity=48)
    got, _ = tm.decode_step(caches, {
        "token_ids": ids_t[:, n:],
        "lengths": torch.tensor([n], dtype=torch.int32)})
    np.testing.assert_allclose(np32(got), np32(want), **MODEL_TOL)


def test_init_cache_shapes(models):
    """``init_cache`` has the reference's shapes and dtypes per layer."""
    arch, (jm, _, _, tm) = models
    want = jax_layer_caches(jm.cfg, jm.init_cache(3, 40))
    got = tm.init_cache(3, 40)
    for jl, tl in zip(want, got):
        assert set(jl) == set(tl)
        for name in jl:
            jt = jl[name]["data"] if isinstance(jl[name], dict) else jl[name]
            tt = tl[name]["data"] if isinstance(tl[name], dict) else tl[name]
            assert tuple(tt.shape) == tuple(jt.shape), name
            assert str(tt.dtype).removeprefix("torch.") == str(jt.dtype)


PROMPT_LENS = (2, 13, 40)     # shorter than the conv history; past window
MAX_NEW = 6


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_tokens_identical(arch):
    """Both ServingEngines serve the same perturbed weights: identical
    greedy tokens for prompts of 2, 13 and 40 tokens over 4 slots."""
    jm, params, _, tm = pair(arch)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, jm.cfg.vocab, size=n) for n in PROMPT_LENS]
    jeng = jengine.ServingEngine(jm, params, max_slots=4, capacity=64)
    teng = tengine.ServingEngine(tm, max_slots=4, capacity=64)
    for eng in (jeng, teng):
        for p in prompts:
            eng.submit(p, max_new=MAX_NEW)
        eng.run_until_drained()
    want = {r.rid: r.tokens for r in jeng.completed}
    got = {r.rid: r.tokens for r in teng.completed}
    assert len(got) == len(PROMPT_LENS)
    assert all(len(t) == MAX_NEW for t in got.values())
    assert got == want


def test_engine_prefill_lands_in_its_slot():
    """A recurrent prefill writes its final state into its own slot of the
    batched cache and no other."""
    _, _, _, tm = pair("rwkv6-7b")
    eng = tengine.ServingEngine(tm, max_slots=3, capacity=32)
    before = [{k: v.clone() for k, v in c.items()} for c in eng.caches]
    eng.slots[0] = object()                # slot 0 taken: admit into 1
    eng.submit(np.arange(5), max_new=2)
    eng._admit()
    assert eng.slots[1] is not None
    for old, new in zip(before, eng.caches):
        for name in new:
            assert torch.equal(new[name][0], old[name][0])
            assert torch.equal(new[name][2], old[name][2])
            assert not torch.equal(new[name][1], old[name][1])


# ---------------------------------------------------------------------------
# conversion and storage
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_and_storage_dtypes(arch):
    """The tree's values arrive unchanged in the dtype each is used in:
    lam, w0 and the decay LoRA in float32 even when the model computes in
    bfloat16; projections, conv, mu and u in bfloat16."""
    jm, _, tree, _ = pair(arch)
    tcfg = tconfigs.get(arch).reduced(dtype="bfloat16")
    sd = params_from_jax(tcfg, tree)
    tm = tbuild(tcfg, device="cpu")
    tm.load_state_dict(sd)                       # strict: same key set
    f32 = {"lam", "w0", "w_lora_a", "w_lora_b", "ln", "ln_t", "ln_c"}
    seen = set()
    for key, value in tm.state_dict().items():
        assert torch.equal(value, sd[key].to(value.dtype)), key
        parts = key.split(".")
        if parts[0] != "layers" or parts[2] != "t":
            continue
        name = parts[-1]
        seen.add(name)
        want = torch.float32 if name in f32 else torch.bfloat16
        assert value.dtype == want, key
        if want == torch.float32:
            assert torch.equal(value, sd[key]), key      # not rounded
    assert seen & {"lam", "w_lora_a", "w_lora_b", "w0"}


def test_full_width_recurrent_storage():
    """At full width the recurrent weights are stored as they are used:
    bf16 projections, f32 lam / w0 / decay LoRA (one layer, vocab cut)."""
    for arch, kind in (("recurrentgemma-9b", "rglru"), ("rwkv6-7b", "rwkv")):
        cfg = dataclasses.replace(tconfigs.get(arch), n_layers=1, vocab=512)
        assert cfg.layer_kinds == (kind,)
        t = tbuild(cfg, device="cpu").layers[0].t
        if kind == "rglru":
            assert t.w_in.dtype == t.conv_w.dtype == torch.bfloat16
            assert t.lam.dtype == torch.float32
            assert t.w_in.shape == (4096, 4096) and t.conv_w.shape == (4, 4096)
        else:
            assert t.wr.dtype == t.u.dtype == torch.bfloat16
            assert t.w0.dtype == t.w_lora_b.dtype == torch.float32
            assert t.u.shape == (64, 64)
