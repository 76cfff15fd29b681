"""Port parity: repro_torch model layers, caches, prefill and decode vs
repro's ``Model`` on reduced configs.

Inputs are made with numpy from a seed; model weights come from
``repro``'s ``Model.init`` and are carried across by
``repro_torch.models.convert.params_from_jax``.  Everything runs in
float32 on the CPU, where both packages compute the same sums in possibly
different orders: atol = rtol = 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build as jbuild
from repro.models import kvcache as jkv
from repro.models import layers as jlayers
from repro_torch import configs as tconfigs
from repro_torch.models import build as tbuild
from repro_torch.models import kvcache as tkv
from repro_torch.models import layers as tlayers
from repro_torch.models.convert import params_from_jax

from test_torch_recurrent import pair as perturbed_pair

TOL = dict(atol=1e-4, rtol=1e-4)

#: (name, arch, reduced() overrides): MHA, GQA + tied embeddings + rope
#: theta 5e5, a local-window ring cache, and an int8 cache.
VARIANTS = {
    "stablelm": ("stablelm-1.6b", {}),
    "llama": ("llama3.2-3b", {}),
    "local": ("stablelm-1.6b", dict(block_pattern=("attn", "local"),
                                    local_window=8)),
    "int8": ("llama3.2-3b", dict(kv_cache_dtype="int8")),
}


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def pair(name, seed=0):
    """(jax Model, jax params, port Model with the same weights)."""
    arch, over = VARIANTS[name]
    jcfg = jconfigs.get(arch).reduced(**over)
    tcfg = tconfigs.get(arch).reduced(**over)
    jm = jbuild(jcfg)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = tbuild(tcfg, device="cpu")
    tm.load_state_dict(params_from_jax(tcfg, jax.tree.map(np.asarray,
                                                          params)))
    return jm, params, tm


@pytest.fixture(scope="module", params=list(VARIANTS))
def models(request):
    return request.param, pair(request.param)


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


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 5, 32)) * 3).astype(np.float32)
    s = rng.standard_normal(32).astype(np.float32) * 0.1
    want = jlayers.rmsnorm(jnp.asarray(x).astype(dtype), jnp.asarray(s))
    got = tlayers.rmsnorm(torch.from_numpy(x).to(tlayers.dtype_of(dtype)),
                          torch.from_numpy(s))
    assert got.dtype == tlayers.dtype_of(dtype)
    tol = TOL if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(np32(got), np32(want), **tol)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 4000, size=(2, 7)).astype(np.int32)
    want = jlayers.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tlayers.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(np32(got), np32(want), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("window", [None, 8])
def test_kvcache_prefill_insert_dequant(dtype, window):
    rng = np.random.default_rng(2)
    k = rng.standard_normal((2, 13, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 13, 2, 16)).astype(np.float32)
    jk, jv = jkv.from_prefill(jnp.asarray(k), jnp.asarray(v), 32, dtype,
                              window)
    tk, tv = tkv.from_prefill(torch.from_numpy(k), torch.from_numpy(v), 32,
                              dtype, window)
    new = rng.standard_normal((2, 2, 16)).astype(np.float32)
    lengths = np.array([13, 5], np.int32)
    jk = jkv.insert(jk, jnp.asarray(new), jnp.asarray(lengths), window)
    tkv.insert(tk, torch.from_numpy(new), torch.from_numpy(lengths), window)
    assert tkv.size(tk) == jkv.size(jk) == (8 if window else 32)
    for jl, tl in ((jk, tk), (jv, tv)):
        assert set(jl) == set(tl)
        if dtype == "int8":                # identical quantization
            np.testing.assert_array_equal(tl["data"].numpy(),
                                          np.asarray(jl["data"]))
            np.testing.assert_allclose(tl["scale"].numpy(),
                                       np.asarray(jl["scale"]), rtol=1e-6)
        np.testing.assert_array_equal(np32(tl["data"]), np32(jl["data"]))
        np.testing.assert_array_equal(np32(tkv.dequant(tl)),
                                      np32(jkv.dequant(jl)))


# ---------------------------------------------------------------------------
# blocks and whole-model passes
# ---------------------------------------------------------------------------
def test_attention_and_mlp_blocks(models):
    name, (jm, params, tm) = models
    cfg = jm.cfg
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9)[None], (2, 9)).astype(np.int32)
    lp = jax.tree.map(lambda a: a[0], params["groups"][0])
    y, (k, v) = jlayers.attention_block(
        cfg, lp["t"], {}, jnp.asarray(x), jnp.asarray(pos),
        kind=cfg.block_pattern[0], backend="xla")
    ty, (tk, tv) = tm.layers[0].t(torch.from_numpy(x), torch.from_numpy(pos),
                                  backend="torch")
    for a, b in ((ty, y), (tk, k), (tv, v)):
        np.testing.assert_allclose(np32(a), np32(b), **TOL)
    want = jlayers.mlp_block(cfg, lp["c"], {}, jnp.asarray(x))
    got = tm.layers[0].c(torch.from_numpy(x))
    np.testing.assert_allclose(np32(got), np32(want), **TOL)


def test_forward_logits(models):
    name, (jm, params, tm) = models
    ids = np.random.default_rng(4).integers(0, jm.cfg.vocab, (2, 10))
    want, _ = jm.forward(params, {"token_ids": jnp.asarray(ids, jnp.int32)})
    got = tm({"token_ids": torch.from_numpy(ids)})
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(np32(got), np32(want), **TOL)


def test_prefill_and_decode(models):
    """Prefill logits and caches, then three decode steps."""
    name, (jm, params, tm) = models
    cfg = jm.cfg
    rng = np.random.default_rng(5)
    ids = rng.integers(0, cfg.vocab, (2, 11)).astype(np.int32)
    jl, jc = jm.prefill(params, {"token_ids": jnp.asarray(ids)}, capacity=24)
    tl, tc = tm.prefill({"token_ids": torch.from_numpy(ids)}, capacity=24)
    np.testing.assert_allclose(np32(tl), np32(jl), **TOL)
    for jlay, tlay in zip(jax_layer_caches(cfg, jc), tc):
        for kv in ("k", "v"):
            got = np32(tkv.dequant(tlay[kv]))
            want = np32(jkv.dequant(jlay[kv]))
            if "scale" in tlay[kv]:
                # k/v agree to ~1e-6, so round(x / scale) may land one
                # int8 step apart where x / scale sits near a half
                step = np.asarray(jlay[kv]["scale"]) * 1.01 + 1e-4
                assert (np.abs(got - want) <= step).all()
            else:
                np.testing.assert_allclose(got, want, **TOL)
    lengths = np.array([11, 11], np.int32)
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        jl, jc = jm.decode_step(params, jc, {"token_ids": jnp.asarray(tok),
                                             "lengths": jnp.asarray(lengths)})
        tl, tc = tm.decode_step(tc, {"token_ids": torch.from_numpy(tok),
                                     "lengths": torch.from_numpy(lengths)})
        assert tl.shape == (2, 1, cfg.vocab)
        np.testing.assert_allclose(np32(tl), np32(jl), **TOL)
        lengths = lengths + 1


def test_init_distributions():
    """``Model.init`` draws the reference's distributions: zero norms,
    N(0, 0.02) token table, N(0, fan_in^-1/2) projections."""
    cfg = tconfigs.get("stablelm-1.6b").reduced(d_model=256, d_ff=512,
                                                vocab=4096)
    tm = tbuild(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert not tm.emb.final_ln.any() and not tm.layers[0].t.ln.any()
    assert tm.emb.tok.std().item() == pytest.approx(0.02, rel=0.05)
    assert tm.layers[0].t.wq.std().item() == pytest.approx(256 ** -0.5,
                                                           rel=0.05)
    assert tm.layers[0].c.wo.std().item() == pytest.approx(512 ** -0.5,
                                                           rel=0.05)
    again = tbuild(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert torch.equal(again.layers[1].c.wi, tm.layers[1].c.wi)


def test_full_width_weights_stored_in_use_dtype():
    """At full width matmul weights are bf16, norms and head f32."""
    cfg = tconfigs.get("stablelm-1.6b")
    small = dataclasses.replace(cfg, n_layers=1, vocab=512)
    tm = tbuild(small, device="cpu")
    assert tm.layers[0].t.wq.dtype == torch.bfloat16
    assert tm.layers[0].c.wi_gate.dtype == torch.bfloat16
    assert tm.layers[0].t.ln.dtype == torch.float32
    assert tm.emb.head.dtype == torch.float32


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_configs_copied_verbatim(arch):
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert dataclasses.asdict(jcfg.reduced()) == dataclasses.asdict(
        tcfg.reduced())
    assert jcfg.n_params() == tcfg.n_params()
    for shape in jconfigs.SHAPES:
        assert (dataclasses.asdict(jconfigs.SHAPES[shape])
                == dataclasses.asdict(tconfigs.SHAPES[shape]))
        assert (jconfigs.cell_supported(jcfg, shape)
                == tconfigs.cell_supported(tcfg, shape))


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_reduced_configs_at_head_16(arch):
    """Every reduced config runs at head size 16 (the size the attention
    kernels gained for it): the whole model, prefill and two decode steps
    (forward for the encoder-only one), against repro's on the same
    numpy-seeded weights, with the recurrent parameters init leaves at
    zero filled.  The MoE configs run at their reduced capacity factor
    (8.0, drop-free); tests/test_torch_moe.py covers 1.25."""
    jm, params, _, tm = perturbed_pair(arch)
    cfg = tm.cfg
    assert cfg.d_head == jm.cfg.d_head == 16
    rng = np.random.default_rng(11)
    if cfg.embeds_only:
        x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
        want, _ = jm.forward(params, {"embeds": jnp.asarray(x)})
        got = tm({"embeds": torch.from_numpy(x)})
        np.testing.assert_allclose(np32(got), np32(want), **TOL)
        return
    ids = rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    jl, jc = jm.prefill(params, {"token_ids": jnp.asarray(ids)}, capacity=20)
    tl, tc = tm.prefill({"token_ids": torch.from_numpy(ids)}, capacity=20)
    np.testing.assert_allclose(np32(tl), np32(jl), **TOL)
    lengths = np.array([12, 12], np.int32)
    for _ in range(2):
        tok = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        jl, jc = jm.decode_step(params, jc, {"token_ids": jnp.asarray(tok),
                                             "lengths": jnp.asarray(lengths)})
        tl, tc = tm.decode_step(tc, {"token_ids": torch.from_numpy(tok),
                                     "lengths": torch.from_numpy(lengths)})
        np.testing.assert_allclose(np32(tl), np32(jl), **TOL)
        lengths = lengths + 1


def test_mm_embeds_prefix():
    """internvl2-2b's projected image embeddings replace the first
    ``mm_prefix`` positions: forward and prefill logits, and a decode step
    after it, against repro's on the same weights and embeddings."""
    jm, params, _, tm = perturbed_pair("internvl2-2b")
    cfg = tm.cfg
    assert cfg.mm_prefix
    rng = np.random.default_rng(12)
    S = cfg.mm_prefix + 5
    ids = rng.integers(0, cfg.vocab, (2, S)).astype(np.int32)
    mm = rng.standard_normal((2, cfg.mm_prefix, cfg.mm_embed_dim)).astype(
        np.float32)
    jbatch = {"token_ids": jnp.asarray(ids), "mm_embeds": jnp.asarray(mm)}
    tbatch = {"token_ids": torch.from_numpy(ids),
              "mm_embeds": torch.from_numpy(mm)}
    want, _ = jm.forward(params, jbatch)
    got = tm(tbatch)
    np.testing.assert_allclose(np32(got), np32(want), **TOL)
    plain = tm({"token_ids": torch.from_numpy(ids)})
    assert not np.allclose(np32(plain), np32(got), **TOL)  # the prefix acts
    jl, jc = jm.prefill(params, jbatch, capacity=S + 4)
    tl, tc = tm.prefill(tbatch, capacity=S + 4)
    np.testing.assert_allclose(np32(tl), np32(jl), **TOL)
    tok = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
    lengths = np.full(2, S, np.int32)
    jl, _ = jm.decode_step(params, jc, {"token_ids": jnp.asarray(tok),
                                       "lengths": jnp.asarray(lengths)})
    tl, _ = tm.decode_step(tc, {"token_ids": torch.from_numpy(tok),
                                "lengths": torch.from_numpy(lengths)})
    np.testing.assert_allclose(np32(tl), np32(jl), **TOL)
