"""Port parity: the four configurations ``chip_smoke.py``'s phase 20 runs
on the card, qwen1.5-32b, nemotron-4-15b, internvl2-2b and hubert-xlarge,
at reduced widths with the setting each one alone has kept.

* qwen1.5-32b: an int8 KV cache (``reduced(kv_cache_dtype="int8")``)
  and its QKV bias;
* nemotron-4-15b: the squared-ReLU MLP;
* internvl2-2b: the ``mm_prefix`` of projected patch embeddings;
* hubert-xlarge: bidirectional attention over frame embeddings, at its
  head size of 80 (``reduced(d_head=80)``).

Weights come from ``repro``'s ``Model.init``; the leaves it leaves at
zero (the norms' scales and the QKV bias) get seeded values on the numpy
tree first, so that a bias or a norm the port dropped would show.  The
three decoder models are served through both packages' ``ServingEngine``
(greedy tokens equal); internvl2-2b's prefill with patch embeddings and
hubert-xlarge's encoder are held to ``repro`` on the CPU in float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build as jbuild
from repro.models import kvcache as jkv
from repro.serve import engine as jengine
from repro_torch import configs as tconfigs
from repro_torch.models import build as tbuild
from repro_torch.models import kvcache as tkv
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import engine as tengine

#: the models' tolerance (tests/test_torch_models.py)
TOL = dict(atol=1e-4, rtol=1e-4)
#: the attention kernels' float32 tolerance (tests/test_kernels.py)
KERNEL_TOL = dict(atol=2e-5, rtol=2e-5)
#: the decoder models and what ``reduced()`` must keep of each
SERVED = {"qwen1.5-32b": dict(kv_cache_dtype="int8"),
          "nemotron-4-15b": {},
          "internvl2-2b": {}}
#: leaves the reference's init leaves at zero, redrawn N(0, 0.1^2)
ZERO_AT_INIT = ("ln", "final_ln", "bq", "bk", "bv")
PROMPT_LENS = (8, 13, 8, 21)
MAX_NEW = 6


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def filled(tree, rng):
    """The numpy param tree with ZERO_AT_INIT leaves redrawn from
    ``rng``."""
    if isinstance(tree, dict):
        return {k: ((0.1 * rng.standard_normal(np.shape(v)))
                    .astype(np.float32) if k in ZERO_AT_INIT
                    else filled(v, rng))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(filled(v, rng) for v in tree)
    return tree


def pair(arch, **over):
    """(jax Model, its params, port Model with the same weights)."""
    jcfg = jconfigs.get(arch).reduced(**over)
    tcfg = tconfigs.get(arch).reduced(**over)
    jm = jbuild(jcfg)
    tree = filled(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))),
                  np.random.default_rng(3))
    tm = tbuild(tcfg, device="cpu")
    tm.load_state_dict(params_from_jax(tcfg, tree))
    return jm, jax.tree.map(jnp.asarray, tree), tm


def test_reduced_keeps_each_models_setting():
    qwen = tconfigs.get("qwen1.5-32b").reduced(**SERVED["qwen1.5-32b"])
    assert qwen.kv_cache_dtype == "int8" and qwen.qkv_bias
    assert tconfigs.get("nemotron-4-15b").reduced().act == "squared_relu"
    vlm = tconfigs.get("internvl2-2b").reduced()
    assert vlm.mm_prefix and vlm.mm_embed_dim
    hubert = tconfigs.get("hubert-xlarge").reduced(d_head=80)
    assert hubert.bidirectional and hubert.embeds_only
    assert hubert.d_head == 80


@pytest.mark.parametrize("arch", list(SERVED))
def test_engines_serve_the_same_tokens(arch):
    """Both packages' engines, the same weights and prompts: greedy tokens
    equal, every request its MAX_NEW tokens."""
    jm, params, tm = pair(arch, **SERVED[arch])
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tm.cfg.vocab, size=n) for n in PROMPT_LENS]
    jeng = jengine.ServingEngine(jm, params, max_slots=4, capacity=48)
    teng = tengine.ServingEngine(tm, max_slots=4, capacity=48)
    for eng in (jeng, teng):
        for p in prompts:
            eng.submit(p, max_new=MAX_NEW)
        eng.run_until_drained()
    want = {r.rid: r.tokens for r in jeng.completed}
    got = {r.rid: r.tokens for r in teng.completed}
    assert len(got) == len(prompts)
    assert all(len(t) == MAX_NEW for t in got.values())
    assert got == want
    if arch == "qwen1.5-32b":
        assert teng.caches[0]["k"]["data"].dtype == torch.int8


def test_int8_cache_within_its_quantization_bound():
    """qwen1.5-32b's int8 cache after a prefill: each dequantized row
    within |x|max / 254 of the prompt's unquantized k and v (the float32
    cache of the same weights), and equal to the reference's int8 cache
    within one quantization step."""
    jm, params, tm = pair("qwen1.5-32b", **SERVED["qwen1.5-32b"])
    _, _, t32 = pair("qwen1.5-32b", kv_cache_dtype="float32")
    ids = np.random.default_rng(5).integers(0, tm.cfg.vocab, (2, 17))
    _, caches = tm.prefill({"token_ids": torch.from_numpy(ids)}, capacity=24)
    _, exact = t32.prefill({"token_ids": torch.from_numpy(ids)}, capacity=24)
    _, jcaches = jm.prefill(params, {"token_ids": jnp.asarray(ids, jnp.int32)},
                            capacity=24)
    jgroups = jcaches["groups"][0]
    for i, (c, e) in enumerate(zip(caches, exact)):
        for kv in ("k", "v"):
            x = e[kv]["data"][:, :17]
            got = tkv.dequant(c[kv]).float()[:, :17]
            bound = x.abs().amax(-1, keepdim=True) / 254 * (1 + 1e-4)
            # dequant hands back bf16: its rounding on top
            bound = bound + got.abs() * 2.0 ** -8
            assert bool(((got - x).abs() <= bound).all()), (i, kv)
            scale = np.asarray(jgroups[kv]["scale"][i])[:, :17]
            want = np32(jkv.dequant(jax.tree.map(lambda a: a[i],
                                                 jgroups[kv])))[:, :17]
            assert (np.abs(np32(got) - want)
                    <= scale * 1.01 + np.abs(want) * 2.0 ** -7).all()


def test_vlm_prefix_prefill():
    """internvl2-2b's prefill with patch embeddings, text after the
    prefix: last-token logits and every layer's cache against repro's,
    then a decode step; zeroing ``mm_proj`` moves the logits."""
    jm, params, tm = pair("internvl2-2b")
    cfg = tm.cfg
    rng = np.random.default_rng(12)
    S = cfg.mm_prefix + 9
    ids = rng.integers(0, cfg.vocab, (1, S)).astype(np.int32)
    mm = rng.standard_normal((1, cfg.mm_prefix, cfg.mm_embed_dim)).astype(
        np.float32)
    jl, jc = jm.prefill(params, {"token_ids": jnp.asarray(ids),
                                 "mm_embeds": jnp.asarray(mm)}, capacity=S + 4)
    tbatch = {"token_ids": torch.from_numpy(ids),
              "mm_embeds": torch.from_numpy(mm)}
    tl, tc = tm.prefill(tbatch, capacity=S + 4)
    np.testing.assert_allclose(np32(tl), np32(jl), **TOL)
    for i, c in enumerate(tc):
        for kv in ("k", "v"):
            want = np32(jc["groups"][0][kv]["data"][i])
            np.testing.assert_allclose(np32(c[kv]["data"]), want, **TOL)
    tok = rng.integers(0, cfg.vocab, (1, 1)).astype(np.int32)
    lengths = np.full(1, S, np.int32)
    jd, _ = jm.decode_step(params, jc, {"token_ids": jnp.asarray(tok),
                                       "lengths": jnp.asarray(lengths)})
    td, _ = tm.decode_step(tc, {"token_ids": torch.from_numpy(tok),
                                "lengths": torch.from_numpy(lengths)})
    np.testing.assert_allclose(np32(td), np32(jd), **TOL)
    with torch.no_grad():
        tm.emb.mm_proj.zero_()
    moved, _ = tm.prefill(tbatch, capacity=S + 4)
    rel = float((moved - tl).norm() / tl.norm())
    assert rel >= 0.2, rel


@pytest.mark.parametrize("frames", [12, 33])
def test_encoder_at_head_size_80(frames):
    """hubert-xlarge reduced at its own head size of 80: the whole
    bidirectional forward over frame embeddings against repro's, within
    the attention kernels' float32 tolerance."""
    jm, params, tm = pair("hubert-xlarge", d_head=80)
    rng = np.random.default_rng(frames)
    x = rng.standard_normal((2, frames, tm.cfg.d_model)).astype(np.float32)
    want, _ = jm.forward(params, {"embeds": jnp.asarray(x)})
    got = tm({"embeds": torch.from_numpy(x)})
    assert got.shape == (2, frames, tm.cfg.vocab)
    np.testing.assert_allclose(np32(got), np32(want), **KERNEL_TOL)
