"""The plain reference against the port's ``torch`` backend at reduced
widths on the CPU, with the weights both sides draw from one seed."""
from __future__ import annotations

import numpy as np
import pytest
import torch
from conftest import TINY_ARCH

from portbench import check, harness, spec, weights

REF = spec.reference("dense_decoder")
ARCHS = {
    "squared_relu": dict(TINY_ARCH, dtype="float32", kv_cache_dtype="float32"),
    "swiglu_qkv_bias": dict(TINY_ARCH, act="swiglu", qkv_bias=True,
                            n_kv_heads=4, vocab=384, dtype="float32",
                            kv_cache_dtype="float32"),
}


def _port(arch, seed):
    from repro_torch.models import build
    model = build(harness.model_config("nemotron-4-15b", arch), device="cpu")
    weights.fill_model(model, seed, "t")
    return model


def _reference(arch, seed, low=None, round_weights=False):
    return REF.Reference(arch, lambda n, shape, dt: weights.draw(
        seed, "t", n, shape, dt, "cpu"), "cpu", low=low,
        round_weights=round_weights)


@pytest.mark.parametrize("name", list(ARCHS))
def test_reference_names_every_weight_the_port_has(name):
    arch = ARCHS[name]
    model = _port(arch, 1)
    mine = {n: (tuple(s), dt) for n, (s, dt) in REF.names(arch).items()}
    port = {n: (tuple(p.shape), str(p.dtype).removeprefix("torch."))
            for n, p in model.named_parameters()}
    assert mine == port


@pytest.mark.parametrize("name", list(ARCHS))
def test_reference_matches_the_port_in_float32(name):
    arch = ARCHS[name]
    model = _port(arch, 2)
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, arch["vocab"], 37))
    want = model.forward({"token_ids": ids[None]})[0]
    got = _reference(arch, 2).logits([ids], [0])[0]
    assert got.shape == want.shape
    err = (got - want).abs().max() / want.abs().max()
    assert err < 1e-5


def test_the_same_seed_draws_the_same_weights_and_another_does_not():
    a = weights.draw(3, "t", "layers.0.t.wq", (64, 32), torch.bfloat16, "cpu")
    b = weights.draw(3, "t", "layers.0.t.wq", (64, 32), torch.bfloat16, "cpu")
    c = weights.draw(4, "t", "layers.0.t.wq", (64, 32), torch.bfloat16, "cpu")
    d = weights.draw(3, "u", "layers.0.t.wq", (64, 32), torch.bfloat16, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, d)
    assert a.float().std() == pytest.approx(64 ** -0.5, rel=0.1)


def test_served_greedy_tokens_read_gap_zero_and_others_do_not():
    """Decoding greedily from the reference itself gives gap 0 at every
    served position; a token swapped for another gives that token's gap."""
    arch = ARCHS["squared_relu"]
    ref = _reference(arch, 5)
    prompt = np.random.default_rng(1).integers(0, arch["vocab"], 9)
    seq = torch.as_tensor(prompt)
    served = []
    for _ in range(6):
        tok = int(ref.logits([seq], [len(seq) - 1])[0][-1].argmax())
        served.append(tok)
        seq = torch.cat([seq, torch.tensor([tok])])
    req = type("R", (), {"prompt": prompt, "tokens": served})()
    lg = check.reference_logits(ref, [req], "cpu")
    gap, n = check.widest_gap(lg, [req])
    assert n == 6 and gap < 1e-5
    bad = type("R", (), {"prompt": prompt,
                         "tokens": served[:3] + [(served[3] + 1) % 512]
                         + served[4:]})()
    gap = check.widest_gap(check.reference_logits(ref, [bad], "cpu"), [bad])[0]
    assert gap > 0


def test_sample_holds_the_longest_and_reaches_the_target():
    reqs = [type("R", (), {"tokens": [0] * n})() for n in (5, 40, 7, 9, 3)]
    s = check.sample(reqs, 9, 50)
    assert s[0] is reqs[1] and sum(len(r.tokens) for r in s) >= 50
    assert check.sample(reqs, 9, 50) == s
    assert check.sample([], 9, 50) == []


def test_each_control_departs_from_the_reference_by_its_precision():
    """``bf16`` rounds the float32 table, norms and head too (so it
    departs from the float32 reference of a bfloat16 model a little);
    ``fp8`` departs several times further."""
    arch = dict(TINY_ARCH, param_dtype="float32")
    ids = torch.as_tensor(np.random.default_rng(3).integers(
        0, arch["vocab"], 29))
    want = _reference(arch, 6).logits([ids], [0])[0]
    err = {}
    for name, (low, every) in REF.CONTROLS.items():
        got = _reference(arch, 6, low, every).logits([ids], [0])[0]
        err[name] = float((got - want).abs().max() / want.abs().max())
    assert 0 < err["bf16"] < err["fp8"] / 3
    ref = _reference(arch, 6, REF.bf16, True)
    table = ref._table()
    assert torch.equal(table, table.bfloat16().float())
    assert not torch.equal(table, _reference(arch, 6)._table())
