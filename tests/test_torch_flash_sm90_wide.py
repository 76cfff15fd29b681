"""The bf16 flash route at head sizes 80 and 256: ``flash_sm90``, the
same TMA-fed, warp-specialised ``wgmma`` kernel as at 64 and 128, with
its tiles sized for these heads (csrc/flash_attention.cu, ``Sm90``).

On the CPU: the plain version ``attention_torch`` against
``repro.kernels.ref.attention`` in float32 at the reference's ``2e-5``
at every case the card tests add for these head sizes
(``tests/test_torch_flash_sm90.py``: recurrentgemma-9b's 16 query heads
over one kv head of 256 and hubert-xlarge's 16 heads of 80, around the
128-row q tile and the kv tile, under every mask, and the served
shapes); and the kernel's arithmetic in plain PyTorch
(``attention_sm90``: 64-key tiles at D 256, 128-key tiles at D 80 with
the columns zero-filled to 96 as the TMA boxes lay them down, scores in
float32 from bf16 operands, the online softmax in the exp2 domain, P in
bf16 hi + lo) against ``repro``'s attention through the JAX package's
own CPU route at bf16's ``2e-2`` (``tests/test_kernels.py:17-18``);
and that ``chip_smoke.py --s1`` refuses arguments.
"""
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa

F32_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
LOG2E = 1.4426950408889634
#: ``flash_sm90``'s tiles by head size: (query rows a block, keys a kv
#: tile, columns in shared memory, columns of O += P.V)
TILES = {80: (128, 128, 96, 80), 256: (128, 64, 256, 256)}

#: query rows around the 128-row q tile, the 64-row warpgroup half and
#: the 64-key tile, and a served prompt
SQ = (1, 63, 64, 65, 127, 128, 129, 1000)
#: Skv - Sq: queries at the start of the keys, and offset past them
EXTRA = (0, 70)
#: causal, local windows of 48 and 100, bidirectional
MASKS = [(True, None), (True, 48), (True, 100), (False, None)]
#: (Hq, Hkv, D): recurrentgemma-9b's local layers, hubert-xlarge's encoder
WIDE_HEADS = [(16, 1, 256), (16, 16, 80)]
#: the served shapes, (B, Sq, Skv, Hq, Hkv, D, causal, window):
#: recurrentgemma-9b's 2300-token prompt past its 2048 window (and
#: without it), its 8-token prompt (one warpgroup), hubert-xlarge's 1000
#: frames
SERVED = {
    "rg_2300_window": (1, 2300, 2300, 16, 1, 256, True, 2048),
    "rg_2300": (1, 2300, 2300, 16, 1, 256, True, None),
    "rg_8": (2, 8, 8, 16, 1, 256, True, 2048),
    "hubert_1000": (1, 1000, 1000, 16, 16, 80, False, None),
}


def _draw(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _bf16(x):
    """float32 numpy values rounded to bf16 (as float32)."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


@pytest.fixture(scope="module")
def jref():
    from repro.kernels import ref

    return ref


@pytest.fixture(scope="module")
def jops():
    from repro.kernels import ops

    return ops


def _reference(mod, qn, kn, vn, causal, window):
    import jax.numpy as jnp

    return np.asarray(mod.attention(*(jnp.asarray(x) for x in (qn, kn, vn)),
                                    causal=causal, window=window))


def _check_plain(jref, B, Sq, Skv, Hq, Hkv, D, causal, window, seed):
    qn, kn, vn = _draw(seed, (B, Sq, Hq, D), (B, Skv, Hkv, D),
                       (B, Skv, Hkv, D))
    got = tfa.attention_torch(*(torch.from_numpy(x) for x in (qn, kn, vn)),
                              causal=causal, window=window)
    want = _reference(jref, qn, kn, vn, causal, window)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("Sq", SQ)
@pytest.mark.parametrize("extra", EXTRA)
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("heads", WIDE_HEADS)
def test_plain_vs_reference_at_wide_cases(jref, Sq, extra, causal, window,
                                          heads):
    """The card tests hold the kernel to ``attention_torch`` at these
    heads; this holds ``attention_torch`` to the JAX package's oracle at
    the same cases, float32, B 1."""
    Hq, Hkv, D = heads
    _check_plain(jref, 1, Sq, Sq + extra, Hq, Hkv, D, causal, window,
                 Sq * 7 + extra + D)


@pytest.mark.parametrize("case", list(SERVED))
def test_plain_vs_reference_at_served_shapes(jref, case):
    B, Sq, Skv, Hq, Hkv, D, causal, window = SERVED[case]
    _check_plain(jref, B, Sq, Skv, Hq, Hkv, D, causal, window, Sq + D)


def attention_sm90(q, k, v, *, causal: bool = True,
                   window: int | None = None, pieces: int = 2):
    """``flash_sm90``'s arithmetic at head sizes 80 and 256 in plain
    PyTorch.  q, k, v hold bf16 values (as float32); returns the float32
    output before its rounding to bf16.

    Per block of 128 query rows: the live kv range the kernel visits
    (its start on a kv-tile boundary), in tiles of TILES' keys; q, k and
    v zero-filled to the columns the boxes hold (96 at D 80), S = Q.K^T
    over them in float32 (bf16 products are exact); the online softmax
    in the exp2 domain (scale x log2 e, the running maximum of the
    scaled scores), P as bf16 hi = bf16(p) and lo = bf16(p - hi)
    (``pieces`` 1: hi alone), O += hi.V + lo.V over O's columns, l the
    sum of p; out = O / max(l, 1e-30).  The tensor cores' order of
    summation is not repeated."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    group = Hq // Hkv
    BQ, BK, DP, ON = TILES[D]

    def cols(x, n):
        return torch.nn.functional.pad(x, (0, n - x.shape[-1]))

    qg = cols(q, DP).reshape(B, Sq, Hkv, group, DP)
    k, v = cols(k, DP), cols(v, DP)
    sl2 = LOG2E / math.sqrt(D)
    off = Skv - Sq
    out = torch.zeros(B, Sq, Hkv, group, ON)
    for q0 in range(0, Sq, BQ):
        q1 = min(q0 + BQ, Sq)
        first, last = q0 + off, q1 - 1 + off
        kv_end = min(Skv, last + 1) if causal else Skv
        kv_begin = (max(0, first - window + 1) // BK * BK
                    if window is not None else 0)
        qb = qg[:, q0:q1]
        qp = torch.arange(q0, q1) + off
        m = torch.full(qb.shape[:-1], -1e30)
        l = torch.zeros(qb.shape[:-1])
        o = torch.zeros(*qb.shape[:-1], ON)
        for k0 in range(kv_begin, kv_end, BK):
            kb, vb = k[:, k0:k0 + BK], v[:, k0:k0 + BK, :, :ON]
            s = torch.einsum("bqhgd,bkhd->bqhgk", qb, kb)
            kp = torch.arange(k0, k0 + kb.shape[1])
            live = torch.ones(len(qp), len(kp), dtype=torch.bool)
            if causal:
                live &= kp[None, :] <= qp[:, None]
            if window is not None:
                live &= kp[None, :] > qp[:, None] - window
            s = s.masked_fill(~live[None, :, None, None, :], -math.inf)
            m_new = torch.maximum(m, s.amax(-1) * sl2)
            p = torch.exp2(s * sl2 - m_new[..., None])
            alpha = torch.exp2(m - m_new)
            hi = p.to(torch.bfloat16).float()
            lo = (p - hi).to(torch.bfloat16).float()
            pv = torch.einsum("bqhgk,bkhe->bqhge", hi, vb)
            if pieces == 2:
                pv = pv + torch.einsum("bqhgk,bkhe->bqhge", lo, vb)
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + pv
            m = m_new
        out[:, q0:q1] = o / l.clamp_min(1e-30)[..., None]
    return out[..., :D].reshape(B, Sq, Hq, D)


#: the arithmetic model's cases: the served shapes but the longest, and
#: tile edges under a window and an offset
MODEL_CASES = {
    "rg_8": SERVED["rg_8"],
    "hubert_1000": SERVED["hubert_1000"],
    "rg_window_offset": (1, 129, 300, 16, 1, 256, True, 100),
    "rg_kv_tile_edges": (2, 65, 65, 16, 1, 256, True, None),
    "hubert_causal_offset": (1, 127, 200, 16, 16, 80, True, None),
    "hubert_window": (2, 300, 300, 4, 4, 80, True, 48),
}


def _model_inputs(case):
    B, Sq, Skv, Hq, Hkv, D, causal, window = MODEL_CASES[case]
    qn, kn, vn = (_bf16(x) for x in _draw(Sq + Hq + D, (B, Sq, Hq, D),
                                          (B, Skv, Hkv, D),
                                          (B, Skv, Hkv, D)))
    return (qn, kn, vn), causal, window


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_sm90_arithmetic_vs_reference(jops, case):
    """The kernel's tiled bf16 arithmetic, its output rounded to bf16,
    within bf16's 2e-2 of repro's attention on the same bf16 values."""
    (qn, kn, vn), causal, window = _model_inputs(case)
    want = _reference(jops, qn, kn, vn, causal, window)
    got = attention_sm90(*(torch.from_numpy(x) for x in (qn, kn, vn)),
                         causal=causal, window=window)
    got = got.to(torch.bfloat16).float().numpy()
    np.testing.assert_allclose(got, want, **BF16_TOL)


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_p_in_two_pieces_is_near_float32(jops, case):
    """Before the output's rounding, P as bf16 hi + lo keeps the tiled
    arithmetic within the float32 reference's own 2e-5 (~2^-17 a
    probability), where one bf16 P (~2^-9) errs a hundredfold more: the
    reason the served build keeps two pieces."""
    (qn, kn, vn), causal, window = _model_inputs(case)
    want = _reference(jops, qn, kn, vn, causal, window)
    errs = {n: float(np.abs(attention_sm90(
        *(torch.from_numpy(x) for x in (qn, kn, vn)), causal=causal,
        window=window, pieces=n).numpy() - want).max()) for n in (1, 2)}
    assert errs[2] <= F32_TOL["atol"]
    assert errs[2] * 100 <= errs[1]


def test_s1_check_refuses_arguments():
    """``chip_smoke.py --s1`` (recurrentgemma-9b's served error layer by
    layer) takes no arguments: given one it names the refusal, exits
    non-zero and prints no result, before it looks for a card."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(root / "chip_smoke.py"),
                           "--s1", "20"], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "--s1 takes no arguments, got ['20']" in proc.stderr
