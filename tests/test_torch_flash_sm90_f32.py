"""The float32 flash-attention route at head sizes 64, 80, 128 and 256:
``flash_sm90_f32``, three TF32 products on ``wgmma``.

On the CPU: TF32 rounding as ``cvt.rna.tf32.f32`` rounds
(``tf32_round``), the truncation the tensor cores apply (``tf32_trunc``)
and the kernel's pieces; the order in which the kernel writes each 8-key
group of its transposed V tile, against a model of the TF32 ``wgmma``
operand fragments (the plain order must fail); and the kernel's
arithmetic in plain PyTorch (``attention_tf32x3``: every operand in TF32
hi and lo, three products) against ``repro``'s attention through the
JAX package's own CPU route, within the reference's ``2e-5`` at the
characterization's group shape, at head size 128 under GQA, and at
hubert-xlarge's (80, bidirectional) and recurrentgemma-9b's local
layers' (256, MQA, a window) heads, where one TF32 product (hi.hi
alone) misses.

Marked ``cuda`` (skipped without a card): the kernel against
``attention_torch`` at ``2e-5`` around its q tile (128 rows, 64 at head
size 256; Sq 1 to 1000, Skv = Sq and Sq + 70, causal / windows 48, 100 /
bidirectional, GQA ratios 1, 3, 6 and 16), one launch a call; builds of
the same source with a V tile in plain key order and with one TF32
product, which must fail that check; the kernel at 2048 and 4096
tokens, where O accumulated in place by the tensor cores drifted past
it, and at recurrentgemma-9b's 2300-token local layer and hubert-xlarge's
1000 frames; and that the tensor cores read a float32 operand by
dropping its low 13 bits.  The card tests import nothing of JAX.
"""
import ctypes
import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as tfa

F32_TOL = dict(atol=2e-5, rtol=2e-5)

# ---------------------------------------------------------------------------
# CPU: TF32 rounding, the fragment order, the arithmetic
# ---------------------------------------------------------------------------
ULP = 2.0 ** -10            # a TF32 unit in the last place at 1
#: keys a kv tile of ``flash_sm90_f32`` by head size (the tile of its
#: online softmax; csrc/flash_attention.cu)
BLOCK_KV = {64: 64, 80: 32, 128: 32, 256: 16}


def tf32_round(x):
    """float32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds: to
    nearest on 10 fraction bits, ties away from zero (the low 13 bits of
    the result are zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(x):
    """float32 ``x`` as the tensor cores read an operand of a TF32
    product: its low 13 bits dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def tf32_pieces(x):
    """``flash_sm90_f32``'s TF32 pieces of x, (hi, lo), as the tensor
    cores read them: hi = x rounded to nearest, lo = x - hi with its low
    13 bits dropped."""
    hi = tf32_round(x)
    return hi, tf32_trunc(x - hi)


def attention_tf32x3(q, k, v, *, causal: bool = True,
                     window: int | None = None, one_product: bool = False):
    """``flash_sm90_f32``'s arithmetic in plain PyTorch (float32): q
    scaled first, then every operand of S = Q.K^T and of O += P.V in TF32
    hi and lo pieces (``tf32_pieces``), each product the sum lo.hi +
    hi.lo + hi.hi (``one_product``: hi.hi alone), the online softmax over
    the kernel's kv tiles (``BLOCK_KV``), each tile's P.V added to O in
    float32 as the kernel adds it.  The tensor cores' order of summation
    is not repeated."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    group = Hq // Hkv
    block_kv = BLOCK_KV[D]

    def prod(eq, a, b):
        (ah, al), (bh, bl) = tf32_pieces(a), tf32_pieces(b)
        out = torch.einsum(eq, ah, bh)
        if not one_product:
            out = (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)) + out
        return out

    qg = (q.float() / math.sqrt(D)).reshape(B, Sq, Hkv, group, D)
    q_pos = torch.arange(Sq) + (Skv - Sq)
    m = torch.full((B, Sq, Hkv, group), -1e30)
    l = torch.zeros((B, Sq, Hkv, group))
    acc = torch.zeros((B, Sq, Hkv, group, D))
    for k0 in range(0, Skv, block_kv):
        kb = k[:, k0:k0 + block_kv].float()
        vb = v[:, k0:k0 + block_kv].float()
        s = prod("bqhgd,bkhd->bqhgk", qg, kb)
        k_pos = torch.arange(k0, k0 + kb.shape[1])
        mask = torch.ones((Sq, kb.shape[1]), dtype=torch.bool)
        if causal:
            mask &= k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            mask &= k_pos[None, :] > q_pos[:, None] - window
        s = s.masked_fill(~mask[None, :, None, None, :], -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + prod("bqhgk,bkhe->bqhge", p, vb)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, Sq, Hq, D)


@pytest.mark.parametrize("x,want", [
    (1.0, 1.0),
    (1 + ULP / 2, 1 + ULP),              # a tie rounds away from zero
    (-(1 + ULP / 2), -(1 + ULP)),
    (1 + ULP + ULP / 2, 1 + 2 * ULP),    # away, not to even
    (1 + ULP / 2 - 2.0 ** -23, 1.0),     # below the tie
    (3.14159, 3.140625),
    (-2.71828, -2.71875),
    (0.0, 0.0)])
def test_tf32_round(x, want):
    got = tf32_round(torch.tensor([x], dtype=torch.float32))
    assert got.item() == want


def test_tf32_pieces_carry_the_float():
    """hi and lo have their low 13 bits clear, x - hi is exact, and hi +
    lo is within 2^-21 of x, where hi alone is not within 2^-13: the
    pieces the kernel multiplies, as the tensor cores read them."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(100_000)
                          * 10.0 ** rng.integers(-3, 4, 100_000))
                         .astype(np.float32))
    hi, lo = tf32_pieces(x)
    for piece in (hi, lo):
        assert not bool((piece.view(torch.int32) & 0x1FFF).any())
    assert torch.equal(hi + (x - hi), x)
    rel = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs()).max().item()
    assert rel <= 2.0 ** -21
    assert ((hi.double() - x.double()).abs() / x.double().abs()).max() \
        > 2.0 ** -13


def test_tf32_trunc():
    x = torch.tensor([1 + ULP - 2.0 ** -23, -(1 + ULP / 2), 3.14159])
    assert tf32_trunc(x).tolist() == [1.0, -1.0, 3.140625]


#: the order flash_sm90_f32 writes each 8-key group of V^T in
#: (csrc/flash_attention.cu::put_v), and the plain order
V_ORDERS = {"fragment": (0, 2, 4, 6, 1, 3, 5, 7), "plain": tuple(range(8))}


@pytest.mark.parametrize("order", list(V_ORDERS))
def test_p_fragment_key_order(order):
    """A model of one warp's k step of O += P.V in TF32 ``wgmma``
    (sm90_tiles.cuh's TF32 note): thread (g, t) holds the score
    accumulator's (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1) of
    an 8-key block, and passes {d0, d2, d1, d3} as the A fragment, whose
    k indices are t, t, t + 4, t + 4; B's row j is V's key order[j].  The
    fragment order gives P.V, the plain order does not."""
    rng = np.random.default_rng(1)
    p = rng.standard_normal((16, 8))
    vt = rng.standard_normal((8, 5))
    key = V_ORDERS[order]
    a = np.zeros((16, 8))                # A by (row, k index)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        d = (p[g, 2 * t], p[g, 2 * t + 1], p[g + 8, 2 * t],
             p[g + 8, 2 * t + 1])
        frag = (d[0], d[2], d[1], d[3])
        for (r, kidx), val in zip(((g, t), (g + 8, t), (g, t + 4),
                                   (g + 8, t + 4)), frag):
            a[r, kidx] = val
    b = vt[list(key)]                    # B row j: V's key order[j]
    got = a @ b
    assert np.allclose(got, p @ vt) == (order == "fragment")


#: the characterization's attention group (stablelm-1.6b: B 2, S 256,
#: 32/32 heads of 64, causal) and dbrx-132b's 48/8 heads of 128 (GQA 6)
#: at a served prompt, with a window and a bidirectional case beside;
#: hubert-xlarge's encoder layer (heads of 80, bidirectional) and
#: recurrentgemma-9b's local layer (MQA, heads of 256, a window) cut to
#: 4 query heads and a few hundred positions
TWIN_CASES = {
    "characterization": (2, 256, 256, 32, 32, 64, True, None),
    "dbrx_d128_gqa": (1, 513, 513, 48, 8, 128, True, None),
    "window_d64": (1, 300, 300, 8, 2, 64, True, 100),
    "bidirectional_d128_offset": (1, 129, 200, 6, 1, 128, False, None),
    "hubert_d80_bidirectional": (1, 200, 200, 4, 4, 80, False, None),
    "recurrentgemma_d256_mqa_window": (1, 300, 300, 4, 1, 256, True, 100),
}


def _draw(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _case_inputs(case):
    B, Sq, Skv, Hq, Hkv, D, causal, window = TWIN_CASES[case]
    return _draw(Sq + Hq, (B, Sq, Hq, D), (B, Skv, Hkv, D),
                 (B, Skv, Hkv, D)), causal, window


@pytest.fixture(scope="module")
def jops():
    from repro.kernels import ops

    return ops


def _repro_attention(jops, qn, kn, vn, causal, window):
    import jax.numpy as jnp

    return np.asarray(jops.attention(*(jnp.asarray(x) for x in (qn, kn, vn)),
                                     causal=causal, window=window))


def _excess(got, want) -> float:
    """The largest |got - want| over atol + rtol |want| (<= 1 passes)."""
    return float((np.abs(got - want) / (F32_TOL["atol"] + F32_TOL["rtol"]
                                        * np.abs(want))).max())


@pytest.mark.parametrize("case", list(TWIN_CASES))
def test_tf32x3_arithmetic_vs_reference(jops, case):
    """Three TF32 products (lo.hi + hi.lo + hi.hi) hold the reference's
    2e-5 with room to spare (the kernel adds only the tensor cores' order
    of summation)."""
    (qn, kn, vn), causal, window = _case_inputs(case)
    want = _repro_attention(jops, qn, kn, vn, causal, window)
    got = attention_tf32x3(*(torch.from_numpy(x) for x in (qn, kn, vn)),
                           causal=causal, window=window).numpy()
    assert _excess(got, want) <= 0.25


@pytest.mark.parametrize("case", list(TWIN_CASES))
def test_one_tf32_product_misses(jops, case):
    """hi.hi alone (~2^-11 a product) misses the same tolerance."""
    (qn, kn, vn), causal, window = _case_inputs(case)
    want = _repro_attention(jops, qn, kn, vn, causal, window)
    got = attention_tf32x3(*(torch.from_numpy(x) for x in (qn, kn, vn)),
                           causal=causal, window=window,
                           one_product=True).numpy()
    assert _excess(got, want) > 4.0


# ---------------------------------------------------------------------------
# card only
# ---------------------------------------------------------------------------
#: nvcc defines of the builds the card tests take beside the served one:
#: V^T in plain key order; one product of hi alone, hi = x as it is, or x
#: with its low 13 bits cleared
PLAIN_V = ("-DFLASH_SM90_F32_PLAIN_V=1",)
HI_AS_IS = ("-DFLASH_SM90_F32_ONE_PRODUCT=1",)
HI_CLEARED = ("-DFLASH_SM90_F32_ONE_PRODUCT=2",)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built with nvcc "
                    "for sm_90a)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def variants():
    """The variant builds, each nvcc started at once (a build takes tens
    of seconds).  Module-scoped fixtures are set up before the function's
    ``cuda_device``, so this one skips without a card itself."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built with nvcc "
                    "for sm_90a)")
    defines = ((), PLAIN_V, HI_AS_IS, HI_CLEARED)
    with ThreadPoolExecutor(len(defines)) as pool:
        list(pool.map(lambda d: _build.load("flash_attention", d), defines))
    return defines


def _card(dev, seed, *shapes):
    return [torch.from_numpy(x).to(dev) for x in _draw(seed, *shapes)]


#: query rows around the 128-row q tile (and the 64-row warpgroup half),
#: and a served prompt
SQ = (1, 63, 64, 65, 127, 128, 129, 1000)
#: Skv - Sq: queries at the start of the keys, and offset past them
EXTRA = (0, 70)
#: causal, local windows of 48 and 100, bidirectional
MASKS = [(True, None), (True, 48), (True, 100), (False, None)]
#: (query heads, kv heads) by head size: GQA ratios 1, 3, 6, 16 at 64 and
#: 128 (stablelm-1.6b, llama3.2-3b, dbrx-132b, qwen3-moe-235b-a22b);
#: hubert-xlarge's 16/16 at 80 and recurrentgemma-9b's MQA 16/1 at 256,
#: each beside the other ratios
HEADS = {64: [(32, 32), (24, 8), (48, 8), (64, 4)],
         80: [(16, 16), (24, 8), (48, 8), (16, 1)],
         128: [(32, 32), (24, 8), (48, 8), (64, 4)],
         256: [(16, 1), (16, 16), (24, 8), (64, 4)]}


@pytest.mark.cuda
@pytest.mark.parametrize("Sq", SQ)
@pytest.mark.parametrize("extra", EXTRA)
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("D,heads", [(D, h) for D in tfa.SM90_F32_HEAD_DIMS
                                     for h in HEADS[D]])
def test_sm90_f32_kernel_vs_plain(cuda_device, Sq, extra, causal, window,
                                  heads, D):
    """B 2; Skv = Sq + extra (queries the last Sq positions); float32 at
    the reference's 2e-5."""
    (Hq, Hkv), B, Skv = heads, 2, Sq + extra
    q, k, v = _card(cuda_device, Sq * 7 + extra, (B, Sq, Hq, D),
                    (B, Skv, Hkv, D), (B, Skv, Hkv, D))
    assert tfa.kernel_for(q.dtype, D) == "flash_sm90_f32"
    before = tfa.launches
    got = tfa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tfa.launches == before + 1
    assert got.shape == q.shape and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(
        got.cpu().numpy(),
        tfa.attention_torch(q, k, v, causal=causal,
                            window=window).cpu().numpy(), **F32_TOL)


def _variant_launch(defines, q, k, v):
    """One causal launch of the flash source built with the nvcc
    ``defines`` (a library of its own; not counted in ``launches``), at a
    head size it serves unpadded."""
    lib = _build.load("flash_attention", defines)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_fwd.argtypes = [p, p, p, p] + [i] * 9 + [f, p]
    lib.flash_attention_fwd.restype = i
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1:3]
    out = torch.empty_like(q)
    code = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 0, B, Sq,
        Skv, Hq, Hkv, D, 1, -1, 1.0 / math.sqrt(D),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, code, f"flash_attention {' '.join(defines)}")
    return out


#: (query heads, kv heads) of the variant checks by head size: the
#: characterization's 32/32, hubert-xlarge's 16/16 at 80,
#: recurrentgemma-9b's 16/1 at 256
VARIANT_HEADS = {64: (32, 32), 80: (16, 16), 128: (32, 32), 256: (16, 1)}


def _variant_excess(dev, defines, D, seed=5):
    """B 2, S 256 at head size D (VARIANT_HEADS) through the build with
    ``defines`` (the served wrapper without any): the largest error over
    the 2e-5 tolerance against ``attention_torch``, and the output."""
    Hq, Hkv = VARIANT_HEADS[D]
    q, k, v = _card(dev, seed, (2, 256, Hq, D), (2, 256, Hkv, D),
                    (2, 256, Hkv, D))
    got = (_variant_launch(defines, q, k, v) if defines
           else tfa.flash_attention(q, k, v))
    want = tfa.attention_torch(q, k, v, causal=True)
    torch.cuda.synchronize()
    return _excess(got.cpu().numpy(), want.cpu().numpy()), got


@pytest.mark.cuda
@pytest.mark.parametrize("D", tfa.SM90_F32_HEAD_DIMS)
def test_sm90_f32_planted_faults_fail(cuda_device, variants, D):
    """The served build passes; a V tile written in plain key order, and
    one TF32 product, fail the check it passes."""
    assert _variant_excess(cuda_device, (), D)[0] <= 1.0
    assert _variant_excess(cuda_device, PLAIN_V, D)[0] > 100.0
    assert _variant_excess(cuda_device, HI_AS_IS, D)[0] > 4.0


@pytest.mark.cuda
@pytest.mark.parametrize("D", tfa.SM90_F32_HEAD_DIMS)
def test_tensor_cores_drop_the_low_13_bits(cuda_device, variants, D):
    """One TF32 product of x as it is and of x with its low 13 bits
    cleared agree bit for bit: the tensor cores read a float32 operand
    (from shared memory and from registers) as its top 19 bits, which
    lets the served build pass lo = x - hi as it is.  (Both differ from
    the served build's output.)"""
    cleared = _variant_excess(cuda_device, HI_CLEARED, D)[1]
    as_is = _variant_excess(cuda_device, HI_AS_IS, D)[1]
    assert torch.equal(cleared, as_is)
    assert not torch.equal(cleared, _variant_excess(cuda_device, (), D)[1])


#: (S, D, (query heads, kv heads), causal, window): causal prefills of
#: 2048 and 4096 tokens at 64 and 128, recurrentgemma-9b's local layer
#: at its 2300-token prompt (window 2048) and hubert-xlarge's encoder
#: layer over 1000 frames (bidirectional)
LONG = [(S, D, heads, True, None) for S in (2048, 4096)
        for D, heads in ((64, (32, 32)), (128, (48, 8)))] + [
    (2300, 256, (16, 1), True, 2048), (1000, 80, (16, 16), False, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("scale", (1.0, 2.0, 4.0))
@pytest.mark.parametrize("S,D,heads,causal,window", LONG)
def test_sm90_f32_long_prefill_vs_plain(cuda_device, S, D, heads, causal,
                                        window, scale):
    """B 1, q scaled by 1, 2 and 4 (peakier softmax): each turn's P.V is
    added to O in float32, so the error does not grow with the prefill's
    length."""
    Hq, Hkv = heads
    q, k, v = _card(cuda_device, S + D, (1, S, Hq, D), (1, S, Hkv, D),
                    (1, S, Hkv, D))
    q = q * scale
    got = tfa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    np.testing.assert_allclose(
        got.cpu().numpy(),
        tfa.attention_torch(q, k, v, causal=causal,
                            window=window).cpu().numpy(), **F32_TOL)
