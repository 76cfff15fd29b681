"""Port parity: repro_torch attention ops vs repro's Pallas kernels.

The same inputs, made with numpy from a seed, go through
``repro.kernels.ops`` (Pallas kernels in interpret mode, as
``tests/test_kernels.py`` runs them on the CPU), ``repro.kernels.ref``
and the port's plain PyTorch versions.  Tolerances are
``tests/test_kernels.py``'s: atol = rtol = 2e-5 in float32, 2e-2 in
bfloat16 (both packages round the same f32 draws to bf16 with
round-to-nearest-even, so the inputs are identical).

Tests marked ``cuda`` hold the hand-written kernels against their plain
versions and skip on hosts without a CUDA device.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

ATTN_SHAPES = [                    # tests/test_kernels.py:22-28
    # (B, Sq, Skv, Hq, Hkv, D)
    (1, 128, 128, 4, 4, 64),       # MHA
    (2, 256, 256, 8, 2, 64),       # GQA 4:1
    (1, 64, 64, 4, 1, 128),        # MQA
    (2, 96, 96, 4, 2, 32),         # non-128 seq (masked tail tiles)
]
MASKS = [(True, None), (False, None), (True, 48)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(name):
    return (dict(atol=2e-2, rtol=2e-2) if name == "bfloat16"
            else dict(atol=2e-5, rtol=2e-5))


def draw(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def both(x, dtype_name):
    jd, td = DTYPES[dtype_name]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


class TestAttentionParity:
    @pytest.mark.parametrize("shape", ATTN_SHAPES)
    @pytest.mark.parametrize("dtype", list(DTYPES))
    @pytest.mark.parametrize("causal,window", MASKS)
    def test_plain_vs_pallas_and_oracle(self, shape, dtype, causal, window):
        B, Sq, Skv, Hq, Hkv, D = shape
        qn, kn, vn = draw(0, (B, Sq, Hq, D), (B, Skv, Hkv, D),
                          (B, Skv, Hkv, D))
        (qj, qt), (kj, kt), (vj, vt) = (both(x, dtype) for x in (qn, kn, vn))
        got = tops.attention(qt, kt, vt, causal=causal, window=window,
                             block_kv=64, backend="torch")
        assert got.dtype == qt.dtype and got.shape == qt.shape
        pallas = jops.attention(qj, kj, vj, causal=causal, window=window,
                                backend="pallas_interpret", block_q=64,
                                block_kv=64)
        oracle = jref.attention(qj, kj, vj, causal=causal, window=window)
        np.testing.assert_allclose(f32(got), f32(pallas), **tol(dtype))
        np.testing.assert_allclose(f32(got), f32(oracle), **tol(dtype))
        mine = tref.attention(qt, kt, vt, causal=causal, window=window)
        np.testing.assert_allclose(f32(mine), f32(oracle), **tol(dtype))

    def test_offset_queries(self):
        """Sq < Skv: queries are the last Sq positions (chunked prefill)."""
        qn, kn, vn = draw(1, (2, 32, 4, 64), (2, 128, 4, 64), (2, 128, 4, 64))
        got = tops.attention(*(torch.from_numpy(x) for x in (qn, kn, vn)),
                             causal=True, block_kv=32, backend="torch")
        want = jref.attention(*(jnp.asarray(x) for x in (qn, kn, vn)),
                              causal=True)
        np.testing.assert_allclose(f32(got), f32(want), atol=2e-5, rtol=2e-5)


#: recurrentgemma-9b's local attention: 16 query heads, one kv head of 256
HEAD_256 = [(1, 96, 96, 16, 1, 256, True, 48), (2, 40, 40, 16, 1, 256,
                                                 True, None)]
DECODE_256 = [(3, 64, 16, 1, 256, (5, 64, 70))]     # a length past the ring


@pytest.mark.parametrize("case", HEAD_256)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_head_256_plain_vs_pallas(case, dtype):
    """The plain attention at recurrentgemma-9b's head size against the
    Pallas kernel in interpret mode."""
    B, Sq, Skv, Hq, Hkv, D, causal, window = case
    qn, kn, vn = draw(7, (B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D))
    (qj, qt), (kj, kt), (vj, vt) = (both(x, dtype) for x in (qn, kn, vn))
    got = tops.attention(qt, kt, vt, causal=causal, window=window,
                         block_kv=32, backend="torch")
    want = jops.attention(qj, kj, vj, causal=causal, window=window,
                          backend="pallas_interpret", block_q=32,
                          block_kv=32)
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))


@pytest.mark.parametrize("case", DECODE_256)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_head_256_plain_vs_pallas(case, dtype):
    B, S, Hq, Hkv, D, lens = case
    qn, kn, vn = draw(8, (B, 1, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))
    (qj, qt), (kj, kt), (vj, vt) = (both(x, dtype) for x in (qn, kn, vn))
    clamped = np.minimum(np.array(lens, np.int32), S)   # as the model clamps
    got = tops.decode_attention(qt, kt, vt, torch.from_numpy(clamped),
                                backend="torch")
    want = jops.decode_attention(qj, kj, vj, jnp.asarray(clamped),
                                 backend="pallas_interpret")
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))


#: the head sizes the kernels gained for the reduced configs (16) and
#: hubert-xlarge (80), and one the wrappers zero-pad (40 -> 64):
#: (B, Sq, Skv, Hq, Hkv, D)
SMALL_HEADS = [(2, 70, 70, 4, 2, 16), (1, 65, 130, 16, 16, 80),
               (1, 40, 96, 4, 1, 40)]


@pytest.mark.parametrize("shape", SMALL_HEADS)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal,window", MASKS)
def test_small_heads_plain_vs_pallas(shape, dtype, causal, window):
    """The plain attention at head sizes 16, 80 and 40 against the Pallas
    kernel in interpret mode."""
    B, Sq, Skv, Hq, Hkv, D = shape
    qn, kn, vn = draw(16, (B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D))
    (qj, qt), (kj, kt), (vj, vt) = (both(x, dtype) for x in (qn, kn, vn))
    got = tops.attention(qt, kt, vt, causal=causal, window=window,
                         block_kv=32, backend="torch")
    want = jops.attention(qj, kj, vj, causal=causal, window=window,
                          backend="pallas_interpret", block_q=32,
                          block_kv=32)
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))


@pytest.mark.parametrize("D", [16, 40, 80])
@pytest.mark.parametrize("G", [1, 8])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_small_heads_decode_plain_vs_pallas(D, G, dtype):
    """Decode at head sizes 16, 80 and 40, groups of 1 and 8, lengths 0,
    1 and S, against the Pallas kernel in interpret mode."""
    B, S, Hkv = 3, 96, 2
    qn, kn, vn = draw(17, (B, 1, Hkv * G, D), (B, S, Hkv, D),
                      (B, S, Hkv, D))
    (qj, qt), (kj, kt), (vj, vt) = (both(x, dtype) for x in (qn, kn, vn))
    lens = np.array([0, 1, S], np.int32)
    got = tops.decode_attention(qt, kt, vt, torch.from_numpy(lens),
                                backend="torch")
    want = jops.decode_attention(qj, kj, vj, jnp.asarray(lens),
                                 backend="pallas_interpret")
    # length 0: the Pallas kernel and the plain version give 0
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))


@pytest.mark.parametrize("D,want", [(1, 16), (16, 16), (17, 32), (40, 64),
                                    (64, 64), (65, 80), (80, 80), (81, 128),
                                    (200, 256), (256, 256)])
def test_padded_head_dim(D, want):
    """Every head size up to 256 runs at the next instantiated one."""
    assert tfa.padded_head_dim(D) == want
    x = torch.randn(2, 3, D)
    padded = tfa.pad_head(x, want)
    assert padded.shape == (2, 3, want) and padded.is_contiguous()
    assert torch.equal(padded[..., :D], x)
    assert not padded[..., D:].any()


@pytest.mark.parametrize("D", [0, 257, 288])
def test_padded_head_dim_refuses_past_256(D):
    with pytest.raises(NotImplementedError, match=f"head dim {D}"):
        tfa.padded_head_dim(D)


DECODE_CASES = [
    # (B, S, Hq, Hkv, D, lengths): 0, 1, full, non-multiples of 512
    (4, 1100, 8, 2, 64, (0, 1, 1100, 513)),
    (3, 600, 4, 4, 32, (600, 37, 512)),
    (2, 256, 4, 1, 128, (255, 256)),
]


class TestDecodeParity:
    @pytest.mark.parametrize("case", DECODE_CASES)
    @pytest.mark.parametrize("dtype", list(DTYPES))
    def test_plain_vs_pallas_and_oracle(self, case, dtype):
        B, S, Hq, Hkv, D, lens = case
        qn, kn, vn = draw(2, (B, 1, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))
        (qj, qt), (kj, kt), (vj, vt) = (both(x, dtype) for x in (qn, kn, vn))
        lj = jnp.asarray(lens, jnp.int32)
        lt = torch.tensor(lens, dtype=torch.int32)
        got = tops.decode_attention(qt, kt, vt, lt, backend="torch")
        assert got.dtype == qt.dtype and got.shape == qt.shape
        pallas = jops.decode_attention(qj, kj, vj, lj,
                                       backend="pallas_interpret")
        oracle = jref.attention(qj, kj, vj, causal=True, lengths=lj)
        np.testing.assert_allclose(f32(got), f32(pallas), **tol(dtype))
        np.testing.assert_allclose(f32(got), f32(oracle), **tol(dtype))
        mine = tops.decode_attention(qt, kt, vt, lt, backend="ref")
        np.testing.assert_allclose(f32(mine), f32(oracle), **tol(dtype))
        if 0 in lens:                      # empty sequence -> 0, not NaN
            assert not got[list(lens).index(0)].float().any()

    def test_nan_past_length_is_guarded(self):
        """Cache rows past the length may hold anything, NaN included."""
        qn, kn, vn = draw(3, (2, 1, 4, 32), (2, 64, 2, 32), (2, 64, 2, 32))
        kn[:, 40:] = np.nan
        vn[:, 40:] = np.nan
        lt = torch.tensor([40, 7], dtype=torch.int32)
        got = tops.decode_attention(*(torch.from_numpy(x)
                                      for x in (qn, kn, vn)), lt)
        clean = (jnp.asarray(np.nan_to_num(x)) for x in (qn, kn, vn))
        want = jref.attention(*clean, causal=True,
                              lengths=jnp.asarray([40, 7], jnp.int32))
        np.testing.assert_allclose(f32(got), f32(want), atol=2e-5, rtol=2e-5)


class TestDispatch:
    def test_auto_on_cpu_takes_plain_version(self, monkeypatch):
        def boom(*a, **k):
            raise AssertionError("kernel launched for a CPU tensor")
        monkeypatch.setattr(tfa, "_launch", boom)
        monkeypatch.setattr(tdec, "_launch", boom)
        q = torch.randn(1, 8, 2, 32)
        out = tops.attention(q, q, q)
        assert out.shape == q.shape
        lens = torch.tensor([5], dtype=torch.int32)
        assert tops.decode_attention(q[:, :1], q, q, lens).shape == (1, 1, 2,
                                                                     32)

    def test_cuda_backend_refuses_cpu_tensors(self):
        q = torch.randn(1, 8, 2, 32)
        with pytest.raises(ValueError, match="CUDA"):
            tops.attention(q, q, q, backend="cuda")
        with pytest.raises(ValueError, match="CUDA"):
            tops.decode_attention(q[:, :1], q, q,
                                  torch.tensor([3], dtype=torch.int32),
                                  backend="cuda")

    def test_unknown_backend(self):
        q = torch.randn(1, 8, 2, 32)
        with pytest.raises(ValueError, match="unknown backend"):
            tops.attention(q, q, q, backend="pallas")


# ---------------------------------------------------------------------------
# card only: the hand-written kernels vs their plain versions
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built with nvcc "
                    "for sm_90a)")
    return torch.device("cuda")


def _card(x, dtype, dev):
    return torch.from_numpy(x).to(dev).to(DTYPES[dtype][1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ATTN_SHAPES + [(1, 100, 300, 32, 32, 64)])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_kernel_vs_plain(cuda_device, shape, dtype, causal, window):
    B, Sq, Skv, Hq, Hkv, D = shape
    q, k, v = (_card(x, dtype, cuda_device) for x in draw(
        4, (B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
    before = tfa.launches
    got = tfa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tfa.launches == before + 1
    want = tfa.attention_torch(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(f32(got.cpu()), f32(want.cpu()), **tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_kernel_vs_plain(cuda_device, case, dtype):
    B, S, Hq, Hkv, D, lens = case
    q, k, v = (_card(x, dtype, cuda_device) for x in draw(
        5, (B, 1, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    before = tdec.launches
    got = tdec.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert tdec.launches == before + 1
    want = tdec.decode_attention_torch(q, k, v, lengths)
    np.testing.assert_allclose(f32(got.cpu()), f32(want.cpu()), **tol(dtype))


@pytest.mark.cuda
def test_decode_kernel_ignores_nan_past_length(cuda_device):
    """Cache rows past the length may hold anything, NaN included: the
    kernel zeroes K there and never reads V (the 0 * NaN guard)."""
    qn, kn, vn = draw(6, (2, 1, 4, 64), (2, 300, 2, 64), (2, 300, 2, 64))
    kn[:, 140:] = np.nan
    vn[:, 140:] = np.nan
    q, k, v = (_card(x, "float32", cuda_device) for x in (qn, kn, vn))
    lengths = torch.tensor([140, 3], dtype=torch.int32, device=cuda_device)
    got = tdec.decode_attention(q, k, v, lengths)
    want = tdec.decode_attention_torch(q, k, v, lengths)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(f32(got.cpu()), f32(want.cpu()),
                               **tol("float32"))


@pytest.mark.cuda
@pytest.mark.parametrize("case", HEAD_256 + [(1, 2300, 2300, 16, 1, 256,
                                              True, 2048)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_kernel_head_256_vs_plain(cuda_device, case, dtype):
    B, Sq, Skv, Hq, Hkv, D, causal, window = case
    q, k, v = (_card(x, dtype, cuda_device) for x in draw(
        9, (B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
    before = tfa.launches
    got = tfa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tfa.launches == before + 1
    want = tfa.attention_torch(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(f32(got.cpu()), f32(want.cpu()), **tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("case", DECODE_256 + [(4, 2048, 16, 1, 256,
                                                (9, 2048, 2301, 4000))])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_kernel_head_256_vs_plain(cuda_device, case, dtype):
    """Lengths past the cache read the whole ring in both versions."""
    B, S, Hq, Hkv, D, lens = case
    q, k, v = (_card(x, dtype, cuda_device) for x in draw(
        10, (B, 1, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    before = tdec.launches
    got = tdec.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert tdec.launches == before + 1
    want = tdec.decode_attention_torch(q, k, v, lengths)
    np.testing.assert_allclose(f32(got.cpu()), f32(want.cpu()), **tol(dtype))


# ---------------------------------------------------------------------------
# card only: the split-KV decode and the tensor-core flash kernel's edges
# ---------------------------------------------------------------------------
#: (B, S, Hq, Hkv, D, lengths): one sequence over an 8192-slot cache (the
#: most splits), lengths on split boundaries and one row either side (on
#: 132 SMs the wrapper splits these shapes every 192 and 64 rows), a
#: 16-head group at B = 1, groups of 3 at D = 128
DECODE_SPLIT_CASES = [
    (1, 8192, 32, 32, 64, (1,)), (1, 8192, 32, 32, 64, (8192,)),
    (1, 8192, 16, 1, 256, (1,)), (1, 8192, 16, 1, 256, (8192,)),
    (4, 2048, 32, 32, 64, (384, 385, 383, 768)),
    (4, 2048, 16, 1, 256, (64, 65, 63, 128)),
    (1, 2048, 16, 1, 256, (2000,)), (1, 2048, 16, 1, 128, (777,)),
    (2, 1024, 24, 8, 128, (700, 1024)),
    (3, 500, 8, 1, 32, (0, 499, 500)),          # G = 8: the mma path's edge
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", DECODE_SPLIT_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_split_kernel_vs_plain(cuda_device, case, dtype):
    B, S, Hq, Hkv, D, lens = case
    q, k, v = (_card(x, dtype, cuda_device) for x in draw(
        11, (B, 1, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    before = tdec.launches
    got = tdec.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert tdec.launches == before + 1           # one per call, any splits
    want = tdec.decode_attention_torch(q, k, v, lengths)
    np.testing.assert_allclose(f32(got.cpu()), f32(want.cpu()), **tol(dtype))
    splits = tdec.decode_splits(B, Hkv, S, torch.cuda.get_device_properties(
        cuda_device).multi_processor_count)
    twin = tdec.decode_attention_split_torch(q, k, v, lengths, splits)
    np.testing.assert_allclose(f32(got.cpu()), f32(twin.cpu()), **tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,kv_dtype", [("float32", "bfloat16"),
                                              ("bfloat16", "float32")])
def test_decode_kernel_mixed_types(cuda_device, q_dtype, kv_dtype):
    """q of one type over caches of the other (the CUDA-core path)."""
    qn, kn, vn = draw(12, (2, 1, 16, 128), (2, 700, 1, 128), (2, 700, 1, 128))
    q = _card(qn, q_dtype, cuda_device)
    k, v = (_card(x, kv_dtype, cuda_device) for x in (kn, vn))
    lengths = torch.tensor([700, 129], dtype=torch.int32, device=cuda_device)
    got = tdec.decode_attention(q, k, v, lengths)
    want = tdec.decode_attention_torch(q, k, v, lengths)
    assert got.dtype == q.dtype
    np.testing.assert_allclose(f32(got.cpu()), f32(want.cpu()),
                               **tol("bfloat16"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_kernel_ignores_nan_past_length_mqa_256(cuda_device, dtype):
    """The 0 * NaN guard on the tensor-core path (bf16) and the CUDA-core
    path (float32): recurrentgemma-9b's 16 heads over one kv head of 256."""
    qn, kn, vn = draw(13, (3, 1, 16, 256), (3, 1000, 1, 256),
                      (3, 1000, 1, 256))
    lens = (700, 65, 0)
    for b, n in enumerate(lens):
        kn[b, n:] = np.nan
        vn[b, n:] = np.nan
    q, k, v = (_card(x, dtype, cuda_device) for x in (qn, kn, vn))
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    got = tdec.decode_attention(q, k, v, lengths)
    want = tdec.decode_attention_torch(q, k, v, lengths)
    assert torch.isfinite(got).all()
    assert not got[2].float().any()
    np.testing.assert_allclose(f32(got.cpu()), f32(want.cpu()), **tol(dtype))


@pytest.mark.cuda
def test_decode_kernel_never_syncs(cuda_device):
    """The wrapper reads no lengths on the host: under sync debug mode
    "error" a synchronizing call would raise."""
    qn, kn, vn = draw(14, (2, 1, 16, 256), (2, 512, 1, 256), (2, 512, 1, 256))
    q, k, v = (_card(x, "bfloat16", cuda_device) for x in (qn, kn, vn))
    lengths = torch.tensor([300, 512], dtype=torch.int32, device=cuda_device)
    tdec.decode_attention(q, k, v, lengths)      # build and warm up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tdec.decode_attention(q, k, v, lengths)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


#: (B, Sq, Skv, Hq, Hkv, causal, window) at every head size: one query row,
#: a q tile one row short, a tile spilling one row over, Sq < Skv
FLASH_EDGE_CASES = [(1, 1, 129, 4, 2, True, None), (2, 63, 63, 4, 1, True,
                                                     None),
                    (1, 65, 200, 4, 4, True, 48), (1, 65, 130, 4, 2, False,
                                                   None)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_EDGE_CASES)
@pytest.mark.parametrize("D", (32, 64, 128, 256))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_kernel_edges_vs_plain(cuda_device, case, D, dtype):
    B, Sq, Skv, Hq, Hkv, causal, window = case
    q, k, v = (_card(x, dtype, cuda_device) for x in draw(
        15, (B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
    before = tfa.launches
    got = tfa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tfa.launches == before + 1
    want = tfa.attention_torch(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(f32(got.cpu()), f32(want.cpu()), **tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kernels_refuse_unsupported_head_size(cuda_device, dtype):
    """No fallback: a CUDA tensor the kernels cannot take raises (every
    head size past 256; smaller ones are padded)."""
    td = DTYPES[dtype][1]
    q = torch.randn(1, 8, 2, 288, device=cuda_device).to(td)
    with pytest.raises(NotImplementedError, match="head dim 288"):
        tfa.flash_attention(q, q, q)
    lengths = torch.tensor([5], dtype=torch.int32, device=cuda_device)
    with pytest.raises(NotImplementedError, match="head dim 288"):
        tdec.decode_attention(q[:, :1].contiguous(), q, q, lengths)


#: (B, Sq, Skv, Hq, Hkv, causal, window) at head sizes 16 and 80 and the
#: padded 40: causal, local window, bidirectional
SMALL_HEAD_MASKS = [(2, 70, 70, 4, 2, True, None),
                    (1, 130, 130, 16, 1, True, 48),
                    (1, 65, 130, 16, 16, False, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SMALL_HEAD_MASKS)
@pytest.mark.parametrize("D", (16, 40, 80))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_kernel_small_heads_vs_plain(cuda_device, case, D, dtype):
    B, Sq, Skv, Hq, Hkv, causal, window = case
    q, k, v = (_card(x, dtype, cuda_device) for x in draw(
        18, (B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
    before = tfa.launches
    got = tfa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tfa.launches == before + 1
    assert got.shape == q.shape and got.is_contiguous()
    want = tfa.attention_torch(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(f32(got.cpu()), f32(want.cpu()), **tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("D", (16, 40, 80))
@pytest.mark.parametrize("G", (1, 8, 16))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_kernel_small_heads_vs_plain(cuda_device, D, G, dtype):
    """Groups of 1 (the CUDA-core pass) and 8 and 16 (the tensor-core
    pass in bf16), lengths 0, 1 and S, one split and several."""
    for B, S in ((3, 300), (3, 2048)):
        q, k, v = (_card(x, dtype, cuda_device) for x in draw(
            19, (B, 1, 2 * G, D), (B, S, 2, D), (B, S, 2, D)))
        lengths = torch.tensor([0, 1, S], dtype=torch.int32,
                               device=cuda_device)
        before = tdec.launches
        got = tdec.decode_attention(q, k, v, lengths)
        torch.cuda.synchronize()
        assert tdec.launches == before + 1
        assert got.shape == q.shape and got.is_contiguous()
        want = tdec.decode_attention_torch(q, k, v, lengths)
        np.testing.assert_allclose(f32(got.cpu()), f32(want.cpu()),
                                   **tol(dtype))
