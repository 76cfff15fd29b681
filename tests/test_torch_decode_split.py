"""The split-KV decode's arithmetic, on the CPU.

``decode_attention_split_torch`` is the plain twin of the kernel's two
passes (partials per tile-aligned split, then the combine).  The same
inputs, made with numpy from a seed, go through it, through ``repro``'s
Pallas decode kernel in interpret mode (as ``tests/test_kernels.py`` runs
it on the CPU) and through the port's one-pass plain version.  Tolerances
are ``tests/test_kernels.py``'s: atol = rtol = 2e-5 in float32, 2e-2 in
bfloat16.

The lengths hold 0, 1, every split boundary of every split count below
and one row either side of it, the whole cache, and past it.  The split
count the wrapper picks is a function of the shapes and the SM count
only: the lengths stay on the device.
"""
import functools
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import decode_attention as tdec

S = 448                           # 7 tiles of 64
SPLITS = (1, 2, 3, 7, 16)
GROUPS = {1: (2, 2), 3: (6, 2), 16: (16, 1)}      # G -> (Hq, Hkv)
HEAD_DIMS = (32, 64, 256)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _lengths() -> tuple:
    marks = {0, 1, S, S + 1, S + 52}
    for n in SPLITS:
        c = tdec.split_chunk(S, n)
        for j in range(1, n):
            if j * c <= S:
                marks |= {j * c - 1, j * c, j * c + 1}
    return tuple(sorted(marks))


LENGTHS = _lengths()


def tol(name):
    return (dict(atol=2e-2, rtol=2e-2) if name == "bfloat16"
            else dict(atol=2e-5, rtol=2e-5))


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@functools.cache
def inputs(G: int, D: int, dtype: str):
    """numpy draws, the port's tensors and the Pallas kernel's output."""
    Hq, Hkv = GROUPS[G]
    B = len(LENGTHS)
    rng = np.random.default_rng(1000 * G + D)
    qn, kn, vn = (rng.standard_normal(s).astype(np.float32)
                  for s in ((B, 1, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    jd, td = DTYPES[dtype]
    qt, kt, vt = (torch.from_numpy(x).to(td) for x in (qn, kn, vn))
    lt = torch.tensor(LENGTHS, dtype=torch.int32)
    clamped = np.minimum(np.array(LENGTHS, np.int32), S)
    pallas = jops.decode_attention(*(jnp.asarray(x).astype(jd)
                                     for x in (qn, kn, vn)),
                                   jnp.asarray(clamped),
                                   backend="pallas_interpret")
    return qt, kt, vt, lt, f32(pallas)


def test_lengths_cover_every_boundary():
    assert 0 in LENGTHS and 1 in LENGTHS and max(LENGTHS) > S
    for n in SPLITS[1:]:
        c = tdec.split_chunk(S, n)
        assert {c - 1, c, c + 1} <= set(LENGTHS)


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("G", list(GROUPS))
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_split_twin_vs_pallas_and_plain(splits, G, D, dtype):
    q, k, v, lengths, pallas = inputs(G, D, dtype)
    got = tdec.decode_attention_split_torch(q, k, v, lengths, splits)
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(f32(got), pallas, **tol(dtype))
    plain = tdec.decode_attention_torch(q, k, v, lengths)
    np.testing.assert_allclose(f32(got), f32(plain), **tol(dtype))
    assert not got[LENGTHS.index(0)].float().any()   # empty: 0, not NaN
    assert torch.isfinite(got.float()).all()


@pytest.mark.parametrize("splits", SPLITS)
def test_split_twin_ignores_nan_past_length(splits):
    """Rows past the length may hold NaN: no split multiplies them."""
    q, k, v, lengths, _ = inputs(3, 64, "float32")
    k, v = k.clone(), v.clone()
    clean = tdec.decode_attention_split_torch(q, k, v, lengths, splits)
    for b, n in enumerate(LENGTHS):
        k[b, n:] = float("nan")
        v[b, n:] = float("nan")
    got = tdec.decode_attention_split_torch(q, k, v, lengths, splits)
    np.testing.assert_array_equal(f32(got), f32(clean))


def test_split_chunk_is_tile_aligned_and_covers():
    for s in (0, 1, 63, 64, 65, 448, 2048, 2049, 8192):
        for n in (1, 2, 3, 7, 16, 128, 200):
            c = tdec.split_chunk(s, n)
            assert c % tdec.SPLIT_ALIGN == 0 and c >= tdec.SPLIT_ALIGN
            assert n * c >= s


SHAPES = [(B, Hkv, s) for B in (1, 2, 4, 8, 64) for Hkv in (1, 8, 32)
          for s in (1, 64, 200, 2048, 8192)]


@pytest.mark.parametrize("sm", (132, 114, 16))
def test_split_count(sm):
    """At least 1; the chunk it implies tile-aligned and covering S; and
    B * Hkv * splits >= 2 x the SM count where S has the tiles for it,
    else one split per tile."""
    for B, Hkv, s in SHAPES:
        n = tdec.decode_splits(B, Hkv, s, sm)
        tiles = max(1, -(-s // tdec.SPLIT_ALIGN))
        assert 1 <= n <= tiles
        c = tdec.split_chunk(s, n)
        assert c % tdec.SPLIT_ALIGN == 0 and n * c >= s
        if B * Hkv * tiles >= 2 * sm:
            assert B * Hkv * n >= 2 * sm, (B, Hkv, s, n)
        else:
            assert n == tiles


def test_split_count_ignores_lengths():
    """The split count takes no lengths: the wrapper calls it with the
    shapes alone, so the host never reads the device's lengths."""
    params = list(inspect.signature(tdec.decode_splits).parameters)
    assert params == ["B", "Hkv", "S", "sm_count"]
    src = inspect.getsource(tdec._launch)
    assert "decode_splits(B, Hkv, S," in src
    for banned in ("lengths.cpu", "lengths.tolist", "lengths.item",
                   "synchronize"):
        assert banned not in src


@pytest.mark.parametrize("G,D", [(1, 64), (3, 128), (16, 256), (16, 32),
                                 (24, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shared_memory_fits(G, D, dtype):
    """Every group and head size the kernel takes fits in a block's
    shared memory (the mma path for bf16 at G >= 8, else CUDA cores)."""
    smem = tdec.smem_bytes(dtype, dtype, D, G)
    assert 0 < smem <= tdec._SMEM_LIMIT
