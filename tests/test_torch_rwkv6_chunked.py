"""Port parity: the chunked RWKV-6 form of repro_torch against repro's.

``rwkv6_chunked_torch`` computes the recurrence in 16-step chunks, two
chained matrix products a chunk (the form a tensor-core kernel would
take); ``rwkv6_torch``, the plain version the CUDA kernel repeats bit for
bit, walks it step by step.  The same inputs, made with numpy from a
seed, go through the chunked form and through
``repro.kernels.ops.rwkv6``'s ``xla`` and ``pallas_interpret`` backends,
repro's oracle ``ref``, the port's oracle and the plain version, at
``tests/test_kernels.py``'s tolerances (``rwkv_tol``: atol 1e-4 in float32
and 5e-2 in bfloat16, rtol 5e-2).

Decays: ``tests/test_kernels.py``'s sigmoid(N + 2) (every chunk takes the
factorised form); that with w = 0 and w = 1 exactly on some steps and
channels; w in 0.01-0.05, whose products leave 2^-64 within a chunk (the
pairwise form without a zero); and rwkv6-7b's own range, exp(-exp(w0 +
lora)) around w0 = -6 (``models/recurrent.py``), ~0.9975.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv6 as trk

from test_torch_scans import (DTYPES, RWKV_DECAYS, RWKV_TS, both, np32,
                              rwkv_inputs as inputs, rwkv_tol)

HEADS = ((16, 16), (40, 64), (64, 40))             # (D, Dv)


def check(got, want, tol):
    for g, x in zip(got, want):
        g, x = np32(g), np32(x)
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, x, **tol)


def against_references(arrays, dtype, with_state, backends):
    """The chunked form against each of ``backends`` of repro and the
    port's sequential oracle; returns the chunked result."""
    r, k, v, w, u, s0 = arrays
    pairs = [both(x, dtype) for x in (r, k, v, w, u)]
    js, ts = [p[0] for p in pairs], [p[1] for p in pairs]
    sj, st = ((jnp.asarray(s0), torch.from_numpy(s0)) if with_state
              else (None, None))
    got = trk.rwkv6_chunked_torch(*ts, st)
    assert got[0].dtype == ts[2].dtype and got[0].shape == ts[2].shape
    assert got[1].dtype == torch.float32
    assert got[1].shape == (r.shape[0], r.shape[2], r.shape[3], v.shape[3])
    tol = rwkv_tol(dtype)
    for backend in backends:
        want = (jref.rwkv6(*js, sj) if backend == "ref"
                else jops.rwkv6(*js, sj, backend=backend))
        check(got, want, tol)
    check(got, tref.rwkv6(*ts, st), tol)
    return got


@pytest.mark.parametrize("T", RWKV_TS)
@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("with_state", [False, True])
def test_chunked_vs_reference_backends(T, heads, with_state):
    arrays = inputs(30 + T, 2, T, 2, *heads)
    against_references(arrays, "float32", with_state,
                       ("xla", "pallas_interpret", "ref"))


@pytest.mark.parametrize("decay", RWKV_DECAYS[1:])
@pytest.mark.parametrize("T", (1, 16, 17, 65))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decay_edges(decay, T, dtype):
    """w = 0 and w = 1 exactly, steep decays (the pairwise form) and the
    model's own range: finite and within the tolerance of every
    reference, with and without state0."""
    arrays = inputs(40 + T, 1, T, 3, 40, 24, decay)
    for with_state in (False, True):
        against_references(arrays, dtype, with_state, ("xla", "ref"))


def test_zero_decay_forgets():
    """A step with w = 0 on every channel empties the state: what came
    before it no longer reaches y past it, exactly."""
    r, k, v, w, u, s0 = (torch.from_numpy(x)
                         for x in inputs(5, 1, 40, 2, 16, 16))
    w[:, 20] = 0.0
    y, _ = trk.rwkv6_chunked_torch(r, k, v, w, u, s0)
    r2, k2, v2 = (x.clone() for x in (r, k, v))
    for x in (r2, k2, v2):
        x[:, :20] = torch.randn_like(x[:, :20])
    y2, _ = trk.rwkv6_chunked_torch(r2, k2, v2, w, u, None)
    assert torch.equal(y[:, 21:], y2[:, 21:])


@pytest.mark.parametrize("chunk", (1, 2, 4, 8, 32))
@pytest.mark.parametrize("decay", ("sigmoid", "edges"))
def test_chunk_length_free(chunk, decay):
    """Any chunk length gives the plain version's result within the
    float32 tolerance."""
    r, k, v, w, u, s0 = (torch.from_numpy(x)
                         for x in inputs(6, 2, 65, 2, 40, 24, decay))
    want = trk.rwkv6_torch(r, k, v, w, u, s0)
    check(trk.rwkv6_chunked_torch(r, k, v, w, u, s0, chunk), want,
          rwkv_tol("float32"))


@pytest.mark.parametrize("cut", (7, 16, 23, 40))
def test_cut_carries_state(cut):
    """Scanning [0, cut) and then [cut, T) with the state passed on
    equals one pass (tests/test_kernels.py:142-159), the cut off the
    chunk boundaries too."""
    r, k, v, w, u, s0 = (torch.from_numpy(x)
                         for x in inputs(7, 1, 57, 2, 16, 16, "edges"))
    y, s = trk.rwkv6_torch(r, k, v, w, u, s0)
    y1, s1 = trk.rwkv6_torch(*(x[:, :cut] for x in (r, k, v, w)), u, s0)
    y2, s2 = trk.rwkv6_torch(*(x[:, cut:] for x in (r, k, v, w)), u, s1)
    check((torch.cat([y1, y2], 1), s2), (y, s), rwkv_tol("float32"))
