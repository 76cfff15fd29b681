"""Port parity: the chunked RWKV-6 form of repro_torch against repro's.

``rwkv6_chunked_torch`` computes the recurrence in chunks of steps, a few
matrix products a chunk: the algorithm of the CUDA kernel's chunked
prefill, and at ``rwkv6.CHUNK`` (with ``split=True``, the bf16 kernel's
operand pieces) its plain twin; ``rwkv6_torch``, the plain version the
decode kernel repeats bit for bit, walks it step by step.  The same
inputs, made with numpy from a seed, go through the chunked form and
through ``repro.kernels.ops.rwkv6``'s ``xla`` and ``pallas_interpret``
backends, repro's oracle ``ref``, the port's oracle and the plain version,
at ``tests/test_kernels.py``'s tolerances (``rwkv_tol``: atol 1e-4 in
float32 and 5e-2 in bfloat16, rtol 5e-2).  The last tests hold
``chip_smoke.py``'s served verdict (``argmax_verdict``) on synthetic
logits.

Decays: ``tests/test_kernels.py``'s sigmoid(N + 2) (every chunk takes the
factorised form); that with w = 0 and w = 1 exactly on some steps and
channels; w in 0.01-0.05, whose products leave 2^-64 within a chunk (the
pairwise form without a zero); and rwkv6-7b's own range, exp(-exp(w0 +
lora)) around w0 = -6 (``models/recurrent.py``), ~0.9975.
"""
import importlib.util
from pathlib import Path

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


#: the kernel's chunk edges: C - 1, C, C + 1 and 2C + 1 steps
CHUNK_EDGES = (trk.CHUNK - 1, trk.CHUNK, trk.CHUNK + 1, 2 * trk.CHUNK + 1)


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("decay", RWKV_DECAYS)
@pytest.mark.parametrize("T", CHUNK_EDGES)
def test_kernel_chunk_edges(T, decay, with_state, split):
    """The chunked form at the CUDA kernel's chunk length, across its
    edges, at every decay (the factorised and the pairwise branch), and
    with ``split``, the kernel's bf16 operand pieces: within rwkv_tol of
    repro's xla and pallas_interpret backends, its oracle, and the
    port's."""
    r, k, v, w, u, s0 = inputs(50 + T, 2, T, 2, 40, 24, decay)
    pairs = [both(x, "float32") for x in (r, k, v, w, u)]
    js, ts = [p[0] for p in pairs], [p[1] for p in pairs]
    sj, st = ((jnp.asarray(s0), torch.from_numpy(s0)) if with_state
              else (None, None))
    got = trk.rwkv6_chunked_torch(*ts, st, trk.CHUNK, split)
    tol = rwkv_tol("float32")
    for backend in ("xla", "pallas_interpret"):
        check(got, jops.rwkv6(*js, sj, backend=backend), tol)
    check(got, jref.rwkv6(*js, sj), tol)
    check(got, tref.rwkv6(*ts, st), tol)


def test_chunk_edges_are_checked():
    """The lengths the card's checks use hold the kernel's chunk edges."""
    assert set(CHUNK_EDGES) <= set(RWKV_TS)


@pytest.mark.parametrize("form", ["chunked", "sequential"])
def test_cpu_tensors_take_the_plain_version(form):
    """On CPU tensors the served wrapper and the sequential yardstick are
    both the plain version."""
    scan = {"chunked": trk.rwkv6_scan, "sequential": trk.sequential_scan}
    r, k, v, w, u, s0 = (torch.from_numpy(x)
                         for x in inputs(61, 1, 20, 2, 16, 16))
    got = scan[form](r, k, v, w, u, s0)
    want = trk.rwkv6_torch(r, k, v, w, u, s0)
    assert all(torch.equal(g, x) for g, x in zip(got, want))


@pytest.mark.parametrize("decay", RWKV_DECAYS)
def test_split_models_bf16_operands(decay):
    """``split=True`` differs from the float32 chunked form by the
    operands' lost bits and the dropped piece products alone (below
    2^-16 x 2^-8 of a product): within float32 rounding of the largest
    output (2^-17 of it, a few of its ulps), and not zero."""
    r, k, v, w, u, s0 = (torch.from_numpy(x)
                         for x in inputs(60, 1, 2 * trk.CHUNK + 1, 2, 64,
                                         64, decay))
    exact = trk.rwkv6_chunked_torch(r, k, v, w, u, s0, trk.CHUNK)
    split = trk.rwkv6_chunked_torch(r, k, v, w, u, s0, trk.CHUNK, True)
    for a, b in zip(split, exact):
        err = float((a - b).abs().max())
        assert 0 < err <= 2.0 ** -17 * float(b.abs().max())
    x = torch.tensor([1.0 + 2.0 ** -10 + 2.0 ** -20, 3.0, -(1.0 + 2.0 ** -8)])
    pieces = trk.bf16_pieces(x)
    assert [p.tolist() for p in pieces] == [[1.0, 3.0, -1.0],
                                            [2.0 ** -10, 0.0, -2.0 ** -8],
                                            [2.0 ** -20, 0.0, 0.0]]
    assert torch.equal(pieces[0] + pieces[1] + pieces[2], x)


@pytest.fixture(scope="module")
def chip_smoke():
    """``chip_smoke.py`` as a module (it imports only the standard library
    and torch at top level)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _logits(seed, n=4096):
    return torch.from_numpy(np.random.default_rng(seed)
                            .standard_normal(n).astype(np.float32))


def test_verdict_passes_a_near_tie_within_the_spread(chip_smoke):
    """The plain path's top two 0.01 apart, a correct path 0.05 off at
    most: a kernel path that picks the second passes."""
    plain = _logits(1)
    top, second = torch.topk(plain, 2).indices.tolist()
    plain[second] = plain[top] - 0.01
    oracle = plain + 0.05 * torch.sign(_logits(2))
    kernel = plain.clone()
    kernel[second] = plain[top] + 0.005
    v = chip_smoke.argmax_verdict(kernel, plain, {"oracle": oracle})
    assert v["argmax"] == second and v["plain_argmax"] == top
    assert v["spread"] == pytest.approx(0.05, rel=1e-5)
    assert v["spread_path"] == "oracle"
    assert v["margin"] == pytest.approx(0.01, rel=1e-4)
    assert v["margin_limit"] == pytest.approx(chip_smoke.FLOOR_MARGIN * 0.05,
                                              rel=1e-5)
    assert v["argmax_ok"] and v["rel_ok"] and v["ok"]


def test_verdict_refuses_a_far_argmax(chip_smoke):
    """An argmax whose plain logit lies further below the maximum than
    FLOOR_MARGIN x the spread fails, however small the relative error."""
    plain = _logits(3)
    far = int(plain.argmin())
    plain[far] = plain.max() - 1.0
    kernel = plain.clone()
    kernel[far] = plain.max() + 0.001
    correct = {"oracle": plain + 0.05, "chunked": plain - 0.08}
    v = chip_smoke.argmax_verdict(kernel, plain, correct)
    assert v["spread_path"] == "chunked"
    assert v["spread"] == pytest.approx(0.08, rel=1e-5)
    assert v["rel_ok"] and v["rel_err"] < chip_smoke.E2E_REL_TOL
    assert v["margin"] > v["margin_limit"]
    assert not v["argmax_ok"] and not v["ok"]


def test_verdict_refuses_a_relative_error_past_the_limit(chip_smoke):
    """The same argmax but a relative error past max(E2E_REL_TOL,
    FLOOR_MARGIN x the largest correct path's) fails; just inside it
    passes."""
    plain = _logits(4)
    plain[int(plain.argmax())] += 5.0
    noise = _logits(5)
    correct = {"oracle": plain + 0.03 * noise, "chunked": plain + 0.1 * noise}
    floor = chip_smoke.rel_err(correct["chunked"], plain)
    assert floor > chip_smoke.E2E_REL_TOL
    for scale, ok in ((0.1 * chip_smoke.FLOOR_MARGIN * 1.1, False),
                      (0.1 * chip_smoke.FLOOR_MARGIN * 0.9, True)):
        v = chip_smoke.argmax_verdict(plain + scale * noise, plain, correct)
        assert v["floor_path"] == "chunked"
        assert v["limit"] == pytest.approx(chip_smoke.FLOOR_MARGIN * floor)
        assert v["argmax"] == v["plain_argmax"] and v["argmax_ok"]
        assert v["rel_ok"] is ok and v["ok"] is ok
