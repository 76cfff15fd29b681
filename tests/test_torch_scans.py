"""Port parity: the recurrent scans of repro_torch (RG-LRU and RWKV-6)
against repro's.

The same inputs, made with numpy from a seed, go through the port's plain
versions and oracles and ``repro``'s ``ref``, ``xla`` and
``pallas_interpret`` backends, at ``tests/test_kernels.py``'s shapes and
tolerances (scan: atol = rtol = 2e-5 in float32, 2e-2 in bfloat16;
RWKV-6: atol 1e-4 / 5e-2, rtol 5e-2).

Tests marked ``cuda`` hold the RG-LRU kernel against its plain version
bit for bit (at every served prefill length and through its element
copies), and the RWKV-6 kernel at every length of RWKV_TS and decay of
RWKV_DECAYS: its decode (T = 1) bit for bit, its chunked prefill within
rwkv_tol of the plain version and ``rwkv6.TWIN_TOL`` of its chunked twin;
they skip on hosts without a CUDA device.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rglru as trg
from repro_torch.kernels import rwkv6 as trk

from test_torch_kernels import cuda_device  # noqa: F401

SCAN_SHAPES = [(2, 64, 32), (1, 100, 256), (3, 33, 128)]   # (B, S, D)
#: rows whose byte stride is not a multiple of 16 (in bfloat16; D 6 in
#: float32 too), which the RG-LRU kernel reads by element copies, as a
#: ragged D is
RAGGED_SCANS = [(1, 9, 6), (1, 9, 36), (2, 5, 300)]
RWKV_SHAPES = [(1, 32, 2, 16, 16), (2, 17, 4, 32, 32),     # (B,T,H,D,Dv)
               (1, 64, 1, 64, 64)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}

def scan_tol(dtype):
    return (dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16"
            else dict(atol=2e-5, rtol=2e-5))


def rwkv_tol(dtype):
    return dict(atol=5e-2 if dtype == "bfloat16" else 1e-4, rtol=5e-2)


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def both(x, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def sigmoid(x):
    return (1.0 / (1.0 + np.exp(-x))).astype(np.float32)


def scan_inputs(seed, B, S, D):
    rng = np.random.default_rng(seed)
    a = sigmoid(rng.standard_normal((B, S, D)).astype(np.float32))
    b, h0 = (rng.standard_normal(s).astype(np.float32)
             for s in ((B, S, D), (B, D)))
    return a, b, h0


#: RWKV-6 decays: tests/test_kernels.py's sigmoid(N + 2); that with w = 0
#: and w = 1 exactly on some steps and channels; w in 0.01-0.05, whose
#: products leave 2^-64 within 16 steps; rwkv6-7b's own range, exp(-exp(w0
#: + lora)) around w0 = -6 (models/recurrent.py), ~0.9975
RWKV_DECAYS = ("sigmoid", "edges", "steep", "model")
#: RWKV-6 lengths: decode, and around the chunked kernel's 16-step chunks
#: (C - 1, C, C + 1, 2C + 1 for C = rwkv6.CHUNK)
RWKV_TS = (1, 2, 15, 16, 17, 33, 64, 65)


def rwkv_inputs(seed, B, T, H, D, Dv, decay="sigmoid"):
    """tests/test_kernels.py:129-137's distributions, w by ``decay`` (one
    of RWKV_DECAYS)."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    r, k, v = normal(B, T, H, D), normal(B, T, H, D) * 0.3, normal(B, T, H, Dv)
    w = sigmoid(normal(B, T, H, D) + 2.0)
    if decay == "edges":
        w[:, ::5, :, ::3] = 0.0
        w[:, 2::7, :, 1::4] = 1.0
    elif decay == "steep":
        w = rng.uniform(0.01, 0.05, (B, T, H, D)).astype(np.float32)
    elif decay == "model":
        w = np.exp(-np.exp(-6.0 + 0.5 * normal(B, T, H, D)))
        w = w.astype(np.float32)
    u = normal(H, D) * 0.3
    s0 = normal(B, H, D, Dv) * 0.1
    return r, k, v, w, u, s0


# ---------------------------------------------------------------------------
# the scans' plain versions and oracles
# ---------------------------------------------------------------------------
class TestLinearScanParity:
    @pytest.mark.parametrize("shape", SCAN_SHAPES + RAGGED_SCANS)
    @pytest.mark.parametrize("dtype", list(DTYPES))
    @pytest.mark.parametrize("with_h0", [False, True])
    def test_plain_vs_reference_backends(self, shape, dtype, with_h0):
        a, b, h0 = scan_inputs(0, *shape)
        (aj, at), (bj, bt), (hj, ht) = (both(x, dtype) for x in (a, b, h0))
        if not with_h0:
            hj = ht = None
        got, got_last = tops.linear_scan(at, bt, ht, backend="torch")
        assert got.dtype == at.dtype and got.shape == at.shape
        assert got_last.dtype == torch.float32
        for backend in ("xla", "pallas_interpret"):
            want, want_last = jops.linear_scan(aj, bj, hj, backend=backend)
            np.testing.assert_allclose(np32(got), np32(want), **scan_tol(dtype))
            np.testing.assert_allclose(np32(got_last), np32(want_last),
                                       **scan_tol(dtype))
        want, want_last = jref.linear_scan(aj, bj, hj)
        mine, mine_last = tops.linear_scan(at, bt, ht, backend="ref")
        assert mine_last.dtype == torch.float32
        for g in (got, mine):
            np.testing.assert_allclose(np32(g), np32(want), **scan_tol(dtype))
        for g in (got_last, mine_last):
            np.testing.assert_allclose(np32(g), np32(want_last),
                                       **scan_tol(dtype))

    @pytest.mark.parametrize("backend", ["torch", "ref"])
    def test_h_last_is_float32(self, backend):
        """ROADMAP.md's known reference inconsistency: ``repro``'s Pallas
        path returns h_last in a's dtype, its oracle and XLA path in
        float32; the port returns float32, exactly the float32 carry."""
        a, b, h0 = scan_inputs(1, 2, 9, 16)
        at, bt = (torch.from_numpy(x).to(torch.bfloat16) for x in (a, b))
        h, last = tops.linear_scan(at, bt, torch.from_numpy(h0),
                                   backend=backend)
        assert h.dtype == torch.bfloat16 and last.dtype == torch.float32
        _, want = jref.linear_scan(jnp.asarray(a).astype(jnp.bfloat16),
                                   jnp.asarray(b).astype(jnp.bfloat16),
                                   jnp.asarray(h0))
        assert np.asarray(want).dtype == np.float32
        np.testing.assert_allclose(last.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)

    def test_chunked_carry_equals_one_pass(self):
        """Scanning [0:k) then [k:S) with the carry passed on equals one
        scan (tests/test_kernels.py:103-116)."""
        a, b, _ = scan_inputs(2, 2, 48, 16)
        at, bt = torch.from_numpy(a), torch.from_numpy(b)
        full, last = tops.linear_scan(at, bt, backend="torch")
        k = 20
        _, h1 = tops.linear_scan(at[:, :k], bt[:, :k], backend="torch")
        h2_all, h2 = tops.linear_scan(at[:, k:], bt[:, k:], h1,
                                      backend="torch")
        np.testing.assert_allclose(h2.numpy(), last.numpy(), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(h2_all.numpy(), full[:, k:].numpy(),
                                   atol=1e-5, rtol=1e-5)


class TestRWKV6Parity:
    @pytest.mark.parametrize("shape", RWKV_SHAPES)
    @pytest.mark.parametrize("dtype", list(DTYPES))
    @pytest.mark.parametrize("with_state", [False, True])
    def test_plain_vs_reference_backends(self, shape, dtype, with_state):
        r, k, v, w, u, s0 = rwkv_inputs(3, *shape)
        pairs = [both(x, dtype) for x in (r, k, v, w, u)]
        js = [p[0] for p in pairs]
        ts = [p[1] for p in pairs]
        sj, st = ((jnp.asarray(s0), torch.from_numpy(s0)) if with_state
                  else (None, None))
        got, got_state = tops.rwkv6(*ts, st, backend="torch")
        assert got.dtype == ts[2].dtype and got.shape == ts[2].shape
        assert got_state.dtype == torch.float32
        tol = rwkv_tol(dtype)
        for backend in ("xla", "pallas_interpret"):
            want, want_state = jops.rwkv6(*js, sj, backend=backend)
            np.testing.assert_allclose(np32(got), np32(want), **tol)
            np.testing.assert_allclose(np32(got_state), np32(want_state),
                                       **tol)
        want, want_state = jref.rwkv6(*js, sj)
        mine, mine_state = tops.rwkv6(*ts, st, backend="ref")
        for g, gs in ((got, got_state), (mine, mine_state)):
            np.testing.assert_allclose(np32(g), np32(want), **tol)
            np.testing.assert_allclose(np32(gs), np32(want_state), **tol)

    def test_chunked_state_equals_one_pass(self):
        """Chunked evaluation with the state carried equals one pass
        (tests/test_kernels.py:142-159)."""
        r, k, v, w, u, _ = (torch.from_numpy(x)
                            for x in rwkv_inputs(4, 1, 40, 2, 16, 16))
        y_full, s_full = tops.rwkv6(r, k, v, w, u, backend="torch")
        cut = 23
        _, s1 = tops.rwkv6(r[:, :cut], k[:, :cut], v[:, :cut], w[:, :cut],
                           u, backend="torch")
        y2, s2 = tops.rwkv6(r[:, cut:], k[:, cut:], v[:, cut:], w[:, cut:],
                            u, s1, backend="torch")
        np.testing.assert_allclose(y2.numpy(), y_full[:, cut:].numpy(),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(s2.numpy(), s_full.numpy(), atol=1e-5,
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# card only: the hand-written scan kernels vs their plain versions
# ---------------------------------------------------------------------------
def _card(x, dtype, dev):
    return torch.from_numpy(x).to(dev).to(DTYPES[dtype][1])


#: recurrentgemma-9b's served prefills: one prompt of each length at d_rnn
#: 4096 (chip_smoke.py's RG_PROMPT_LENS)
SERVED_SCANS = [(1, s, 4096) for s in (8, 100, 513, 1000, 2300)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SCAN_SHAPES + RAGGED_SCANS
                         + [(4, 1, 4096), (1, 300, 4099)] + SERVED_SCANS)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_kernel_vs_plain(cuda_device, shape, dtype, with_h0):
    """The kernel walks each channel's time in the plain version's order
    and rounding, so they agree bit for bit."""
    a, b, h0 = scan_inputs(20, *shape)
    at, bt = (_card(x, dtype, cuda_device) for x in (a, b))
    ht = torch.from_numpy(h0).to(cuda_device) if with_h0 else None
    before = trg.launches
    got, got_last = tops.linear_scan(at, bt, ht)
    torch.cuda.synchronize()
    assert trg.launches == before + 1
    assert got_last.dtype == torch.float32
    want, want_last = trg.linear_scan_torch(at, bt, ht)
    assert torch.equal(got, want) and torch.equal(got_last, want_last)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(1, 300, 4096), (2, 65, 64)])
def test_rglru_kernel_element_copies(cuda_device, dtype, shape):
    """Inputs one element past a 16-byte boundary take the ring's element
    copies and give the same bits."""
    a, b, h0 = scan_inputs(23, *shape)
    n = a.size
    store = torch.empty(2 * n + 2, dtype=DTYPES[dtype][1],
                        device=cuda_device)
    at, bt = store[1:1 + n].view(shape), store[n + 2:].view(shape)
    at.copy_(_card(a, dtype, cuda_device))
    bt.copy_(_card(b, dtype, cuda_device))
    assert at.data_ptr() % 16 and bt.data_ptr() % 16
    ht = torch.from_numpy(h0).to(cuda_device)
    got = trg.rglru_scan(at, bt, ht)
    want = trg.linear_scan_torch(at.clone(), bt.clone(), ht)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _rwkv6_held(got, args, dtype):
    """The kernel's outputs as its form is held: T = 1 (the decode kernel)
    equal to the plain version bit for bit; the chunked prefill within
    rwkv_tol of it and within ``rwkv6.TWIN_TOL`` of its chunked twin."""
    want = trk.rwkv6_torch(*args)
    for g, x in zip(got, want):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(np32(g.cpu()), np32(x.cpu()),
                                   **rwkv_tol(dtype))
    if args[0].shape[1] == 1:
        assert all(torch.equal(g, x) for g, x in zip(got, want))
        return
    tol = trk.TWIN_TOL[DTYPES[dtype][1]]
    for name, g, x in zip(("y", "state"), got, trk.twin(*args)):
        np.testing.assert_allclose(np32(g.cpu()), np32(x.cpu()), **tol[name])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", RWKV_SHAPES + [(4, 1, 64, 64, 64),
                                                 (1, 33, 3, 16, 40)])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv6_kernel_vs_plain(cuda_device, shape, dtype, with_state):
    """T = 1 bit for bit; T > 1 (the chunked prefill) within rwkv_tol of
    the plain version and ``rwkv6.TWIN_TOL`` of its twin; the sequential
    form bit for bit."""
    r, k, v, w, u, s0 = rwkv_inputs(21, *shape)
    ts = [_card(x, dtype, cuda_device) for x in (r, k, v, w, u)]
    st = torch.from_numpy(s0).to(cuda_device) if with_state else None
    before = trk.launches
    got = tops.rwkv6(*ts, st)
    torch.cuda.synchronize()
    assert trk.launches == before + 1
    _rwkv6_held(got, (*ts, st), dtype)
    seq = trk.sequential_scan(*ts, st)
    assert all(torch.equal(g, x)
               for g, x in zip(seq, trk.rwkv6_torch(*ts, st)))


@pytest.mark.cuda
@pytest.mark.parametrize("T", RWKV_TS)
@pytest.mark.parametrize("decay", RWKV_DECAYS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rwkv6_kernel_edges_vs_plain(cuda_device, T, decay, dtype):
    """Around the chunk of 16 steps (C - 1, C, C + 1, 2C + 1), with w = 0
    and w = 1 exactly, steep decays (the pairwise form) and the model's
    own range; head sizes that the prefill's 32-column blocks, 16-byte
    pieces and the decode's 4-wide vectors do not divide: finite, T = 1
    bit for bit, T > 1 within rwkv_tol of the plain version and
    ``rwkv6.TWIN_TOL`` of the chunked twin."""
    for D, Dv, with_state in ((40, 24, True), (24, 40, False),
                              (20, 18, True)):
        r, k, v, w, u, s0 = rwkv_inputs(22 + T, 2, T, 2, D, Dv, decay)
        ts = [_card(x, dtype, cuda_device) for x in (r, k, v, w, u)]
        st = torch.from_numpy(s0).to(cuda_device) if with_state else None
        got = tops.rwkv6(*ts, st)
        torch.cuda.synchronize()
        _rwkv6_held(got, (*ts, st), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rwkv6_kernel_heads_independent(cuda_device, dtype):
    """A head's outputs are the same bits whether it is launched among 64
    heads or among 32 (a tensor-parallel rank's share of rwkv6-7b)."""
    r, k, v, w, u, s0 = rwkv_inputs(24, 1, 300, 64, 64, 64, "model")
    ts = [_card(x, dtype, cuda_device) for x in (r, k, v, w)]
    ut = _card(u, dtype, cuda_device)
    st = torch.from_numpy(s0).to(cuda_device)
    y, state = trk.rwkv6_scan(*ts, ut, st)
    y32, s32 = trk.rwkv6_scan(*(x[:, :, :32].contiguous() for x in ts),
                              ut[:32].contiguous(), st[:, :32].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(y32, y[:, :, :32]) and torch.equal(s32, state[:, :32])


@pytest.mark.cuda
def test_rwkv6_kernel_refuses_large_heads(cuda_device):
    x = torch.zeros(1, 2, 1, 128, device=cuda_device)
    with pytest.raises(NotImplementedError, match="head sizes"):
        trk.rwkv6_scan(x, x, x, x, torch.zeros(1, 128, device=cuda_device))
