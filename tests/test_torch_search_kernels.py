"""Port parity: the search kernels of repro_torch vs repro's Pallas kernels.

The PCCS slowdown surface (``repro_torch.kernels.slowdown``) and the
annealing select step (``repro_torch.kernels.search``).  The same inputs,
made with numpy from a seed, go through ``repro``'s Pallas kernels in
interpret mode (as ``tests/test_kernels.py`` and ``tests/test_search.py``
run them on the CPU), ``repro``'s XLA oracles and the port's plain PyTorch
versions.  Tolerances: the slowdown at atol = rtol = 5e-6 in float32
(``tests/test_kernels.py:185``) and 1e-12 in float64 (the versions differ
only in summation order); the select step bit for bit.

Tests marked ``cuda`` hold the hand-written kernels against their plain
versions (the slowdown also bit for bit against ``slowdown_gather``, its
per-element formula written as gathers) and skip on hosts without a CUDA
device.
"""
import jax
import numpy as np
import pytest
import torch

from repro.kernels import search as jsearch
from repro.kernels import slowdown as jslow
from repro_torch.kernels import search as tsearch
from repro_torch.kernels import slowdown as tslow

from test_torch_core import one_thread  # noqa: F401


# ---------------------------------------------------------------------------
# plain versions vs the Pallas kernels and the oracles
# ---------------------------------------------------------------------------
#: tests/test_kernels.py:166-171 (non-square, non-uniform knots) and the
#: Fig.-6-shaped 5x5 PCCS surface of repro/profiling/virtual.py:42-50
SURFACES = {
    "test_kernels": ((0.2, 0.6, 1.0), (0.2, 0.5, 0.8, 1.1),
                     ((1.0, 1.1, 1.3, 1.5), (1.1, 1.4, 1.7, 1.9),
                      (1.3, 1.7, 2.2, 2.5))),
    "pccs": ((0.1, 0.3, 0.5, 0.7, 0.9), (0.1, 0.3, 0.5, 0.7, 0.9),
             ((1.00, 1.02, 1.06, 1.12, 1.20), (1.02, 1.08, 1.18, 1.32, 1.50),
              (1.05, 1.15, 1.32, 1.55, 1.82), (1.08, 1.24, 1.48, 1.80, 2.18),
              (1.12, 1.34, 1.64, 2.05, 2.60))),
    # a repeated knot: the max(k - kprev, 1e-30) guard of ref._hat_weights
    "repeated": ((0.2, 0.5, 0.5, 1.0), (0.3, 0.9),
                 ((1.0, 1.2), (1.1, 1.5), (1.2, 1.7), (1.4, 2.0))),
}
SLOW_TOL = {"float32": 5e-6, "float64": 1e-12}
FLOATS = {"float32": (np.float32, torch.float32),
          "float64": (np.float64, torch.float64)}


def slowdown_inputs(name, n, dtype, seed=0):
    """Demands over [-0.1, 1.4): zeros, negatives, outside the knots, and
    every own/ext knot pair exactly."""
    ok, ek, tab = SURFACES[name]
    rng = np.random.default_rng(seed)
    own = rng.uniform(-0.1, 1.4, size=n)
    ext = rng.uniform(-0.1, 1.4, size=n)
    grid = [(o, e) for o in ok for e in ek] + [(0.0, 0.7), (0.5, 0.0),
                                               (-1.0, 0.7), (2.0, 2.0)]
    for i, (o, e) in enumerate(grid[:n]):
        own[i], ext[i] = o, e
    np_dt = FLOATS[dtype][0]
    return (own.astype(np_dt), ext.astype(np_dt), np.asarray(ok, np_dt),
            np.asarray(ek, np_dt), np.asarray(tab, np_dt))


def to_torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


class TestSlowdownParity:
    @pytest.mark.parametrize("surface", list(SURFACES))
    @pytest.mark.parametrize("dtype", list(FLOATS))
    @pytest.mark.parametrize("n", [1, 777, 2048])     # 777: ragged block
    def test_plain_vs_pallas_and_oracle(self, surface, dtype, n):
        arrays = slowdown_inputs(surface, n, dtype)
        with jax.enable_x64(dtype == "float64"):
            pallas = np.asarray(jslow.piecewise_slowdown(
                *arrays, backend="pallas_interpret", block=256))
            oracle = np.asarray(jslow.piecewise_slowdown(*arrays,
                                                         backend="xla"))
        got = tslow.piecewise_slowdown(*to_torch(*arrays))
        assert got.dtype == FLOATS[dtype][1] and got.shape == (n,)
        tol = SLOW_TOL[dtype]
        np.testing.assert_allclose(got.numpy(), pallas, atol=tol, rtol=tol)
        np.testing.assert_allclose(got.numpy(), oracle, atol=tol, rtol=tol)
        mine = tslow.piecewise_slowdown(*to_torch(*arrays), backend="ref")
        np.testing.assert_allclose(mine.numpy(), oracle, atol=tol, rtol=tol)

    def test_zero_demand_is_identity(self):
        ok, ek, tab = (torch.tensor(x, dtype=torch.float64)
                       for x in SURFACES["test_kernels"])
        own = torch.tensor([0.0, 0.5, -1.0], dtype=torch.float64)
        ext = torch.tensor([0.7, 0.0, 0.7], dtype=torch.float64)
        out = tslow.piecewise_slowdown(own, ext, ok, ek, tab)
        assert out.tolist() == [1.0, 1.0, 1.0]

    def test_matches_scalar_model_at_knots_and_corners(self):
        from repro_torch.core.contention import PiecewiseModel
        ok, ek, tab = SURFACES["test_kernels"]
        m = PiecewiseModel(ok, ek, tab)
        pts = [(0.2, 0.5), (0.6, 1.1), (0.0, 0.9), (0.9, 0.0), (2.0, 2.0),
               (0.05, 0.05), (1.0, 1.1), (0.6, 0.8)]
        own = torch.tensor([o for o, _ in pts], dtype=torch.float64)
        ext = torch.tensor([e for _, e in pts], dtype=torch.float64)
        got = tslow.piecewise_slowdown(
            own, ext, *(torch.tensor(x, dtype=torch.float64)
                        for x in (ok, ek, tab)))
        want = [m.slowdown(o, e) for o, e in pts]
        np.testing.assert_allclose(got.numpy(), want, atol=1e-12)


#: tables for the kernel's per-element formula: one row (K = 1), one
#: column (M = 1), one entry, and 32 x 32 (the most the kernel takes,
#: read by __ldg rather than from the lanes), beside SURFACES
_K32 = np.sort(np.random.default_rng(7).uniform(0.0, 1.2, 32))
GATHER_SURFACES = dict(
    SURFACES,
    one_row=((0.4,), (0.1, 0.3, 0.5, 0.7, 0.9),
             ((1.00, 1.02, 1.06, 1.12, 1.20),)),
    one_column=((0.1, 0.3, 0.5, 0.7, 0.9), (0.6,),
                ((1.00,), (1.02,), (1.05,), (1.08,), (1.12,))),
    one_entry=((0.5,), (0.5,), ((1.3,),)),
    k32=(tuple(_K32), tuple(_K32),
         tuple(tuple(1.0 + 0.05 * i + 0.01 * j for j in range(32))
               for i in range(32))))


def slowdown_gather(own, ext, own_knots, ext_knots, table):
    """The kernel's per-element formula as gathers, op for op: on each
    axis the bracket (the last knot <= x, kept in [0, n - 2]), the two hat
    weights by the oracle's formula with all four divisions, then the
    two-level sum with the fmas the kernel writes out (fma(x, y, z * w)
    for x * y + z * w; on one row or column fma(w1, t[i+1], w0 * t[i])).
    ``torch.addcmul(z, x, y)`` is that fma on the card: it rounds once
    (test_addcmul_rounds_once_on_the_card)."""
    dt, dev = own.dtype, own.device
    tiny = torch.tensor(1e-30, dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)

    def hat(kprev, k, knext, first, last, x):
        dk0, dk1 = k - kprev, knext - k
        up = (x - kprev) / torch.where(dk0 > tiny, dk0, tiny)
        dn = (knext - x) / torch.where(dk1 > tiny, dk1, tiny)
        h = torch.where(up < dn, up, dn)
        h = torch.where(h < 0, zero, torch.where(h > 1, one, h))
        h = torch.where(first & (x <= k), one, h)
        return torch.where(last & (x >= k), one, h)

    def bracket(knots, x):
        n = knots.shape[0]
        i = torch.zeros(x.shape, dtype=torch.long, device=dev)
        for q in range(1, n - 1):
            i = torch.where(knots[q] <= x, q, i)
        km, k0, k1 = knots[(i - 1).clamp_min(0)], knots[i], knots[i + 1]
        k2 = knots[(i + 2).clamp_max(n - 1)]
        no = torch.zeros_like(i, dtype=torch.bool)
        return i, hat(km, k0, k1, i == 0, no, x), hat(k0, k1, k2, no,
                                                      i + 1 == n - 1, x)

    K, M = table.shape
    t = table.reshape(-1)
    if K == 1 and M == 1:
        s = t[0].expand(own.shape)
    elif K == 1:
        j, w0, w1 = bracket(ext_knots, ext)
        s = torch.addcmul(w0 * t[j], w1, t[j + 1])
    elif M == 1:
        i, w0, w1 = bracket(own_knots, own)
        s = torch.addcmul(w0 * t[i], w1, t[i + 1])
    else:
        i, hi0, hi1 = bracket(own_knots, own)
        j, hj0, hj1 = bracket(ext_knots, ext)
        r0 = i * M + j
        r1 = r0 + M
        a = torch.addcmul(t[r0 + 1] * hj1, t[r0], hj0)
        b = torch.addcmul(t[r1 + 1] * hj1, t[r1], hj0)
        s = torch.addcmul(hi1 * b, hi0, a)
    return torch.where((own <= 0) | (ext <= 0), one, s)


def gather_inputs(name, n, dtype, seed=3):
    """Demands over [-0.1, 1.4): every own/ext knot pair exactly, then
    random values; the knots and table of GATHER_SURFACES[name]."""
    ok, ek, tab = GATHER_SURFACES[name]
    rng = np.random.default_rng(seed)
    own = rng.uniform(-0.1, 1.4, size=n)
    ext = rng.uniform(-0.1, 1.4, size=n)
    pairs = [(o, e) for o in ok for e in ek]
    for i, (o, e) in enumerate(pairs[:n]):
        own[i], ext[i] = o, e
    np_dt = FLOATS[dtype][0]
    return to_torch(own.astype(np_dt), ext.astype(np_dt),
                    np.asarray(ok, np_dt), np.asarray(ek, np_dt),
                    np.asarray(tab, np_dt))


@pytest.mark.parametrize("surface", list(GATHER_SURFACES))
@pytest.mark.parametrize("dtype", list(FLOATS))
def test_gather_form_is_the_plain_version(surface, dtype):
    """The gather form computes the surface: it agrees with the plain
    version (the hat-basis contraction) within SLOW_TOL."""
    args = gather_inputs(surface, 3000, dtype)
    got = slowdown_gather(*args)
    want = tslow.piecewise_slowdown_torch(*args)
    tol = SLOW_TOL[dtype]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("n, want", [
    (1, (1, 128)), (128, (1, 128)), (129, (2, 128)), (8192, (64, 128)),
    (132 * 32 * 128, (132 * 32, 128)), (1 << 20, (132 * 32, 128))])
def test_slowdown_launch_grid(n, want):
    """One thread an element in blocks of 128 (the search's 8192 elements
    on 64 SMs), capped at 132 x 32 blocks, beyond which the kernel strides
    over the grid."""
    assert tslow.launch_grid(n) == want


def select_inputs(p=64, l=6, dtype=np.float32, seed=0):
    """tests/test_search.py:118-129, plus NaN, -inf and tied lanes."""
    rng = np.random.default_rng(seed)
    cur = rng.integers(0, 3, size=(p, l)).astype(np.int32)
    prop = rng.integers(0, 3, size=(p, l)).astype(np.int32)
    best = rng.integers(0, 3, size=(p, l)).astype(np.int32)
    curo = rng.uniform(1, 10, p).astype(dtype)
    propo = rng.uniform(1, 10, p).astype(dtype)
    besto = rng.uniform(1, 10, p).astype(dtype)
    propo[3] = np.inf            # error-poisoned lane
    propo[5], curo[5] = np.inf, np.inf        # inf - inf: NaN delta
    propo[7] = np.nan
    propo[9] = -np.inf
    propo[11] = besto[11]        # tie: strict < keeps the incumbent
    propo[13] = curo[13]         # delta 0 always accepts
    u = rng.uniform(0, 1, p).astype(dtype)
    temp = np.asarray(0.37, dtype)
    return cur, prop, best, curo, propo, besto, u, temp


class TestSelectParity:
    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    @pytest.mark.parametrize("p,temp", [(64, 0.37), (300, 0.37),
                                        (64, 1e-40), (64, 25.0)])
    def test_plain_vs_pallas_bitwise(self, dtype, p, temp):
        args = list(select_inputs(p=p, dtype=dtype))
        args[-1] = np.asarray(temp, dtype)
        with jax.enable_x64(dtype == np.float64):
            pallas = [np.asarray(x) for x in jsearch.anneal_select(
                *args, backend="pallas_interpret")]
            xla = [np.asarray(x) for x in jsearch.anneal_select(
                *args, backend="xla")]
        t = to_torch(*args[:-1])
        for backend in ("auto", "torch", "ref"):
            got = tsearch.anneal_select(*t, float(args[-1]), backend=backend)
            for g, want, ref in zip(got, pallas, xla):
                np.testing.assert_array_equal(g.numpy(), want)
                np.testing.assert_array_equal(g.numpy(), ref)

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_tensor_temperature_is_the_float_one(self, dtype):
        """A one-element tensor temperature decides as the float does."""
        args = to_torch(*select_inputs(p=300, dtype=dtype)[:-1])
        want = tsearch.anneal_select(*args, 0.37)
        for temp in (torch.tensor([0.37], dtype=args[3].dtype),
                     torch.tensor(0.37, dtype=args[3].dtype)):
            for g, w in zip(tsearch.anneal_select(*args, temp), want):
                np.testing.assert_array_equal(g.numpy(), w.numpy())

    def test_nonfinite_proposals_always_reject(self):
        cur, prop, best, curo, propo, besto, u, temp = select_inputs()
        propo[:] = -np.inf
        ncur, ncuro, _, _ = tsearch.anneal_select(
            *to_torch(cur, prop, best, curo, propo, besto, u), float(temp))
        np.testing.assert_array_equal(ncur.numpy(), cur)
        np.testing.assert_array_equal(ncuro.numpy(), curo)

    def test_dispatch_and_refusals(self, monkeypatch):
        def boom(*a, **k):
            raise AssertionError("kernel launched for a CPU tensor")
        monkeypatch.setattr(tsearch, "_launch", boom)
        monkeypatch.setattr(tslow, "_launch", boom)
        args = to_torch(*select_inputs()[:-1])
        assert tsearch.anneal_select(*args, 0.3)[0].shape == (64, 6)
        own, ext, ok, ek, tab = to_torch(*slowdown_inputs("pccs", 9,
                                                          "float64"))
        assert tslow.piecewise_slowdown(own, ext, ok, ek, tab).shape == (9,)
        monkeypatch.undo()
        with pytest.raises(ValueError, match="CUDA"):
            tsearch.anneal_select(*args, 0.3, backend="cuda")
        with pytest.raises(ValueError, match="CUDA"):
            tslow.piecewise_slowdown(own, ext, ok, ek, tab, backend="cuda")
        with pytest.raises(ValueError, match="unknown backend"):
            tslow.piecewise_slowdown(own, ext, ok, ek, tab,
                                     backend="pallas")
        with pytest.raises(ValueError, match="unknown backend"):
            tsearch.anneal_select(*args, 0.3, backend="xla")


#: row lengths L = w x gmax the search gives (gmax a power of two): the
#: kernel's 16-byte path at 64, its 4-byte path at 3, 6 and 130
SELECT_LS = (3, 6, 64, 130)


def select_forms(args, temp, backend="auto"):
    """The out-of-place result, then the same call in place into copies
    of the state (``out`` the state itself)."""
    cur, prop, best, curo, propo, besto, u = args
    want = tsearch.anneal_select(*args, temp, backend=backend)
    state = tuple(t.clone() for t in (cur, curo, best, besto))
    inplace = tsearch.anneal_select(state[0], prop, state[2], state[1],
                                    propo, state[3], u, temp, out=state,
                                    backend=backend)
    assert all(a is b for a, b in zip(inplace, state))
    return want, inplace


def assert_bits(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.cpu().numpy().tobytes() == w.cpu().numpy().tobytes()


class TestSelectOut:
    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    @pytest.mark.parametrize("l", SELECT_LS)
    @pytest.mark.parametrize("temp", [0.37, 1e-40])
    def test_out_forms_equal_the_out_of_place_form(self, dtype, l, temp):
        args = to_torch(*select_inputs(p=64, l=l, dtype=dtype)[:-1])
        want, inplace = select_forms(args, temp)
        assert_bits(inplace, want)
        for backend in ("torch", "ref"):
            for got in select_forms(args, temp, backend):
                assert_bits(got, want)

    def test_out_refusals(self):
        """``out`` is the state itself or nothing: fresh tensors, a
        mixture, a retyped or strided view of the state, and a state
        that overlaps the proposal or itself all raise."""
        args = to_torch(*select_inputs()[:-1])
        cur, prop, best, curo, propo, besto, u = args
        state = (cur, curo, best, besto)
        fresh = tuple(torch.empty_like(t) for t in state)
        bad = {
            "three tensors": state[:3],
            "fresh tensors": fresh,
            "mixed": (cur, curo, fresh[2], fresh[3]),
            "wrong type": (cur, curo.view(torch.uint8), best, besto),
            "not contiguous": (cur.t(), curo, best, besto),
        }
        for name, out in bad.items():
            with pytest.raises(ValueError, match="out"):
                tsearch.anneal_select(*args, 0.3, out=out)
        # the state may not be the proposal, nor share its own memory
        with pytest.raises(ValueError, match="out"):
            tsearch.anneal_select(cur, cur, best, curo, propo, besto, u,
                                  0.3, out=state)
        with pytest.raises(ValueError, match="out"):
            tsearch.anneal_select(cur, prop, cur, curo, propo, besto, u,
                                  0.3, out=(cur, curo, cur, besto))


# ---------------------------------------------------------------------------
# card only: the hand-written kernels vs their plain versions
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built with nvcc "
                    "for sm_90a)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("surface", list(SURFACES))
@pytest.mark.parametrize("dtype", list(FLOATS))
@pytest.mark.parametrize("n", [1, 1000, 1 << 20])
def test_slowdown_kernel_vs_plain(cuda_device, surface, dtype, n):
    arrays = [t.to(cuda_device) for t in to_torch(*slowdown_inputs(
        surface, n, dtype))]
    before = tslow.launches
    got = tslow.piecewise_slowdown(*arrays)
    torch.cuda.synchronize()
    assert tslow.launches == before + 1
    want = tslow.piecewise_slowdown_torch(*arrays)
    tol = SLOW_TOL[dtype]
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(FLOATS))
def test_addcmul_rounds_once_on_the_card(cuda_device, dtype):
    """slowdown_gather's premise: addcmul(z, x, y) is fma(x, y, z) on the
    card.  (1 + e)^2 - (1 + 2e) is e^2 exactly, and 0 when x * y is
    rounded first."""
    e = 2.0 ** (-30 if dtype == "float64" else -12)
    dt = FLOATS[dtype][1]
    x = torch.tensor([1 + e], dtype=dt, device=cuda_device)
    z = torch.tensor([-(1 + 2 * e)], dtype=dt, device=cuda_device)
    assert torch.addcmul(z, x, x).item() == e * e
    assert (x * x + z).item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("surface", list(GATHER_SURFACES))
@pytest.mark.parametrize("dtype", list(FLOATS))
@pytest.mark.parametrize("n", [1, 1000, 8192, 1 << 20])
def test_slowdown_kernel_bitwise_gather_form(cuda_device, surface, dtype,
                                             n):
    """The kernel equals its per-element formula (slowdown_gather) bit
    for bit: repeated knots, one row, one column, one entry, 5 x 5 and
    32 x 32 tables, both types; one element, a ragged length, one wave of
    the orin search (8192) and a length past the grid's cap."""
    args = [t.to(cuda_device) for t in gather_inputs(surface, n, dtype)]
    before = tslow.launches
    got = tslow.piecewise_slowdown(*args)
    torch.cuda.synchronize()
    assert tslow.launches == before + 1
    want = slowdown_gather(*args)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("p", [32, 4096, 65536])
@pytest.mark.parametrize("temp", [0.37, 1e-40])
def test_select_kernel_vs_plain_bitwise(cuda_device, dtype, p, temp):
    args = [t.to(cuda_device) for t in to_torch(
        *select_inputs(p=p, l=64, dtype=dtype)[:-1])]
    before = tsearch.launches
    got = tsearch.anneal_select(*args, temp)
    torch.cuda.synchronize()
    assert tsearch.launches == before + 1
    want = tsearch.anneal_select_torch(*args, temp)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("temp", [0.37, 1e-40, 25.0])
def test_select_kernel_reads_its_temperature_from_the_device(cuda_device,
                                                             dtype, temp):
    """The temperature as a one-element device tensor (a step's entry of
    the search's schedule, as the captured graph passes it) gives the
    plain version's decision bit for bit, as the Python float does, and
    is read on the device: under sync debug mode "error" a host read
    would raise."""
    args = [t.to(cuda_device) for t in to_torch(
        *select_inputs(p=4096, l=64, dtype=dtype)[:-1])]
    schedule = torch.tensor([9.0, temp, 3.0], dtype=args[3].dtype,
                            device=cuda_device)
    step = torch.ones(1, dtype=torch.int64, device=cuda_device)
    want = tsearch.anneal_select_torch(*args, temp)
    tsearch.anneal_select(*args, schedule[1:2])            # warm up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tsearch.anneal_select(*args, schedule.index_select(0, step))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())
    from_float = tsearch.anneal_select(*args, temp)
    for g, w in zip(from_float, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("p", [32, 4096, 65536])
@pytest.mark.parametrize("l", SELECT_LS)
def test_select_kernel_forms_vs_plain_bitwise(cuda_device, dtype, p, l):
    """Out of place and in place, at the search's row lengths (both the
    16-byte and the 4-byte path), each one launch, both equal to the
    plain version bit for bit; the 1e-30 clamp too."""
    args = [t.to(cuda_device) for t in to_torch(
        *select_inputs(p=p, l=l, dtype=dtype)[:-1])]
    for temp in (0.37, 1e-40):
        want = tsearch.anneal_select_torch(*args, temp)
        before = tsearch.launches
        forms = select_forms(args, temp)
        torch.cuda.synchronize()
        assert tsearch.launches == before + 2
        for got in forms:
            assert_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("l", [64, 130])
def test_select_kernel_offset_rows_take_the_scalar_path(cuda_device, dtype,
                                                        l):
    """Rows one int32 past a 16-byte boundary (views into a larger
    buffer) take the 4-byte path, out of place and in place, and still
    equal the plain version bit for bit."""
    host = to_torch(*select_inputs(p=4096, l=l, dtype=dtype)[:-1])
    args = [t.to(cuda_device) for t in host]

    def offset(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda_device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 == 4
        return view

    rows = [offset(t) for t in args[:3]]
    shifted = [rows[0], rows[1], rows[2], *args[3:]]
    for temp in (0.37, 1e-40):
        want = tsearch.anneal_select_torch(*args, temp)
        assert_bits(tsearch.anneal_select(*shifted, temp), want)
        state = (offset(args[0]), args[3].clone(), offset(args[2]),
                 args[5].clone())
        tsearch.anneal_select(state[0], rows[1], state[2], state[1],
                              args[4], state[3], args[6], temp, out=state)
        assert_bits(state, want)


@pytest.mark.cuda
def test_select_kernel_refuses_what_it_cannot_take(cuda_device):
    """No fallback: P * L past 32-bit offsets, and out other than the
    state itself, raise on the card."""
    args = [t.to(cuda_device) for t in to_torch(
        *select_inputs(p=64, l=64)[:-1])]
    cur, prop, best, curo, propo, besto, u = args
    with pytest.raises(ValueError, match="out"):
        tsearch.anneal_select(*args, 0.3,
                              out=(cur, torch.empty_like(curo),
                                   torch.empty_like(best),
                                   torch.empty_like(besto)))
    big = torch.zeros((1 << 31) // 64 + 1, 1, dtype=torch.int32,
                      device=cuda_device).expand(-1, 64)
    objs = torch.zeros(big.shape[0], dtype=torch.float32,
                       device=cuda_device)
    with pytest.raises(ValueError, match="2\\^31"):
        tsearch.anneal_select(big, big, big, objs, objs, objs, objs, 0.3)

