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
versions and skip on hosts without a CUDA device.
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
