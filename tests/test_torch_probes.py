"""Port parity: the streaming antagonist of repro_torch vs repro's.

``repro_torch.profiling.probes`` and the stream kernel's plain version
(``repro_torch.kernels.stream.stream_torch``) against
``repro.profiling.probes``, whose ``stream_once`` runs both its XLA
expression and its Pallas kernel in interpret mode here.  The same inputs,
made with numpy from a seed, go through both.  Tolerance: rtol = 1e-6,
the one ``tests/test_profiling.py`` holds the reference's two backends
to, of the result on the probe's own buffers and of the operands'
magnitude on signed inputs (XLA may contract the multiply-add into one
rounding; the port never does, so where x*c and y cancel the two differ
by an ulp of x*c).

Tests marked ``cuda`` hold the hand-written kernel against its plain
version bit for bit and check that a running probe does not stretch a
measurement on another stream; they skip on hosts without a CUDA device.
"""
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.profiling import probes as jprobes
from repro_torch.kernels import stream as tstream
from repro_torch.profiling import TimerConfig, measure_wallclock
from repro_torch.profiling import probes as tprobes

STREAM_RTOL = 1e-6
CPU = "cpu"


def stream_inputs(n, seed=0):
    """float32 operands over several magnitudes, both signs and zeros."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 10.0 ** rng.integers(-6, 7, n))
    y = (rng.standard_normal(n) * 10.0 ** rng.integers(-6, 7, n))
    x[::7] = 0.0
    return x.astype(np.float32), y.astype(np.float32)


# ---------------------------------------------------------------------------
# plain version vs the reference's two backends
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("n", [1, 3, 4097, 20000])
def test_plain_vs_reference(backend, n):
    x, y = stream_inputs(n)
    want = np.asarray(jprobes.stream_once(jnp.asarray(x), jnp.asarray(y),
                                          backend=backend))
    got = tprobes.stream_once(torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.float32 and got.shape == (n,)
    # XLA may fuse x*c + y into one rounding; where x*c and y cancel that
    # differs from two roundings by an ulp of x*c, not of the result, so
    # the rtol applies to the operands' magnitude |x*c| + |y|
    scale = np.abs(x.astype(np.float64)) * tstream.SCALE + np.abs(y)
    err = np.abs(got.numpy().astype(np.float64) - want)
    assert (err <= STREAM_RTOL * scale).all(), float((err / scale).max())


@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
def test_plain_vs_reference_on_probe_buffers(backend):
    jx, jy = jprobes.make_buffers(0.02)
    tx, ty = tprobes.make_buffers(0.02, device=CPU)
    want = np.asarray(jprobes.stream_once(jx, jy, backend=backend))
    got = tprobes.stream_once(tx, ty, backend="torch")
    np.testing.assert_allclose(got.numpy(), want, rtol=STREAM_RTOL)


def test_scale_is_the_float32_of_the_reference():
    assert np.float32(tstream.SCALE) == np.float32(1.0000001)
    assert float(np.float32(tstream.SCALE)) == tstream.SCALE


@pytest.mark.parametrize("mbytes", [0.02, 1.0, 32.0])
def test_make_buffers_and_stream_bytes_equal(mbytes):
    jx, jy = jprobes.make_buffers(mbytes)
    tx, ty = tprobes.make_buffers(mbytes, device=CPU)
    assert tx.dtype == ty.dtype == torch.float32
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    assert tprobes.stream_bytes(tx) == jprobes.stream_bytes(jx)


def test_backends_dispatch_and_refuse():
    x, y = (torch.from_numpy(a) for a in stream_inputs(64))
    before = tstream.launches
    auto = tprobes.stream_once(x, y)
    assert torch.equal(auto, tstream.stream_torch(x, y))
    assert torch.equal(tprobes.stream_once(x, y, backend="torch"), auto)
    assert tstream.launches == before          # no kernel for CPU tensors
    with pytest.raises(ValueError, match="CUDA"):
        tprobes.stream_once(x, y, backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        tprobes.stream_once(x, y, backend="xla")


def test_peak_bandwidth_on_cpu_is_positive():
    rate = tprobes.measure_peak_bandwidth(
        mbytes=0.05, timer=TimerConfig(warmup=1, repeats=3), device=CPU)
    assert rate > 0.0


# ---------------------------------------------------------------------------
# the MemoryProbe thread
# ---------------------------------------------------------------------------
def test_memory_probe_lifecycle():
    probe = tprobes.MemoryProbe(demand=0.5, mbytes=0.05, period_ms=2.0,
                                device=CPU)
    with probe:
        time.sleep(0.05)
        with pytest.raises(RuntimeError):
            probe.start()
    assert probe.passes > 0
    assert probe.elapsed_s >= 0.05
    assert probe.achieved_bytes_per_s() == pytest.approx(
        probe.passes * probe.bytes_per_pass() / probe.elapsed_s)
    assert probe.bytes_per_pass() == tprobes.stream_bytes(
        tprobes.make_buffers(0.05, device=CPU)[0])
    probe.stop()                          # idempotent


@pytest.mark.parametrize("demand", [0.0, -0.2, 1.5])
def test_probe_demand_validated(demand):
    with pytest.raises(ValueError):
        tprobes.MemoryProbe(demand=demand, device=CPU)
    with pytest.raises(ValueError):
        jprobes.MemoryProbe(demand=demand)


def test_probe_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tprobes.MemoryProbe(demand=0.5)


# ---------------------------------------------------------------------------
# card only: the hand-written kernel vs its plain version
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel is built with nvcc "
                    "for sm_90a)")
    return torch.device("cuda")


def special_values(n, dev):
    """±0, subnormals, ±inf and NaN mixed into ordinary values."""
    x, y = (torch.from_numpy(a).to(dev) for a in stream_inputs(n, seed=3))
    specials = torch.tensor([0.0, -0.0, 1e-40, -1e-40, 1e-45, float("inf"),
                             -float("inf"), float("nan"), 3.4e38, -3.4e38],
                            dtype=torch.float32, device=dev)
    k = min(n, specials.numel())
    x[:k] = specials[:k]
    y[:k] = specials.flip(0)[:k]
    return x, y


def bits(t):
    return t.contiguous().view(torch.int32).cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 4097, (1 << 20) + 3])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_kernel_vs_plain_bitwise(cuda_device, n, offset):
    x, y = special_values(n + offset, cuda_device)
    x, y = x[offset:], y[offset:]
    before = tstream.launches
    got = tstream.stream(x, y)
    torch.cuda.synchronize()
    assert tstream.launches == before + 1
    assert got.shape == (n,)
    assert torch.equal(bits(got), bits(tstream.stream_torch(x, y)))


@pytest.mark.cuda
def test_kernel_mixed_offsets_bitwise(cuda_device):
    """x and y at different offsets modulo 16 bytes: the scalar path."""
    x, y = special_values(5001, cuda_device)
    got = tstream.stream(x[1:4001], y[2:4002])
    assert torch.equal(bits(got),
                       bits(tstream.stream_torch(x[1:4001], y[2:4002])))


@pytest.mark.cuda
def test_probe_does_not_stretch_an_idle_measurement(cuda_device):
    """A full-duty probe on its own stream, with 1 GB passes (~0.3 ms
    each), does not lengthen a no-op measurement on the caller's stream:
    the harness waits for its own stream only."""
    timer = TimerConfig(warmup=2, repeats=31)
    tstream.stream(*tprobes.make_buffers(0.01, device=cuda_device))  # build
    idle = measure_wallclock(lambda: None, timer=timer).median_ms
    probe = tprobes.MemoryProbe(demand=1.0, mbytes=1000.0,
                                device=cuda_device)
    with probe:
        time.sleep(0.05)
        busy = measure_wallclock(lambda: None, timer=timer).median_ms
    assert probe.passes > 0
    pass_ms = probe.elapsed_s * 1e3 / probe.passes
    assert pass_ms > 0.25
    assert busy < idle + 0.1, (idle, busy, pass_ms)
