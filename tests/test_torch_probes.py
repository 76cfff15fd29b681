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
from repro_torch.profiling.harness import measurement_from_times

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
# calibration sizes by device
# ---------------------------------------------------------------------------
def test_cpu_keeps_the_reference_sizes():
    """On the CPU the probe, its peak pass and the CLI's target pass
    keep the reference's sizes (read from the reference's own defaults),
    so the CPU bundles still equal the reference's."""
    import inspect

    sizes = tprobes.probe_sizes(CPU)
    assert sizes == tprobes.REFERENCE_SIZES
    probe = inspect.signature(jprobes.MemoryProbe).parameters
    peak = inspect.signature(jprobes.measure_peak_bandwidth).parameters
    assert sizes.antagonist_mb == probe["mbytes"].default == 8.0
    assert sizes.period_ms == probe["period_ms"].default
    assert sizes.peak_mb == peak["mbytes"].default == 32.0
    assert sizes.target_mb == 8.0 and sizes.sm_share is None
    p = tprobes.MemoryProbe(demand=0.5, device=CPU)
    assert not p.on_device and p.period_s == sizes.period_ms * 1e-3
    assert p.bytes_per_pass() == tprobes.stream_bytes(
        tprobes.make_buffers(8.0, device=CPU)[0])


def test_card_passes_are_past_the_l2(monkeypatch):
    """On CUDA every pass is at least 256 MB (the H100's L2 holds 50
    MB) and the antagonist holds a quarter of the SMs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    sizes = tprobes.probe_sizes("cuda")
    assert sizes == tprobes.CUDA_SIZES
    assert min(sizes.target_mb, sizes.antagonist_mb, sizes.peak_mb) >= 256
    assert sizes.sm_share == 0.25
    # a target pass spans many duty periods, so it sees the mean demand
    assert sizes.period_ms < 0.1


def test_cli_records_the_probe_sizes_on_cpu(tmp_path):
    from repro_torch.launch.profile import main
    from repro_torch.profiling import ProfileBundle

    out = tmp_path / "torch.json"
    assert main(["--executor", "torch", "--reduced", "--device", "cpu",
                 "--seq", "16", "--batch", "1", "--repeats", "3",
                 "--warmup", "1", "--ext-levels", "0.5", "--fit",
                 "piecewise", "--max-groups", "1", "--out", str(out)]) == 0
    prov = ProfileBundle.load(out).provenance
    assert prov["probe"] == tprobes.REFERENCE_SIZES.to_dict()
    assert [c["probe_launches"] for c in prov["corun"]] == [0]


@pytest.mark.parametrize("mbytes", [0.001, 8.0, 1000.0])
def test_pass_bytes_equal_the_buffers(mbytes):
    n = tprobes._elements(mbytes)
    assert tprobes.pass_bytes(mbytes) == n * tstream.BYTES_PER_ELEM
    if mbytes <= 8.0:
        assert tprobes.pass_bytes(mbytes) == tprobes.stream_bytes(
            tprobes.make_buffers(mbytes, device=CPU)[0])


def test_stream_slowdowns_pair_each_co_run(monkeypatch):
    """Each co-run is divided by the standalone pass timed just before
    it: a standalone time drifting 10% a measurement leaves every ratio
    at the co-run's true 1.2, where one standalone reading before the
    sweep would not."""
    calls = []

    def fake(fn, *, timer, name=""):
        k = len(calls)
        calls.append(k)
        drift = 1.0 + 0.1 * (k // 2)
        ms = drift if k % 2 == 0 else 1.2 * drift
        return measurement_from_times(name, [ms], timer)

    monkeypatch.setattr(tprobes, "measure_wallclock", fake)
    sizes = tprobes.ProbeSizes(target_mb=0.01, antagonist_mb=0.01,
                               peak_mb=0.01, period_ms=1.0, sm_share=None)
    base_ms, recs = tprobes.stream_slowdowns(
        [0.5, 0.25, 1.0], sizes=sizes,
        timer=TimerConfig(warmup=0, repeats=1), device=CPU)
    assert len(calls) == 2 * 3
    assert [r["ext"] for r in recs] == [0.5, 0.25, 1.0]
    for i, r in enumerate(recs):
        assert r["base_ms"] == pytest.approx(1.0 + 0.1 * i)
        assert r["ratio"] == r["co_ms"] / r["base_ms"]
        assert r["ratio"] == pytest.approx(1.2, rel=1e-12)
        assert r["slowdown"] == r["ratio"]
        assert r["probe_launches"] == 0           # a host thread
    assert base_ms == pytest.approx(1.1)          # the median standalone


def test_stream_slowdowns_floor_at_one_on_cpu():
    sizes = tprobes.ProbeSizes(target_mb=0.05, antagonist_mb=0.05,
                               peak_mb=0.05, period_ms=1.0, sm_share=None)
    base_ms, recs = tprobes.stream_slowdowns(
        [0.5, 1.0], sizes=sizes, timer=TimerConfig(warmup=1, repeats=3),
        device=CPU)
    assert base_ms > 0 and [r["ext"] for r in recs] == [0.5, 1.0]
    for r in recs:
        assert r["slowdown"] == max(1.0, r["ratio"]) >= 1.0
        assert r["probe_bytes_per_pass"] == tprobes.pass_bytes(0.05)


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


@pytest.mark.cuda
@pytest.mark.parametrize("demand", [1.0, 0.1])
def test_duty_cycle_kernel_bitwise_and_stops(cuda_device, demand):
    """The duty-cycled antagonist on a quarter of the SMs: one launch, its
    output the plain version's bit for bit after its passes, and it stops
    soon after its flag is raised."""
    x, y = special_values(1 << 20, cuda_device)
    out = torch.zeros_like(x)
    moved = torch.zeros(3, dtype=torch.int64, device=cuda_device)
    flag = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    blocks = tstream.duty_blocks(cuda_device, 0.25)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert blocks == max(1, int(sms * 0.25))
    side, ctl = torch.cuda.Stream(), torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    before = tstream.launches
    with torch.cuda.stream(side):
        tstream.duty_cycle(x, y, out, moved, flag, demand=demand,
                           period_ms=0.02, blocks=blocks, max_s=10.0)
    assert tstream.launches == before + 1
    time.sleep(0.05)
    with torch.cuda.stream(ctl):
        flag.fill_(1)
    t0 = time.perf_counter()
    side.synchronize()
    assert time.perf_counter() - t0 < 1.0
    nbytes, span = tstream.moved_stats(moved)
    assert nbytes >= 12 * x.numel() and 0 < span < 1.0
    assert torch.equal(bits(out), bits(tstream.stream_torch(x, y)))


@pytest.mark.cuda
def test_card_probe_is_one_capped_launch(cuda_device):
    """On the card the probe is one launch of the duty-cycle kernel: its
    passes come from the device's byte count, and half the duty moves
    less than full duty."""
    rates = {}
    for demand in (1.0, 0.5):
        probe = tprobes.MemoryProbe(demand=demand, mbytes=256.0,
                                    device=cuda_device)
        assert probe.on_device
        before = tstream.launches
        with probe:
            time.sleep(0.05)
        assert tstream.launches == before + 1
        assert probe.passes > 1 and probe.device_s > 0
        rates[demand] = probe.achieved_bytes_per_s()
    assert rates[0.5] < 0.8 * rates[1.0], rates
