"""Controllable memory-traffic antagonist (§4.2's co-run counterpart).

PCCS calibration needs (own, external) → slowdown samples, which means
co-running the target layer group against an antagonist that requests a
*known, controllable* share of the contention domain's bandwidth.  This
module is that antagonist:

* :func:`stream_once` — one streaming pass over a buffer (reads 2
  operands, writes 1: a saxpy): the hand-written CUDA kernel of
  :mod:`repro_torch.kernels.stream` for a CUDA tensor, its plain PyTorch
  version for a CPU tensor (``auto``), or either one by name.
* :func:`measure_peak_bandwidth` — calibrate the probe itself: achieved
  bytes/s of back-to-back full-duty streaming, which anchors duty-cycled
  demand levels to fractions of *measured* capacity.
* :class:`MemoryProbe` — a duty-cycled antagonist: ``demand=0.6``
  streams 60% of each period and idles 40%, so its requested throughput
  is ~0.6× the full-duty rate.  On the card it is one persistent launch
  of the stream kernel on its own CUDA stream, which holds the duty cycle
  by the device's clock on a capped share of the SMs
  (:func:`repro_torch.kernels.stream.duty_cycle`); on the CPU, a
  background thread issuing passes.  Used to sweep external demand
  against real kernel targets on the card; the virtual SoC takes the
  demand level directly (its ``external=`` knob) so CI never depends on
  wall-clock co-scheduling.

Counterpart of ``repro/profiling/probes.py``.  The sizes depend on the
device (:func:`probe_sizes`): on the CPU the reference's (an 8 MB probe
and target pass, a 32 MB peak pass), on the card passes of 1 GB, past
the H100's 50 MB L2, so that a co-run contends for HBM, not for L2.
"""
from __future__ import annotations

import dataclasses
import statistics
import threading
import time

import torch

from ..kernels import stream as _stream
from ..runtime import resolve_device
from .harness import TimerConfig, measure_device, measure_wallclock


@dataclasses.dataclass(frozen=True)
class ProbeSizes:
    """Calibration pass sizes (MB moved per pass) and the antagonist's
    shape for one device type."""

    #: the co-run target's pass
    target_mb: float
    #: the antagonist's buffer
    antagonist_mb: float
    #: the peak-bandwidth pass
    peak_mb: float
    #: the antagonist's duty period
    period_ms: float
    #: share of the SMs the antagonist may hold (None: a host thread)
    sm_share: float | None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


#: the reference's sizes (repro/profiling/probes.py:95,121 and
#: repro/launch/profile.py:91), which the CPU keeps
REFERENCE_SIZES = ProbeSizes(target_mb=8.0, antagonist_mb=8.0, peak_mb=32.0,
                             period_ms=5.0, sm_share=None)
#: on the card: every pass past the 50 MB L2; a 20 us period, so a ~0.35
#: ms target pass spans some 17 periods and sees the average demand, not
#: one phase; the antagonist on a quarter of the SMs, so the co-run
#: target keeps the rest of the card's SMs and the samples measure HBM,
#: not lost SMs
CUDA_SIZES = ProbeSizes(target_mb=1000.0, antagonist_mb=1000.0,
                        peak_mb=1000.0, period_ms=0.02, sm_share=0.25)


def probe_sizes(device) -> ProbeSizes:
    """The calibration sizes for ``device``'s type: :data:`CUDA_SIZES`
    on the card, the reference's :data:`REFERENCE_SIZES` elsewhere."""
    if resolve_device(device).type == "cuda":
        return CUDA_SIZES
    return REFERENCE_SIZES


def stream_once(x, y, *, backend: str = "auto"):
    """One antagonist pass: reads ``x``/``y`` fully, writes their saxpy.

    ``auto`` takes the kernel for a CUDA tensor and the plain version for
    a CPU tensor; ``cuda``/``torch`` name one.  No fallback."""
    return _stream.stream(x, y, backend=backend)


def make_buffers(mbytes: float = 32.0, *, device=None):
    """Streaming operand pair sized so one pass moves ~``mbytes`` MB, on
    ``device`` (``cuda`` unless asked otherwise)."""
    n = _elements(mbytes)
    x = torch.arange(n, dtype=torch.float32,
                     device=resolve_device(device)) * 1e-6
    return x, x + 1.0


def _elements(mbytes: float) -> int:
    return max(1024, int(mbytes * 1e6 / _stream.BYTES_PER_ELEM))


def pass_bytes(mbytes: float) -> float:
    """Traffic of one pass over :func:`make_buffers`' ``mbytes`` buffers
    (bytes)."""
    return float(_elements(mbytes) * _stream.BYTES_PER_ELEM)


def stream_bytes(x) -> float:
    """Traffic one :func:`stream_once` pass over ``x`` moves (bytes)."""
    return float(x.numel() * _stream.BYTES_PER_ELEM)


def measure_peak_bandwidth(*, mbytes: float | None = None,
                           backend: str = "auto",
                           timer: TimerConfig = TimerConfig(warmup=2,
                                                            repeats=5),
                           device=None) -> float:
    """Achieved bytes/s of full-duty streaming — the probe's own peak.

    Demand fractions handed to :class:`MemoryProbe` (and recorded in
    calibration samples) are relative to this measured rate, the same way
    the paper's "requested memory throughput (%)" is relative to measured
    EMC saturation, not the datasheet number.  ``mbytes`` defaults to
    the device's peak pass (:func:`probe_sizes`); a pass on the card is
    timed by the device's clock (:func:`~repro_torch.profiling.harness.
    measure_device`).
    """
    if mbytes is None:
        mbytes = probe_sizes(device).peak_mb
    x, y = make_buffers(mbytes, device=device)
    measure = measure_device if x.is_cuda else measure_wallclock
    m = measure(lambda: stream_once(x, y, backend=backend), timer=timer,
                name=f"stream-{mbytes}MB")
    return stream_bytes(x) / (m.median_ms * 1e-3)


class MemoryProbe:
    """Duty-cycled background antagonist.

    ``demand`` in (0, 1] is the fraction of each ``period_ms`` window spent
    streaming; the rest idles, so requested throughput scales linearly
    with ``demand`` while the *burst* rate stays at the device's streaming
    peak — the same shape PCCS's microbenchmark antagonists have.
    ``mbytes``, ``period_ms`` and ``sm_share`` default to the device's
    (:func:`probe_sizes`).

    With the kernel (``auto`` or ``cuda`` on the card) the probe is one
    persistent launch on its own CUDA stream that holds the duty cycle on
    the device, on the device's share of the SMs (:func:`probe_sizes`),
    until :meth:`stop` raises its device flag; :attr:`passes` is then the
    bytes it moved over the bytes of one pass, and the rate is taken over
    the device's own first-to-last streaming time.  Otherwise a host thread
    issues passes and idles by the host clock (synchronizing its own
    stream after each pass on the card).  Either way the measuring
    thread's current stream never waits for the probe, and nothing may
    synchronize the whole device while a kernel probe runs.
    """

    def __init__(self, demand: float = 1.0, *, mbytes: float | None = None,
                 backend: str = "auto", period_ms: float | None = None,
                 sm_share: float | None = None, device=None):
        if not 0.0 < demand <= 1.0:
            raise ValueError("demand must be in (0, 1]")
        sizes = probe_sizes(device)
        if sm_share is not None:
            sizes = dataclasses.replace(sizes, sm_share=sm_share)
        self.demand = float(demand)
        self.backend = backend
        self.period_s = (sizes.period_ms if period_ms is None
                         else period_ms) * 1e-3
        self._x, self._y = make_buffers(
            sizes.antagonist_mb if mbytes is None else mbytes, device=device)
        self._cuda = self._x.device.type == "cuda"
        self._stream = (torch.cuda.Stream(self._x.device) if self._cuda
                        else None)
        #: the duty-cycle kernel (one launch) rather than a host thread
        self.on_device = self._cuda and backend in ("auto", "cuda")
        if self.on_device:
            #: SMs the antagonist holds, one block each
            self.blocks = _stream.duty_blocks(self._x.device,
                                              sizes.sm_share)
            self._out = torch.empty_like(self._x)
            self._moved = torch.zeros(3, dtype=torch.int64,
                                      device=self._x.device)
            self._flag = torch.zeros(1, dtype=torch.int32,
                                     device=self._x.device)
            self._ctl = torch.cuda.Stream(self._x.device)
            self._running = False
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        #: streaming passes made (for achieved-rate accounting); a float on
        #: the device (bytes moved / bytes per pass)
        self.passes = 0
        #: seconds between the last start() and stop().
        self.elapsed_s = 0.0
        #: the device's first-to-last streaming seconds (kernel probe)
        self.device_s = 0.0
        self._t0 = 0.0

    def _loop(self):
        if self._cuda:
            with torch.cuda.stream(self._stream):
                self._run()
        else:
            self._run()

    def _run(self):
        burst_s = self.period_s * self.demand
        while not self._stop.is_set():
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < burst_s:
                stream_once(self._x, self._y, backend=self.backend)
                if self._cuda:
                    self._stream.synchronize()
                self.passes += 1
                if self._stop.is_set():
                    return
            idle = self.period_s - (time.perf_counter() - t0)
            if idle > 0:
                self._stop.wait(idle)

    def __enter__(self) -> "MemoryProbe":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def start(self) -> None:
        if self._thread is not None or (self.on_device and self._running):
            raise RuntimeError("probe already started")
        if self._cuda:
            # the buffers were made on the caller's stream
            self._stream.wait_stream(torch.cuda.current_stream(self._x.device))
        self._t0 = time.perf_counter()
        if self.on_device:
            with torch.cuda.stream(self._stream):
                self._flag.zero_()
                _stream.duty_cycle(self._x, self._y, self._out, self._moved,
                                   self._flag, demand=self.demand,
                                   period_ms=self.period_s * 1e3,
                                   blocks=self.blocks)
            self._running = True
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self.on_device:
            if not self._running:
                return
            with torch.cuda.stream(self._ctl):     # not behind the probe
                self._flag.fill_(1)
            self._stream.synchronize()
            self.elapsed_s = time.perf_counter() - self._t0
            self._running = False
            nbytes, self.device_s = _stream.moved_stats(self._moved)
            self.passes = nbytes / self.bytes_per_pass()
            return
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=10.0)
        if self._thread.is_alive():
            raise RuntimeError("memory probe thread did not stop in 10 s")
        self.elapsed_s = time.perf_counter() - self._t0
        self._thread = None

    def bytes_per_pass(self) -> float:
        return stream_bytes(self._x)

    def achieved_bytes_per_s(self) -> float:
        """Bytes the probe streamed over its last run's time: the device's
        first-to-last streaming time for the kernel probe (wall time if it
        streamed once or not at all), else the wall time."""
        span = self.device_s if self.device_s > 0 else self.elapsed_s
        return (self.passes * self.bytes_per_pass() / span
                if span > 0 else 0.0)


def stream_slowdowns(levels, *, sizes: ProbeSizes | None = None,
                     backend: str = "auto",
                     timer: TimerConfig = TimerConfig(),
                     device=None) -> tuple[float, list[dict]]:
    """The target stream pass's co-run slowdown at each demand level.

    At each level the target pass is timed alone and then beside a
    :class:`MemoryProbe` at that demand (each by ``timer``: CUDA events
    on the card, the host's clock elsewhere), and the level's ratio is
    co-run over the standalone pass timed just before it, so a drift of
    the standalone pass between levels does not enter the samples.
    (The reference times the standalone pass once, before the sweep.)

    Returns the median standalone ms and one record per level: both
    times, their ratio, the slowdown (the ratio floored at 1: a co-run
    read faster than standalone is noise) and what the antagonist did.
    """
    sizes = probe_sizes(device) if sizes is None else sizes
    x, y = make_buffers(sizes.target_mb, device=device)
    measure = measure_device if x.is_cuda else measure_wallclock

    def target():
        return stream_once(x, y, backend=backend)

    records = []
    for ext in levels:
        base = measure(target, timer=timer).median_ms
        probe = MemoryProbe(demand=ext, mbytes=sizes.antagonist_mb,
                            backend=backend, period_ms=sizes.period_ms,
                            sm_share=sizes.sm_share, device=device)
        with probe:
            co = measure(target, timer=timer).median_ms
        ratio = co / base
        records.append({
            "ext": float(ext), "base_ms": base, "co_ms": co,
            "ratio": ratio, "slowdown": max(1.0, ratio),
            "probe_launches": int(probe.on_device),
            "probe_passes": probe.passes,
            "probe_bytes_per_pass": probe.bytes_per_pass(),
            "probe_s": probe.elapsed_s,
            "probe_bytes_per_s": probe.achieved_bytes_per_s()})
        del probe   # its buffers go back to the allocator before the next
    return statistics.median(r["base_ms"] for r in records), records
