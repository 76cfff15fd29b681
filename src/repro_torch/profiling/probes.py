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
* :class:`MemoryProbe` — a background thread issuing streaming passes at
  a duty cycle on its own CUDA stream: ``demand=0.6`` streams 60% of each
  period and idles 40%, so its requested throughput is ~0.6× the
  full-duty rate.  Used to sweep external demand against real kernel
  targets on the card; the virtual SoC takes the demand level directly
  (its ``external=`` knob) so CI never depends on wall-clock
  co-scheduling.

Counterpart of ``repro/profiling/probes.py``; the defaults (an 8 MB probe
pass, a 32 MB peak pass) are the reference's.  On an H100 both fit in the
50 MB L2, so at these sizes the antagonist contends for L2, not HBM.
"""
from __future__ import annotations

import threading
import time

import torch

from ..kernels import stream as _stream
from ..runtime import resolve_device
from .harness import TimerConfig, measure_wallclock


def stream_once(x, y, *, backend: str = "auto"):
    """One antagonist pass: reads ``x``/``y`` fully, writes their saxpy.

    ``auto`` takes the kernel for a CUDA tensor and the plain version for
    a CPU tensor; ``cuda``/``torch`` name one.  No fallback."""
    return _stream.stream(x, y, backend=backend)


def make_buffers(mbytes: float = 32.0, *, device=None):
    """Streaming operand pair sized so one pass moves ~``mbytes`` MB, on
    ``device`` (``cuda`` unless asked otherwise)."""
    n = max(1024, int(mbytes * 1e6 / _stream.BYTES_PER_ELEM))
    x = torch.arange(n, dtype=torch.float32,
                     device=resolve_device(device)) * 1e-6
    return x, x + 1.0


def stream_bytes(x) -> float:
    """Traffic one :func:`stream_once` pass over ``x`` moves (bytes)."""
    return float(x.numel() * _stream.BYTES_PER_ELEM)


def measure_peak_bandwidth(*, mbytes: float = 32.0, backend: str = "auto",
                           timer: TimerConfig = TimerConfig(warmup=2,
                                                            repeats=5),
                           device=None) -> float:
    """Achieved bytes/s of full-duty streaming — the probe's own peak.

    Demand fractions handed to :class:`MemoryProbe` (and recorded in
    calibration samples) are relative to this measured rate, the same way
    the paper's "requested memory throughput (%)" is relative to measured
    EMC saturation, not the datasheet number.
    """
    x, y = make_buffers(mbytes, device=device)
    m = measure_wallclock(lambda: stream_once(x, y, backend=backend),
                          timer=timer, name=f"stream-{mbytes}MB")
    return stream_bytes(x) / (m.median_ms * 1e-3)


class MemoryProbe:
    """Duty-cycled background antagonist thread.

    ``demand`` in (0, 1] is the fraction of each ``period_ms`` window spent
    streaming; the rest idles, so requested throughput scales linearly
    with ``demand`` while the *burst* rate stays at the device's streaming
    peak — the same shape PCCS's microbenchmark antagonists have.

    On the card the passes run on the probe's own CUDA stream, which the
    thread makes current for itself (the current stream is per thread),
    and the thread synchronizes that stream alone after each pass; the
    measuring thread's current stream never waits for the probe.
    """

    def __init__(self, demand: float = 1.0, *, mbytes: float = 8.0,
                 backend: str = "auto", period_ms: float = 5.0,
                 device=None):
        if not 0.0 < demand <= 1.0:
            raise ValueError("demand must be in (0, 1]")
        self.demand = float(demand)
        self.backend = backend
        self.period_s = period_ms * 1e-3
        self._x, self._y = make_buffers(mbytes, device=device)
        self._cuda = self._x.device.type == "cuda"
        self._stream = (torch.cuda.Stream(self._x.device) if self._cuda
                        else None)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        #: streaming passes issued (for achieved-rate accounting).
        self.passes = 0
        #: seconds between the last start() and stop().
        self.elapsed_s = 0.0
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
        if self._thread is not None:
            raise RuntimeError("probe already started")
        if self._cuda:
            # the buffers were made on the caller's stream
            self._stream.wait_stream(torch.cuda.current_stream(self._x.device))
        self._stop.clear()
        self._t0 = time.perf_counter()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
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
        """Bytes the probe streamed over its last run's wall time."""
        return (self.passes * self.bytes_per_pass() / self.elapsed_s
                if self.elapsed_s > 0 else 0.0)
