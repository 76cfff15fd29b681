"""Streaming antagonist pass: the hand-written CUDA kernel and its plain
version.

``stream`` launches ``csrc/stream.cu`` on CUDA tensors and counts each
launch in :data:`launches`; on CPU tensors it runs :func:`stream_torch`,
the plain PyTorch version.  There is no fallback between the two: a CUDA
tensor the kernel cannot take raises.

Replaces the TPU kernel ``src/repro/profiling/probes.py`` (``_stream_kernel``,
launched by ``_pallas_stream``).  The source note in the ``.cu`` file says
what bounds the kernel on the card and how its design answers that.

:func:`duty_cycle` launches the same saxpy as the co-run antagonist: one
persistent launch that holds its duty cycle on the device (the probe of
:class:`repro_torch.profiling.probes.MemoryProbe` on the card).  It counts
in :data:`launches` too, one per launch; the passes inside it come back
in its byte counter.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _build

#: launches of the CUDA kernel since import (or since a caller reset it).
#: The antagonist launches from its own thread, so the count is locked.
launches = 0
_count_lock = threading.Lock()

BACKENDS = ("auto", "cuda", "torch")
#: the float32 nearest 1.0000001, exactly (``jnp.float32(1.0000001)``).
SCALE = 1.00000011920928955
#: traffic of one element: x (read) + y (read) + out (write), float32.
BYTES_PER_ELEM = 3 * 4


def _lib() -> ctypes.CDLL:
    lib = _build.load("stream")
    if lib.stream_fwd.argtypes is None:
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.stream_fwd.argtypes = [p, p, p, ll, p]
        lib.stream_fwd.restype = ctypes.c_int
        lib.stream_duty_fwd.argtypes = [p, p, p, ll, ll, ll, ll, p, p,
                                        ctypes.c_int, p]
        lib.stream_duty_fwd.restype = ctypes.c_int
    return lib


def stream(x, y, *, backend: str = "auto"):
    """``x * SCALE + y`` over equal-shaped float32 tensors, the product and
    the sum each rounded to float32.  ``auto`` launches the kernel for a
    CUDA tensor and runs the plain version for a CPU tensor."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; have {BACKENDS}")
    if backend == "torch" or (backend == "auto" and not x.is_cuda):
        return stream_torch(x, y)
    return _launch(x, y)


def _launch(x, y):
    global launches
    if not (x.is_cuda and y.is_cuda and x.device == y.device):
        raise ValueError("stream: x and y must be on one CUDA device")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"stream: x and y must be float32, got "
                        f"{x.dtype}/{y.dtype}")
    if x.shape != y.shape:
        raise ValueError(f"stream: shapes differ, x{tuple(x.shape)} "
                         f"y{tuple(y.shape)}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("stream: x and y must be contiguous")
    n = x.numel()
    # the output shares x's offset modulo 16 bytes, so that an offset view
    # (x[1:], y[1:]) still takes the kernel's float4 path
    shift = (x.data_ptr() % 16) // 4
    out = torch.empty(n + shift, dtype=torch.float32,
                      device=x.device)[shift:].view(x.shape)
    lib = _lib()
    code = lib.stream_fwd(x.data_ptr(), y.data_ptr(), out.data_ptr(), n,
                          torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, "stream")
    with _count_lock:
        launches += 1
    return out


def duty_blocks(device, sm_share: float) -> int:
    """The antagonist's grid: ``sm_share`` of the card's SMs (at least
    one), one block each."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, int(sms * sm_share))


def duty_cycle(x, y, out, moved, stop, *, demand: float, period_ms: float,
               blocks: int, max_s: float = 60.0) -> None:
    """Launch the duty-cycled antagonist on the current stream and return.

    It streams ``out = x * SCALE + y`` over the buffers again and again
    for ``demand * period_ms`` of every ``period_ms`` (by the device's
    clock, all blocks in phase) and sleeps the rest, on ``blocks`` SMs,
    until ``stop`` (a one-element int32 device tensor) turns non-zero or
    ``max_s`` has passed.  ``moved`` (three int64 on the device) is reset
    here and collects the bytes moved and the first and last streaming
    times in ns (:func:`moved_stats`).  The buffers' first ``numel // 4 *
    4`` elements are streamed, so they must be 16-byte aligned.  Counted
    in :data:`launches`, once.
    """
    global launches
    if not (x.is_cuda and x.device == y.device == out.device
            == moved.device == stop.device):
        raise ValueError("duty_cycle: buffers, counter and flag must be on "
                         "one CUDA device")
    if not (x.dtype == y.dtype == out.dtype == torch.float32
            and x.shape == y.shape == out.shape and x.is_contiguous()
            and y.is_contiguous() and out.is_contiguous()):
        raise ValueError("duty_cycle: x, y and out must be contiguous "
                         "float32 of one shape")
    if moved.dtype != torch.int64 or moved.numel() != 3 \
            or stop.dtype != torch.int32 or stop.numel() != 1:
        raise TypeError("duty_cycle: moved must be 3 int64, stop 1 int32")
    if not 0.0 < demand <= 1.0:
        raise ValueError(f"duty_cycle: demand must be in (0, 1], got "
                         f"{demand}")
    period_ns = max(1, int(period_ms * 1e6))
    burst_ns = min(period_ns, max(1, round(demand * period_ns)))
    moved.copy_(torch.tensor([0, -1, 0], dtype=torch.int64))
    lib = _lib()
    code = lib.stream_duty_fwd(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel() // 4,
        period_ns, burst_ns, int(max_s * 1e9), stop.data_ptr(),
        moved.data_ptr(), int(blocks),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, "stream duty cycle")
    with _count_lock:
        launches += 1


def moved_stats(moved) -> tuple[int, float]:
    """``(bytes, seconds)`` from a finished :func:`duty_cycle`'s counter:
    the bytes it moved and the time from its first streaming unit to its
    last (0 s if it never streamed)."""
    nbytes, first, last = (int(v) for v in moved.cpu())
    span = (last - first) * 1e-9 if nbytes and last >= first >= 0 else 0.0
    return nbytes, span


def stream_torch(x, y):
    """Plain PyTorch twin of the TPU kernel body, ``x * c + y`` in float32
    (two eager ops: nothing contracts them into a fused multiply-add)."""
    return x * SCALE + y
