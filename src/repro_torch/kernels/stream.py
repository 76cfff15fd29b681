"""Streaming antagonist pass: the hand-written CUDA kernel and its plain
version.

``stream`` launches ``csrc/stream.cu`` on CUDA tensors and counts each
launch in :data:`launches`; on CPU tensors it runs :func:`stream_torch`,
the plain PyTorch version.  There is no fallback between the two: a CUDA
tensor the kernel cannot take raises.

Replaces the TPU kernel ``src/repro/profiling/probes.py`` (``_stream_kernel``,
launched by ``_pallas_stream``).  The source note in the ``.cu`` file says
what bounds the kernel on the card and how its design answers that.
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
    fn = lib.stream_fwd
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, ctypes.c_longlong, p]
        fn.restype = ctypes.c_int
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


def stream_torch(x, y):
    """Plain PyTorch twin of the TPU kernel body, ``x * c + y`` in float32
    (two eager ops: nothing contracts them into a fused multiply-add)."""
    return x * SCALE + y
