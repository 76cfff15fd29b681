"""PCCS slowdown surface: the hand-written CUDA kernel and its plain version.

``piecewise_slowdown`` launches ``csrc/slowdown.cu`` on CUDA tensors and
counts each launch in :data:`launches`; on CPU tensors it runs
:func:`piecewise_slowdown_torch`, the plain PyTorch version.  There is no
fallback between the two: a CUDA tensor the kernel cannot take raises.

Replaces the TPU kernel ``src/repro/kernels/slowdown.py`` (``_kernel``,
launched by ``_pallas_piecewise``).  The source note in the ``.cu`` file
says what bounds the kernel on the card and how its design answers that.
``backend="auto"`` dispatches by the tensor's device alone: the reference's
``_MIN_PALLAS_ELEMS`` threshold was a TPU launch-cost heuristic.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from . import ref as _ref

#: launches of the CUDA kernel since import (or since a caller reset it).
launches = 0

BACKENDS = ("auto", "cuda", "torch", "ref")
MAX_KNOTS = 32
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}
#: threads a block, and the most blocks before the grid strides (the
#: thread count of 132 x 16 blocks of 256, the first design's cap)
THREADS, MAX_BLOCKS = 128, 132 * 32


def launch_grid(n: int) -> tuple[int, int]:
    """(blocks, threads) of ``csrc/slowdown.cu`` for n elements: one
    thread an element in blocks of THREADS, at most MAX_BLOCKS blocks
    (beyond that the kernel's loop strides over the grid)."""
    return max(1, min(-(-n // THREADS), MAX_BLOCKS)), THREADS


def _lib() -> ctypes.CDLL:
    lib = _build.load("slowdown")
    fn = lib.piecewise_slowdown_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, ctypes.c_longlong, i, i, i, i, i,
                       p]
        fn.restype = ctypes.c_int
    return lib


def piecewise_slowdown(own, ext, own_knots, ext_knots, table, *,
                       backend: str = "auto"):
    """Batched PCCS slowdown over equal-shaped demand tensors.

    ``own``/``ext`` are demand fractions of any shape; ``own_knots`` (K,),
    ``ext_knots`` (M,) and ``table`` (K, M) are the calibration surface,
    cast to the demands' dtype.  Returns the elementwise slowdown (1.0
    wherever either demand is <= 0).  ``auto`` launches the kernel for a
    CUDA tensor and runs the plain version for a CPU tensor.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; have {BACKENDS}")
    ok = own_knots.to(own.dtype)
    ek = ext_knots.to(own.dtype)
    tab = table.to(own.dtype)
    if backend == "ref":
        return _ref.piecewise_slowdown(own, ext, ok, ek, tab)
    if backend == "torch" or (backend == "auto" and not own.is_cuda):
        return piecewise_slowdown_torch(own, ext, ok, ek, tab)
    return _launch(own, ext, ok, ek, tab)


def _launch(own, ext, ok, ek, tab):
    global launches
    tensors = (own, ext, ok, ek, tab)
    if not all(t.is_cuda and t.device == own.device for t in tensors):
        raise ValueError("piecewise_slowdown: demands, knots and table must "
                         "be on one CUDA device")
    if own.dtype not in _DTYPE_CODE or ext.dtype != own.dtype:
        raise TypeError(f"piecewise_slowdown: demands must be float32 or "
                        f"float64 alike, got {own.dtype}/{ext.dtype}")
    K, M = ok.shape[0], ek.shape[0]
    if (own.shape != ext.shape or ok.dim() != 1 or ek.dim() != 1
            or tab.shape != (K, M)):
        raise ValueError(f"piecewise_slowdown: bad shapes own"
                         f"{tuple(own.shape)} ext{tuple(ext.shape)} knots "
                         f"({K},)/({M},) table{tuple(tab.shape)}")
    if not (1 <= K <= MAX_KNOTS and 1 <= M <= MAX_KNOTS):
        raise NotImplementedError(f"piecewise_slowdown kernel: {K}x{M} "
                                  f"knots, at most {MAX_KNOTS} per axis")
    own_c, ext_c = own.contiguous(), ext.contiguous()
    ok, ek, tab = ok.contiguous(), ek.contiguous(), tab.contiguous()
    out = torch.empty_like(own_c)
    lib = _lib()
    stream = torch.cuda.current_stream(own.device).cuda_stream
    blocks, threads = launch_grid(own_c.numel())
    code = lib.piecewise_slowdown_fwd(
        own_c.data_ptr(), ext_c.data_ptr(), ok.data_ptr(), ek.data_ptr(),
        tab.data_ptr(), out.data_ptr(), own_c.numel(), K, M,
        _DTYPE_CODE[own.dtype], blocks, threads, stream)
    _build.check(lib, code, "piecewise_slowdown")
    launches += 1
    return out


def piecewise_slowdown_torch(own, ext, own_knots, ext_knots, table):
    """Plain PyTorch twin of the TPU kernel body: the hat-basis
    contraction ``sum((hatO @ table) * hatE, -1)`` over the flat demands,
    1.0 where own <= 0 or ext <= 0."""
    shape = own.shape
    ho = _ref._hat_weights(own_knots, own.reshape(-1))      # (N, K)
    he = _ref._hat_weights(ext_knots, ext.reshape(-1))      # (N, M)
    s = ((ho @ table) * he).sum(-1).reshape(shape)
    return torch.where((own <= 0.0) | (ext <= 0.0), torch.ones_like(s), s)
