"""RG-LRU scan: the hand-written CUDA kernel and its plain version.

``rglru_scan`` launches ``csrc/rglru.cu`` on CUDA tensors and counts each
launch in :data:`launches`; on CPU tensors it runs
:func:`linear_scan_torch`, the plain PyTorch version.  There is no
fallback between the two: a CUDA tensor the kernel cannot take raises.

Replaces the TPU kernel ``src/repro/kernels/rglru.py`` (``_kernel``,
launched by ``rglru_scan``).  The source note in the ``.cu`` file says
what bounds the kernel on the card and how its design answers that.

``h_last`` is float32 on every path, as ``repro``'s oracle and XLA path
return it; ``repro``'s Pallas path alone returns ``a``'s dtype.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: launches of the CUDA kernel since import (or since a caller reset it).
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("rglru")
    fn = lib.rglru_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def rglru_scan(a, b, h0=None):
    """h_t = a_t h_{t-1} + b_t over axis 1.  a, b: (B, S, D); h0: (B, D)
    or None (zeros).  Returns (h_all (B, S, D) in a's dtype, h_last (B, D)
    float32).  On a CUDA tensor this launches the kernel; on a CPU tensor
    it runs :func:`linear_scan_torch`."""
    if not a.is_cuda:
        return linear_scan_torch(a, b, h0)
    return _launch(a, b, h0)


def _launch(a, b, h0):
    global launches
    tensors = (a, b) if h0 is None else (a, b, h0)
    if not all(t.is_cuda and t.device == a.device for t in tensors):
        raise ValueError("rglru_scan: a, b and h0 must be on one CUDA device")
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise TypeError(f"rglru_scan: a and b must share one dtype of "
                        f"float32/bfloat16, got {a.dtype}/{b.dtype}")
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"rglru_scan: bad shapes a{tuple(a.shape)} "
                         f"b{tuple(b.shape)}")
    B, S, D = a.shape
    if S < 1:
        raise ValueError(f"rglru_scan kernel: needs 1 <= S, got "
                         f"a{tuple(a.shape)}")
    if h0 is not None:
        if h0.shape != (B, D):
            raise ValueError(f"rglru_scan: h0{tuple(h0.shape)} is not "
                             f"({B}, {D})")
        h0 = h0.to(torch.float32).contiguous()
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("rglru_scan: a and b must be contiguous")
    lib = _lib()
    h = torch.empty_like(a)
    h_last = torch.empty((B, D), dtype=torch.float32, device=a.device)
    code = lib.rglru_fwd(
        a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(),
        h.data_ptr(), h_last.data_ptr(), _DTYPE_CODE[a.dtype], B, S, D,
        torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(lib, code, "rglru_scan")
    launches += 1
    return h, h_last


def linear_scan_torch(a, b, h0=None):
    """Plain PyTorch twin of ``repro``'s ``_linear_scan_xla``: the same
    recurrence, sequential over time in float32, the product and the sum
    rounded separately as the kernel rounds them."""
    B, S, D = a.shape
    hv = (torch.zeros((B, D), dtype=torch.float32, device=a.device)
          if h0 is None else h0.float())
    af, bf = a.float(), b.float()
    h = torch.empty_like(a)
    for t in range(S):
        hv = af[:, t] * hv + bf[:, t]
        h[:, t] = hv
    return h, hv
