"""RWKV-6 recurrence: the hand-written CUDA kernel and its plain version.

``rwkv6_scan`` launches ``csrc/rwkv6.cu`` on CUDA tensors and counts each
launch in :data:`launches`; on CPU tensors it runs :func:`rwkv6_torch`,
the plain PyTorch version.  There is no fallback between the two: a CUDA
tensor the kernel cannot take raises.

Replaces the TPU kernel ``src/repro/kernels/rwkv6.py`` (``_kernel``,
launched by ``rwkv6_scan``).  The source note in the ``.cu`` file says
what bounds the kernel on the card and how its design answers that.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

#: launches of the CUDA kernel since import (or since a caller reset it).
launches = 0

#: the largest head size (D and Dv) the kernel takes
MAX_HEAD = 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("rwkv6")
    fn = lib.rwkv6_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def rwkv6_scan(r, k, v, w, u, state0=None):
    """r, k, w: (B, T, H, D); v: (B, T, H, Dv); u: (H, D); state0:
    (B, H, D, Dv) or None (zeros).  Returns (y (B, T, H, Dv) in v's dtype,
    state (B, H, D, Dv) float32).  On a CUDA tensor this launches the
    kernel; on a CPU tensor it runs :func:`rwkv6_torch`."""
    if not r.is_cuda:
        return rwkv6_torch(r, k, v, w, u, state0)
    return _launch(r, k, v, w, u, state0)


def _launch(r, k, v, w, u, state0):
    global launches
    ins = (r, k, v, w, u)
    tensors = ins if state0 is None else ins + (state0,)
    if not all(t.is_cuda and t.device == r.device for t in tensors):
        raise ValueError("rwkv6_scan: all operands must be on one CUDA "
                         "device")
    if r.dtype not in _DTYPE_CODE or any(t.dtype != r.dtype for t in ins):
        raise TypeError("rwkv6_scan: r, k, v, w, u must share one dtype of "
                        f"float32/bfloat16, got {[t.dtype for t in ins]}")
    if r.dim() != 4 or k.shape != r.shape or w.shape != r.shape \
            or v.dim() != 4 or v.shape[:3] != r.shape[:3]:
        raise ValueError(f"rwkv6_scan: bad shapes r{tuple(r.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} "
                         f"w{tuple(w.shape)}")
    B, T, H, D = r.shape
    Dv = v.shape[-1]
    if u.shape != (H, D):
        raise ValueError(f"rwkv6_scan: u{tuple(u.shape)} is not ({H}, {D})")
    if not (1 <= D <= MAX_HEAD and 1 <= Dv <= MAX_HEAD):
        raise NotImplementedError(
            f"rwkv6_scan kernel: head sizes D={D}, Dv={Dv} outside "
            f"1..{MAX_HEAD}")
    if T < 1 or B > 65535:
        raise ValueError(f"rwkv6_scan kernel: needs 1 <= T and B <= 65535, "
                         f"got r{tuple(r.shape)}")
    if state0 is not None:
        if state0.shape != (B, H, D, Dv):
            raise ValueError(f"rwkv6_scan: state0{tuple(state0.shape)} is "
                             f"not ({B}, {H}, {D}, {Dv})")
        state0 = state0.to(torch.float32).contiguous()
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("rwkv6_scan: r, k, v, w, u must be contiguous")
    lib = _lib()
    y = torch.empty_like(v)
    state = torch.empty((B, H, D, Dv), dtype=torch.float32, device=r.device)
    code = lib.rwkv6_fwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        None if state0 is None else state0.data_ptr(), y.data_ptr(),
        state.data_ptr(), _DTYPE_CODE[r.dtype], B, T, H, D, Dv,
        torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(lib, code, "rwkv6_scan")
    launches += 1
    return y, state


def rwkv6_torch(r, k, v, w, u, state0=None):
    """Plain PyTorch twin of ``repro``'s ``_rwkv6_xla``: the same step,
    sequential over time in float32 (the state is float32, y is cast to
    v's dtype at the end).

    Each step's D terms of y are summed by halving (the first half plus
    the second, D padded with zeros to a power of two), where
    ``_rwkv6_xla`` leaves the order to XLA: the kernel, which rounds
    every op as these eager ops do and sums in the same order, equals this
    version bit for bit."""
    B, T, H, D = r.shape
    Dv = v.shape[-1]
    S = (torch.zeros((B, H, D, Dv), dtype=torch.float32, device=r.device)
         if state0 is None else state0.float())
    uf = u.float()[None, :, :, None]
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    y = torch.empty((B, T, H, Dv), dtype=torch.float32, device=r.device)
    width = 1 << (D - 1).bit_length()               # D padded to 2^n
    for t in range(T):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]    # (B, H, D, Dv)
        terms = (S + uf * kv) * rf[:, t, :, :, None]
        terms = F.pad(terms, (0, 0, 0, width - D))
        half = width // 2
        while half:
            terms = terms[:, :, :half] + terms[:, :, half:]
            half //= 2
        y[:, t] = terms[:, :, 0]
        S = wf[:, t, :, :, None] * S + kv
    return y.to(v.dtype), S
