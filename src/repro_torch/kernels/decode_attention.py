"""Decode attention: the hand-written CUDA kernel and its plain version.

``decode_attention`` launches ``csrc/decode_attention.cu`` on CUDA tensors
and counts each launch in :data:`launches`; on CPU tensors it runs
:func:`decode_attention_torch`, the plain PyTorch version.  There is no
fallback between the two: a CUDA tensor the kernel cannot take raises.

Replaces the TPU kernel ``src/repro/kernels/decode_attention.py``
(``_kernel``, launched by ``decode_attention``).  The source note in the
``.cu`` file says what bounds the kernel on the card and how its design
answers that.  The cache layout stays (B, S, Hkv, D), so the kernel reads
the port's KV cache in place.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

#: launches of the CUDA kernel since import (or since a caller reset it).
launches = 0

HEAD_DIMS = (32, 64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232448                 # bytes a block may use on Hopper


def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    fn = lib.decode_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib


def decode_attention(q, k_cache, v_cache, lengths):
    """q: (B, 1, Hq, D); caches: (B, S, Hkv, D); lengths: (B,) int32.

    Each sequence attends over its first ``lengths[b]`` cache positions.
    On a CUDA tensor this launches the kernel; on a CPU tensor it runs
    :func:`decode_attention_torch`.
    """
    if not q.is_cuda:
        return decode_attention_torch(q, k_cache, v_cache, lengths)
    return _launch(q, k_cache, v_cache, lengths)


def _launch(q, k, v, lengths):
    global launches
    if not (k.is_cuda and v.is_cuda and lengths.is_cuda
            and q.device == k.device == v.device == lengths.device):
        raise ValueError("decode_attention: q, caches and lengths must be on "
                         "one CUDA device")
    if q.dtype not in _DTYPE_CODE or k.dtype not in _DTYPE_CODE \
            or k.dtype != v.dtype:
        raise TypeError(f"decode_attention: q and caches must be float32 or "
                        f"bfloat16 (caches alike), got {q.dtype}/{k.dtype}/"
                        f"{v.dtype}")
    if lengths.dtype != torch.int32:
        raise TypeError(f"decode_attention: lengths must be int32, got "
                        f"{lengths.dtype}")
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    B, _, Hq, D = q.shape
    _, S, Hkv, Dk = k.shape
    if k.shape[0] != B or Dk != D or Hq % Hkv or lengths.shape != (B,):
        raise ValueError(f"decode_attention: incompatible q{tuple(q.shape)}, "
                         f"caches{tuple(k.shape)}, lengths"
                         f"{tuple(lengths.shape)}")
    if D not in HEAD_DIMS:
        raise NotImplementedError(f"decode_attention kernel: head dim {D} "
                                  f"not in {HEAD_DIMS}")
    G = Hq // Hkv
    smem = 4 * (128 * (D + 1) + 2 * G * D + 128 * G + 3 * G)
    if smem > _SMEM_LIMIT:
        raise NotImplementedError(f"decode_attention kernel: GQA group {G} "
                                  f"at head dim {D} needs {smem} B of shared "
                                  f"memory")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
            and lengths.is_contiguous()):
        raise ValueError("decode_attention: inputs must be contiguous")
    lib = _lib()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.decode_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), _DTYPE_CODE[q.dtype], _DTYPE_CODE[k.dtype], B, S, Hq,
        Hkv, D, 1.0 / math.sqrt(D), stream)
    _build.check(lib, code, "decode_attention")
    launches += 1
    return out


def decode_attention_torch(q, k_cache, v_cache, lengths):
    """Plain PyTorch twin of ``repro``'s ``_decode_xla``.

    Two differences from that twin make it compute what the TPU kernel
    computes: a length of 0 gives 0 (``_decode_xla`` would average the
    whole cache), and values past the length are zeroed before the
    product (the kernel's 0 * NaN guard).
    """
    B, _, Hq, D = q.shape
    _, S, Hkv, Dv = v_cache.shape
    group = Hq // Hkv
    qg = q.float().reshape(B, Hkv, group, D) / math.sqrt(D)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float())
    valid = (torch.arange(S, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])                   # (B, S)
    s = s.masked_fill(~valid[:, None, None, :], -math.inf)
    m = s.amax(-1, keepdim=True).clamp_min(-1e30)
    p = torch.exp(s - m)
    vz = v_cache.float().masked_fill(~valid[:, :, None, None], 0.0)
    out = torch.einsum("bhgk,bkhe->bhge", p, vz) / p.sum(
        -1, keepdim=True).clamp_min(1e-30)
    return out.reshape(B, 1, Hq, Dv).to(q.dtype)
