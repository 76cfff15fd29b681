"""Decode attention: the hand-written CUDA kernel and its plain version.

``decode_attention`` launches ``csrc/decode_attention.cu`` on CUDA tensors
and counts each launch in :data:`launches`; on CPU tensors it runs
:func:`decode_attention_torch`, the plain PyTorch version.  There is no
fallback between the two: a CUDA tensor the kernel cannot take raises.

Replaces the TPU kernel ``src/repro/kernels/decode_attention.py``
(``_kernel``, launched by ``decode_attention``).  The source note in the
``.cu`` file says what bounds the kernel on the card and how its design
answers that: a split pass over tile-aligned ranges of the cache
(:func:`decode_splits`, :func:`split_chunk`) and a combine pass.
:func:`decode_attention_split_torch` is the plain twin of those two
passes, for the tests.  The cache layout stays (B, S, Hkv, D), so the
kernel reads the port's KV cache in place.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from .flash_attention import pad_head, padded_head_dim

#: launches of the CUDA kernel since import (or since a caller reset it):
#: one per wrapper call, whether it ran one pass or split and combine.
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232448                 # bytes a block may use on Hopper
#: split boundaries are multiples of this many cache rows (a kv tile of
#: either pass-1 kernel divides it)
SPLIT_ALIGN = 64
#: the wrapper aims for this many pass-1 blocks per SM
BLOCKS_PER_SM = 8
_THREADS = 128


def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    fn = lib.decode_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i,
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_splits(B: int, Hkv: int, S: int, sm_count: int = 132) -> int:
    """How many splits of the cache the kernel runs per (b, kv-head).

    A function of the shapes and the SM count only, never of the lengths
    (they stay on the device): enough splits that B * Hkv * splits reaches
    ``BLOCKS_PER_SM * sm_count``, as far as S has 64-row tiles for them.
    """
    tiles = max(1, -(-S // SPLIT_ALIGN))
    want = -(-BLOCKS_PER_SM * sm_count // max(1, B * Hkv))
    per = max(1, tiles // max(1, want))       # tiles per split
    return -(-tiles // per)


def split_chunk(S: int, splits: int) -> int:
    """Cache rows per split: a multiple of ``SPLIT_ALIGN``; ``splits``
    chunks cover S (trailing splits may be empty)."""
    tiles = max(1, -(-S // SPLIT_ALIGN))
    return -(-tiles // splits) * SPLIT_ALIGN


def smem_bytes(q_dtype, kv_dtype, D: int, G: int) -> int:
    """Dynamic shared memory of the pass-1 kernel ``csrc`` picks for these
    types, head size and group (``Mma<D>::SMEM``, ``Simt<...>::SMEM``)."""
    if q_dtype == kv_dtype == torch.bfloat16 and G >= 8:
        ld = D + 8
        region = max(2 * 2 * 64 * ld * 2, 4 * 16 * (D + 2) * 4)
        return region + 16 * ld * 2
    gc = 8 if G >= 8 else 4 if G >= 4 else 2 if G >= 2 else 1
    size = 4 if kv_dtype == torch.float32 else 2
    bkv = 32 if D * size > 512 else 64
    rows = _THREADS // (D * size // 16)
    region = max(2 * 2 * bkv * D * size, rows * gc * D * 4)
    return region + 4 * (gc * D + gc * bkv + 3 * gc)


def decode_attention(q, k_cache, v_cache, lengths):
    """q: (B, 1, Hq, D); caches: (B, S, Hkv, D); lengths: (B,) int32.

    Each sequence attends over its first ``lengths[b]`` cache positions.
    On a CUDA tensor this launches the kernel; on a CPU tensor it runs
    :func:`decode_attention_torch`.  A head size not in
    :data:`~repro_torch.kernels.flash_attention.HEAD_DIMS` (up to 256) is
    zero-padded to the next one, the scale kept at 1/sqrt(D) of the true
    D.  That copies the whole cache on every call, so it is for sizes no
    config uses (every config's head size is instantiated).
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
    Dp = padded_head_dim(D)
    G = Hq // Hkv
    smem = smem_bytes(q.dtype, k.dtype, Dp, G)
    if smem > _SMEM_LIMIT:
        raise NotImplementedError(f"decode_attention kernel: GQA group {G} "
                                  f"at head dim {D} needs {smem} B of shared "
                                  f"memory")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
            and lengths.is_contiguous()):
        raise ValueError("decode_attention: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("decode_attention: q and caches must be 16-byte "
                         "aligned (the kernel copies 16 bytes at a time)")
    if Dp != D:
        q, k, v = (pad_head(x, Dp) for x in (q, k, v))
    lib = _lib()
    out = torch.empty_like(q)
    index = q.device.index
    if index is None:
        index = torch.cuda.current_device()
    splits = decode_splits(B, Hkv, S, _sm_count(index))
    part_acc = part_ml = 0
    if splits > 1 and B:
        rows = B * Hq * splits
        scratch = torch.empty(rows * (Dp + 2), dtype=torch.float32,
                              device=q.device)
        part_acc = scratch.data_ptr()
        part_ml = scratch[rows * Dp:].data_ptr()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.decode_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), part_acc, part_ml, _DTYPE_CODE[q.dtype],
        _DTYPE_CODE[k.dtype], B, S, Hq, Hkv, Dp, splits,
        split_chunk(S, splits), 1.0 / math.sqrt(D), stream)
    _build.check(lib, code, "decode_attention")
    launches += 1
    return out if Dp == D else out[..., :D].contiguous()


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


def decode_attention_split_torch(q, k_cache, v_cache, lengths, splits: int):
    """Plain PyTorch twin of the kernel's two passes (tests only).

    Pass 1: split j owns cache rows ``[j * chunk, (j + 1) * chunk)`` with
    ``chunk = split_chunk(S, splits)``, and gives f32 partials (m, l, acc)
    per query head over the rows below the length (m = -1e30, l = 0,
    acc = 0 for a split with none).  Pass 2 rescales them by
    exp(m_j - max m), sums and divides by max(l, 1e-30).
    """
    B, _, Hq, D = q.shape
    _, S, Hkv, Dv = v_cache.shape
    G = Hq // Hkv
    chunk = split_chunk(S, splits)
    dev = q.device
    qg = q.float().reshape(B, Hkv, G, D) / math.sqrt(D)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float())   # (B,Hkv,G,S)
    pos = torch.arange(S, device=dev)
    length = lengths.to(dev).long().clamp(0, S)[:, None]         # (B, 1)
    ms, ls, accs = [], [], []
    for j in range(splits):
        live = (pos >= j * chunk) & (pos < (j + 1) * chunk) & (pos < length)
        sj = s.masked_fill(~live[:, None, None, :], -math.inf)
        m = sj.amax(-1).clamp_min(-1e30)                         # (B,Hkv,G)
        p = torch.exp(sj - m[..., None])
        vz = v_cache.float().masked_fill(~live[:, :, None, None], 0.0)
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bhgk,bkhe->bhge", p, vz))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    w = torch.exp(m - m.amax(0))
    out = (acc * w[..., None]).sum(0) / (l * w).sum(0).clamp_min(
        1e-30)[..., None]
    return out.reshape(B, 1, Hq, Dv).to(q.dtype)
