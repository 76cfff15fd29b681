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
kernel reads the port's KV cache in place, or a view of some of its kv
heads.

On a mesh whose KV cache is split by sequence, the two passes run as
entries of their own: :func:`decode_attention_partials` (the split pass
over a rank's chunk, counted in :data:`partials_launches`) and
:func:`decode_attention_combine` (the combine over every rank's
partials, :data:`combine_launches`), with the plain twins
:func:`decode_attention_partials_torch` and
:func:`decode_attention_combine_torch`.  They run eagerly (a mesh's
decode step is not captured), so :mod:`.graph` does not count them.
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
#: launches of the split pass alone (:func:`decode_attention_partials`)
#: and of the combine pass alone (:func:`decode_attention_combine`), the
#: two entries a sequence-split cache on a mesh runs
partials_launches = 0
combine_launches = 0

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
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, p, p] + [i] * 10 + [f, p]
        lib.decode_attention_partials.argtypes = (
            [p, p, p, p, p, p] + [i] * 11 + [f, p])
        lib.decode_attention_combine.argtypes = [p, p, p] + [i] * 5 + [p]
        for entry in (fn, lib.decode_attention_partials,
                      lib.decode_attention_combine):
            entry.restype = ctypes.c_int
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


def _check(q, k, v, lengths):
    """The kernel's contract on q, the caches and the lengths; returns the
    group size and the cache's row stride."""
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
    if not (q.is_contiguous() and lengths.is_contiguous()
            and _rows(k) is not None and _rows(k) == _rows(v)):
        raise ValueError("decode_attention: q must be contiguous and the "
                         "caches (B, S, Hkv, D) with dense heads and rows, "
                         "such as a view of some heads of a wider cache")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("decode_attention: q and caches must be 16-byte "
                         "aligned (the kernel copies 16 bytes at a time)")
    return G, _rows(k)


def _rows(x):
    """Elements between the rows of a (B, S, H, D) cache view whose heads
    and elements are dense and whose batch rows are S rows apart, else
    None."""
    B, S, H, D = x.shape
    st = x.stride()
    if st[3] != 1 or (H > 1 and st[2] != D) or st[1] < H * D \
            or (B > 1 and st[0] != S * st[1]) or (st[1] * x.element_size()) % 16:
        return None
    return st[1]


def _launch(q, k, v, lengths):
    global launches
    G, kv_row = _check(q, k, v, lengths)
    B, _, Hq, D = q.shape
    _, S, Hkv, _ = k.shape
    Dp = padded_head_dim(D)
    if Dp != D:
        q, k, v = (pad_head(x, Dp) for x in (q, k, v))
        kv_row = Hkv * Dp
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
        split_chunk(S, splits), kv_row, 1.0 / math.sqrt(D), stream)
    _build.check(lib, code, "decode_attention")
    launches += 1
    return out if Dp == D else out[..., :D].contiguous()


def decode_attention_partials(q, k_chunk, v_chunk, lengths,
                              offset: int = 0):
    """The split pass alone, over a chunk of a sequence-split cache.

    ``k_chunk``/``v_chunk`` (B, S, Hkv, D) hold sequence positions
    ``[offset, offset + S)``; sequence b's live rows there are the first
    ``clamp(lengths[b] - offset, 0, S)``.  Returns f32 ``(ml, acc)``:
    ``ml`` (B, Hq, J, 2) the running max and sum of each of J splits, and
    ``acc`` (B, Hq, J, D) its unnormalised output; a split with no live
    row gives m = -1e30, l = 0, acc = 0.  On a CUDA tensor
    this launches the kernel's split pass (J from :func:`decode_splits`);
    on a CPU tensor it runs :func:`decode_attention_partials_torch` with
    J = 1.  :func:`decode_attention_combine` merges any number of such
    partials concatenated on the J axis."""
    if not q.is_cuda:
        return decode_attention_partials_torch(q, k_chunk, v_chunk, lengths,
                                               offset)
    global partials_launches
    _, kv_row = _check(q, k_chunk, v_chunk, lengths)
    B, _, Hq, D = q.shape
    _, S, Hkv, _ = k_chunk.shape
    k, v = k_chunk, v_chunk
    Dp = padded_head_dim(D)
    if Dp != D:
        q, k, v = (pad_head(x, Dp) for x in (q, k, v))
        kv_row = Hkv * Dp
    index = q.device.index
    if index is None:
        index = torch.cuda.current_device()
    splits = decode_splits(B, Hkv, S, _sm_count(index))
    rows = B * Hq * splits
    flat = torch.empty(rows * (Dp + 2), dtype=torch.float32,
                       device=q.device)
    acc, ml = flat[:rows * Dp], flat[rows * Dp:]
    lib = _lib()
    code = lib.decode_attention_partials(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        acc.data_ptr(), ml.data_ptr(), _DTYPE_CODE[q.dtype],
        _DTYPE_CODE[k.dtype], B, S, Hq, Hkv, Dp, splits,
        split_chunk(S, splits), kv_row, int(offset), 1.0 / math.sqrt(D),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, code, "decode_attention_partials")
    partials_launches += 1
    acc = acc.view(B, Hq, splits, Dp)
    return ml.view(B, Hq, splits, 2), acc if Dp == D else acc[..., :D]


def decode_attention_combine(ml, acc, dtype=torch.float32):
    """The combine pass alone: ``ml`` (B, Hq, J, 2) and ``acc`` (B, Hq, J,
    D) f32 partials (:func:`decode_attention_partials`', concatenated on
    J) -> (B, 1, Hq, D) in ``dtype``: each partial rescaled by exp(m_j -
    max m), summed, divided by max(sum l, 1e-30), so all-empty partials
    give 0.  On CUDA tensors this launches the kernel's combine pass; on
    CPU tensors it runs :func:`decode_attention_combine_torch`."""
    if not acc.is_cuda:
        return decode_attention_combine_torch(ml, acc, dtype)
    global combine_launches
    B, Hq, J, D = acc.shape
    if ml.shape != (B, Hq, J, 2) or ml.dtype != torch.float32 \
            or acc.dtype != torch.float32 or ml.device != acc.device \
            or dtype not in _DTYPE_CODE:
        raise ValueError(f"decode_attention_combine: f32 ml (B, Hq, J, 2) "
                         f"and acc (B, Hq, J, D) on one device, got "
                         f"{tuple(ml.shape)} {ml.dtype} / {tuple(acc.shape)} "
                         f"{acc.dtype}, out {dtype}")
    ml, acc = ml.contiguous(), acc.contiguous()
    out = torch.empty((B, 1, Hq, D), dtype=dtype, device=acc.device)
    lib = _lib()
    code = lib.decode_attention_combine(
        acc.data_ptr(), ml.data_ptr(), out.data_ptr(), _DTYPE_CODE[dtype],
        B, Hq, D, J, torch.cuda.current_stream(acc.device).cuda_stream)
    _build.check(lib, code, "decode_attention_combine")
    combine_launches += 1
    return out


def decode_attention_partials_torch(q, k_chunk, v_chunk, lengths,
                                    offset: int = 0, splits: int = 1):
    """Plain twin of :func:`decode_attention_partials`: f32 ``(ml, acc)``
    of ``splits`` splits of ``split_chunk(S, splits)`` rows each, over the
    chunk's live rows (those below ``lengths - offset``)."""
    B, _, Hq, D = q.shape
    _, S, Hkv, Dv = v_chunk.shape
    G = Hq // Hkv
    chunk = split_chunk(S, splits)
    dev = q.device
    qg = q.float().reshape(B, Hkv, G, D) / math.sqrt(D)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_chunk.float())  # (B,Hkv,G,S)
    pos = torch.arange(S, device=dev)
    live_n = (lengths.to(dev).long() - int(offset)).clamp(0, S)[:, None]
    ml, accs = [], []
    for j in range(splits):
        live = (pos >= j * chunk) & (pos < (j + 1) * chunk) & (pos < live_n)
        sj = s.masked_fill(~live[:, None, None, :], -math.inf)
        m = sj.amax(-1).clamp_min(-1e30)                         # (B,Hkv,G)
        p = torch.exp(sj - m[..., None])
        vz = v_chunk.float().masked_fill(~live[:, :, None, None], 0.0)
        ml.append(torch.stack([m, p.sum(-1)], -1).reshape(B, Hq, 2))
        accs.append(torch.einsum("bhgk,bkhe->bhge", p, vz).reshape(B, Hq,
                                                                   Dv))
    return torch.stack(ml, 2), torch.stack(accs, 2)


def decode_attention_combine_torch(ml, acc, dtype=torch.float32):
    """Plain twin of :func:`decode_attention_combine`."""
    m, l = ml[..., 0], ml[..., 1]                               # (B,Hq,J)
    w = torch.exp(m - m.amax(-1, keepdim=True))
    out = (acc * w[..., None]).sum(2) / (l * w).sum(-1).clamp_min(
        1e-30)[..., None]
    return out[:, None].to(dtype)


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
