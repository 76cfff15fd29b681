"""Flash attention: the hand-written CUDA kernel and its plain version.

``flash_attention`` launches ``csrc/flash_attention.cu`` on CUDA tensors
and counts each launch in :data:`launches`; on CPU tensors it runs
:func:`attention_torch`, the plain PyTorch version.  There is no fallback
between the two: a CUDA tensor the kernel cannot take raises.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py``
(``_kernel``, launched by ``flash_attention``).  The source note in the
``.cu`` file says what bounds the kernels on the card and how their
designs answer that.  The wrapper's one launch takes the kernel that
:func:`kernel_for` names (chosen in ``csrc`` by the dtype code and the
head size alone): the warp-specialised ``wgmma`` kernels
``flash_sm90`` for bfloat16 and ``flash_sm90_f32`` for float32 at
head sizes 64, 80, 128 and 256, every full-width model's (the first
TMA-fed; the second with each operand in TF32 hi and lo pieces, three
TF32 products a product, on 64-row blocks of one consumer warpgroup at
256); at 16 and 32, the reduced configs' sizes, the ``mma.sync`` kernel
``flash_mma`` for bfloat16 and the CUDA-core ``flash_kernel`` for
float32.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

#: launches of the CUDA kernel since import (or since a caller reset it).
launches = 0

#: head sizes the kernels are instantiated at; any other D <= 256 is
#: zero-padded up to the next of these (:func:`padded_head_dim`)
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the kernels of ``csrc/flash_attention.cu``, indexed by the code its
#: ``flash_attention_route`` returns
KERNELS = ("flash_kernel", "flash_mma", "flash_sm90", "flash_sm90_f32")
#: the head sizes ``flash_sm90`` (bfloat16) serves
SM90_HEAD_DIMS = (64, 80, 128, 256)
#: the head sizes ``flash_sm90_f32`` (float32) serves
SM90_F32_HEAD_DIMS = (64, 80, 128, 256)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if lib.flash_attention_fwd.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_fwd.argtypes = [p, p, p, p] + [i] * 9 + [f, p]
        lib.flash_attention_route.argtypes = [i, i]
        for fn in (lib.flash_attention_fwd, lib.flash_attention_route):
            fn.restype = i
    return lib


def kernel_for(dtype: torch.dtype, D: int) -> str:
    """The kernel a call of head size ``D`` in ``dtype`` launches on the
    card: one of :data:`KERNELS`, from the dtype and the padded head size
    alone (``csrc``'s ``route`` decides the same; the card tests hold the
    two together).  Raises as :func:`padded_head_dim` and for a dtype the
    kernels do not take."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention: no kernel for {dtype}")
    Dp = padded_head_dim(D)
    if dtype == torch.float32:
        return "flash_sm90_f32" if Dp in SM90_F32_HEAD_DIMS else "flash_kernel"
    return "flash_sm90" if Dp in SM90_HEAD_DIMS else "flash_mma"


def padded_head_dim(D: int) -> int:
    """The instantiated head size a head of ``D`` runs at: the smallest of
    :data:`HEAD_DIMS` that is >= D.  Raises ``NotImplementedError`` past
    256, the largest."""
    if not 1 <= D <= HEAD_DIMS[-1]:
        raise NotImplementedError(f"attention kernels: head dim {D} not in "
                                  f"[1, {HEAD_DIMS[-1]}]")
    return next(d for d in HEAD_DIMS if d >= D)


def pad_head(x, D: int):
    """``x`` with its last axis zero-padded to ``D`` (contiguous)."""
    return torch.nn.functional.pad(x, (0, D - x.shape[-1]))


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None):
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D).

    Queries are the last Sq of the Skv positions.  On a CUDA tensor this
    launches the kernel; on a CPU tensor it runs :func:`attention_torch`.
    A head size not in :data:`HEAD_DIMS` (up to 256) is zero-padded to the
    next one: zero columns leave q.k^T unchanged, the scale stays
    1/sqrt(D) of the true D, and the padded output columns are cut.  The
    padding copies q, k and v, so it is for sizes no config uses.
    """
    if not q.is_cuda:
        return attention_torch(q, k, v, causal=causal, window=window)
    return _launch(q, k, v, causal, window)


def check_args(q, k, v, window) -> int:
    """Refuse what the kernels do not take; return the padded head size.

    Everything :func:`flash_attention` checks before a launch but the
    device, so the CPU tests reach it."""
    if q.dtype not in _DTYPE_CODE or not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"flash_attention: q, k, v must share one dtype of "
                        f"float32/bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, Dk = k.shape
    if k.shape[0] != B or Dk != D or Hq % Hkv or Sq > Skv:
        raise ValueError(f"flash_attention: incompatible q{tuple(q.shape)} "
                         f"and k/v{tuple(k.shape)}")
    Dp = padded_head_dim(D)
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must be 16-byte aligned "
                         "(the bf16 kernels copy 16 bytes at a time)")
    return Dp


def _launch(q, k, v, causal, window):
    global launches
    if not (k.is_cuda and v.is_cuda and q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v must be on one CUDA device")
    Dp = check_args(q, k, v, window)
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1:3]
    if Dp != D:
        q, k, v = (pad_head(x, Dp) for x in (q, k, v))
    lib = _lib()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPE_CODE[q.dtype], B, Sq, Skv, Hq, Hkv, Dp, int(causal),
        -1 if window is None else int(window), 1.0 / math.sqrt(D), stream)
    _build.check(lib, code, "flash_attention")
    launches += 1
    return out if Dp == D else out[..., :D].contiguous()


def attention_torch(q, k, v, *, causal: bool = True,
                    window: int | None = None, block_kv: int = 1024):
    """Plain PyTorch twin of ``repro``'s ``_attention_xla``: the same
    blocked online softmax, as a loop over kv tiles of ``block_kv``.

    Masked scores get probability 0 (not ``exp(-1e30 - m)``), so a query
    with no live key returns 0 as the oracle does; every other row is the
    same sum as ``_attention_xla``'s.
    """
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, Dv = v.shape
    group = Hq // Hkv
    block_kv = int(min(block_kv, Skv))
    dev = q.device
    qg = (q.float() / math.sqrt(D)).reshape(B, Sq, Hkv, group, D)
    q_pos = torch.arange(Sq, device=dev) + (Skv - Sq)
    m = torch.full((B, Sq, Hkv, group), -1e30, device=dev)
    l = torch.zeros((B, Sq, Hkv, group), device=dev)
    acc = torch.zeros((B, Sq, Hkv, group, Dv), device=dev)
    for k0 in range(0, Skv, block_kv):
        kb = k[:, k0:k0 + block_kv].float()
        vb = v[:, k0:k0 + block_kv].float()
        s = torch.einsum("bqhgd,bkhd->bqhgk", qg, kb)
        k_pos = torch.arange(k0, k0 + kb.shape[1], device=dev)
        mask = torch.ones((Sq, kb.shape[1]), dtype=torch.bool, device=dev)
        if causal:
            mask &= k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            mask &= k_pos[None, :] > q_pos[:, None] - window
        s = s.masked_fill(~mask[None, :, None, None, :], -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bqhgk,bkhe->bqhge",
                                                    p, vb)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, Sq, Hq, Dv).to(q.dtype)
