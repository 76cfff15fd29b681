"""RWKV-6 recurrence: the hand-written CUDA kernel and its plain version.

``rwkv6_scan`` launches ``csrc/rwkv6.cu`` on CUDA tensors and counts each
launch in :data:`launches`; on CPU tensors it runs :func:`rwkv6_torch`,
the plain PyTorch version.  There is no fallback between the two: a CUDA
tensor the kernel cannot take raises.

Replaces the TPU kernel ``src/repro/kernels/rwkv6.py`` (``_kernel``,
launched by ``rwkv6_scan``).  A prefill (T > 1) runs the chunked scan of
:func:`rwkv6_chunked_torch` on the tensor cores; its plain twin is
:func:`twin`, the tolerances it is held to :data:`TWIN_TOL` (against the
twin) and the reference's (against :func:`rwkv6_torch`).  A decode step
(T = 1) repeats :func:`rwkv6_torch`'s bits, and so does
:func:`sequential_scan`, the earlier step-by-step prefill, kept only as
the chunked one's yardstick (no served path calls it).  The source note in the ``.cu`` file says what bounds
the kernel on the card and how its design answers that.
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
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


#: the C entry's ``form`` for T > 1
_SEQUENTIAL, _CHUNKED = 0, 1


def rwkv6_scan(r, k, v, w, u, state0=None):
    """r, k, w: (B, T, H, D); v: (B, T, H, Dv); u: (H, D); state0:
    (B, H, D, Dv) or None (zeros).  Returns (y (B, T, H, Dv) in v's dtype,
    state (B, H, D, Dv) float32).  On a CUDA tensor this launches the
    kernel (T = 1: the decode kernel; else the chunked prefill) and counts
    the launch; on a CPU tensor it runs :func:`rwkv6_torch`."""
    global launches
    if not r.is_cuda:
        return rwkv6_torch(r, k, v, w, u, state0)
    out = _launch(r, k, v, w, u, state0, _CHUNKED)
    launches += 1
    return out


def sequential_scan(r, k, v, w, u, state0=None):
    """The step-by-step prefill kernel the chunked one replaced
    (``rwkv6_prefill`` in ``csrc/rwkv6.cu``), which repeats
    :func:`rwkv6_torch`'s bits: the yardstick the chunked prefill is timed
    and checked beside, on no served path, so not counted in
    :data:`launches`.  Arguments and results as :func:`rwkv6_scan` (T = 1
    takes the decode kernel)."""
    if not r.is_cuda:
        return rwkv6_torch(r, k, v, w, u, state0)
    return _launch(r, k, v, w, u, state0, _SEQUENTIAL)


def _launch(r, k, v, w, u, state0, form):
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
        state.data_ptr(), _DTYPE_CODE[r.dtype], form, B, T, H, D, Dv,
        torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(lib, code, "rwkv6_scan")
    return y, state


def rwkv6_torch(r, k, v, w, u, state0=None):
    """Plain PyTorch twin of ``repro``'s ``_rwkv6_xla``: the same step,
    sequential over time in float32 (the state is float32, y is cast to
    v's dtype at the end).

    Each step's D terms of y are summed by halving (the first half plus
    the second, D padded with zeros to a power of two), where
    ``_rwkv6_xla`` leaves the order to XLA: the decode kernel and the
    sequential prefill, which round every op as these eager ops do and sum
    in the same order, equal this version bit for bit."""
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


#: a chunk of :func:`rwkv6_chunked_torch` forms A from the factorised
#: ``(r ⊙ P_t) . (k / P_{s+1})`` only while every channel's decay product
#: ``P_{t+1}`` stays at or above this, else from pairwise products
FACTOR_MIN = 2.0 ** -64

#: the chunk length of the CUDA kernel's chunked prefill (``csrc/rwkv6.cu``)
CHUNK = 16

#: the chunked kernel against its plain twin, ``rwkv6_chunked_torch(...,
#: chunk=CHUNK, split=<bf16 inputs>)``, by type and output.  The two do the
#: same operations on the same (split) operands and differ only in the
#: order of float32 products and sums (tensor-core accumulation, each
#: slice's share of A split on its own, the decay products by a scan, k ⊙ Σ
#: as (k / P) P_C, a fast division), ~1e-6 relative: the float32 state, and
#: float32 y, within 1e-4; bf16 y within one bf16 step (2^-7 |y|), where
#: the two fall on either side of a rounding boundary, and 1e-3 where y's
#: terms cancel.
TWIN_TOL = {torch.float32: {"y": dict(atol=1e-4, rtol=1e-4),
                            "state": dict(atol=1e-4, rtol=1e-4)},
            torch.bfloat16: {"y": dict(atol=1e-3, rtol=2.0 ** -7),
                             "state": dict(atol=1e-4, rtol=1e-4)}}


def twin(r, k, v, w, u, state0=None):
    """The chunked kernel's plain twin on these inputs:
    :func:`rwkv6_chunked_torch` at :data:`CHUNK`, with the bf16 kernel's
    operand pieces for bf16 inputs."""
    return rwkv6_chunked_torch(r, k, v, w, u, state0, CHUNK,
                               r.dtype == torch.bfloat16)


def bf16_pieces(x):
    """``x`` (float32) as three bfloat16 pieces held in float32, each the
    nearest-even bfloat16 of what the ones before it leave, as
    ``csrc/rwkv6.cu::split3`` rounds them: their sum carries the 24 bits of
    a float32 significand."""
    pieces = []
    for _ in range(3):
        p = x.to(torch.bfloat16).float()
        pieces.append(p)
        x = x - p
    return tuple(pieces)


def _mm_split(a, b):
    """``a @ b`` from the pieces of both operands, in the kernel's order:
    the piece products down to 2^-16 of the leading one, largest first
    (a0 b0, a0 b1, a1 b0, a0 b2, a1 b1, a2 b0)."""
    pa, pb = bf16_pieces(a), bf16_pieces(b)
    out = pa[0] @ pb[0]
    for n in (1, 2):
        for m in range(n + 1):
            out = out + pa[m] @ pb[n - m]
    return out


def _mm_split_left(a, b):
    """``a @ b`` for a ``b`` that bfloat16 holds exactly: a0 b + a1 b +
    a2 b."""
    pa = bf16_pieces(a)
    return pa[0] @ b + pa[1] @ b + pa[2] @ b


def rwkv6_chunked_torch(r, k, v, w, u, state0=None, chunk=16, split=False):
    """The RWKV-6 recurrence in chunks of ``chunk`` steps, in float32: the
    algorithm of the CUDA kernel's chunked prefill, and its plain twin
    at ``chunk=CHUNK`` (with ``split=True`` for bfloat16 inputs).

    Same arguments and results as :func:`rwkv6_torch`.  With ``P_t = w_0
    ... w_{t-1}`` within a chunk and ``Σ_s = w_{s+1} ... w_{C-1}``, a
    chunk starting from S gives::

        y_t  = (r_t ⊙ P_t)ᵀ S + Σ_{s<t} A_ts v_s + A_tt v_t
        A_ts = Σ_i r_ti k_si (w_{s+1} ... w_{t-1})_i   (s < t)
        A_tt = Σ_i r_ti u_i k_ti
        S'   = diag(P_C) S + (k ⊙ Σ)ᵀ V

    Decays enter only as running products, never as logarithms: w = 0
    weighs exactly 0 and w = 1 exactly 1.  A (b, h, chunk) whose products
    ``P_{t+1}`` all stay at or above :data:`FACTOR_MIN` forms A_ts as
    ``(r_t ⊙ P_t) . (k_s / P_{s+1})``; any other forms each ``w_{s+1} ...
    w_{t-1}`` as a running product.  T is padded to whole chunks (r = k =
    v = 0, w = 1).

    ``split=True`` models the bfloat16 kernel's tensor-core operands:
    every float32 operand of a product (r ⊙ P, k / P, k ⊙ Σ, A and S)
    enters as its three bfloat16 pieces (:func:`bf16_pieces`), the piece
    products below 2^-16 of the leading one dropped; V, bfloat16 already,
    enters whole."""
    B, T, H, D = r.shape
    Dv = v.shape[-1]
    mm = _mm_split if split else torch.matmul
    mm_v = _mm_split_left if split else torch.matmul
    pt = -T % chunk
    rf, kf, wf = (F.pad(x.float().transpose(1, 2), (0, 0, 0, pt), value=pad)
                  for x, pad in ((r, 0.0), (k, 0.0), (w, 1.0)))
    vf = F.pad(v.float().transpose(1, 2), (0, 0, 0, pt))    # (B, H, T', Dv)
    uf = u.float()[None, :, None, :]                        # (1, H, 1, D)
    S = (torch.zeros((B, H, D, Dv), dtype=torch.float32, device=r.device)
         if state0 is None else state0.float())
    lower = torch.ones(chunk, chunk, dtype=torch.bool,
                       device=r.device).tril(-1)            # [t, s]: s < t
    ys = []
    for c0 in range(0, T + pt, chunk):
        rc, kc, wc, vc = (x[:, :, c0:c0 + chunk] for x in (rf, kf, wf, vf))
        ones = torch.ones_like(wc[:, :, :1])
        P = torch.cumprod(torch.cat([ones, wc], 2), 2)      # P_0 .. P_C
        sig = torch.cat([torch.cumprod(wc[:, :, 1:].flip(2), 2).flip(2),
                         ones], 2)                          # Σ_0 .. Σ_{C-1}
        q = rc * P[:, :, :chunk]
        fast = (P[:, :, 1:] >= FACTOR_MIN).flatten(2).all(-1)
        A = mm(q, (kc / P[:, :, 1:]).transpose(-1, -2))
        if not bool(fast.all()):
            rows, dec = [], torch.ones_like(rc)  # dec[s] = w_{s+1} ... w_{t-1}
            for t in range(chunk):
                rows.append(((rc[:, :, t, None] * dec) * kc).sum(-1))
                dec = torch.cat([dec[:, :, :t] * wc[:, :, t, None],
                                 dec[:, :, t:]], 2)
            A = torch.where(fast[..., None, None], A, torch.stack(rows, 2))
        A = torch.where(lower, A, 0.0)
        A = A + torch.diag_embed((rc * uf * kc).sum(-1))
        ys.append(mm(q, S) + mm_v(A, vc))
        S = P[:, :, chunk, :, None] * S \
            + mm_v((kc * sig).transpose(-1, -2), vc)
    y = torch.cat(ys, 2)[:, :, :T].transpose(1, 2)
    return y.to(v.dtype), S
