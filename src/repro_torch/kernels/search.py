"""Annealing select step: the hand-written CUDA kernel and its plain version.

``anneal_select`` launches ``csrc/search.cu`` on CUDA tensors and counts
each launch in :data:`launches`; on CPU tensors it runs
:func:`anneal_select_torch`, the plain PyTorch version.  There is no
fallback between the two: a CUDA tensor the kernel cannot take raises.

Replaces the TPU kernel ``src/repro/kernels/search.py`` (``_kernel``,
launched by ``_pallas_select``).  The source note in the ``.cu`` file says
what bounds the kernel on the card and how its design answers that.  The
reference's ``global_lanes`` argument is dropped: it kept the ``auto``
size threshold invariant across mesh shards, and on the card ``auto`` has
no size threshold to keep invariant.  All backends make the same decision
bit for bit, so the search's incumbent does not depend on the backend.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from . import ref as _ref

#: launches of the CUDA kernel since import (or since a caller reset it).
launches = 0

BACKENDS = ("auto", "cuda", "torch", "ref")
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("search")
    fn = lib.anneal_select_fwd
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, p, p, p, p, p, p, p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return lib


def anneal_select(cur, prop, best, cur_obj, prop_obj, best_obj, u, temp, *,
                  out=None, backend: str = "auto"):
    """Metropolis accept + per-chain incumbent update over (P, L) rows.

    Semantics (and the oracle) live in :func:`repro_torch.kernels.ref.
    anneal_select`.  ``temp`` is a Python float or a one-element tensor,
    taken in the objectives' dtype; the kernel reads it from the device,
    so a temperature already there (a step's entry of the search's
    schedule) costs no host read and can be captured in a CUDA graph.
    Returns ``(new_cur, new_cur_obj, new_best, new_best_obj)``: new
    tensors, or with ``out=(cur, cur_obj, best, best_obj)`` the state
    itself, updated in place (the kernel then stores only what the
    decision changes; :func:`check_out`).
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; have {BACKENDS}")
    args = (cur, prop, best, cur_obj, prop_obj, best_obj, u, temp)
    if out is not None:
        check_out(out, args[:7])
    if backend == "ref":
        return _into(out, _ref.anneal_select(*args))
    if backend == "torch" or (backend == "auto" and not cur.is_cuda):
        return _into(out, anneal_select_torch(*args))
    return _launch(*args, out)


def _span(t):
    start = t.data_ptr()
    return start, start + t.numel() * t.element_size()


def _overlap(a, b) -> bool:
    (a0, a1), (b0, b1) = _span(a), _span(b)
    return a0 < b1 and b0 < a1 and a.numel() > 0 and b.numel() > 0


def check_out(out, inputs) -> None:
    """``out`` for ``inputs`` ``(cur, prop, best, cur_obj, prop_obj,
    best_obj, u)``: the contiguous state ``(cur, cur_obj, best,
    best_obj)`` itself (the same memory), four tensors that overlap
    neither ``prop``, ``prop_obj`` and ``u`` nor one another.  Raises
    ``ValueError`` otherwise."""
    cur, prop, best, cur_obj, prop_obj, best_obj, u = inputs
    state = (cur, cur_obj, best, best_obj)
    if len(out) != 4 or not all(
            _span(o) == _span(x) and o.shape == x.shape
            and o.dtype == x.dtype and o.device == x.device
            and o.is_contiguous() and x.is_contiguous()
            for o, x in zip(out, state)):
        raise ValueError("anneal_select: out must be the contiguous state "
                         "(cur, cur_obj, best, best_obj) itself")
    pairs = [(o, x) for o in out for x in (prop, prop_obj, u)]
    pairs += [(a, b) for i, a in enumerate(out) for b in out[i + 1:]]
    if any(_overlap(a, b) for a, b in pairs):
        raise ValueError("anneal_select: out (the state) overlaps prop, "
                         "prop_obj, u or itself")


def _into(out, result):
    if out is None:
        return result
    for o, r in zip(out, result):
        o.copy_(r)
    return tuple(out)


def _launch(cur, prop, best, cur_obj, prop_obj, best_obj, u, temp, out):
    global launches
    rows, objs = (cur, prop, best), (cur_obj, prop_obj, best_obj, u)
    if not all(t.is_cuda and t.device == cur.device for t in rows + objs):
        raise ValueError("anneal_select: rows, objectives and draws must be "
                         "on one CUDA device")
    dt = cur_obj.dtype
    if dt not in _DTYPE_CODE or any(t.dtype != dt for t in objs):
        raise TypeError(f"anneal_select: objectives and draws must share "
                        f"float32 or float64, got "
                        f"{[str(t.dtype) for t in objs]}")
    if any(t.dtype != torch.int32 for t in rows):
        raise TypeError("anneal_select: rows must be int32")
    if cur.dim() != 2 or prop.shape != cur.shape or best.shape != cur.shape:
        raise ValueError(f"anneal_select: rows must share one (P, L) shape, "
                         f"got {[tuple(t.shape) for t in rows]}")
    P, L = cur.shape
    if L < 1 or any(t.shape != (P,) for t in objs):
        raise ValueError(f"anneal_select: objectives and draws must be "
                         f"({P},) for rows ({P}, {L})")
    if P * L >= 1 << 31:
        raise ValueError(f"anneal_select: P * L must be below 2^31 (32-bit "
                         f"offsets), got {P} x {L}")
    rows = tuple(t.contiguous() for t in rows)
    objs = tuple(t.contiguous() for t in objs)
    if isinstance(temp, torch.Tensor):
        if temp.numel() != 1:
            raise ValueError(f"anneal_select: temp must hold one value, "
                             f"got {tuple(temp.shape)}")
        temp_d = temp.to(device=cur.device, dtype=dt).reshape(())
    else:
        temp_d = torch.full((), float(temp), dtype=dt, device=cur.device)
    if out is None:
        out = (torch.empty_like(rows[0]), torch.empty_like(objs[0]),
               torch.empty_like(rows[0]), torch.empty_like(objs[0]))
    lib = _lib()
    stream = torch.cuda.current_stream(cur.device).cuda_stream
    code = lib.anneal_select_fwd(
        *(t.data_ptr() for t in rows), *(t.data_ptr() for t in objs),
        temp_d.data_ptr(), *(t.data_ptr() for t in out), P, L,
        _DTYPE_CODE[dt], stream)
    _build.check(lib, code, "anneal_select")
    launches += 1
    return tuple(out)


def anneal_select_torch(cur, prop, best, cur_obj, prop_obj, best_obj, u,
                        temp, *, out=None):
    """Plain PyTorch version: the TPU kernel body is the oracle's decision
    (:func:`repro_torch.kernels.ref.anneal_select`), bit for bit; with
    ``out``, the result is copied into it."""
    if out is not None:
        check_out(out, (cur, prop, best, cur_obj, prop_obj, best_obj, u))
    return _into(out, _ref.anneal_select(cur, prop, best, cur_obj, prop_obj,
                                         best_obj, u, temp))
