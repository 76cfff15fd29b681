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
        fn.argtypes = [p, p, p, p, p, p, p, ctypes.c_double, p, p, p, p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return lib


def anneal_select(cur, prop, best, cur_obj, prop_obj, best_obj, u, temp, *,
                  backend: str = "auto"):
    """Metropolis accept + per-chain incumbent update over (P, L) rows.

    Semantics (and the oracle) live in :func:`repro_torch.kernels.ref.
    anneal_select`.  ``temp`` is a Python float or a 0-d tensor, taken in
    the objectives' dtype.  Returns ``(new_cur, new_cur_obj, new_best,
    new_best_obj)``.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; have {BACKENDS}")
    if backend == "ref":
        return _ref.anneal_select(cur, prop, best, cur_obj, prop_obj,
                                  best_obj, u, temp)
    if backend == "torch" or (backend == "auto" and not cur.is_cuda):
        return anneal_select_torch(cur, prop, best, cur_obj, prop_obj,
                                   best_obj, u, temp)
    return _launch(cur, prop, best, cur_obj, prop_obj, best_obj, u, temp)


def _launch(cur, prop, best, cur_obj, prop_obj, best_obj, u, temp):
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
    rows = tuple(t.contiguous() for t in rows)
    objs = tuple(t.contiguous() for t in objs)
    new_cur, new_best = torch.empty_like(rows[0]), torch.empty_like(rows[0])
    new_cur_obj, new_best_obj = torch.empty_like(objs[0]), \
        torch.empty_like(objs[0])
    lib = _lib()
    stream = torch.cuda.current_stream(cur.device).cuda_stream
    code = lib.anneal_select_fwd(
        *(t.data_ptr() for t in rows), *(t.data_ptr() for t in objs),
        float(temp), new_cur.data_ptr(), new_cur_obj.data_ptr(),
        new_best.data_ptr(), new_best_obj.data_ptr(), P, L, _DTYPE_CODE[dt],
        stream)
    _build.check(lib, code, "anneal_select")
    launches += 1
    return new_cur, new_cur_obj, new_best, new_best_obj


def anneal_select_torch(cur, prop, best, cur_obj, prop_obj, best_obj, u,
                        temp):
    """Plain PyTorch version: the TPU kernel body is the oracle's decision
    (:func:`repro_torch.kernels.ref.anneal_select`), bit for bit."""
    return _ref.anneal_select(cur, prop, best, cur_obj, prop_obj, best_obj,
                              u, temp)
