"""CUDA graphs that keep the kernels' launch counts exact.

Each kernel wrapper counts a launch when it is called (its module's
``launches``).  Inside a captured graph the wrappers are called once, at
capture, where nothing runs, and never again: a replay re-runs the
recorded kernels without Python.  :class:`Graph` therefore records each
wrapper's count delta at capture, takes it back, and adds it on every
replay, so a count still equals the kernel launches that ran.

:class:`Eager` has the same surface and simply calls the function: the
CPU, and a caller that asks for eager steps on the card (to compare the
two), runs the same static-buffer code through it.  :func:`capture`
picks one of the two.

Capture discipline (``torch.cuda.graphs``): run the function once on a
side stream first (:func:`warm_up`), so every kernel's one-time set-up
(library load, ``set_smem_once``, the SM-count cache, cuBLAS workspaces)
has happened; every graph gets its own memory pool; nothing captured may
read a device value on the host; and the cycle collector is off while a
graph captures (:class:`Graph`).
"""
from __future__ import annotations

import gc
from typing import Any, Callable

import torch

from . import (decode_attention, flash_attention, rglru, rwkv6, search,
               slowdown, stream)

#: every wrapper module that counts its kernel's launches
COUNTED = (flash_attention, decode_attention, slowdown, search, stream,
           rglru, rwkv6)


def _counts() -> list[int]:
    return [m.launches for m in COUNTED]


class Graph:
    """``fn()`` captured once as a CUDA graph; :meth:`replay` re-runs it
    and returns the tensors ``fn`` returned at capture (rewritten by each
    replay)."""

    def __init__(self, fn: Callable[[], Any]):
        self.graph = torch.cuda.CUDAGraph()
        before = _counts()
        # A dead graph may wait in a reference cycle for the cycle
        # collector.  Collected while another graph captures, its
        # destruction is refused by the capturing stream and invalidates
        # the capture (cudaErrorStreamCaptureInvalidated), so no
        # collection runs here.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph):
                self.out = fn()
        finally:
            if collecting:
                gc.enable()
        self._deltas = [(m, a - b) for m, a, b in zip(COUNTED, _counts(),
                                                      before) if a != b]
        for m, b in zip(COUNTED, before):   # capture launched nothing
            m.launches = b

    @property
    def launches(self) -> dict:
        """Launches of each wrapper per replay, by module name."""
        return {m.__name__.rsplit(".", 1)[-1]: d for m, d in self._deltas}

    def replay(self):
        self.graph.replay()
        for m, d in self._deltas:
            m.launches += d
        return self.out


class Eager:
    """The :class:`Graph` surface without capture: each replay calls
    ``fn`` and returns what it returns."""

    def __init__(self, fn: Callable[[], Any]):
        self.fn = fn
        self.launches: dict = {}

    def replay(self):
        return self.fn()


def captures(device, eager: bool = False) -> bool:
    """Whether :func:`capture` makes a :class:`Graph`: on a CUDA
    ``device`` unless the caller asks for ``eager`` steps."""
    return torch.device(device).type == "cuda" and not eager


def capture(fn: Callable[[], Any], device, eager: bool = False
            ) -> Graph | Eager:
    """A :class:`Graph` of ``fn`` where :func:`captures`, else an
    :class:`Eager` stand-in."""
    return Graph(fn) if captures(device, eager) else Eager(fn)


def warm_up(fn: Callable[[], Any], device, eager: bool = False) -> None:
    """Run ``fn`` once on a side stream before it is captured (nothing to
    do where :func:`capture` would not capture).  ``fn`` must leave the
    state a capture will use as it would find it."""
    if not captures(device, eager):
        return
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
