"""Batched serving engine: continuous batching over decode slots
(counterpart of ``repro/serve/engine.py``).

Requests enter a queue; free slots admit them through a single-request
prefill; every ``step()`` runs one batched decode for all slots (per-slot
lengths), greedy-samples, and retires finished requests.  The surface —
``submit`` / ``step`` / ``run_until_drained`` / ``metrics`` /
``admission_gate`` / ``counters`` — is the reference's, so a multiplexer
can drive either engine.

Two differences from the reference, both about memory traffic:

* The model owns its parameters, so the constructor takes no ``params``.
* A prefill writes the prompt's k/v (and a recurrent layer's final
  state) straight into its slot of the preallocated batched cache, where
  the reference builds a one-request cache and splices it in
  (``engine.py:143-155``); decode steps update the cache in place.  A
  decode step advances every slot, empty ones too, as the reference's
  does; admission overwrites a slot's whole state.

Where the reference compiles the decode step with ``jax.jit``, the port
captures it once per engine as a CUDA graph on the card
(:class:`DecodeGraph`): the step always runs every slot over the same
caches, so one graph keyed by (``max_slots``, ``capacity``) serves every
step.  Each step copies the token ids and lengths into the graph's static
device buffers and replays it; the logits come back in a static buffer.
The CPU, and an engine built with ``eager=True``, run the same step
eagerly.  Prefill stays eager everywhere: its length varies from request
to request.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Callable

import numpy as np
import torch

from repro_torch.kernels import graph
from repro_torch.models import Model, kvcache
from repro_torch.obs import TENANT_SCHEMA, conform


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (S,) int32
    max_new: int = 16
    eos: int | None = None
    tokens: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


#: canonical per-tenant telemetry keys, the reference's ``METRIC_KEYS``.
METRIC_KEYS = tuple(TENANT_SCHEMA)


@dataclasses.dataclass
class EngineMetrics:
    """Rolling counters a multiplexer can poll between ``step()`` calls."""

    steps: int = 0
    admitted: int = 0
    #: queue->slot admissions refused by the admission gate.
    deferred: int = 0
    tokens_out: int = 0
    #: wall-clock ms of the most recent decode step (prefills excluded),
    #: up to the host having the sampled tokens (the step is finished).
    last_step_ms: float = 0.0
    decode_ms_total: float = 0.0

    @property
    def mean_step_ms(self) -> float:
        return self.decode_ms_total / self.steps if self.steps else 0.0


class DecodeGraph:
    """``model.decode_step`` over all ``slots`` as one replayed graph.

    ``caches`` are the engine's, updated in place by every replay.  The
    token ids and lengths enter through static device buffers (from a
    pinned staging buffer on the card); :meth:`__call__` returns the
    logits in a static buffer that the next call overwrites.  On the card
    the step is a CUDA graph (:func:`repro_torch.kernels.graph.capture`)
    unless ``eager``; elsewhere the same code steps eagerly.  The warm-up
    before capture steps the engine's own caches: every slot is empty
    then, and admission overwrites a slot's whole state.
    """

    def __init__(self, model: Model, caches, slots: int,
                 eager: bool = False):
        dev = model.device
        self.ids = torch.zeros((slots, 1), dtype=torch.int32, device=dev)
        self.lengths = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self._host = torch.zeros((2, slots), dtype=torch.int32,
                                 pin_memory=dev.type == "cuda")

        def step(c):
            return model.decode_step(c, {"token_ids": self.ids,
                                         "lengths": self.lengths})[0]

        graph.warm_up(lambda: step(caches), dev, eager)
        self.graph = graph.capture(lambda: step(caches), dev, eager)

    def __call__(self, last_tok: np.ndarray, lengths: np.ndarray):
        # the staging buffer is free again: the last step's copies were
        # done before its tokens reached the host
        self._host[0] = torch.from_numpy(last_tok)
        self._host[1] = torch.from_numpy(lengths)
        self.ids.copy_(self._host[0, :, None], non_blocking=True)
        self.lengths.copy_(self._host[1], non_blocking=True)
        return self.graph.replay()


class ServingEngine:
    """``eager=True`` steps the decode eagerly on the card too (to compare
    the two paths); on the CPU it always does.  Either way the step goes
    through :class:`DecodeGraph`.  The engine serves a model on one
    device, as the reference's does: a model built on a mesh of ranks
    serves through ``Model.prefill`` / ``decode_step`` on every rank."""

    def __init__(self, model: Model, max_slots: int = 4,
                 capacity: int = 256,
                 admission_gate: Callable[[Request], bool] | None = None,
                 *, eager: bool = False):
        split = getattr(model, "split", None)
        if split is not None and split.mesh.size > 1:
            raise ValueError(
                f"ServingEngine serves a model on one device; this one is "
                f"built on a mesh of {split.mesh.shape}")
        self.model = model
        self.device = model.device
        self.max_slots = max_slots
        self.capacity = capacity
        self.queue: deque[Request] = deque()
        self.slots: list[Request | None] = [None] * max_slots
        self.lengths = np.zeros((max_slots,), np.int32)
        self.last_tok = np.zeros((max_slots,), np.int32)
        self.caches = model.init_cache(max_slots, capacity)
        self._rid = itertools.count()
        self.steps = 0
        self.completed: list[Request] = []
        #: consulted before each queue->slot admission; ``False`` defers the
        #: head request (FIFO is preserved: admission stops for this step).
        self.admission_gate = admission_gate
        self.counters = EngineMetrics()
        #: the decode step (a CUDA graph on the card unless ``eager``)
        self.graph = DecodeGraph(model, self.caches, max_slots, eager)

    # ------------------------------------------------------------------
    def submit(self, prompt, max_new: int = 16, eos: int | None = None
               ) -> Request:
        req = Request(next(self._rid), np.asarray(prompt, np.int32),
                      max_new=max_new, eos=eos)
        self.queue.append(req)
        return req

    @property
    def active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    @property
    def has_work(self) -> bool:
        """Anything queued or decoding — i.e. ``step()`` would make progress."""
        return bool(self.queue) or self.active > 0

    def metrics(self) -> dict:
        """Telemetry snapshot in the canonical :data:`METRIC_KEYS` shape."""
        c = self.counters
        return conform(TENANT_SCHEMA, {
            "steps": c.steps,
            "active": self.active,
            "queue_depth": len(self.queue),
            "admitted": c.admitted,
            "completed": len(self.completed),
            "deferred": c.deferred,
            "tokens_out": c.tokens_out,
            "last_step_ms": c.last_step_ms,
            "mean_step_ms": c.mean_step_ms,
        })

    # ------------------------------------------------------------------
    def _ids(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _admit(self):
        for slot in range(self.max_slots):
            if self.slots[slot] is not None or not self.queue:
                continue
            if (self.admission_gate is not None
                    and not self.admission_gate(self.queue[0])):
                self.counters.deferred += 1
                break
            req = self.queue.popleft()
            views = [kvcache.select(c, slot) for c in self.caches]
            logits, _ = self.model.prefill(
                {"token_ids": self._ids(req.prompt[None])},
                capacity=self.capacity, cache_out=views)
            tok = int(torch.argmax(logits[0, -1]))
            req.tokens.append(tok)
            self.slots[slot] = req
            self.lengths[slot] = len(req.prompt)
            self.last_tok[slot] = tok
            self.counters.admitted += 1
            self.counters.tokens_out += 1

    def step(self) -> int:
        """Admit + one batched decode step; returns #active slots.

        Exactly one batched decode, timed into ``counters.last_step_ms``
        up to the sampled tokens reaching the host (which waits for the
        device), so a multiplexer can compare observed step latency with
        a schedule's prediction.
        """
        self._admit()
        if self.active == 0:
            return 0
        t0 = time.perf_counter()
        logits = self.graph(self.last_tok, self.lengths)
        toks = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
        self.counters.last_step_ms = (time.perf_counter() - t0) * 1e3
        self.counters.decode_ms_total += self.counters.last_step_ms
        self.counters.steps += 1
        self.counters.tokens_out += self.active
        self.steps += 1
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            self.lengths[slot] += 1
            tok = int(toks[slot])
            req.tokens.append(tok)
            self.last_tok[slot] = tok
            if (len(req.tokens) >= req.max_new
                    or (req.eos is not None and tok == req.eos)
                    or self.lengths[slot] >= self.capacity - 1):
                req.done = True
                self.completed.append(req)
                self.slots[slot] = None
        return self.active

    def run_until_drained(self, max_steps: int = 10000):
        while (self.queue or self.active) and self.steps < max_steps:
            self.step()
        return self.completed
