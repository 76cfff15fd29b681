"""Span-based structured tracer with Chrome-trace/Perfetto JSON export.

The tracer records *complete* spans (name, category, start, duration,
args) and *instant* events on named tracks, in memory, with zero
third-party dependencies.  Design constraints, in order:

1. **Disabled is free.**  The module-level default tracer is a
   :class:`NullTracer`; every instrumentation site goes through it and
   must cost no more than an attribute lookup plus a shared no-op
   context manager.  Hot loops (the fleet replay, the anneal chunk
   loop) stay hot.

2. **Deterministic export.**  The clock is injectable.  Wall-clock
   tracing uses ``time.perf_counter``; the fleet gateway instead
   records against its *virtual* millisecond clock, so two identical
   replays export byte-identical JSON (sorted keys, fixed separators,
   stable track ids, recording order preserved).  That makes traces
   CI-diffable artifacts, same as plans and profile bundles.

3. **Perfetto-loadable.**  :meth:`Tracer.to_chrome` emits the Chrome
   trace-event JSON object format (``{"traceEvents": [...]}`` with
   ``ph: "X"`` complete events and ``ph: "i"`` instants, timestamps in
   microseconds) which ``ui.perfetto.dev`` and ``chrome://tracing``
   both load directly.

Spans nest per thread: each thread carries its own span stack, and the
exported events carry that thread's stable track id, so concurrent
solver threads render as parallel tracks instead of interleaving.

Bulk ingestion: :meth:`Tracer.add_events` appends pre-built event
dicts in one locked call.  The fleet gateway derives its million
per-request queue/service spans *post hoc* from its flat NumPy record
arrays and hands them over in bulk — recording them live, one context
manager per request, would swamp the replay loop.
"""
from __future__ import annotations

import contextlib
import functools
import json
import threading
import time
from typing import Any, Callable, Iterator

__all__ = [
    "NULL_TRACER",
    "NullTracer",
    "Span",
    "Tracer",
    "get_tracer",
    "set_tracer",
    "span",
    "instant",
    "trace",
]

#: process id used in every exported event — the tracer is in-process
#: only, and a fixed pid keeps exports byte-stable across runs.
_PID = 1


class Span:
    """Mutable handle for an open span: ``with tracer.span(...) as sp``.

    ``sp.set(key=value)`` attaches args after the span opened (e.g. the
    objective once the solver returns).  Plain dict under the hood so a
    closed span serializes without translation.
    """

    __slots__ = ("name", "cat", "t0", "args")

    def __init__(self, name: str, cat: str, t0: float,
                 args: dict[str, Any]) -> None:
        self.name = name
        self.cat = cat
        self.t0 = t0
        self.args = args

    def set(self, **kwargs: Any) -> "Span":
        self.args.update(kwargs)
        return self


class NullTracer:
    """Disabled tracer: every operation is a near-zero no-op.

    All instrumentation sites call through this by default, so the
    overhead of shipping tracing in library code is one attribute
    lookup and a shared pre-built context manager.
    """

    enabled = False

    _NULL_SPAN = Span("", "", 0.0, {})
    _NULL_CTX = contextlib.nullcontext(_NULL_SPAN)

    def span(self, name: str, cat: str = "repro", **args: Any):
        return self._NULL_CTX

    def instant(self, name: str, cat: str = "repro", *,
                ts_ms: float | None = None, track: str | None = None,
                **args: Any) -> None:
        return None

    def complete(self, name: str, ts_ms: float, dur_ms: float,
                 cat: str = "repro", *, track: str | None = None,
                 **args: Any) -> None:
        return None

    def add_events(self, events) -> None:
        return None

    def counter_sample(self, name: str, ts_ms: float,
                       values: dict[str, float]) -> None:
        return None

    def trace(self, name: str | None = None, cat: str = "repro"):
        """Decorator form: returns the function unchanged."""
        if callable(name):  # bare @tracer.trace
            return name

        def deco(fn):
            return fn
        return deco


#: shared disabled tracer; also the initial global tracer.
NULL_TRACER = NullTracer()


class Tracer:
    """Recording tracer.

    Parameters
    ----------
    clock:
        Zero-arg callable returning *milliseconds* as a float.  Default
        is wall time from ``time.perf_counter``.  The fleet gateway
        passes its virtual clock so traces are deterministic.
    """

    enabled = True

    def __init__(self, clock: Callable[[], float] | None = None) -> None:
        self._wall = clock is None
        self._clock = clock or (lambda: time.perf_counter() * 1e3)
        self._lock = threading.Lock()
        self._events: list[dict[str, Any]] = []
        self._local = threading.local()
        # thread/track name -> stable small integer tid, in first-seen
        # order (deterministic for single-threaded / virtual-clock use).
        self._tids: dict[str, int] = {}

    # -- internals ---------------------------------------------------

    def _now(self) -> float:
        return self._clock()

    def _tid_locked(self, track: str) -> int:
        tid = self._tids.get(track)
        if tid is None:
            tid = len(self._tids) + 1
            self._tids[track] = tid
        return tid

    def _thread_track(self) -> str:
        name = getattr(self._local, "track", None)
        if name is None:
            t = threading.current_thread()
            name = "main" if t is threading.main_thread() else t.name
            self._local.track = name
        return name

    def _append(self, ev: dict[str, Any]) -> None:
        with self._lock:
            self._events.append(ev)

    # -- recording API ----------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "repro",
             **args: Any) -> Iterator[Span]:
        """Record a complete event covering the ``with`` body."""
        sp = Span(name, cat, self._now(), dict(args))
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        stack.append(sp)
        try:
            yield sp
        finally:
            stack.pop()
            t1 = self._now()
            track = self._thread_track()
            with self._lock:
                self._events.append({
                    "ph": "X", "name": sp.name, "cat": sp.cat,
                    "ts": round(sp.t0 * 1e3, 3),
                    "dur": round((t1 - sp.t0) * 1e3, 3),
                    "pid": _PID, "tid": self._tid_locked(track),
                    "args": sp.args,
                })

    def trace(self, name: str | None = None, cat: str = "repro"):
        """Decorator: wrap a function in a span named after it."""
        def deco(fn, span_name=None):
            label = span_name or fn.__qualname__

            @functools.wraps(fn)
            def wrapper(*a, **kw):
                with self.span(label, cat):
                    return fn(*a, **kw)
            return wrapper

        if callable(name):  # bare @tracer.trace
            return deco(name)
        return lambda fn: deco(fn, name)

    def instant(self, name: str, cat: str = "repro", *,
                ts_ms: float | None = None, track: str | None = None,
                **args: Any) -> None:
        """Record a zero-duration instant event (rendered as an arrow)."""
        ts = self._now() if ts_ms is None else ts_ms
        track = track or self._thread_track()
        with self._lock:
            self._events.append({
                "ph": "i", "name": name, "cat": cat,
                "ts": round(ts * 1e3, 3), "pid": _PID,
                "tid": self._tid_locked(track), "s": "t",
                "args": dict(args),
            })

    def complete(self, name: str, ts_ms: float, dur_ms: float,
                 cat: str = "repro", *, track: str | None = None,
                 **args: Any) -> None:
        """Record a complete event at explicit (clock-domain) times."""
        track = track or self._thread_track()
        with self._lock:
            self._events.append({
                "ph": "X", "name": name, "cat": cat,
                "ts": round(ts_ms * 1e3, 3),
                "dur": round(dur_ms * 1e3, 3),
                "pid": _PID, "tid": self._tid_locked(track),
                "args": dict(args),
            })

    def counter_sample(self, name: str, ts_ms: float,
                       values: dict[str, float]) -> None:
        """Record a Chrome counter-track sample (stacked area chart)."""
        with self._lock:
            self._events.append({
                "ph": "C", "name": name, "cat": "metrics",
                "ts": round(ts_ms * 1e3, 3), "pid": _PID,
                "tid": 0, "args": dict(values),
            })

    def add_events(self, events) -> None:
        """Bulk-append pre-built Chrome event dicts (one lock trip).

        Callers own the event shape; :meth:`track_id` hands out the
        stable tid for a named track.  Used by the fleet replay to
        ingest spans derived from its NumPy record arrays.
        """
        with self._lock:
            self._events.extend(events)

    def track_id(self, track: str) -> int:
        """Stable integer tid for a named track (registering it)."""
        with self._lock:
            return self._tid_locked(track)

    # -- export ------------------------------------------------------

    def events(self) -> list[dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def to_chrome(self) -> dict[str, Any]:
        """Chrome trace-event object format (Perfetto-loadable)."""
        with self._lock:
            meta = [
                {"ph": "M", "name": "thread_name", "pid": _PID, "tid": tid,
                 "args": {"name": track}}
                for track, tid in self._tids.items()
            ]
            return {
                "traceEvents": meta + list(self._events),
                "displayTimeUnit": "ms",
                "otherData": {
                    "producer": "repro_torch.obs",
                    "clock": "wall_ms" if self._wall else "virtual_ms",
                },
            }

    def to_json(self, *, indent: int | None = None) -> str:
        """Deterministic JSON: sorted keys, fixed separators.

        With a virtual clock and identical inputs this is byte-stable
        across runs — the property the determinism tests pin.
        """
        seps = (",", ": ") if indent is not None else (",", ":")
        return json.dumps(self.to_chrome(), sort_keys=True,
                          indent=indent, separators=seps)

    def write(self, path) -> None:
        import pathlib

        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(self.to_json() + "\n")


# -- module-level current tracer -------------------------------------

_current: NullTracer | Tracer = NULL_TRACER
_current_lock = threading.Lock()


def get_tracer() -> NullTracer | Tracer:
    """The process-wide current tracer (NullTracer unless configured)."""
    return _current


def set_tracer(tracer: NullTracer | Tracer | None):
    """Install ``tracer`` globally; ``None`` restores the null tracer.

    Returns the previous tracer so callers can restore it.
    """
    global _current
    with _current_lock:
        prev = _current
        _current = NULL_TRACER if tracer is None else tracer
    return prev


def span(name: str, cat: str = "repro", **args: Any):
    """``with obs.span("solve"):`` against the current global tracer."""
    return _current.span(name, cat, **args)


def instant(name: str, cat: str = "repro", **kwargs: Any) -> None:
    _current.instant(name, cat, **kwargs)


def trace(name: str | None = None, cat: str = "repro"):
    """Decorator resolving the global tracer *per call* (late-bound).

    Unlike ``tracer.trace`` this keeps working when the global tracer
    is swapped after import — the common case for library code.
    """
    def deco(fn, span_name=None):
        label = span_name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            t = _current
            if not t.enabled:
                return fn(*a, **kw)
            with t.span(label):
                return fn(*a, **kw)
        return wrapper

    if callable(name):
        return deco(name)
    return lambda fn: deco(fn, name)
