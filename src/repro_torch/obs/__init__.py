"""repro_torch.obs — zero-dependency observability: traces, metrics,
timelines (copy of ``repro/obs/__init__.py``).

* :mod:`repro_torch.obs.trace` — span tracer with Chrome-trace/Perfetto
  export; clock-injectable so virtual-clock replays are byte-stable.
* :mod:`repro_torch.obs.metrics` — counters/gauges/histograms registry
  with JSON snapshots and Prometheus text exposition; home of the
  canonical serving metric schemas.
* :mod:`repro_torch.obs.timeline` — recorded Plan/simulation timelines
  as per-accelerator Gantt charts (Perfetto JSON + ASCII).

This module additionally owns the logger hierarchy: every module under
``src/repro_torch/`` obtains its logger via :func:`get_logger`, which pins
names to the ``repro_torch.<pkg>.<mod>`` convention, and CLIs call
:func:`configure_logging` exactly once.
"""
from __future__ import annotations

import json as _json
import logging
import sys

from .metrics import (  # noqa: F401
    ADMISSION_SCHEMA,
    Counter,
    GATEWAY_SCHEMA,
    Gauge,
    Histogram,
    MetricsRegistry,
    TENANT_SCHEMA,
    conform,
    get_registry,
    set_registry,
)
from .trace import (  # noqa: F401
    NULL_TRACER,
    NullTracer,
    Span,
    Tracer,
    get_tracer,
    instant,
    set_tracer,
    span,
    trace,
)

__all__ = [
    "ADMISSION_SCHEMA", "Counter", "GATEWAY_SCHEMA", "Gauge", "Histogram",
    "MetricsRegistry", "NULL_TRACER", "NullTracer", "Span", "TENANT_SCHEMA",
    "Tracer", "configure_logging", "conform", "get_logger", "get_registry",
    "get_tracer", "instant", "set_registry", "set_tracer", "span", "trace",
]

_ROOT_LOGGER = "repro_torch"   # the port's own logger tree


def get_logger(name: str) -> logging.Logger:
    """Logger pinned to the ``repro_torch.<pkg>.<mod>`` hierarchy.

    Pass ``__name__``: package modules (``repro_torch.core.scheduler``) map
    through unchanged, out-of-tree callers (``benchmarks.bench_search``,
    ``__main__``) are re-rooted under ``repro_torch.`` so one
    :func:`configure_logging` call governs everything.
    """
    if name == "__main__" or not name:
        name = _ROOT_LOGGER
    elif name != _ROOT_LOGGER and not name.startswith(_ROOT_LOGGER + "."):
        name = f"{_ROOT_LOGGER}.{name}"
    return logging.getLogger(name)


class _JsonFormatter(logging.Formatter):
    """One JSON object per line — machine-tailable CLI logs."""

    def format(self, record: logging.LogRecord) -> str:
        doc = {
            "ts": round(record.created, 6),
            "level": record.levelname.lower(),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            doc["exc"] = self.formatException(record.exc_info)
        return _json.dumps(doc, sort_keys=True, separators=(",", ":"))


def configure_logging(level: int | str = "info", *, json: bool = False,
                      stream=None) -> logging.Logger:
    """Configure the ``repro_torch`` logger tree for CLI use (idempotent).

    Installs a single stream handler on the ``repro_torch`` root logger —
    plain ``time level logger: msg`` lines, or JSON lines with
    ``json=True`` — replacing any handler a previous call installed.
    Library code never calls this; only ``launch/*`` entry points and
    benchmark mains do.
    """
    if isinstance(level, str):
        level = getattr(logging, level.upper())
    root = logging.getLogger(_ROOT_LOGGER)
    root.setLevel(level)
    for h in list(root.handlers):
        if getattr(h, "_repro_obs", False):
            root.removeHandler(h)
    handler = logging.StreamHandler(stream or sys.stderr)
    handler._repro_obs = True  # type: ignore[attr-defined]
    if json:
        handler.setFormatter(_JsonFormatter())
    else:
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s",
            datefmt="%H:%M:%S"))
    root.addHandler(handler)
    root.propagate = False
    return root
