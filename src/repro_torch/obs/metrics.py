"""Canonical per-tenant serving metric schema (copy of the part of
``repro/obs/metrics.py`` the serving engine needs).

``TENANT_SCHEMA`` and :func:`conform` are copied verbatim so the port's
``ServingEngine.metrics()`` emits exactly the reference's shape; the
registry, series classes and other schemas are not ported yet.
"""
from __future__ import annotations

from typing import Any, Mapping

__all__ = ["TENANT_SCHEMA", "conform"]

TENANT_SCHEMA: dict[str, tuple[str, str]] = {
    "steps": ("counter", "decode steps executed for this tenant"),
    "active": ("gauge", "requests currently decoding"),
    "queue_depth": ("gauge", "requests admitted but not yet started"),
    "admitted": ("counter", "requests admitted past the KV budget"),
    "completed": ("counter", "requests fully decoded"),
    "deferred": ("counter", "admission deferrals (KV budget pressure)"),
    "tokens_out": ("counter", "decode tokens emitted"),
    "last_step_ms": ("gauge", "latency of the most recent decode step"),
    "mean_step_ms": ("gauge", "mean decode-step latency"),
}


def conform(schema: Mapping[str, tuple[str, str]],
            values: Mapping[str, Any], **extra: Any) -> dict[str, Any]:
    """Build a dict in exact schema order from ``values``.

    Missing keys raise ``KeyError`` — a provider that stops emitting a
    canonical metric fails loudly instead of drifting.  ``extra``
    appends provider-specific keys after the canonical block.
    """
    out = {k: values[k] for k in schema}
    out.update(extra)
    return out
