"""repro_torch.obs — the serving metric schema (tracing and the metrics
registry are not ported yet)."""
from .metrics import TENANT_SCHEMA, conform  # noqa: F401

__all__ = ["TENANT_SCHEMA", "conform"]
