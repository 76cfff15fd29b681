"""Serving on the port: the single-model continuous-batching engine."""
