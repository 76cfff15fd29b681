"""Training data streams (counterpart of ``repro/data``)."""
