"""Roofline terms and the dry run's report (counterpart of
``repro/analysis``)."""
