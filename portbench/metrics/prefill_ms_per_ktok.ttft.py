"""Admission ms per thousand prompt tokens: the benchmark's wall around
each engine ``step()`` that admitted, less its ``last_step_ms``, over the
prompt tokens it admitted."""
from portbench import readers


def read(rec):
    return readers.prefill_ms_per_ktok(rec)
