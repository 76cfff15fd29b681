"""The engine's decode step, ms: ``EngineMetrics.last_step_ms`` summed over
the measured part's decode steps, over their count."""
from portbench import readers


def read(rec):
    return readers.decode_step_ms(rec)
