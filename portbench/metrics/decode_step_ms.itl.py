"""The decode step, ms: ``EngineMetrics.last_step_ms`` summed over the
measured part; behind a gateway, every tenant's summed over the
gateway's steps."""
from portbench import readers


def read(rec):
    return readers.decode_step_ms(rec)
