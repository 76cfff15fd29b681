"""The mean wall of one ``MultiTenantGateway.step()`` in the measured part
(the benchmark's span around each call), ms."""
from portbench import readers


def read(rec):
    return readers.gateway_step_ms(rec)
