"""The device's idle share of the profiled slice, %: 1 less the union of
the device operations' intervals over the slice's wall."""
from portbench import readers


def read(rec):
    return readers.idle_share(rec)
