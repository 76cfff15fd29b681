"""The model FLOPs of the measured part (prefills and decoded tokens,
counted from shapes by ``portbench.roofline``) over its seconds times
989 TFLOP/s, %."""
from portbench import readers


def read(rec):
    return readers.mfu(rec)
