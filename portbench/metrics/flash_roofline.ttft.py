"""The flash kernels' share of their roofline in the profiled slice, %:
the bound of each prefill's causal attention over the kernels' device
ms."""
from portbench import readers


def read(rec):
    return readers.flash_roofline(rec)
