"""The decode attention kernels' share of their roofline in the profiled
slice, %: the bound of every replay's attention (k and v of each slot's
length, q and o) over the kernels' device ms."""
from portbench import readers


def read(rec):
    return readers.decode_attention_roofline(rec)
