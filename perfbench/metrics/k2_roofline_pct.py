"""Kernel 2's share of its roofline: the least time of the profiled
datasets' work (every filtered track × (k + 1) squared distances, or each
byte moved once) over the device time of every ``mad_kernel`` launch."""

from perfbench.lib.readers import kernel2_pct


def read(trace):
    return kernel2_pct(trace)
