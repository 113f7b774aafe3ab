"""Kernel 1's share of its roofline: the least time of the profiled
units' work (every filled node × k squared distances, or each byte moved
once) over the device time of every ``fused_kernel`` launch in them."""

from perfbench.lib.readers import kernel1_pct


def read(trace):
    return kernel1_pct(trace)
