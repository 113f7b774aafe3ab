"""CUDA kernel launches per dataset: the kernel records of the profiled
stretch (copies and sets left out) over its datasets."""

from perfbench.lib.readers import launches


def read(trace):
    return launches(trace)
