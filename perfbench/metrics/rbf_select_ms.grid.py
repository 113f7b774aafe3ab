"""Device time per grid call of the kernels launched under the port's
span ``ptv.grid.rbf.select`` (the local RBF's k-set selection: host
set-up, cell list and the generic block-centric exact top-k), in ms, from
the profiled stretch (``lib/span_device.py``)."""

from perfbench.lib.span_device import per_call_ms


def read(trace):
    return per_call_ms("ptv.grid.rbf.select")
