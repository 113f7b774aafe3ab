"""Device time per grid call of the kernels launched under the port's
span ``ptv.grid.rbf.solve`` (the batched saddle solves and the models'
evaluation), in ms, from the profiled stretch
(``lib/span_device.py``)."""

from perfbench.lib.span_device import per_call_ms


def read(trace):
    return per_call_ms("ptv.grid.rbf.solve")
