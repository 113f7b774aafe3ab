"""The local-RBF solve's share of its roofline: the least time of the
profiled units' solves (``roofline/rbf_solve.py``, from the problem's
sizes) over the device time of the kernels launched under the port's
span ``ptv.grid.rbf.solve`` in them, in %."""

from perfbench.lib.span_device import seconds
from perfbench.roofline.rbf_solve import least


def read(trace):
    measured = seconds("ptv.grid.rbf.solve")
    if measured is None or not trace.sizes:
        return None
    return 100.0 * sum(least(s) for s in trace.sizes) / measured
