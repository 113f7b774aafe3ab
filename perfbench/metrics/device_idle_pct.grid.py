"""The device's idle share of the profiled stretch, in %: one minus the
union of every device interval (kernels, copies, sets) over the stretch's
span."""

from perfbench.lib.readers import idle_pct


def read(trace):
    return idle_pct(trace)
