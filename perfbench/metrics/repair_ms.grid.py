"""Mean wall per grid call of the port's span ``ptv.grid.repair``, less its
first child ``ptv.wait.repair.uncovered`` (where the host waits for
kernel 1's main pass to drain), in ms: the repair ladder's own host and
device time, from the spans the port recorded over the profiled
stretch."""

from perfbench.lib.spans import less_first_child_ms, records


def read(trace):
    return less_first_child_ms(records(), "ptv.grid.repair",
                               "ptv.wait.repair.uncovered")
