"""Grid nodes that reach the repair ladder per grid call: the port's
counter ``repair.uncovered`` summed over each ``ptv.grid`` call of the
profiled stretch."""

from perfbench.lib.spans import counter, records


def read(trace):
    return counter(records(), "repair.uncovered")
