"""Mean wall per grid call of the port's span ``ptv.grid.prepare``, in ms:
the host's critical path from the call's entry until kernel 1's main
launch returns (the upload, the cell list, the panel width, phase 1),
from the spans the port recorded over the profiled stretch."""

from perfbench.lib.spans import records, span_ms


def read(trace):
    return span_ms(records(), "ptv.grid.prepare")
