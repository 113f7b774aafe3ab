"""Reads from the device to the host per grid call: the port's counter
``host_syncs`` (one per ``ptv.wait.<site>`` span) summed over each
``ptv.grid`` call of the profiled stretch."""

from perfbench.lib.spans import counter, records


def read(trace):
    return counter(records(), "host_syncs")
