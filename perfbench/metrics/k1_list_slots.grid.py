"""Panel slots on kernel 1's per-warp lists per grid call: the port's
counter ``kernel1.list_slots`` summed over each ``ptv.grid`` call of the
profiled stretch (main pass and fused repair); None where the port does
not count it."""

from perfbench.lib.spans import counter, records


def read(trace):
    recs = records()
    if not any("kernel1.list_slots" in r["counters"] for r in recs):
        return None
    return counter(recs, "kernel1.list_slots")
