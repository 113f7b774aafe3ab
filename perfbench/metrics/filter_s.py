"""Mean wall per dataset of the pipeline's ``filter_outliers`` stage
(``StageTimings``, a host clock around work that ends in host numpy), over
the traced run's datasets outside the profiled stretch."""

from perfbench.lib.readers import stage_mean


def read(trace):
    return stage_mean(trace, "filter_outliers")
