"""What the per-layer metric readers share."""

import re

from perfbench.roofline import kernels

KERNEL1 = re.compile(r"(^|[\s:])fused_kernel\s*[<(]")
KERNEL2 = re.compile(r"(^|[\s:])mad_kernel\s*[<(]")


def stage_mean(trace, stage):
    """Mean wall of a ``StageTimings`` stage over the unprofiled units
    that ran it; None where none did."""
    walls = [s[stage] for s in trace.stages if stage in s]
    return sum(walls) / len(walls) if walls else None


def kernel_seconds(trace, pattern):
    return sum(s for name, (_, s) in trace.device.kernels.items()
               if pattern.search(name))


def roofline_pct(trace, pattern, work):
    """Least time of the profiled units' work over the kernel's measured
    device time, in %; None where the kernel left no device time."""
    measured = kernel_seconds(trace, pattern)
    if measured <= 0:
        return None
    least = sum(kernels.least_seconds(*work(s)) for s in trace.sizes)
    return 100.0 * least / measured


def kernel1_pct(trace):
    return roofline_pct(trace, KERNEL1, lambda s: kernels.kernel1(
        s["k1_nodes"], s["k1_k"], s["k1_points"]))


def kernel2_pct(trace):
    return roofline_pct(trace, KERNEL2, lambda s: kernels.kernel2(
        s["k2_points"], s["k2_k"]))


def launches(trace):
    if not trace.device.units or not trace.device.kernels:
        return None
    return sum(c for c, _ in trace.device.kernels.values()) / trace.device.units


def idle_pct(trace):
    d = trace.device
    if d.window_s <= 0 or d.busy_s <= 0:
        return None
    return 100.0 * (1.0 - d.busy_s / d.window_s)
