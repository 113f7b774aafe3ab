"""Read a ``torch.profiler`` trace of a steady stretch of whole units.

``profile_units`` runs a callable under the profiler (CPU and, on a card,
CUDA activities) inside a ``perfbench.stretch`` annotation and returns a
:class:`DeviceTrace`: device time and launches by kernel name, copies
apart, the union of every device interval (busy time), the stretch's
host wall, and the idle gaps labelled by the innermost host op that was
running at each gap's middle.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field

STRETCH = "perfbench.stretch"
NO_OP = "host work outside any torch op"
NAME_CHARS = 160          # kernel names are cut to this many characters


@dataclass
class DeviceTrace:
    units: int = 0
    window_s: float = 0.0                 # the stretch's annotated span
    busy_s: float = 0.0                   # union of device intervals
    kernels: dict = field(default_factory=dict)   # name -> [count, seconds]
    copies: dict = field(default_factory=dict)    # name -> [count, seconds]
    idle: dict = field(default_factory=dict)      # host label -> seconds

    def breakdown(self, top=10):
        ops = sorted(((n, s) for n, (_, s) in
                      {**self.kernels, **self.copies}.items()),
                     key=lambda x: -x[1])[:top]
        gaps = sorted(self.idle.items(), key=lambda x: -x[1])[:top]
        return {"device_ops": [[n[:NAME_CHARS], s] for n, s in ops],
                "idle_gaps": [[n[:NAME_CHARS], s] for n, s in gaps]}


def _is_copy(name):
    return name.startswith("Memcpy") or name.startswith("Memset")


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def _label_gaps(gaps, host_events):
    """Seconds of idle device time per label: the innermost host event
    (properly nested on one thread) open at each gap's middle."""
    evs = sorted(host_events, key=lambda x: (x[0], -x[1]))
    starts = [s for s, _, _ in evs]
    out = defaultdict(float)
    stack, i = [], 0
    for mid, length in sorted(((s + e) / 2, e - s) for s, e in gaps):
        j = bisect.bisect_right(starts, mid)
        while i < j:
            s, e, name = evs[i]
            while stack and stack[-1][1] < s:
                stack.pop()
            stack.append((s, e, name))
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        out[stack[-1][2] if stack else NO_OP] += length * 1e-6
    return dict(out)


def profile_units(torch, run_units):
    """Profile ``run_units()`` (which returns how many units it ran) and
    read the trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])

    def sync():
        if cuda:
            torch.cuda.synchronize()

    sync()
    with profile(activities=acts) as prof:
        with record_function(STRETCH):
            t0 = time.perf_counter()
            units = run_units()
            sync()
            wall = time.perf_counter() - t0
    out = DeviceTrace(units=units, window_s=wall)
    events = prof.events()
    stretch = [e for e in events if e.name == STRETCH
               and e.device_type == DeviceType.CPU]
    if not stretch:
        return out
    s0, s1 = stretch[0].time_range.start, stretch[0].time_range.end
    out.window_s = (s1 - s0) * 1e-6
    thread = stretch[0].thread
    spans, host = [], []
    for e in events:
        if e.name.startswith("perfbench.") or e.name.startswith("ProfilerStep"):
            continue
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            table = out.copies if _is_copy(e.name) else out.kernels
            row = table.setdefault(e.name, [0, 0.0])
            row[0] += 1
            row[1] += (end - start) * 1e-6
            spans.append((max(start, s0), min(end, s1)))
        elif e.thread == thread:
            host.append((start, end, e.name))
    busy = _union([(s, e) for s, e in spans if e > s])
    out.busy_s = sum(e - s for s, e in busy) * 1e-6
    gaps, t = [], s0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if s1 > t:
        gaps.append((t, s1))
    out.idle = _label_gaps(gaps, host)
    return out
