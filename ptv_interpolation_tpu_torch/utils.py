"""Observability utilities: per-stage wall-clock timers and profiler traces.

Counterpart of ``ptv_interpolation_tpu/utils.py``: :class:`StageTimings` is
the same class; :func:`profiler_trace` wraps the block in a
``torch.profiler`` trace (CPU, and CUDA where a card is present) and
writes it as a Chrome trace (``trace.json``, viewable in Perfetto or
``chrome://tracing``).

A stage's wall is a host clock. The pipeline's stages end in host numpy
arrays, so device work inside a stage has finished when its timer stops.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional


class StageTimings:
    """Accumulates named stage durations; used by the pipeline."""

    def __init__(self):
        self.stages: Dict[str, float] = {}
        self._order = []

    @contextlib.contextmanager
    def stage(self, name: str, verbose: bool = False):
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            self.stages[name] = self.stages.get(name, 0.0) + dt
            if name not in self._order:
                self._order.append(name)
            if verbose:
                print(f"  [timing] {name}: {dt:.3f}s")

    def report(self) -> str:
        total = sum(self.stages.values())
        lines = ["--- Stage timings ---"]
        for name in self._order:
            dt = self.stages[name]
            lines.append(f"  {name:30s} {dt:8.3f}s ({dt / max(total, 1e-9):5.1%})")
        lines.append(f"  {'total':30s} {total:8.3f}s")
        return "\n".join(lines)


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """Wrap a block in a ``torch.profiler`` trace when ``log_dir`` is
    given and write it to ``log_dir/trace.json``; no-op otherwise."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
