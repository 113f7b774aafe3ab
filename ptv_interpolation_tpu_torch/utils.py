"""Observability utilities: per-stage timers, spans and counters on the
profiler's clock, and profiler traces.

Counterpart of ``ptv_interpolation_tpu/utils.py``: :class:`StageTimings` is
the same class; :func:`profiler_trace` wraps the block in a
``torch.profiler`` trace (CPU, and CUDA where a card is present) and
writes it as a Chrome trace (``trace.json``, viewable in Perfetto or
``chrome://tracing``).

A stage's wall is a host clock (``time.perf_counter``). The pipeline's
stages end in host numpy arrays, so device work inside a stage has
finished when its timer stops.

**Spans and counters.** :func:`span` marks a stretch of host work by name,
:func:`wait` a point where the host blocks on the device, and
:func:`count` adds to a named counter. They record only while tracing is
on: while a ``torch.profiler`` profile runs, or inside :func:`capture`.
Then a span opens a profiler range of its name under a profiler (so it
lies on the profiler's clock, a host event in the same trace as the
device's activity) and appends a record to a bounded in-memory list that
:func:`spans` exports. With tracing off a span is one check and a shared
null context, and nothing is recorded.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Dict, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

SPAN_LIMIT = 32768       # finished span records kept, the oldest dropped
_FOLD = 256              # device-tensor increments kept before folding

# The profiler range of a span: a function-scope range, a host event on
# the calling thread only. ``torch.profiler.record_function`` opens a
# user-scope range, which the profiler also copies onto the device's
# timeline (from the span's first launch to its last), where a reader of
# device time takes it for device work.
_record_function = torch._C._profiler._RecordFunctionFast


class StageTimings:
    """Accumulates named stage durations; used by the pipeline. Each stage
    is also the span ``ptv.stage.<name>``."""

    def __init__(self):
        self.stages: Dict[str, float] = {}
        self._order = []

    @contextlib.contextmanager
    def stage(self, name: str, verbose: bool = False):
        t0 = time.perf_counter()
        try:
            with span("ptv.stage." + name):
                yield
        finally:
            dt = time.perf_counter() - t0
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
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# ---------------------------------------------------------------------------
# Spans and counters
# ---------------------------------------------------------------------------

class _Counts(dict):
    """Counter name → int. Increments given as device tensors are kept
    aside, unread, until :meth:`resolve` (a long run of them is folded
    into one tensor on the device, still unread)."""

    def __init__(self):
        super().__init__()
        self.pending = []

    def add(self, name: str, n):
        if isinstance(n, torch.Tensor):
            self.setdefault(name, 0)
            self.pending.append((name, n))
            if len(self.pending) >= _FOLD:
                groups = {}
                for key, t in self.pending:
                    groups.setdefault(key, []).append(t.reshape(-1))
                self.pending = [(key, torch.cat(ts).sum())
                                for key, ts in groups.items()]
        else:
            self[name] = self.get(name, 0) + int(n)

    def resolve(self) -> Dict[str, int]:
        for name, t in self.pending:
            self[name] += int(t.sum())
        self.pending = []
        return dict(self)


class _Record:
    """What tracing has recorded: finished spans (at most ``SPAN_LIMIT``)
    and the process's counter totals."""

    def __init__(self):
        self._spans = collections.deque(maxlen=SPAN_LIMIT)
        self._totals = _Counts()
        self._lock = threading.Lock()

    def clear(self):
        with self._lock:
            self._spans.clear()
            self._totals = _Counts()

    def spans(self) -> list:
        """The finished spans, oldest first, each a dict: ``name``,
        ``id``, ``parent`` (None at a root), ``call`` (the id of its
        root), ``thread``, ``start_ns`` and ``end_ns``
        (``time.perf_counter_ns``), ``attrs`` and ``counters``."""
        with self._lock:
            recs = list(self._spans)
        return [dict(r, counters=r["counters"].resolve()) for r in recs]

    def counters(self) -> Dict[str, int]:
        """Counter totals over everything recorded since the last
        :func:`capture` began."""
        with self._lock:
            return self._totals.resolve()


_RECORD = _Record()
_IDS = itertools.count(1)
_local = threading.local()
_capturing = 0


def tracing() -> bool:
    """True while a ``torch.profiler`` profile runs or a :func:`capture`
    block is open."""
    return _capturing > 0 or _autograd_profiler._is_profiler_enabled


def _open_spans() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def set(self, **attrs):
        pass


_NULL = _NullSpan()


class _Span:
    __slots__ = ("rec", "_fn")

    def __init__(self, name: str, attrs: dict):
        self.rec = {"name": name, "attrs": attrs, "counters": _Counts()}
        self._fn = None

    def __enter__(self):
        stack = _open_spans()
        rec = self.rec
        rec["id"] = sid = next(_IDS)
        rec["parent"] = stack[-1]["id"] if stack else None
        rec["call"] = stack[-1]["call"] if stack else sid
        rec["thread"] = threading.get_ident()
        if _autograd_profiler._is_profiler_enabled:
            self._fn = _record_function(rec["name"])
            self._fn.__enter__()
        stack.append(rec)
        rec["start_ns"] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.rec["end_ns"] = time.perf_counter_ns()
        _open_spans().pop()
        if self._fn is not None:
            self._fn.__exit__(*exc)
        with _RECORD._lock:
            _RECORD._spans.append(self.rec)
        return False

    def set(self, **attrs):
        """Add attributes known only inside the span."""
        self.rec["attrs"].update(attrs)


def span(name: str, **attrs):
    """A context manager marking host work as the span ``name`` with
    ``attrs``; its ``set(**attrs)`` adds attributes later. Records only
    while :func:`tracing`; otherwise a shared null context."""
    if not tracing():
        return _NULL
    return _Span(name, attrs)


class _Wait(_Span):
    __slots__ = ()

    def __enter__(self):
        super().__enter__()
        count("host_syncs")
        return self


def wait(site: str):
    """:func:`span` ``ptv.wait.<site>`` around one read from the device to
    the host (the host waits there until the device's queue drains); it
    counts one ``host_syncs``."""
    if not tracing():
        return _NULL
    return _Wait("ptv.wait." + site, {})


def count(name: str, n=1):
    """Add ``n`` to the counter ``name`` of the innermost open span and to
    the process's totals, while :func:`tracing`. ``n`` may be a one-element
    device tensor: it is read only when :func:`spans` or :func:`counters`
    export it."""
    if not tracing():
        return
    stack = _open_spans()
    if stack:
        stack[-1]["counters"].add(name, n)
    with _RECORD._lock:
        _RECORD._totals.add(name, n)


spans = _RECORD.spans
counters = _RECORD.counters


@contextlib.contextmanager
def capture():
    """Record spans and counters without a profiler (tests, smoke runs):
    clears the record, turns tracing on for the block, and yields the
    record (its ``spans()`` and ``counters()``)."""
    global _capturing
    _RECORD.clear()
    with _RECORD._lock:
        _capturing += 1
    try:
        yield _RECORD
    finally:
        with _RECORD._lock:
            _capturing -= 1
