"""Device time under the port's spans in a profiled stretch.

Each kernel that a profiled stretch ran is assigned to the spans of the
port (``ptv.…``) that were open on the host when it was launched: the
profiler links a kernel to the op that launched it by their correlation
id (``FunctionEvent.kernels``), and the op's chain of enclosing host
ranges (``cpu_parent``) holds the port's spans, the innermost first. A
span's device time is the sum over every kernel launched anywhere under
it; copies and sets (``Memcpy…``, ``Memset…``) are left out, as
``lib/trace.py`` keeps them apart.

:func:`install` has every ``torch.profiler.profile`` leave this table
when its events are read (``lib/trace.py::profile_units`` reads them
once, after the stretch), so the table describes the last profiled
stretch of the process; a step that wants it calls :func:`install` in its
``prepare``. A port without the spans leaves no time under their names,
and the readers below then give None.
"""

from __future__ import annotations

from collections import defaultdict

PREFIX = "ptv."
ROOT = "ptv.grid"

_LAST = {"under": {}, "calls": 0}


def _is_copy(name):
    return name.startswith("Memcpy") or name.startswith("Memset")


def summarise(events):
    """``{"under": {span name: device seconds}, "calls": n}`` of a list of
    the profiler's ``FunctionEvent``s: every kernel's time added once to
    each distinct ``ptv.`` name on its launching op's chain of enclosing
    host ranges, and ``n`` the number of ``ptv.grid`` roots."""
    under = defaultdict(float)
    calls = 0
    for e in events:
        if e.name == ROOT:
            calls += 1
        secs = sum(k.duration for k in (getattr(e, "kernels", None) or ())
                   if not _is_copy(k.name)) * 1e-6
        if secs <= 0:
            continue
        seen, p = set(), e
        while p is not None:
            if p.name.startswith(PREFIX) and p.name not in seen:
                seen.add(p.name)
                under[p.name] += secs
            p = p.cpu_parent
    return {"under": dict(under), "calls": calls}


def install():
    """Wrap ``torch.profiler.profile.events`` (once per process) so that
    reading a profile's events also leaves their summary here."""
    from torch.profiler import profile
    if getattr(profile.events, "_leaves_span_device", False):
        return
    original = profile.events

    def events(self):
        out = original(self)
        if out is not None:
            _LAST.clear()
            _LAST.update(summarise(out))
        return out

    events._leaves_span_device = True
    profile.events = events


def seconds(name):
    """Device seconds under the span ``name`` over the last profiled
    stretch; None where no kernel ran under it."""
    secs = _LAST["under"].get(name)
    return secs if secs else None


def per_call_ms(name):
    """Device milliseconds under the span ``name`` per ``ptv.grid`` call
    of the last profiled stretch; None where there is none."""
    secs = seconds(name)
    if secs is None or not _LAST["calls"]:
        return None
    return 1e3 * secs / _LAST["calls"]
