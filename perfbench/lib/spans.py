"""Per-call readings of the port's own spans and counters.

The port records spans and counters while ``torch.profiler`` runs, so the
profiled stretch leaves them in ``ptv_interpolation_tpu_torch.utils``;
:func:`records` exports them (a port without that exporter gives none,
and every reader below then gives None). Values are per ``ptv.grid``
root, one grid call: each reader averages over the calls that have what
it reads.
"""

ROOT = "ptv.grid"


def records():
    """The port's finished span records; empty where it keeps none."""
    try:
        from ptv_interpolation_tpu_torch import utils
    except ImportError:
        return []
    export = getattr(utils, "spans", None)
    return list(export()) if callable(export) else []


def calls(recs, root=ROOT):
    """``(root span, its subtree)`` for each span named ``root``; the
    subtree holds the root and every span under it."""
    kids = {}
    for r in recs:
        kids.setdefault(r["parent"], []).append(r)
    out = []
    for r in recs:
        if r["name"] != root:
            continue
        sub, todo = [], [r]
        while todo:
            x = todo.pop()
            sub.append(x)
            todo.extend(kids.get(x["id"], []))
        out.append((r, sub))
    return out


def wall_ms(r):
    return (r["end_ns"] - r["start_ns"]) * 1e-6


def per_call(recs, value):
    """Mean of ``value(root, subtree)`` over the calls where it is not
    None; None where no call gives one."""
    vals = [value(root, sub) for root, sub in calls(recs)]
    vals = [v for v in vals if v is not None]
    return sum(vals) / len(vals) if vals else None


def span_ms(recs, name):
    """Mean wall per call of the spans ``name`` in it, in ms."""
    def value(root, sub):
        walls = [wall_ms(r) for r in sub if r["name"] == name]
        return sum(walls) if walls else None
    return per_call(recs, value)


def less_first_child_ms(recs, name, first):
    """Mean wall per call of the spans ``name``, each less its first child
    where that child is named ``first``, in ms."""
    def value(root, sub):
        walls = []
        for r in sub:
            if r["name"] != name:
                continue
            kids = sorted((c for c in sub if c["parent"] == r["id"]),
                          key=lambda c: c["start_ns"])
            lead = wall_ms(kids[0]) if kids and kids[0]["name"] == first \
                else 0.0
            walls.append(wall_ms(r) - lead)
        return sum(walls) if walls else None
    return per_call(recs, value)


def counter(recs, name):
    """Mean per call of the counter ``name`` summed over the call's
    spans."""
    return per_call(recs, lambda root, sub: sum(
        r["counters"].get(name, 0) for r in sub))
