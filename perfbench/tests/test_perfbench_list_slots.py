"""The reader of kernel 1's list counter (``metrics/k1_list_slots.grid.py``)
on a synthetic span list: two grid calls whose kernel spans count
``kernel1.list_slots``, the exact mean per call, and None where the port
does not count it or keeps no spans."""

import pytest

from perfbench.lib.manifest import load_module

from conftest import BENCH

NAME = "k1_list_slots.grid"
MS = 1_000_000                    # ns per ms


def _span(sid, name, parent, call, start_ms, end_ms, **counters):
    return {"name": name, "id": sid, "parent": parent, "call": call,
            "thread": 1, "start_ns": int(start_ms * MS),
            "end_ns": int(end_ms * MS), "attrs": {}, "counters": counters}


def _two_calls(with_counter=True):
    """Call 1: the main pass's kernel span lists 1 000 slots, the fused
    repair's 200; call 2: the main pass lists 1 400. A kernel span outside
    every call lists 5 000."""
    def slots(n):
        return {"kernel1.list_slots": n, "kernel1.list_overflow": 0} \
            if with_counter else {}
    return [
        _span(3, "ptv.grid.kernel1", 2, 1, 1, 2, **{"kernel1.launches": 1},
              **slots(1000)),
        _span(2, "ptv.grid.prepare", 1, 1, 0, 3),
        _span(5, "ptv.grid.kernel1", 4, 1, 4, 5, **slots(200)),
        _span(4, "ptv.grid.repair.fused", 1, 1, 3, 6),
        _span(1, "ptv.grid", None, 1, 0, 7),
        _span(8, "ptv.grid.kernel1", 7, 6, 8, 9, **slots(1400)),
        _span(7, "ptv.grid.prepare", 6, 6, 8, 10),
        _span(6, "ptv.grid", None, 6, 8, 11),
        _span(9, "ptv.grid.kernel1", None, 9, 12, 13, **slots(5000)),
    ]


def test_reads_the_mean_per_call(monkeypatch):
    from ptv_interpolation_tpu_torch import utils
    monkeypatch.setattr(utils, "spans", _two_calls)
    assert load_module(BENCH / "metrics", NAME).read(None) == \
        pytest.approx(1300.0)


def test_none_where_the_port_does_not_count(monkeypatch):
    """A port older than the counter, one that recorded no call, and one
    without the exporter give None and do not raise."""
    from ptv_interpolation_tpu_torch import utils
    monkeypatch.setattr(utils, "spans", lambda: _two_calls(False))
    assert load_module(BENCH / "metrics", NAME).read(None) is None
    monkeypatch.setattr(utils, "spans", lambda: [])
    assert load_module(BENCH / "metrics", NAME).read(None) is None
    monkeypatch.delattr(utils, "spans")
    assert load_module(BENCH / "metrics", NAME).read(None) is None
