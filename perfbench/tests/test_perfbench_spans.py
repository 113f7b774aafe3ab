"""The readers of the port's spans and counters (``lib/spans.py`` and the
four ``metrics/*.grid.py`` that use it) on a synthetic span list: two
grid calls with nested children and a first wait, exact values, and None
where no call was recorded or the port keeps no spans."""

import pytest

from perfbench.lib import spans as lib
from perfbench.lib.manifest import load_module

from conftest import BENCH

METRICS = ("prepare_ms.grid", "repair_ms.grid", "host_syncs.grid",
           "repair_nodes.grid")
MS = 1_000_000                    # ns per ms


def _span(sid, name, parent, call, start_ms, end_ms, **counters):
    return {"name": name, "id": sid, "parent": parent, "call": call,
            "thread": 1, "start_ns": int(start_ms * MS),
            "end_ns": int(end_ms * MS), "attrs": {}, "counters": counters}


def _two_calls():
    """Call 1: prepare 10 ms with two waits, repair 6 ms whose first child
    is a 2 ms wait; call 2 (under a pipeline stage): prepare 14 ms, repair
    4 ms whose first child is the fused stage, not a wait. Oldest first,
    as the port exports them (a span ends after its children)."""
    return [
        _span(3, "ptv.wait.bounds", 2, 1, 1, 2, host_syncs=1),
        _span(4, "ptv.wait.block_capacity", 2, 1, 5, 6, host_syncs=1),
        _span(2, "ptv.grid.prepare", 1, 1, 0, 10),
        _span(6, "ptv.wait.repair.uncovered", 5, 1, 12, 14, host_syncs=1),
        _span(7, "ptv.grid.repair.fused", 5, 1, 14, 18),
        _span(5, "ptv.grid.repair", 1, 1, 12, 18, **{"repair.uncovered": 300,
                                                       "repair.fused": 300}),
        _span(1, "ptv.grid", None, 1, 0, 19),
        _span(12, "ptv.grid.prepare", 11, 10, 20, 34),
        _span(14, "ptv.grid.repair.fused", 13, 10, 35, 38,
              **{"repair.fused": 98}),
        _span(15, "ptv.wait.repair.select", 14, 10, 36, 37, host_syncs=1),
        _span(13, "ptv.grid.repair", 11, 10, 35, 39,
              **{"repair.uncovered": 100}),
        _span(11, "ptv.grid", 10, 10, 20, 40),
        _span(10, "ptv.stage.interpolate", None, 10, 20, 41, host_syncs=5),
    ]


def test_calls_and_subtrees():
    got = lib.calls(_two_calls())
    assert [root["id"] for root, _ in got] == [1, 11]
    assert sorted(r["id"] for r in got[0][1]) == [1, 2, 3, 4, 5, 6, 7]
    assert sorted(r["id"] for r in got[1][1]) == [11, 12, 13, 14, 15]


def test_readers_exact():
    recs = _two_calls()
    assert lib.span_ms(recs, "ptv.grid.prepare") == pytest.approx(12.0)
    # (6 - 2) and 4: the second call's first child is not the wait
    assert lib.less_first_child_ms(
        recs, "ptv.grid.repair",
        "ptv.wait.repair.uncovered") == pytest.approx(4.0)
    # the stage span's own count lies outside both calls
    assert lib.counter(recs, "host_syncs") == pytest.approx(2.0)
    assert lib.counter(recs, "repair.uncovered") == pytest.approx(200.0)
    assert lib.counter(recs, "repair.fused") == pytest.approx(199.0)
    assert lib.span_ms(recs, "ptv.grid.kernel1") is None


def test_readers_none_without_a_call():
    recs = [r for r in _two_calls() if r["name"] != "ptv.grid"]
    assert lib.span_ms(recs, "ptv.grid.prepare") is None
    assert lib.less_first_child_ms(recs, "ptv.grid.repair",
                                   "ptv.wait.repair.uncovered") is None
    assert lib.counter(recs, "host_syncs") is None
    assert lib.counter([], "repair.uncovered") is None


@pytest.mark.parametrize("name,want", [
    ("prepare_ms.grid", 12.0), ("repair_ms.grid", 4.0),
    ("host_syncs.grid", 2.0), ("repair_nodes.grid", 200.0)])
def test_metric_files_read_the_port(monkeypatch, name, want):
    from ptv_interpolation_tpu_torch import utils
    monkeypatch.setattr(utils, "spans", _two_calls)
    assert load_module(BENCH / "metrics", name).read(None) == \
        pytest.approx(want)
    monkeypatch.setattr(utils, "spans", lambda: [])
    assert load_module(BENCH / "metrics", name).read(None) is None


@pytest.mark.parametrize("name", METRICS)
def test_metric_files_without_the_exporter(monkeypatch, name):
    """A port that keeps no spans (one older than them) gives None and
    does not raise."""
    from ptv_interpolation_tpu_torch import utils
    monkeypatch.delattr(utils, "spans")
    assert lib.records() == []
    assert load_module(BENCH / "metrics", name).read(None) is None
