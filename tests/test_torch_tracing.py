"""Spans and counters of the port (``ptv_interpolation_tpu_torch.utils``):
the grid call's span tree inside ``capture()``, nothing recorded with
tracing off, the spans on ``torch.profiler``'s clock, and device-tensor
counters left unread until export."""

import json

import numpy as np
import pytest
import torch

from ptv_interpolation_tpu_torch import utils
from ptv_interpolation_tpu_torch.grid import create_grid
from ptv_interpolation_tpu_torch.interpolate import interpolate_field
from ptv_interpolation_tpu_torch.ops import fused_grid_knn as tfg
import torch_port_fixtures as fx

K = 10


def _call():
    """A small sibson grid call on the CPU through the fused route: the
    cloud fills [0, 12)³ and the grid reaches 13, so the far faces'
    nodes are uncovered and go to the repair ladder, whose fused stage
    serves all but a few far corners (brute force takes those)."""
    pts, vals, bounds, n = fx.uniform(n_pts=3000, n=12)
    return interpolate_field(pts, vals, create_grid(bounds, n),
                             method="sibson", sibson_neighbors=K,
                             use_grid_kernel="always", device="cpu")


def _children(spans):
    kids = {}
    for r in sorted(spans, key=lambda r: r["start_ns"]):
        kids.setdefault(r["parent"], []).append(r)
    return kids


def _names(kids, rec):
    return [c["name"] for c in kids.get(rec["id"], [])]


def test_grid_call_span_tree(monkeypatch):
    uncovered = []
    repair = tfg.repair_empty_nodes

    def seen(field, den, *a, **kw):
        uncovered.append(int((den == 0).sum()))
        return repair(field, den, *a, **kw)

    monkeypatch.setattr(tfg, "repair_empty_nodes", seen)
    with utils.capture() as rec:
        _call()
    spans = rec.spans()
    roots = [r for r in spans if r["parent"] is None]
    assert [r["name"] for r in roots] == ["ptv.grid"]
    root = roots[0]
    assert root["attrs"] == {"method": "sibson", "n_points": 3000,
                             "nodes": 12 ** 3, "k": K}
    assert {r["call"] for r in spans} == {root["id"]}
    by_id = {r["id"]: r for r in spans}
    for r in spans:
        if r["parent"] is not None:
            p = by_id[r["parent"]]
            assert p["start_ns"] <= r["start_ns"] <= r["end_ns"] <= \
                p["end_ns"]
            assert r["thread"] == p["thread"]

    kids = _children(spans)
    assert _names(kids, root) == ["ptv.grid.prepare", "ptv.grid.reassemble",
                                  "ptv.grid.repair"]
    prepare, _, repair_span = kids[root["id"]]
    assert _names(kids, prepare) == [
        "ptv.grid.upload", "ptv.grid.cells", "ptv.grid.capacity",
        "ptv.grid.panel", "ptv.grid.kernel1"]
    cells, capacity, kernel1 = (kids[prepare["id"]][i] for i in (1, 2, 4))
    assert _names(kids, cells) == [
        "ptv.wait.bounds", "ptv.wait.bounds", "ptv.wait.cell_cap",
        "ptv.wait.row_capacity"]
    assert _names(kids, capacity) == ["ptv.wait.block_capacity"]
    assert capacity["attrs"]["C"] == kernel1["attrs"]["C"] > 0
    assert kernel1["attrs"]["n_blocks"] > 0
    assert _names(kids, repair_span) == [
        "ptv.wait.repair.uncovered", "ptv.grid.repair.fused",
        "ptv.wait.repair.uncovered", "ptv.grid.repair.bruteforce"]
    fused = kids[repair_span["id"]][1]
    assert _names(kids, fused) == [
        "ptv.wait.repair.blocks", "ptv.wait.repair.survey",
        "ptv.wait.repair.capacity", "ptv.grid.panel", "ptv.grid.kernel1",
        "ptv.wait.repair.select", "ptv.wait.repair.select",
        "ptv.wait.repair.certified"]

    counts = rec.counters()
    assert len(uncovered) == 1 and uncovered[0] > 0
    assert counts["repair.uncovered"] == uncovered[0]
    assert repair_span["counters"]["repair.uncovered"] == uncovered[0]
    assert 0 < counts["repair.bruteforce"] < counts["repair.fused"]
    assert counts["repair.fused"] + counts["repair.bruteforce"] == \
        uncovered[0]
    waits = [r for r in spans if r["name"].startswith("ptv.wait.")]
    assert counts["host_syncs"] == len(waits) >= 13
    assert all(r["counters"] == {"host_syncs": 1} for r in waits)
    assert "kernel1.launches" not in counts       # the CPU runs no kernel


def test_tracing_off_records_nothing(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a profiler range opened with tracing off")

    monkeypatch.setattr(utils, "_record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not utils.tracing()
    before, totals = len(utils.spans()), utils.counters()
    _call()
    assert len(utils.spans()) == before and utils.counters() == totals
    assert utils.span("ptv.grid") is utils.span("ptv.grid.prepare")


def test_spans_on_the_profiler_clock(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _call()
    events = prof.events()
    grid = [e for e in events if e.name == "ptv.grid"]
    prepare = [e for e in events if e.name == "ptv.grid.prepare"]
    assert len(grid) == 1 and len(prepare) == 1
    g, p = grid[0], prepare[0]
    assert p.thread == g.thread
    assert g.time_range.start <= p.time_range.start
    assert p.time_range.end <= g.time_range.end
    # not user-scope ranges: the profiler would copy those onto the
    # device's timeline, where they read as device time
    ours = [e for e in events if e.name.startswith("ptv.")]
    assert ours and all(
        e.scope != int(torch._C._profiler.RecordScope.USER_SCOPE.value)
        and e.device_type == torch.autograd.DeviceType.CPU for e in ours)
    assert [r["name"] for r in utils.spans()].count("ptv.grid") >= 1

    with utils.profiler_trace(str(tmp_path)):
        _call()
    trace = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"ptv.grid", "ptv.grid.kernel1", "ptv.wait.bounds"} <= names


def test_stage_spans_nest_the_grid_call():
    timings = utils.StageTimings()
    with utils.capture() as rec:
        with timings.stage("interpolate"):
            _call()
    spans = rec.spans()
    stage = [r for r in spans if r["name"] == "ptv.stage.interpolate"]
    grid = [r for r in spans if r["name"] == "ptv.grid"]
    assert len(stage) == 1 and len(grid) == 1
    assert grid[0]["parent"] == stage[0]["id"]
    assert stage[0]["parent"] is None
    assert {r["call"] for r in spans} == {stage[0]["id"]}
    wall = (stage[0]["end_ns"] - stage[0]["start_ns"]) * 1e-9
    assert 0 < wall <= timings.stages["interpolate"]
    assert list(timings.stages) == ["interpolate"]


def test_device_tensor_counter_read_at_export():
    """A tensor counted inside a span is read when the record is exported,
    not when it is counted: a count the device writes after the launch
    returns (here, after the call) shows."""
    tally = torch.zeros(1, dtype=torch.int32)
    with utils.capture() as rec:
        with utils.span("ptv.test") as sp:
            utils.count("test.overflow", tally)
            utils.count("test.calls")
        assert sp.rec["counters"]["test.overflow"] == 0
        tally += 7
    assert rec.counters() == {"test.overflow": 7, "test.calls": 1}
    assert rec.spans()[0]["counters"] == {"test.overflow": 7,
                                          "test.calls": 1}


def test_device_tensor_counters_fold_unread():
    """Past ``_FOLD`` pending tensors the increments fold into one device
    sum per counter (queued after the writes, as a stream orders them):
    memory stays bounded and the totals stay exact."""
    n = 3 * utils._FOLD + 5
    with utils.capture() as rec:
        with utils.span("ptv.test") as sp:
            for i in range(n):
                utils.count("test.overflow", torch.full((1,), i + 1,
                                                        dtype=torch.int32))
        assert len(sp.rec["counters"].pending) < utils._FOLD
    want = n * (n + 1) // 2
    assert rec.counters() == {"test.overflow": want}
    assert rec.spans()[0]["counters"] == {"test.overflow": want}


def test_count_outside_a_span_goes_to_the_totals():
    with utils.capture() as rec:
        utils.count("test.loose", 4)
        utils.count("test.loose")
        utils.count("test.zero", 0)
    assert rec.counters() == {"test.loose": 5, "test.zero": 0}
    assert rec.spans() == []
    with utils.capture() as rec:
        pass
    assert rec.counters() == {} and rec.spans() == []


def test_span_records_when_the_block_raises():
    with utils.capture() as rec:
        with pytest.raises(ValueError):
            with utils.span("ptv.test.fails", what=1):
                raise ValueError("inside")
        with utils.span("ptv.test.after"):
            pass
    spans = rec.spans()
    assert [r["name"] for r in spans] == ["ptv.test.fails", "ptv.test.after"]
    assert all(r["parent"] is None for r in spans)
    assert spans[0]["attrs"] == {"what": 1}
    assert np.all([r["end_ns"] >= r["start_ns"] for r in spans])
