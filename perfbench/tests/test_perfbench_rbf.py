"""The local-RBF cell ``uniform256_rbf_tps`` on the CPU at its tiny size
(its last line, the control failing its limits, each fault of the timed
path failing ``correct``), the reader of device time under the port's
spans (``lib/span_device.py``) on a synthetic event tree and on a real
profile, and the solve's roofline arithmetic."""

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from conftest import last_json, run_cpu
from perfbench.lib import span_device
from perfbench.roofline import rbf_solve
from perfbench.roofline.kernels import least_seconds

CELL = "uniform256_rbf_tps"
RUN = ["--seed", "4294967311", "--seconds", "1", "--device", "cpu"]


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line(tiny_root, trace):
    out = last_json(run_cpu(tiny_root, ["--workload", CELL, "--trace",
                                        str(trace), *RUN]))
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert list(out["checks"]) == ["field_l2", "edge_l2", "field_gap"]
    if trace:
        # the CPU runs no kernel, so no device metric finds a reading
        assert out["metrics"] == {}
    else:
        assert set(out["metrics"]) == {"setup_s", "grid_s"}


def test_control_fails(tiny_root):
    """The reference in bfloat16 in the program's place fails at least
    one of the cell's numbers; the program passes all of them."""
    out = tiny_root / "cal_rbf.json"
    proc = run_cpu(tiny_root, ["--workload", CELL, "--seeds", "5",
                               "--control-seeds", "6", "--device", "cpu",
                               "--out", str(out)],
                   script="perfbench/calibrate.py")
    assert proc.returncode == 0, proc.stderr[-3000:]
    table = json.loads(out.read_text())
    limits = {k: v["limit"] for k, v in table["summary"].items()}
    program = next(iter(table["program"].values()))
    control = next(iter(table["control"].values()))
    assert all(program[k] <= limits[k] for k in limits), program
    assert any(not control[k] <= limits[k] for k in limits), control


@pytest.mark.parametrize("fault", ["half_tracks", "answer_altered"])
def test_fault_is_not_correct(tiny_root, fault):
    runner = Path(__file__).resolve().parent / "fault_run.py"
    proc = run_cpu(tiny_root, [str(tiny_root), fault, "--workload", CELL,
                               "--trace", "0", *RUN], script=runner)
    assert last_json(proc)["correct"] is False


def _event(name, parent=None, kernels=()):
    return SimpleNamespace(name=name, cpu_parent=parent, kernels=[
        SimpleNamespace(name=n, duration=us) for n, us in kernels])


def test_kernels_go_to_every_enclosing_span():
    """A kernel's time (µs) goes once to each distinct ``ptv.`` name on
    its op's chain of host ranges; copies and kernels outside any span
    go nowhere; each ``ptv.grid`` root is one call."""
    root = _event("ptv.grid")
    select = _event("ptv.grid.rbf.select", root)
    wait = _event("ptv.wait.bounds", select)
    solve = _event("ptv.grid.rbf.solve", root)
    inner = _event("ptv.grid.rbf.solve", solve)
    events = [root, select, wait, solve, inner,
              _event("aten::topk", select, [("topk", 300.0)]),
              _event("aten::amax", wait, [("reduce", 20.0),
                                          ("Memcpy DtoH", 5.0)]),
              _event("aten::mul", inner, [("mul", 100.0)]),
              _event("aten::add", None, [("add", 7.0)])]
    got = span_device.summarise(events)
    assert got["calls"] == 1
    assert got["under"] == pytest.approx({
        "ptv.grid": 420e-6, "ptv.grid.rbf.select": 320e-6,
        "ptv.wait.bounds": 20e-6, "ptv.grid.rbf.solve": 100e-6})


def test_a_profile_leaves_its_calls():
    """With the wrapper installed, reading a profile's events leaves its
    table: two calls of the route, and on the CPU no device time, so the
    readers give None."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ptv_interpolation_tpu_torch.grid import create_grid
    from ptv_interpolation_tpu_torch.interpolate import interpolate_field
    span_device.install()
    span_device.install()                   # once per process
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 8, (600, 3)).astype(np.float32)
    vals = rng.normal(size=(600, 3)).astype(np.float32)
    grid = create_grid(((0, 9),) * 3, 8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            interpolate_field(pts, vals, grid, method="rbf",
                              use_grid_kernel="always", device="cpu")
    prof.events()
    assert span_device._LAST["calls"] == 2
    assert span_device.per_call_ms("ptv.grid.rbf.solve") is None


def test_solve_roofline_at_the_headline():
    """256³ nodes, k = 20, m = 4, 1M points, 3 channels: 6 408
    multiply-adds a node (LU 4 608, substitutions 1 728, evaluation 72),
    3.21 ms at the fp32 rate; 2.91 GB once, 0.87 ms; operations bound."""
    ops, n_bytes = rbf_solve.rbf_solve(256 ** 3, 20, 4, 1_000_000)
    assert ops == 256 ** 3 * 6408
    assert n_bytes == 4 * (256 ** 3 * 43 + 1_000_000 * 6)
    assert ops / 33.5e12 * 1e3 == pytest.approx(3.209, abs=1e-3)
    assert n_bytes / 3.35e12 * 1e3 == pytest.approx(0.869, abs=1e-3)
    sizes = {"rbf_nodes": 256 ** 3, "rbf_k": 20, "rbf_m": 4,
             "rbf_points": 1_000_000, "rbf_channels": 3}
    assert rbf_solve.least(sizes) == least_seconds(ops, n_bytes) \
        == ops / 33.5e12
