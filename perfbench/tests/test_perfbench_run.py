"""Whole runs of the benchmark's cells on the CPU at tiny sizes: the last
line's keys, the control failing the cell's limits, and each fault of the
timed path turning ``correct`` false."""

import pytest

from conftest import last_json, run_cpu

CELLS = ("glass_prod_clean", "uniform256_sibson", "glass_prod_noclean")
RUN = ["--seed", "4294967311", "--seconds", "1", "--device", "cpu"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_last_line(tiny_root, cell, trace):
    proc = run_cpu(tiny_root, ["--workload", cell, "--trace", str(trace),
                               *RUN])
    out = last_json(proc)
    keys = list(out)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if trace:
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(out["device"])
    else:
        assert "setup_s" in out["metrics"]
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    # every number compared is printed beside its limit as the last lines
    # of standard error
    tail = proc.stderr.strip().splitlines()[-len(out["checks"]):]
    assert [line.split()[1] for line in tail] == list(out["checks"])
    assert all(line.startswith("check ") and " limit " in line
               for line in tail)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(tiny_root, cell):
    """The plain reference in bfloat16 in the program's place fails at
    least one of the cell's numbers; the program passes all of them."""
    import json
    proc = run_cpu(tiny_root, ["--workload", cell, "--seeds", "5",
                               "--control-seeds", "6", "--device", "cpu",
                               "--out", str(tiny_root / f"cal_{cell}.json")],
                   script="perfbench/calibrate.py")
    assert proc.returncode == 0, proc.stderr[-3000:]
    table = json.loads((tiny_root / f"cal_{cell}.json").read_text())
    limits = {k: v["limit"] for k, v in table["summary"].items()}
    program = next(iter(table["program"].values()))
    control = next(iter(table["control"].values()))
    assert all(program[k] <= limits[k] for k in limits), program
    assert any(not control[k] <= limits[k] for k in limits), control


FAULTS = [("glass_prod_clean", "clean_unchanged"),
          ("glass_prod_clean", "filter_unchanged"),
          ("glass_prod_clean", "half_tracks"),
          ("glass_prod_clean", "answer_altered"),
          ("glass_prod_noclean", "filter_unchanged"),
          ("glass_prod_noclean", "half_tracks"),
          ("glass_prod_noclean", "answer_altered"),
          ("uniform256_sibson", "half_tracks"),
          ("uniform256_sibson", "answer_altered")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_not_correct(tiny_root, cell, fault):
    from pathlib import Path
    runner = Path(__file__).resolve().parent / "fault_run.py"
    proc = run_cpu(tiny_root, [str(tiny_root), fault, "--workload", cell,
                               "--trace", "0", *RUN], script=runner)
    assert last_json(proc)["correct"] is False
