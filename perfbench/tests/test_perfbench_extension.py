"""A later change adds a cell as files plus entries in ``BENCHMARK.json``:
a configuration, a traffic mix, the cell's limits and a per-layer metric
reader, each found by its name, with no edit to a file already there.
The added mix runs ``run_pipeline`` then ``run_analysis``, the job of the
analysis cell that is planned next."""

import json

from conftest import last_json, make_tiny_checkout, run_cpu


def test_new_files_are_found_by_name(tmp_path):
    root = make_tiny_checkout(tmp_path)
    bench = root / "perfbench"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}

    cfg = json.loads((bench / "configs" / "tiny_glass.json").read_text())
    cfg.update(name="throwaway_glass", n_tracks=2500)
    (bench / "configs" / "throwaway_glass.json").write_text(json.dumps(cfg))
    mix = {"loop": "closed", "clients": 1, "pool": 2,
           "job": [{"step": "run_pipeline", "divergence_free": True},
                   {"step": "run_analysis", "drag": False,
                    "permeability_pressure": False}],
           "checks": ["pipeline_field", "cleaned_field"],
           "check_units": 1, "trace_units": 1}
    (bench / "traffic" / "throwaway_mix.json").write_text(json.dumps(mix))
    limits = json.loads((bench / "limits" / "glass_prod_clean.json")
                        .read_text())
    (bench / "limits" / "throwaway_cell.json").write_text(json.dumps(limits))
    (bench / "metrics" / "throwaway.units.py").write_text(
        "def read(trace):\n    return float(trace.device.units)\n")

    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({
        "name": "throwaway_glass", "source": "https://example.org/x",
        "file": "perfbench/configs/throwaway_glass.json",
        "reduced": cfg["reduced"], "why": "a test"})
    manifest["workloads"].append({
        "name": "throwaway_cell", "config": "throwaway_glass",
        "traffic": "throwaway_mix", "chips": 1, "why": "a test"})
    for m in manifest["end_to_end"]:
        if m["name"] == "pipeline_s":
            m["workloads"].append("throwaway_cell")
    manifest["per_layer"].append({
        "name": "throwaway.units", "unit": "units", "better": "higher",
        "source": "device_trace", "layer": "device", "moves": "pipeline_s",
        "workloads": ["throwaway_cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))

    for trace in (0, 1):
        out = last_json(run_cpu(root, [
            "--workload", "throwaway_cell", "--seed", "7", "--seconds", "1",
            "--trace", str(trace), "--device", "cpu"]))
        assert out["correct"] is True, out["checks"]
        if trace:
            assert out["metrics"]["throwaway.units"]["value"] == 1.0
            assert "clean_s" not in out["metrics"]
        else:
            assert set(out["metrics"]) == {"setup_s", "pipeline_s"}
    after = {p: p.read_bytes() for p in before}
    assert after == before
