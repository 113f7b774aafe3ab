"""A held-out cell moves into the benchmark, and a new configuration
enters it, by entries in ``BENCHMARK.json`` and added files alone.

The first case does what the change that admits ``glass_prod_clean``
will do: in a copy of the checkout it adds the cell, its configuration,
``pipeline_s`` with the cell in its list and the per-layer entries it
reports to ``BENCHMARK.json``, and leaves ``pending.json`` as it is. The manifest's
rules then hold with and without the held-out cells merged in, the cell
runs and reports its metrics, and no file of the copy but
``BENCHMARK.json`` has changed. The second case adds a configuration with
its tiny stand-in, which ``make_tiny_checkout`` then takes."""

import json
import shutil
from pathlib import Path

import pytest

import test_perfbench_manifest as rules
from conftest import (BENCH, REPO, last_json, make_tiny_checkout, run_cpu,
                      with_pending)

RUN = ["--seed", "4294967311", "--seconds", "1", "--device", "cpu"]
MOVED_LAYER = ("k2_roofline_pct", "filter_s", "clean_s")


def copy_checkout(dest: Path) -> Path:
    """``dest`` becomes a copy of this checkout's benchmark, tests and
    stand-ins included."""
    shutil.copytree(BENCH, dest / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    return dest


def files_of(root: Path) -> dict:
    return {p.relative_to(root): p.read_bytes()
            for p in root.rglob("*") if p.is_file()}


def hold_to_the_rules(manifest, root: Path):
    for M in (manifest, with_pending(manifest, root / "perfbench")):
        rules.test_names_units_and_text(M)
        rules.test_end_to_end_bounds(M)
        rules.test_every_cell_reports_what_it_must(M)
        rules.test_every_named_piece_is_a_file(M, root=root)


def test_a_held_out_cell_moves_in_by_entries_alone(tmp_path):
    src = copy_checkout(tmp_path / "src")
    before = files_of(src)
    pending = json.loads((src / "perfbench" / "pending.json").read_text())
    old = json.loads((src / "BENCHMARK.json").read_text())

    def entry(key, name):
        return next(e for e in pending[key] if e["name"] == name)

    manifest = json.loads(json.dumps(old))
    manifest["configs"].append(entry("configs", "porous_glass"))
    manifest["workloads"].append(entry("workloads", "glass_prod_clean"))
    assert "pipeline_s" not in {m["name"] for m in old["end_to_end"]}
    manifest["end_to_end"].append(dict(entry("end_to_end", "pipeline_s"),
                                       workloads=["glass_prod_clean"]))
    for name in MOVED_LAYER:
        manifest["per_layer"].append(dict(entry("per_layer", name),
                                          workloads=["glass_prod_clean"]))
    (src / "BENCHMARK.json").write_text(json.dumps(manifest, indent=2))

    # every entry that was there is there unchanged
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        now = {e["name"]: e for e in manifest[key]}
        for e in old[key]:
            assert now[e["name"]] == e
    hold_to_the_rules(manifest, src)
    merged = with_pending(manifest, src / "perfbench")
    names = [w["name"] for w in merged["workloads"]]
    assert sorted(names) == sorted(set(names)) and "glass_prod_noclean" in names

    root = make_tiny_checkout(tmp_path / "tiny", src=src, pending=False)
    for trace in (0, 1):
        out = last_json(run_cpu(root, ["--workload", "glass_prod_clean",
                                       "--trace", str(trace), *RUN]))
        assert out["correct"] is True, out["checks"]
        if trace:
            # kernel 2's share reads the device's trace: on the CPU it
            # finds no kernel and the run leaves it out
            assert set(out["metrics"]) == {"filter_s", "clean_s"}
        else:
            assert set(out["metrics"]) == {"setup_s", "pipeline_s"}
        assert all(m["value"] > 0 for m in out["metrics"].values())

    after = files_of(src)
    del before[Path("BENCHMARK.json")], after[Path("BENCHMARK.json")]
    assert after == before


def test_a_new_configuration_brings_its_tiny_stand_in(tmp_path):
    src = copy_checkout(tmp_path / "src")
    bench = src / "perfbench"
    cfg = json.loads((bench / "configs" / "uniform256.json").read_text())
    cfg["name"] = "cube_other"
    (bench / "configs" / "cube_other.json").write_text(json.dumps(cfg))
    (bench / "limits" / "cube_other_sibson.json").write_bytes(
        (bench / "limits" / "uniform256_sibson.json").read_bytes())
    manifest = json.loads((src / "BENCHMARK.json").read_text())
    manifest["configs"].append({
        "name": "cube_other", "source": "https://example.org/x",
        "file": "perfbench/configs/cube_other.json", "reduced": [],
        "why": "a test"})
    manifest["workloads"].append({
        "name": "cube_other_sibson", "config": "cube_other",
        "traffic": "grid_calls", "chips": 1, "why": "a test"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "uniform256_sibson" in m.get("workloads", []):
            m["workloads"].append("cube_other_sibson")
    (src / "BENCHMARK.json").write_text(json.dumps(manifest))
    hold_to_the_rules(manifest, src)

    with pytest.raises(FileNotFoundError,
                       match="perfbench/tests/tiny/cube_other.json"):
        make_tiny_checkout(tmp_path / "refused", src=src)

    tiny = json.loads((bench / "tests" / "tiny" / "uniform256.json")
                      .read_text())
    tiny.update(name="tiny_other", n_points=5000)
    (bench / "tests" / "tiny" / "cube_other.json").write_text(
        json.dumps(tiny))
    root = make_tiny_checkout(tmp_path / "tiny", src=src)
    made = json.loads((root / "BENCHMARK.json").read_text())
    assert {c["name"]: c["file"] for c in made["configs"]}["tiny_other"] == \
        "perfbench/configs/tiny_other.json"
    got = json.loads((root / "perfbench" / "configs" / "tiny_other.json")
                     .read_text())
    assert got["n_points"] == 5000 and got["grid_n"] == 16
    out = last_json(run_cpu(root, ["--workload", "cube_other_sibson",
                                   "--trace", "0", *RUN]))
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"setup_s", "grid_s", "grid_p95_s"}
