"""``BENCHMARK.json`` against the benchmark's rules: names, units and
text within their characters, every piece a cell names present as a file,
every per-layer metric's cells reporting the end-to-end metric it moves,
and the bounds and run length within their limits. The same holds with
the held-out cells of ``pending.json`` added."""

import json
import re
from pathlib import Path

import pytest

from conftest import with_pending

BENCH = Path(__file__).resolve().parent.parent
REPO = BENCH.parent
MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
BOTH = [MANIFEST, with_pending(MANIFEST)]

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def text_ok(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def cells_of(metric, M):
    return metric.get("workloads", [w["name"] for w in M["workloads"]])


def test_top_level_keys():
    M = MANIFEST
    assert list(M) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]
    assert M["command"] == ["python3", "perfbench/run.py"]
    assert M["paths"] == ["perfbench"]
    assert all(PATH.match(p) and ".." not in p for p in M["paths"])
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("M", BOTH, ids=["manifest", "with_pending"])
def test_names_units_and_text(M):
    names = []
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and text_ok(c["source"])
        assert text_ok(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and text_ok(w["why"])
        names.append(w["name"])
    for m in M["end_to_end"] + M["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in M["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert text_ok(m["layer"])
    assert len(names) == len(set(names))


@pytest.mark.parametrize("M", BOTH, ids=["manifest", "with_pending"])
def test_end_to_end_bounds(M):
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in M["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("M", BOTH, ids=["manifest", "with_pending"])
def test_every_cell_reports_what_it_must(M):
    e2e = {m["name"]: m for m in M["end_to_end"]}
    cells = {w["name"] for w in M["workloads"]}
    configs = {c["name"] for c in M["configs"]}
    assert configs == {w["config"] for w in M["workloads"]}
    for w in M["workloads"]:
        assert w["config"] in configs
        reported = {n for n, m in e2e.items() if w["name"] in cells_of(m, M)}
        assert "setup_s" in reported and len(reported) >= 2
        assert any(w["name"] in cells_of(m, M) for m in M["per_layer"])
    for m in M["end_to_end"] + M["per_layer"]:
        # a list of cells, where given, names at least one, each once
        listed = cells_of(m, M)
        assert listed and len(listed) == len(set(listed)), m["name"]
        assert set(listed) <= cells, m["name"]
    for m in M["per_layer"]:
        assert m["moves"] in e2e
        assert set(cells_of(m, M)) <= cells
        for cell in cells_of(m, M):
            assert cell in cells_of(e2e[m["moves"]], M), (m["name"], cell)
    layers = {}
    for m in M["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("M", BOTH, ids=["manifest", "with_pending"])
def test_every_named_piece_is_a_file(M, root=REPO):
    bench = root / "perfbench"
    for c in M["configs"]:
        path = root / c["file"]
        assert path.is_file() and c["file"].startswith("perfbench/")
        cfg = json.loads(path.read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert (bench / "generators" / f"{cfg['generator']}.py").is_file()
    for w in M["workloads"]:
        mix = json.loads((bench / "traffic" / f"{w['traffic']}.json")
                         .read_text())
        limits = json.loads((bench / "limits" / f"{w['name']}.json")
                            .read_text())
        for step in mix["job"]:
            assert (bench / "steps" / f"{step['step']}.py").is_file()
        for check in mix["checks"]:
            assert (bench / "checks" / f"{check}.py").is_file()
        assert all(isinstance(v, (int, float)) for v in limits.values())
    for m in M["end_to_end"]:
        assert (bench / "endtoend" / f"{m['name']}.py").is_file()
    for m in M["per_layer"]:
        assert (bench / "metrics" / f"{m['name']}.py").is_file()


def test_run_seconds_fits_the_full_check():
    """A full check of 24 cells: 2 + 14 per cell runs of run_seconds + 60
    s, 2 × 90 s more per cell, 1200 s spare, within 43 200 s."""
    rs = MANIFEST["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["steps", "checks", "metrics", "endtoend",
                                  "generators"])
def test_file_names_use_name_characters(kind):
    for f in (BENCH / kind).glob("*.py"):
        if f.name != "__init__.py":
            assert NAME.match(f.stem), f
