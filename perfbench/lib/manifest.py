"""Find a cell's pieces by name: the manifest (``BENCHMARK.json`` at the
checkout's root), the configuration, the traffic mix, the cell's limits,
and the modules named by them.

Every named piece is a file: ``configs/<config>.json``,
``traffic/<traffic>.json``, ``limits/<cell>.json``, and ``<folder>/<name>.py``
for a generator, a step, a check, an end-to-end metric or a per-layer
metric, where ``<name>`` is the name exactly as written, dots included.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass, field
from pathlib import Path

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def load_module(folder: Path, name: str):
    """The module ``folder/<name>.py``, loaded once per process."""
    if not NAME.match(name):
        raise ValueError(f"not a valid name: {name!r}")
    path = folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{path} does not exist")
    key = "perfbench_named." + folder.name + "." + name.replace(".", "__")
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module


def _read_json(path: Path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload of the manifest with everything it names."""

    root: Path                  # the checkout's root
    bench: Path                 # the benchmark's folder
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list = field(default_factory=list)   # manifest entries
    per_layer: list = field(default_factory=list)

    def module(self, kind: str, name: str):
        return load_module(self.bench / kind, name)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, workload: str, bench: Path | None = None) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``; ``bench`` is the
    benchmark's folder (default: the folder that holds this file's
    package)."""
    manifest = _read_json(root / "BENCHMARK.json")
    bench = bench or Path(__file__).resolve().parent.parent
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"have {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = _read_json(root / configs[w["config"]]["file"])
    mix = _read_json(bench / "traffic" / f"{w['traffic']}.json")
    limits = _read_json(bench / "limits" / f"{workload}.json")
    e2e = [m for m in manifest["end_to_end"] if _reports(m, workload)]
    layer = [m for m in manifest["per_layer"] if _reports(m, workload)]
    return Cell(root=root, bench=bench, name=workload, chips=int(w["chips"]),
                config=config, mix=mix, limits=limits, end_to_end=e2e,
                per_layer=layer)
