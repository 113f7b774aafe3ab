"""Fixtures of the benchmark's own tests: a copy of the benchmark in a
temporary checkout whose cells run the real cells' mixes and limits on
tiny configurations, and a helper that runs a command of it on the CPU.

The tests are run from the repository's root:
``python -m pytest perfbench/tests -q -p no:cacheprovider``; the ones
marked ``gpu`` need a card and skip without one."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
REPO = BENCH.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# tiny stand-ins for the two configurations, small enough for the CPU
TINY = {
    "porous_glass": {"name": "tiny_glass", "raw_shape_zyx": [40, 34, 30],
                     "solid_formula": {"rates_zyx": [0.5, 0.6, 0.7],
                                       "level": 0.55},
                     "n_tracks": 3000, "boundary_sampling": 5},
    "uniform256": {"name": "tiny_cube", "n_points": 6000, "extent": 16,
                   "grid_n": 16, "grid_bounds": [[0, 17], [0, 17], [0, 17]]},
}


def with_pending(manifest):
    """The manifest with the held-out cells of ``pending.json`` added."""
    pending = json.loads((BENCH / "pending.json").read_text())
    out = json.loads(json.dumps(manifest))
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        out[key] += pending[key]
    return out


def make_tiny_checkout(dest: Path) -> Path:
    """``dest`` becomes a checkout holding ``BENCHMARK.json`` and a copy of
    the benchmark, with the held-out cells added and each configuration
    swapped for its tiny stand-in."""
    shutil.copytree(BENCH, dest / "perfbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    manifest = with_pending(json.loads((REPO / "BENCHMARK.json").read_text()))
    for c in manifest["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        cfg.update(TINY[c["name"]])
        path = f"perfbench/configs/{cfg['name']}.json"
        (dest / path).write_text(json.dumps(cfg, indent=1))
        c["file"] = path
    names = {c: TINY[c]["name"] for c in TINY}
    for c in manifest["configs"]:
        c["name"] = names[c["name"]]
    for w in manifest["workloads"]:
        w["config"] = names[w["config"]]
    (dest / "BENCHMARK.json").write_text(json.dumps(manifest, indent=1))
    return dest


def run_cpu(root: Path, argv, script="perfbench/run.py", timeout=600):
    """Run ``script`` of the checkout ``root`` on the CPU; the port comes
    from this repository. Returns the completed process."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, str(root / script), *argv],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=timeout)


def last_json(proc):
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_checkout(tmp_path_factory.mktemp("checkout"))
