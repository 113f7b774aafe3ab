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

def with_pending(manifest, bench: Path = BENCH):
    """The manifest with the held-out cells of ``pending.json`` merged in
    by name: an entry whose name the manifest already has is not added
    again, and the cells of a pending metric that the manifest has join
    that metric's ``workloads``. A held-out cell thus moves in through
    entries in ``BENCHMARK.json`` alone."""
    pending = json.loads((bench / "pending.json").read_text())
    out = json.loads(json.dumps(manifest))
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        have = {e["name"]: e for e in out[key]}
        for entry in pending[key]:
            mine = have.get(entry["name"])
            if mine is None:
                out[key].append(entry)
            elif "workloads" in mine:
                mine["workloads"] += [w for w in entry["workloads"]
                                      if w not in mine["workloads"]]
    return out


def tiny_stand_in(bench: Path, config: str) -> dict:
    """The keys that shrink the configuration ``config`` for the CPU, from
    ``tests/tiny/<config>.json`` of the benchmark ``bench``: one file per
    configuration, so a new configuration brings its own."""
    path = bench / "tests" / "tiny" / f"{config}.json"
    if not path.is_file():
        raise FileNotFoundError(
            f"the configuration {config!r} has no tiny stand-in: add "
            f"perfbench/tests/tiny/{config}.json with the keys that shrink "
            f"it for the CPU, and a new \"name\"")
    return json.loads(path.read_text())


def make_tiny_checkout(dest: Path, src: Path = REPO,
                       pending: bool = True) -> Path:
    """``dest`` becomes a checkout holding ``BENCHMARK.json`` and a copy of
    the benchmark of the checkout ``src``, with the held-out cells merged
    in (unless ``pending`` is false) and each configuration swapped for
    its tiny stand-in."""
    bench = src / "perfbench"
    shutil.copytree(bench, dest / "perfbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    manifest = json.loads((src / "BENCHMARK.json").read_text())
    if pending:
        manifest = with_pending(manifest, bench)
    names = {}
    for c in manifest["configs"]:
        cfg = json.loads((src / c["file"]).read_text())
        cfg.update(tiny_stand_in(bench, c["name"]))
        path = f"perfbench/configs/{cfg['name']}.json"
        (dest / path).write_text(json.dumps(cfg, indent=1))
        names[c["name"]] = cfg["name"]
        c["name"], c["file"] = cfg["name"], path
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
