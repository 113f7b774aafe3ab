"""What the benchmark loads: no JAX, no JAX package (whole top-level
names: the port's name begins with the JAX package's), and a reference
that loads nothing of the program under test."""

import ast
import subprocess
import sys

from conftest import REPO, last_json, run_cpu

BENCH = REPO / "perfbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "ptv_interpolation_tpu"}
PORT = "ptv_interpolation_tpu_torch"


def _top_level_after(code):
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(proc.stdout.split())


def test_run_and_every_module_it_loads_import_no_jax():
    names = ", ".join(repr(str(p.relative_to(BENCH))) for kind in
                      ("steps", "checks", "metrics", "endtoend",
                       "generators") for p in (BENCH / kind).glob("*.py"))
    code = f"""
import sys, importlib
sys.path.insert(0, {str(REPO)!r})
import perfbench.run, perfbench.calibrate
from pathlib import Path
from perfbench.lib.manifest import load_module
import perfbench.lib.checking, perfbench.lib.trace, perfbench.lib.readers
import perfbench.reference.porous, perfbench.roofline.kernels
import ptv_interpolation_tpu_torch.pipeline, ptv_interpolation_tpu_torch.interpolate
import ptv_interpolation_tpu_torch.analyze
for rel in [{names}]:
    p = Path({str(BENCH)!r}) / rel
    if p.stem != "__init__":
        load_module(p.parent, p.stem)
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    loaded = _top_level_after(code)
    assert PORT in loaded
    assert not loaded & FORBIDDEN


def test_a_whole_run_loads_no_jax(tiny_root):
    # the run itself fails without a result where it finds them loaded
    out = last_json(run_cpu(tiny_root, ["--workload", "glass_prod_clean",
                                        "--seed", "1", "--seconds", "1",
                                        "--trace", "1", "--device", "cpu"]))
    assert out["correct"] is True


def test_the_reference_loads_nothing_of_the_program():
    code = f"""
import sys
sys.path.insert(0, {str(REPO)!r})
import perfbench.reference.porous, perfbench.reference.cleaning
import perfbench.reference.knn, perfbench.reference.sibson
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    loaded = _top_level_after(code)
    assert not loaded & (FORBIDDEN | {PORT})
    for path in (BENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops = {(node.module or "").split(".")[0]}
            else:
                continue
            assert not tops & (FORBIDDEN | {PORT}), (path, tops)


def test_a_checkout_without_the_port_gives_no_result(tmp_path):
    import shutil
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "glass_prod_clean",
         "--seed", "1", "--seconds", "1", "--trace", "0", "--device", "cpu"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0
    assert not proc.stdout.strip()


def test_a_run_that_finds_the_jax_package_loaded_gives_no_result(tiny_root):
    code = f"""
import sys
sys.path.insert(0, {str(tiny_root)!r})
import ptv_interpolation_tpu
from perfbench import run
sys.exit(run.main(["--workload", "uniform256_sibson", "--seed", "1",
                   "--seconds", "1", "--trace", "0", "--device", "cpu"]))
"""
    import os
    proc = subprocess.run([sys.executable, "-c", code], cwd=tiny_root,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=str(REPO),
                                   JAX_PLATFORMS="cpu"))
    assert proc.returncode != 0
    assert not proc.stdout.strip()
    assert "ptv_interpolation_tpu" in proc.stderr.splitlines()[-1]
