"""Build a kernel source under ``ops/csrc/`` with ``nvcc`` into a shared
library with a plain C interface, and load it with ``ctypes``.

The build runs at first use, from the package's own sources, into
``ptv_interpolation_tpu_torch/_build/`` (git-ignored). The library's file
name carries a hash of its source and flags, so an edited source is
rebuilt and a finished build is reused. ``nvcc`` is taken from
``$CUDA_HOME/bin`` (default ``/usr/local/cuda``) or the ``PATH``; each
build writes its command and the compiler's output (``-Xptxas -v``:
registers, shared memory, spills) to ``_build/<name>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found under {cuda_home}/bin or on PATH; the CUDA "
            f"kernels are built from source and need the CUDA toolkit")
    return found


def build_library(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date build exists;
    return the path of the shared library."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    (BUILD_DIR / f"{name}.log").write_text(
        " ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (exit {res.returncode}) building "
                           f"{src}:\n{res.stderr[-4000:]}")
    os.replace(tmp, lib)   # atomic: a concurrent build never sees a partial
    return lib


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, loaded once per process."""
    return ctypes.CDLL(str(build_library(name)))
