"""ctypes binding for the native CSV parser (native/fastcsv.cpp).

Falls back silently when the shared library hasn't been built — callers
(`csvio.load_ptv_data`) treat any failure here as "use the pandas path".
Build with ``native/build.sh``.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None


class _Result(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.POINTER(ctypes.c_float)),
        ("n_rows", ctypes.c_long),
        ("ok", ctypes.c_int),
        ("err", ctypes.c_char * 256),
    ]


def _load_lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.path.join(here, "native", "libptvcsv.so")
    lib = ctypes.CDLL(path)
    lib.ptv_csv_load.argtypes = [ctypes.c_char_p]
    lib.ptv_csv_load.restype = ctypes.POINTER(_Result)
    lib.ptv_csv_free.argtypes = [ctypes.POINTER(_Result)]
    lib.ptv_csv_free.restype = None
    # known-answer self-test before enabling: CDLL can succeed on a
    # stale/foreign-ISA binary and only misbehave on first real parse
    import tempfile
    with tempfile.NamedTemporaryFile("w", suffix=".csv",
                                     delete=False) as f:
        f.write("x,y,z,u,v,w\n1,2,3,0.5,-0.5,1.5\n")
        kat = f.name
    try:
        res = lib.ptv_csv_load(os.fsencode(kat))
        try:
            ok = bool(res.contents.ok) and res.contents.n_rows == 1
            if ok:
                row = np.ctypeslib.as_array(
                    res.contents.data, shape=(1, 6))[0]
                ok = np.allclose(row, [1, 2, 3, 0.5, -0.5, 1.5])
        finally:
            lib.ptv_csv_free(res)
        if not ok:
            raise OSError("libptvcsv failed known-answer self-test")
    finally:
        os.unlink(kat)
    _LIB = lib
    return lib


def load(filepath: str):
    """Parse a PTV CSV natively → PointCloud. Raises on parse errors (the
    caller maps them to the pandas fallback / IOError contract)."""
    from ptv_interpolation_tpu_torch.io.csvio import PointCloud

    lib = _load_lib()
    res = lib.ptv_csv_load(os.fsencode(filepath))
    try:
        if not res.contents.ok:
            raise ValueError(res.contents.err.decode("utf-8", "replace"))
        n = res.contents.n_rows
        arr = np.ctypeslib.as_array(res.contents.data, shape=(n, 6)).copy()
    finally:
        lib.ptv_csv_free(res)
    return PointCloud(arr[:, :3], arr[:, 3:])
