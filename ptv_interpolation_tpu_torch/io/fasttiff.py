"""ctypes binding for the native TIFF strip decoders (native/fasttiff.cpp).

LZW and PackBits decode at memory speed (the pure-Python LZW loop is
< 1 MB/s on literal-heavy streams — an hour-class wait for a production
657³ scan). Falls back silently when the shared library hasn't been
built; `io/tiff.py::_decompress` treats any failure here as "use the
Python decoder". Build with ``native/build.sh``.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_FAILED = False


# Known-answer vectors run once at load time: CDLL can succeed on a
# library built for a different ISA (or a truncated/stale binary) and
# only SIGILL/garble on first real use — validate before enabling.
# LZW: Clear,'a','b','c',EOI at 9 bits MSB-first; PackBits: literal run
# of 3 + repeat-X-three (both verified against the Python decoders).
_KAT = (("ptv_lzw_decode", bytes([0x80, 0x18, 0x4C, 0x46, 0x38, 0x08]),
         b"abc"),
        ("ptv_packbits_decode", b"\x02abc\xfeX", b"abcXXX"))


def _load_lib():
    global _LIB, _FAILED
    if _LIB is not None or _FAILED:
        return _LIB
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.path.join(here, "native", "libptvtiff.so")
    try:
        lib = ctypes.CDLL(path)
        for fn in (lib.ptv_lzw_decode, lib.ptv_packbits_decode):
            fn.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
                           ctypes.POINTER(ctypes.c_uint8), ctypes.c_long]
            fn.restype = ctypes.c_long
        for name, src, want in _KAT:
            buf = np.empty(len(want), np.uint8)
            s = np.frombuffer(src, np.uint8)
            n = getattr(lib, name)(
                s.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(s),
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                len(want))
            if n != len(want) or buf.tobytes() != want:
                raise OSError(f"{name} failed known-answer self-test")
        _LIB = lib
    except OSError:
        _FAILED = True
        _LIB = None
    return _LIB


def _run(fn_name: str, data: bytes, expected: int) -> bytes | None:
    """Run a native decoder; None → caller falls back to Python.
    ``expected`` is the decoded strip size upper bound (rows × row
    bytes from the IFD); the buffer grows once if a nonconforming file
    under-declares it."""
    lib = _load_lib()
    if lib is None:
        return None
    fn = getattr(lib, fn_name)
    src = np.frombuffer(data, np.uint8)
    src_p = src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    cap = max(int(expected), 1)
    for _ in range(2):
        dst = np.empty(cap, np.uint8)
        n = fn(src_p, len(src),
               dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
        if n == -2:          # capacity short (file lied about strip size)
            cap *= 4
            continue
        if n < 0:
            return None      # corrupt per native parser: Python decides
        return dst[:n].tobytes()
    return None


def lzw_decode(data: bytes, expected: int) -> bytes | None:
    return _run("ptv_lzw_decode", data, expected)


def packbits_decode(data: bytes, expected: int) -> bytes | None:
    return _run("ptv_packbits_decode", data, expected)
