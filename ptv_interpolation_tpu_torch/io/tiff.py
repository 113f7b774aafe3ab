"""Minimal, dependency-free TIFF codec for 3D volumes.

The reference relies on ``tifffile`` for mask input (`interpolator.py:28-39`)
and ZCYX field stack output (`main.py:228-231`, `analyze_flow.py:339-341`).
That package is not part of this image, so the framework ships its own small
codec supporting exactly what the pipeline needs:

* **read**: baseline grayscale TIFFs, little- or big-endian, 1/8/16/32/64-bit
  unsigned/signed/float samples, strip-based, multi-page; compression
  none (1), LZW (5), deflate (8 / 32946 "old-style"), PackBits (32773) —
  the schemes real tomography mask exports use — with horizontal-differencing
  predictor (tag 317, value 2) support. Multi-page volumes stack to
  ``(n_pages, H, W)``; ImageJ hyperstacks with ``channels=C`` reshape to
  ``(Z, C, H, W)``.
* **write**: multi-page grayscale from ``(Z, H, W)`` arrays, or ImageJ-style
  ``(Z, C, H, W)`` hyperstacks (axes 'ZCYX'), uint8/16/float32;
  uncompressed (default) or deflate (``compression='deflate'``).

This is a host-side utility (numpy only) — TIFF parsing is pointer-chasing
and irrelevant to device throughput.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# TIFF tag ids
_IMAGEWIDTH = 256
_IMAGELENGTH = 257
_BITSPERSAMPLE = 258
_COMPRESSION = 259
_PHOTOMETRIC = 262
_IMAGEDESCRIPTION = 270
_STRIPOFFSETS = 273
_SAMPLESPERPIXEL = 277
_ROWSPERSTRIP = 278
_STRIPBYTECOUNTS = 279
_PLANARCONFIG = 284
_PREDICTOR = 317
_SAMPLEFORMAT = 339


def lzw_decode(data: bytes) -> bytes:
    """TIFF-variant LZW decode (compression=5): MSB-first bit packing,
    ClearCode=256, EOI=257, 9→12-bit codes with 'early change' width bumps
    (at table sizes 510/1022/2046 per the TIFF 6.0 spec)."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    table: list = []
    width = 9
    prev = None

    bitbuf = 0
    nbits = 0
    pos = 0
    n = len(data)

    def reset():
        nonlocal table, width, prev
        table = [bytes((i,)) for i in range(256)] + [b"", b""]
        width = 9
        prev = None

    reset()
    while True:
        while nbits < width:
            if pos >= n:
                return bytes(out)
            bitbuf = (bitbuf << 8) | data[pos]
            pos += 1
            nbits += 8
        code = (bitbuf >> (nbits - width)) & ((1 << width) - 1)
        nbits -= width
        if code == CLEAR:
            reset()
            continue
        if code == EOI:
            return bytes(out)
        if prev is None:
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        elif code == len(table):
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise IOError(f"corrupt LZW stream (code {code} > table size)")
        out += entry
        prev = entry
        # early change: width grows one code before the table fills
        if len(table) + 1 >= (1 << width) and width < 12:
            width += 1


def packbits_decode(data: bytes) -> bytes:
    """PackBits RLE decode (compression=32773)."""
    out = bytearray()
    pos = 0
    n = len(data)
    while pos < n:
        hdr = data[pos]
        pos += 1
        if hdr < 128:                      # literal run of hdr+1 bytes
            out += data[pos: pos + hdr + 1]
            pos += hdr + 1
        elif hdr > 128:                    # repeat next byte 257-hdr times
            if pos < n:
                out += data[pos: pos + 1] * (257 - hdr)
                pos += 1
        # hdr == 128: no-op
    return bytes(out)


def _decompress(raw: bytes, compression: int, path: str,
                expected: int = 0) -> bytes:
    """``expected``: decoded-size upper bound (the page byte count) — lets
    the native decoders (native/fasttiff.cpp, memory-speed LZW/PackBits)
    preallocate; 0 or a missing native library falls back to the Python
    decoders."""
    if compression == 1:
        return raw
    if compression in (8, 32946):          # deflate / old-style deflate
        return zlib.decompress(raw)
    if compression == 5:
        if expected:
            from ptv_interpolation_tpu_torch.io import fasttiff
            out = fasttiff.lzw_decode(raw, expected)
            if out is not None:
                return out
        return lzw_decode(raw)
    if compression == 32773:
        if expected:
            from ptv_interpolation_tpu_torch.io import fasttiff
            out = fasttiff.packbits_decode(raw, expected)
            if out is not None:
                return out
        return packbits_decode(raw)
    raise IOError(f"{path}: compression {compression} not supported by the "
                  f"built-in codec (supported: none, LZW, deflate, PackBits)")


def _undo_predictor(page: np.ndarray, predictor: int) -> np.ndarray:
    """Reverse horizontal differencing (predictor=2): cumulative sum along
    each row in the sample's native integer width (modular arithmetic)."""
    if predictor == 2:
        return np.cumsum(page, axis=-1, dtype=page.dtype)
    if predictor not in (1, None):
        raise IOError(f"TIFF predictor {predictor} not supported")
    return page

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 16: 8, 17: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f", 12: "d", 16: "Q", 17: "q"}


def _read_ifd_entries(buf, offset, endian):
    (n_entries,) = struct.unpack_from(endian + "H", buf, offset)
    entries = {}
    pos = offset + 2
    for _ in range(n_entries):
        tag, typ, count = struct.unpack_from(endian + "HHI", buf, pos)
        value_field = buf[pos + 8: pos + 12]
        size = _TYPE_SIZES.get(typ, 1) * count
        if size <= 4:
            data = value_field[:size]
        else:
            (data_offset,) = struct.unpack_from(endian + "I", value_field)
            data = buf[data_offset: data_offset + size]
        if typ in _TYPE_FMT:
            fmt = endian + str(count) + _TYPE_FMT[typ]
            values = struct.unpack_from(fmt, data)
        elif typ == 2:  # ASCII
            values = (data.split(b"\x00")[0].decode("latin-1"),)
        elif typ == 5 or typ == 10:  # RATIONAL
            raw = struct.unpack_from(endian + str(2 * count) + ("I" if typ == 5 else "i"), data)
            values = tuple(raw[i] / max(raw[i + 1], 1) for i in range(0, len(raw), 2))
        else:
            values = (data,)
        entries[tag] = values
        pos += 12
    (next_ifd,) = struct.unpack_from(endian + "I", buf, pos)
    return entries, next_ifd


def read_tiff(path: str) -> np.ndarray:
    """Read a (possibly multi-page) grayscale TIFF into a numpy array.

    Returns ``(H, W)`` for single page, ``(Z, H, W)`` for stacks, and
    ``(Z, C, H, W)`` for ImageJ hyperstacks that declare channels.
    """
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:2] == b"II":
        endian = "<"
    elif buf[:2] == b"MM":
        endian = ">"
    else:
        raise IOError(f"{path}: not a TIFF file")
    (magic,) = struct.unpack_from(endian + "H", buf, 2)
    if magic != 42:
        raise IOError(f"{path}: unsupported TIFF magic {magic}")
    (ifd_offset,) = struct.unpack_from(endian + "I", buf, 4)

    pages = []
    description = None
    while ifd_offset:
        entries, ifd_offset = _read_ifd_entries(buf, ifd_offset, endian)
        width = entries[_IMAGEWIDTH][0]
        height = entries[_IMAGELENGTH][0]
        bits = entries.get(_BITSPERSAMPLE, (1,))[0]
        compression = entries.get(_COMPRESSION, (1,))[0]
        spp = entries.get(_SAMPLESPERPIXEL, (1,))[0]
        fmt = entries.get(_SAMPLEFORMAT, (1,))[0]
        if spp != 1:
            raise IOError(f"{path}: {spp} samples/pixel not supported (grayscale only)")
        if description is None and _IMAGEDESCRIPTION in entries:
            description = entries[_IMAGEDESCRIPTION][0]
        predictor = entries.get(_PREDICTOR, (1,))[0]

        offsets = entries[_STRIPOFFSETS]
        counts = entries[_STRIPBYTECOUNTS]
        # strips are compressed independently; the page byte count bounds
        # any one strip's decoded size (native-decoder preallocation)
        page_bytes = height * ((width * bits + 7) // 8)
        raw = b"".join(_decompress(bytes(buf[o: o + c]), compression, path,
                                   expected=page_bytes)
                       for o, c in zip(offsets, counts))

        if bits == 1:
            unpacked = np.unpackbits(np.frombuffer(raw, np.uint8))
            row_bits = ((width + 7) // 8) * 8
            page = unpacked[: height * row_bits].reshape(height, row_bits)[:, :width].astype(np.uint8)
        else:
            if fmt == 3:
                dtype = {16: np.float16, 32: np.float32, 64: np.float64}[bits]
            elif fmt == 2:
                dtype = {8: np.int8, 16: np.int16, 32: np.int32}[bits]
            else:
                dtype = {8: np.uint8, 16: np.uint16, 32: np.uint32}[bits]
            dt = np.dtype(dtype).newbyteorder(endian)
            page = np.frombuffer(raw, dt)[: height * width].reshape(height, width)
            page = page.astype(dtype)  # native byte order
            page = _undo_predictor(page, predictor)
        pages.append(page)

    arr = pages[0] if len(pages) == 1 else np.stack(pages)
    # ImageJ hyperstack reshaping: "channels=C" in the description means
    # pages are interleaved (Z*C, H, W) -> (Z, C, H, W).
    if description and arr.ndim == 3 and "ImageJ" in description and "channels=" in description:
        try:
            channels = int(description.split("channels=")[1].split("\n")[0])
            if channels > 1 and arr.shape[0] % channels == 0:
                arr = arr.reshape(arr.shape[0] // channels, channels, *arr.shape[1:])
        except (ValueError, IndexError):
            pass
    return arr


def write_tiff(path: str, array: np.ndarray, imagej: bool = False,
               axes: str | None = None, compression: str | None = None):
    """Write a grayscale multi-page TIFF (little-endian).

    ``(H, W)``, ``(Z, H, W)`` and ``(Z, C, H, W)`` arrays are supported;
    4D input is flattened page-wise and described as an ImageJ 'ZCYX'
    hyperstack, matching the reference's output contract (`main.py:228-231`).
    ``compression``: None (default) or 'deflate'/'zlib' for zlib-compressed
    strips (one strip per page).
    """
    arr = np.asarray(array)
    if arr.dtype == np.bool_:
        arr = arr.astype(np.uint8)
    if arr.dtype not in (np.uint8, np.uint16, np.int16, np.float32, np.float64):
        arr = arr.astype(np.float32)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)

    channels = 1
    if arr.ndim == 2:
        pages = arr[None]
    elif arr.ndim == 3:
        pages = arr
    elif arr.ndim == 4:
        z, c = arr.shape[:2]
        channels = c
        pages = arr.reshape(z * c, *arr.shape[2:])
        imagej = True
    else:
        raise ValueError(f"unsupported array rank {arr.ndim}")

    n_pages, height, width = pages.shape
    bits = arr.dtype.itemsize * 8
    sample_format = 3 if arr.dtype.kind == "f" else (2 if arr.dtype.kind == "i" else 1)

    description = None
    if imagej:
        z_slices = n_pages // channels
        description = (f"ImageJ=1.54\nimages={n_pages}\nchannels={channels}\n"
                       f"slices={z_slices}\nhyperstack=true\nmode=grayscale\n")

    endian = "<"
    header = struct.pack(endian + "2sHI", b"II", 42, 8)
    out = bytearray(header)

    # Layout: header | IFDs | pixel data. Compute IFD sizes first.
    tags_per_page = 10 + (1 if description else 0)
    ifd_size = 2 + tags_per_page * 12 + 4
    desc_bytes = b""
    desc_offset = 0
    ifds_start = 8
    heap_start = ifds_start + ifd_size * n_pages
    if description:
        desc_bytes = description.encode("latin-1") + b"\x00"
        if len(desc_bytes) % 2:
            desc_bytes += b"\x00"
        desc_offset = heap_start
        heap_start += len(desc_bytes)
    data_start = heap_start
    page_bytes = height * width * arr.dtype.itemsize

    if compression in ("deflate", "zlib"):
        comp_tag = 8
        le_pages = pages.astype(pages.dtype.newbyteorder("<"), copy=False)
        strips = [zlib.compress(le_pages[p].tobytes(), 6)
                  for p in range(n_pages)]
    elif compression is None:
        comp_tag = 1
        strips = None
    else:
        raise ValueError(f"unsupported write compression {compression!r}")
    strip_sizes = ([len(s) for s in strips] if strips is not None
                   else [page_bytes] * n_pages)
    strip_starts = list(np.cumsum([data_start] + strip_sizes[:-1]))

    ifd_blobs = []
    for p in range(n_pages):
        entries = [
            (_IMAGEWIDTH, 4, (width,)),
            (_IMAGELENGTH, 4, (height,)),
            (_BITSPERSAMPLE, 3, (bits,)),
            (_COMPRESSION, 3, (comp_tag,)),
            (_PHOTOMETRIC, 3, (1,)),
        ]
        if description and p == 0:
            # count includes the trailing NUL; points into the shared heap
            entries.append((_IMAGEDESCRIPTION, 2, None))
        entries += [
            (_STRIPOFFSETS, 4, (int(strip_starts[p]),)),
            (_SAMPLESPERPIXEL, 3, (1,)),
            (_ROWSPERSTRIP, 4, (height,)),
            (_STRIPBYTECOUNTS, 4, (int(strip_sizes[p]),)),
            (_SAMPLEFORMAT, 3, (sample_format,)),
        ]
        if description and p > 0:
            entries.insert(5, (_IMAGEDESCRIPTION, 2, None))
        blob = struct.pack(endian + "H", len(entries))
        for tag, typ, values in sorted(entries, key=lambda e: e[0]):
            if tag == _IMAGEDESCRIPTION:
                blob += struct.pack(endian + "HHII", tag, typ, len(desc_bytes), desc_offset)
            else:
                blob += struct.pack(endian + "HHI", tag, typ, len(values))
                data = struct.pack(endian + str(len(values)) + _TYPE_FMT[typ], *values)
                blob += data + b"\x00" * (4 - len(data))
        next_ifd = ifds_start + (p + 1) * ifd_size if p + 1 < n_pages else 0
        blob += struct.pack(endian + "I", next_ifd)
        assert len(blob) == ifd_size, (len(blob), ifd_size)
        ifd_blobs.append(blob)

    out += b"".join(ifd_blobs)
    out += desc_bytes
    if strips is not None:
        out += b"".join(strips)
    else:
        le = pages.astype(pages.dtype.newbyteorder("<"), copy=False)
        out += le.tobytes()
    with open(path, "wb") as f:
        f.write(out)
