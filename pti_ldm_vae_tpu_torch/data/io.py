"""Image IO: TIF/PNG read + write with numpy, ``struct`` and ``zlib`` alone.

Counterpart of ``pti_ldm_vae_tpu/data/io.py``. The GPU host this port runs on
has no Pillow, ``tifffile`` or ``imageio``, so the formats the pipeline uses
are read and written here directly:

* TIFF: baseline, uncompressed, strip-organised, one sample per pixel
  (8/16/32/64-bit unsigned, signed or float samples), either byte order —
  what ``tifffile`` and Pillow write for the float32 grayscale images the
  pipeline reads, and what :func:`write_tif` writes.
* PNG: 8-bit grayscale or RGB, non-interlaced, every filter type.

Other files (compressed or tiled TIFFs, palette PNGs, other formats) go to
``tifffile`` / ``imageio`` / Pillow where one is installed, else raise.
Readers return float32 arrays shaped like the reference ``TifReader``'s.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["TifReader", "read_image", "write_tif", "write_png"]

# TIFF tags
_WIDTH, _LENGTH, _BITS, _COMPRESSION, _PHOTOMETRIC = 256, 257, 258, 259, 262
_STRIP_OFFSETS, _SAMPLES, _ROWS_PER_STRIP, _STRIP_BYTES = 273, 277, 278, 279
_PLANAR, _SAMPLE_FORMAT, _TILE_WIDTH = 284, 339, 322

# TIFF field type -> (struct code, size)
_TIFF_TYPES = {1: ("B", 1), 3: ("H", 2), 4: ("I", 4), 16: ("Q", 8)}

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


class _Unsupported(ValueError):
    """A file this module does not decode itself."""


def _read_tiff(data: bytes) -> np.ndarray:
    if data[:2] == b"II":
        bo = "<"
    elif data[:2] == b"MM":
        bo = ">"
    else:
        raise _Unsupported("not a TIFF file")
    magic, ifd = struct.unpack(bo + "HI", data[2:8])
    if magic != 42:
        raise _Unsupported("BigTIFF or unknown TIFF variant")
    (n_entries,) = struct.unpack(bo + "H", data[ifd:ifd + 2])
    tags: dict[int, list[int]] = {}
    for i in range(n_entries):
        entry = data[ifd + 2 + 12 * i: ifd + 14 + 12 * i]
        tag, typ, count = struct.unpack(bo + "HHI", entry[:8])
        if typ not in _TIFF_TYPES:
            continue  # rational / ASCII tags carry nothing needed here
        code, size = _TIFF_TYPES[typ]
        if size * count <= 4:
            raw = entry[8:8 + size * count]
        else:
            (offset,) = struct.unpack(bo + "I", entry[8:12])
            raw = data[offset:offset + size * count]
        tags[tag] = list(struct.unpack(bo + code * count, raw))

    width, height = tags[_WIDTH][0], tags[_LENGTH][0]
    bits = tags.get(_BITS, [1])[0]
    samples = tags.get(_SAMPLES, [1])[0]
    fmt = tags.get(_SAMPLE_FORMAT, [1])[0]
    if tags.get(_COMPRESSION, [1])[0] != 1:
        raise _Unsupported("compressed TIFF")
    if _TILE_WIDTH in tags or _STRIP_OFFSETS not in tags:
        raise _Unsupported("tiled TIFF")
    if samples != 1 or tags.get(_PLANAR, [1])[0] != 1:
        raise _Unsupported("multi-sample TIFF")
    kind = {1: "u", 2: "i", 3: "f"}.get(fmt)
    if kind is None or bits not in (8, 16, 32, 64) or (kind == "f" and bits < 32):
        raise _Unsupported(f"TIFF sample format {fmt}/{bits}-bit")
    dtype = np.dtype(f"{bo}{kind}{bits // 8}")
    offsets, counts = tags[_STRIP_OFFSETS], tags[_STRIP_BYTES]
    raw = b"".join(data[o:o + c] for o, c in zip(offsets, counts))
    n = width * height
    if len(raw) < n * dtype.itemsize:
        raise ValueError("truncated TIFF strip data")
    return np.frombuffer(raw, dtype=dtype, count=n).reshape(height, width)


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter_row(ftype: int, line: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """Undo one PNG scanline filter (spec section 9.2)."""
    if ftype == 0:
        return line
    if ftype == 2:
        return (line + prev) & 0xFF
    if ftype == 1:  # sub: running sum per channel
        return np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
    if ftype not in (3, 4):
        raise ValueError(f"bad PNG filter type {ftype}")
    cur = [0] * len(line)
    up = prev.tolist()
    for x, value in enumerate(line.tolist()):
        left = cur[x - bpp] if x >= bpp else 0
        if ftype == 3:
            pred = (left + up[x]) >> 1
        else:
            pred = _paeth(left, up[x], up[x - bpp] if x >= bpp else 0)
        cur[x] = (value + pred) & 0xFF
    return np.asarray(cur, dtype=np.int64)


def _read_png(data: bytes) -> np.ndarray:
    if data[:8] != _PNG_SIGNATURE:
        raise _Unsupported("not a PNG file")
    pos, idat = 8, []
    header = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, color, _, _, interlace = header
    channels = {0: 1, 2: 3}.get(color)
    if depth != 8 or channels is None or interlace:
        raise _Unsupported(f"PNG colour type {color}, depth {depth}, interlace {interlace}")
    stride = width * channels
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8)
    rows = rows.reshape(height, stride + 1)
    out = np.zeros((height, stride), dtype=np.int64)
    prev = np.zeros(stride, dtype=np.int64)
    for y in range(height):
        prev = out[y] = _unfilter_row(int(rows[y, 0]), rows[y, 1:].astype(np.int64), prev, channels)
    img = out.astype(np.uint8)
    return img if channels == 1 else img.reshape(height, width, channels)


def _read_with_package(path: str) -> np.ndarray:
    if path.lower().endswith((".tif", ".tiff")):
        try:
            import tifffile

            return tifffile.imread(path)
        except ImportError:
            pass
    try:
        import imageio.v3 as imageio

        return np.asarray(imageio.imread(path))
    except ImportError:
        pass
    try:
        from PIL import Image
    except ImportError as exc:
        raise ValueError(
            f"{path}: not a baseline TIFF/PNG and no image package is installed"
        ) from exc
    return np.asarray(Image.open(path))


def read_image(path: str) -> np.ndarray:
    """Load an image file as float32 numpy (reference ``TifReader`` contract)."""
    path = str(path)
    with open(path, "rb") as fh:
        data = fh.read()
    try:
        img = _read_png(data) if data[:8] == _PNG_SIGNATURE else _read_tiff(data)
    except _Unsupported:
        img = _read_with_package(path)
    return np.asarray(img).astype(np.float32)


class TifReader:
    """Callable reader, API parity with reference ``transforms.py:64-77``."""

    def __call__(self, path: str) -> np.ndarray:
        return read_image(path)


def write_tif(path: str, array: np.ndarray) -> None:
    """Write a float32 grayscale TIF: little-endian, one uncompressed strip."""
    array = np.asarray(array, dtype=np.float32)
    if array.ndim == 3 and array.shape[-1] == 1:
        array = array[..., 0]
    if array.ndim != 2:
        raise ValueError(f"write_tif takes a 2-D image, got shape {array.shape}")
    height, width = array.shape
    nbytes = array.size * 4
    entries = [  # (tag, type, value), sorted by tag as TIFF requires
        (_WIDTH, 4, width), (_LENGTH, 4, height), (_BITS, 3, 32),
        (_COMPRESSION, 3, 1), (_PHOTOMETRIC, 3, 1), (_STRIP_OFFSETS, 4, 0),
        (_SAMPLES, 3, 1), (_ROWS_PER_STRIP, 4, height), (_STRIP_BYTES, 4, nbytes),
        (_PLANAR, 3, 1), (_SAMPLE_FORMAT, 3, 3),
    ]
    data_offset = 8 + 2 + 12 * len(entries) + 4
    ifd = [struct.pack("<H", len(entries))]
    for tag, typ, value in entries:
        if tag == _STRIP_OFFSETS:
            value = data_offset
        packed = struct.pack("<I", value) if typ == 4 else struct.pack("<HH", value, 0)
        ifd.append(struct.pack("<HHI", tag, typ, 1) + packed)
    ifd.append(struct.pack("<I", 0))  # no next IFD
    with open(path, "wb") as fh:
        fh.write(b"II" + struct.pack("<HI", 42, 8))
        fh.write(b"".join(ifd))
        fh.write(np.ascontiguousarray(array, dtype="<f4").tobytes())


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(kind + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)


def write_png(path: str, array: np.ndarray) -> None:
    """Write a uint8 grayscale ([H, W] or [H, W, 1]) or RGB ([H, W, 3]) PNG."""
    array = np.asarray(array)
    if array.dtype != np.uint8:
        array = np.clip(array, 0, 255).astype(np.uint8)
    if array.ndim == 3 and array.shape[-1] == 1:
        array = array[..., 0]
    if array.ndim == 2:
        color = 0
    elif array.ndim == 3 and array.shape[-1] == 3:
        color = 2
    else:
        raise ValueError(f"write_png takes [H, W], [H, W, 1] or [H, W, 3], got {array.shape}")
    height, width = array.shape[:2]
    rows = np.ascontiguousarray(array).reshape(height, -1)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)  # filter 0
    header = struct.pack(">IIBBBBB", width, height, 8, color, 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(_PNG_SIGNATURE)
        fh.write(_png_chunk(b"IHDR", header))
        fh.write(_png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        fh.write(_png_chunk(b"IEND", b""))
