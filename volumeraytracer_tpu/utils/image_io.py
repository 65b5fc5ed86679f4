"""PNG image I/O and debug image-stack export.

Equivalent of the reference's image layer
(IMG_IO::read_png/write_png, /root/reference/src/image_io.h:16-22,
image_io.cpp) and its debug consumer ``export_image_stack``
(/root/reference/src/image_util.cpp:323-377: one 8-bit PNG per z-slice of a
volume, used to eyeball preprocessed fields in non-NDEBUG builds,
image_util.cpp:443,453).

No libpng/libjpeg dependency: PNGs are encoded/decoded directly with
``zlib`` (8-bit grayscale / RGB / RGBA, the subset the reference writes);
JPEG (IMG_IO::load_jpeg/write_jpeg, image_io.h:19-22) is a from-scratch
baseline codec in ``utils/jpeg.py`` (grayscale + 4:4:4 writer; baseline
reader incl. subsampled files), re-exported here as
``write_jpeg``/``read_jpeg``.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Optional, Union

import numpy as np

from .jpeg import read_jpeg, write_jpeg  # noqa: F401  (C17 parity surface)

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}  # channels -> PNG color type
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def write_png(path: Union[str, Path], image: np.ndarray) -> None:
    """Write an 8-bit PNG (≙ IMG_IO::write_png, image_io.cpp).

    image: (H, W) or (H, W, C) uint8 with C ∈ {1, 3, 4}.
    """
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png expects uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[-1] not in _COLOR_TYPE:
        raise ValueError(f"unsupported image shape {image.shape}")
    h, w, c = img.shape
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    # filter byte 0 (None) per scanline
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    data = (
        _PNG_SIG
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(raw, 6))
        + _chunk(b"IEND", b"")
    )
    Path(path).write_bytes(data)


def _unfilter(raw: np.ndarray, h: int, w: int, c: int) -> np.ndarray:
    """Undo PNG scanline filters (types 0-4) for 8-bit images."""
    stride = w * c
    rows = raw.reshape(h, 1 + stride)
    ftypes = rows[:, 0]
    out = np.zeros((h, stride), np.uint8)
    for y in range(h):
        ft = int(ftypes[y])
        line = rows[y, 1:].astype(np.int32)
        prev = out[y - 1].astype(np.int32) if y else np.zeros(stride, np.int32)
        if ft == 0:
            cur = line
        elif ft == 2:  # Up
            cur = (line + prev) & 0xFF
        else:
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - c] if x >= c else 0
                b = prev[x]
                if ft == 1:  # Sub
                    cur[x] = (line[x] + a) & 0xFF
                elif ft == 3:  # Average
                    cur[x] = (line[x] + (a + b) // 2) & 0xFF
                elif ft == 4:  # Paeth
                    cc = prev[x - c] if x >= c else 0
                    p = a + b - cc
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
                    cur[x] = (line[x] + pred) & 0xFF
                else:
                    raise ValueError(f"unsupported PNG filter {ft}")
        out[y] = cur.astype(np.uint8)
    return out.reshape(h, w, c)


def read_png(path: Union[str, Path]) -> np.ndarray:
    """Read an 8-bit non-interlaced PNG into (H, W, C) uint8
    (≙ IMG_IO::read_png, image_io.cpp)."""
    data = Path(path).read_bytes()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    idat = b""
    h = w = c = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, depth, color, comp, filt, inter = struct.unpack(">IIBBBBB", payload)
            if depth != 8 or inter != 0 or color not in _CHANNELS:
                raise ValueError(
                    f"unsupported PNG (depth={depth}, color={color}, interlace={inter})"
                )
            c = _CHANNELS[color]
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    if h is None:
        raise ValueError(f"{path}: missing IHDR")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return _unfilter(raw, h, w, c)


def to_uint8(field: np.ndarray, lo: Optional[float] = None, hi: Optional[float] = None) -> np.ndarray:
    """Normalise a float field into uint8 for export (min/max by default,
    matching the reference's per-volume scaling, image_util.cpp:334-357)."""
    f = np.asarray(field, np.float64)
    lo = float(f.min()) if lo is None else lo
    hi = float(f.max()) if hi is None else hi
    scale = 255.0 / (hi - lo) if hi > lo else 0.0
    return np.clip((f - lo) * scale, 0, 255).astype(np.uint8)


def export_image_stack(
    directory: Union[str, Path],
    volume: np.ndarray,
    prefix: str = "slice",
    axis: int = 0,
    lo: Optional[float] = None,
    hi: Optional[float] = None,
    format: str = "png",
) -> int:
    """Dump a 3D scalar volume as one grayscale image per slice — the debug
    workflow of export_image_stack (image_util.cpp:323-377).  2D volumes
    produce a single image.  ``format``: "png" (lossless) or "jpeg" (the
    reference's alternate debug format, image_io.h:19-22).  Returns the
    number of files written.
    """
    if format not in ("png", "jpeg"):
        raise ValueError(f"format must be 'png' or 'jpeg', got {format!r}")
    write = write_png if format == "png" else write_jpeg
    ext = format if format == "png" else "jpg"
    vol = np.asarray(volume)
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    img8 = to_uint8(vol, lo, hi)
    if vol.ndim == 2:
        write(directory / f"{prefix}_0000.{ext}", img8)
        return 1
    if vol.ndim != 3:
        raise ValueError(f"export_image_stack needs a 2D/3D volume, got {vol.ndim}D")
    img8 = np.moveaxis(img8, axis, 0)
    for i in range(img8.shape[0]):
        write(directory / f"{prefix}_{i:04d}.{ext}", img8[i])
    return img8.shape[0]
