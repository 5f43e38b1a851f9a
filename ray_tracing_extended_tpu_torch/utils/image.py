"""Image export and import as PNG. Row 0 of a render is the BOTTOM (Unity
UV origin); files are written top row first.

Counterpart of ``ray_tracing_extended_tpu/utils/image.py``, which uses
PIL. The port writes and reads PNG with ``zlib`` and ``struct`` alone, so
it needs no imaging package: 8-bit RGB, no interlacing.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from ..ops.tonemap import to_srgb8

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def save_png(path, img, tone: str = "none", exposure: float = 1.0):
    """Write a linear (H, W, 3) float image (tensor or array) as an sRGB
    PNG, optionally tone-mapped first (``ops/tonemap.to_srgb8``)."""
    data = to_srgb8(torch.as_tensor(img).cpu(), tone=tone, exposure=exposure)
    rows = np.ascontiguousarray(data.numpy()[::-1])
    h, w, _ = rows.shape
    # each scanline: filter type 0 (none), then its RGB bytes
    raw = np.zeros((h, 1 + 3 * w), np.uint8)
    raw[:, 1:] = rows.reshape(h, 3 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters (PNG spec, section 9)."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    pos = 0
    for y in range(h):
        kind = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1).astype(np.int64)
        pos += 1 + stride
        if kind == 0:
            cur = line
        elif kind == 2:
            cur = (line + prev) & 0xFF
        else:
            cur = line.copy()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                c = prev[i - bpp] if i >= bpp else 0
                if kind == 1:
                    pred = a
                elif kind == 3:
                    pred = (a + prev[i]) // 2
                elif kind == 4:
                    pred = _paeth(a, prev[i], c)
                else:
                    raise ValueError(f"unknown PNG filter type {kind}")
                cur[i] = (cur[i] + pred) & 0xFF
        out[y] = cur
        prev = cur
    return out


def read_png_rgb8(path) -> np.ndarray:
    """The 8-bit values of an RGB or RGBA PNG without interlacing, (H, W,
    3) uint8 with row 0 at the top, as stored."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(blob):
        (length,) = struct.unpack(">I", blob[pos:pos + 4])
        kind = blob[pos + 4:pos + 8]
        data = blob[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    w, h, depth, colour_type, _, _, interlace = header
    if depth != 8 or colour_type not in (2, 6) or interlace:
        raise ValueError(
            f"{path}: only 8-bit RGB/RGBA non-interlaced PNGs are read"
        )
    channels = 3 if colour_type == 2 else 4
    return _unfilter(zlib.decompress(b"".join(idat)), h, w * channels,
                     channels).reshape(h, w, channels)[..., :3]


def load_png(path) -> np.ndarray:
    """Read an 8-bit RGB or RGBA PNG back to linear float (sRGB decode),
    (H, W, 3) f32 with row 0 at the bottom."""
    srgb = read_png_rgb8(path)[::-1].astype(np.float32) / 255.0
    lin = np.where(
        srgb <= 0.04045, srgb / 12.92, ((srgb + 0.055) / 1.055) ** 2.4
    )
    return lin.astype(np.float32)
