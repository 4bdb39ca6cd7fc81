"""Minimal PNG encoder/decoder (stdlib zlib + struct).

Copy of volume_path_tracer_tpu/io/png.py. Writes what the reference
renderer's Image::save writes: 3-channel RGB at 8 or 16 bits. The small
decoder reads back what the encoder writes (tests, golden images).
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_MAGIC = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def write_png(path: str, image: np.ndarray, atomic: bool = False) -> None:
    """Write an RGB image [H, W, 3] of dtype uint8 or uint16 as PNG.

    atomic=True stages through a temp file + os.replace so a concurrently
    refreshing reader (a live preview viewer) never sees a torn file.
    """
    image = np.asarray(image)
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3] RGB, got {image.shape}")
    if image.dtype == np.uint8:
        depth = 8
        raw = image
    elif image.dtype == np.uint16:
        depth = 16
        raw = image.astype(">u2")  # PNG is big-endian
    else:
        raise ValueError(f"unsupported dtype {image.dtype} (need uint8/uint16)")
    h, w, _ = image.shape
    ihdr = struct.pack(">IIBBBBB", w, h, depth, 2, 0, 0, 0)  # color type 2 = RGB
    rows = raw.tobytes()
    stride = w * 3 * (depth // 8)
    # filter byte 0 (None) per scanline
    body = b"".join(
        b"\x00" + rows[y * stride : (y + 1) * stride] for y in range(h)
    )
    data = _MAGIC + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(body, 6)) + _chunk(b"IEND", b"")
    out = path + ".tmp" if atomic else path
    with open(out, "wb") as f:
        f.write(data)
    if atomic:
        os.replace(out, path)


def read_png(path: str) -> np.ndarray:
    """Read an RGB PNG written by write_png (filter-0, color type 2)."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != _MAGIC:
        raise ValueError("not a PNG file")
    pos = 8
    idat = b""
    meta = None
    while pos < len(buf):
        (length,) = struct.unpack(">I", buf[pos : pos + 4])
        tag = buf[pos + 4 : pos + 8]
        payload = buf[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            meta = struct.unpack(">IIBBBBB", payload)
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    assert meta is not None
    w, h, depth, ctype, _, _, interlace = meta
    if ctype != 2 or interlace != 0:
        raise ValueError(f"unsupported PNG (ctype={ctype}, interlace={interlace})")
    raw = zlib.decompress(idat)
    nbytes = depth // 8
    stride = w * 3 * nbytes
    out = np.empty((h, w, 3), dtype=np.uint16 if depth == 16 else np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        f0 = raw[y * (stride + 1)]
        line = np.frombuffer(
            raw[y * (stride + 1) + 1 : (y + 1) * (stride + 1)], np.uint8
        ).copy()
        if f0 == 0:
            pass
        elif f0 == 1:  # Sub
            bpp = 3 * nbytes
            for i in range(bpp, stride):
                line[i] = (int(line[i]) + int(line[i - bpp])) & 0xFF
        elif f0 == 2:  # Up
            line = ((line.astype(np.int32) + prev.astype(np.int32)) & 0xFF).astype(np.uint8)
        else:
            raise ValueError(f"unsupported PNG filter {f0}")
        prev = line
        if depth == 16:
            out[y] = line.view(">u2").astype(np.uint16).reshape(w, 3)
        else:
            out[y] = line.reshape(w, 3)
    return out
