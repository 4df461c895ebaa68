"""Image output.

A copy of `loltracer_tpu/utils/image.py`: importing anything from `loltracer_tpu` runs its
package `__init__`, which imports jax. tests/test_torch_frontend.py holds
the two equal.

The reference never persists anything — frames exist only in the SDL window
(SURVEY.md §5.4). Here rendered float images can be saved as PNG (pure
stdlib: zlib + struct; no external deps) or raw .npy. The float->u8
conversion matches the reference's pixel pack (renderer.h:17-22): the
renderer's output is already gamma-encoded in [0,1], scaled by 255 and
truncated toward zero like the C cast.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def image_to_u8(img: np.ndarray) -> np.ndarray:
    """[H, W, 3] float in [0, 1] -> uint8, truncating like the C cast
    (renderer.h:19-21 multiplies by 255 and casts)."""
    img = np.asarray(img)
    return np.clip(img * 255.0, 0.0, 255.0).astype(np.uint8)


def write_png(path: str, img: np.ndarray) -> None:
    """Write [H, W, 3] float (in [0,1]) or uint8 image as an RGB PNG."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = image_to_u8(arr)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3], got {arr.shape}")
    height, width = arr.shape[:2]

    # raw scanlines, filter type 0 per row
    raw = b"".join(
        b"\x00" + arr[y].tobytes() for y in range(height)
    )

    def chunk(tag: bytes, data: bytes) -> bytes:
        block = tag + data
        return (
            struct.pack(">I", len(data))
            + block
            + struct.pack(">I", zlib.crc32(block) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    payload = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(payload)


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader for our own writer's output (8-bit RGB,
    filter 0). Returns uint8 [H, W, 3]."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos = 8
    width = height = None
    idat = b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            width, height, depth, ctype = struct.unpack(">IIBB", body[:10])
            if depth != 8 or ctype != 2:
                raise ValueError("only 8-bit RGB supported")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = width * 3 + 1
    rows = []
    prev = np.zeros(width * 3, np.uint8)
    for y in range(height):
        row = raw[y * stride : (y + 1) * stride]
        filt, scan = row[0], np.frombuffer(row[1:], np.uint8).copy()
        if filt == 0:
            pass
        elif filt == 2:  # Up
            scan = (scan + prev).astype(np.uint8)
        else:
            raise ValueError(f"unsupported PNG filter {filt}")
        rows.append(scan)
        prev = scan
    return np.stack(rows).reshape(height, width, 3)


def write_npy(path: str, img: np.ndarray) -> None:
    np.save(path, np.asarray(img))
