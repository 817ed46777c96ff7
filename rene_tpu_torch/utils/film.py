"""Film output for the port: image layout, 8-bit encoders, PNGs without
PIL.

Counterpart of rene_tpu/utils/film.py: `rays_to_image` and the encoders
are copies of it (the reference's vertical flip, pbrt's 2.2 gamma
through scene/assets/images.py, AOVs as 256 * clamp(v, 0, .999));
`save_png` (:36 there) writes the PNG with zlib and struct, so that
rendering does not need PIL.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from ..scene.assets.images import gamma_correct

__all__ = ["rays_to_image", "to_rgb8", "to_aov8", "to_aov_normal8",
           "save_png", "read_png"]


def rays_to_image(per_ray: np.ndarray, width: int, height: int) -> np.ndarray:
    """(H*W, C) ray-order buffer -> (H, W, C) image with the reference's
    vertical flip (add_image writes at launch_size.y - 1 - y)."""
    img = np.asarray(per_ray).reshape(height, width, -1)
    return img[::-1]


def to_rgb8(linear: np.ndarray) -> np.ndarray:
    v = gamma_correct(np.asarray(linear, np.float32))
    return np.clip(np.round(255.0 * v), 0.0, 255.0).astype(np.uint8)


def to_aov8(linear: np.ndarray) -> np.ndarray:
    return (256.0 * np.clip(linear, 0.0, 0.999)).astype(np.uint8)


def to_aov_normal8(linear: np.ndarray) -> np.ndarray:
    return (256.0 * np.clip(linear * 0.5 + 0.5, 0.0, 0.999)).astype(np.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def save_png(path: str, rgb8: np.ndarray) -> str:
    """Write an (H, W, 3) uint8 image as an 8-bit RGB PNG. `.exr` names
    get `.png` appended, as rene_tpu's writer does."""
    path = str(path)
    if path.endswith(".exr"):
        path = path + ".png"
    img = np.ascontiguousarray(rgb8, dtype=np.uint8)
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {img.shape}")
    raw = np.zeros((h, 1 + w * 3), np.uint8)   # filter byte 0 per row
    raw[:, 1:] = img.reshape(h, w * 3)
    data = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)
    return path


def read_png(path: str) -> np.ndarray:
    """Decode a PNG written by `save_png` (8-bit RGB, filter 0 rows)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            if (depth, ctype) != (8, 2):
                raise ValueError(f"{path}: only 8-bit RGB is supported")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if raw[:, 0].any():
        raise ValueError(f"{path}: filtered rows are not supported")
    return raw[:, 1:].reshape(h, w, 3).copy()
