"""Image output: the port of pathtracer_tpu/io/image.py's PNG path.

PNG is clamp(pix, 0, 1) * 255, 3 channels, mirrored in x as the reference's
saveImage does (main.cpp:395-419). The encoder is written with zlib, so the
port needs no imaging package.
"""
from __future__ import annotations

import struct
import time
import zlib

import numpy as np


def to_uint8(img: np.ndarray) -> np.ndarray:
    """HDR float [H,W,3] -> clamped 8-bit (image.cpp:28-38)."""
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255.0).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def save_png(img, path: str, mirror_x: bool = True) -> str:
    """Save an averaged [H, W, 3] image as an 8-bit RGB PNG."""
    arr = to_uint8(img)
    if mirror_x:
        arr = arr[:, ::-1, :]
    h, w, _ = arr.shape
    # filter type 0 (None) before every scanline
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          np.ascontiguousarray(arr).reshape(h, w * 3)],
                         axis=1).tobytes()
    png = (b"\x89PNG\r\n\x1a\n"
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + _chunk(b"IDAT", zlib.compress(raw, 6))
           + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)
    return path


def reference_style_name(image_name: str, samples: int,
                         ext: str = "png") -> str:
    """"<FILE>.<UTC timestamp>.<N>samp.<ext>" (main.cpp:398-404)."""
    ts = time.strftime("%Y-%m-%d_%H-%M-%Sz", time.gmtime())
    return f"{image_name}.{ts}.{samples}samp.{ext}"
