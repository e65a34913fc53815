"""Image input and output: the port of pathtracer_tpu/io/image.py.

PNG is clamp(pix, 0, 1) * 255, 3 channels, mirrored in x as the reference's
saveImage does (main.cpp:395-419); HDR is flat Radiance RGBE. The PNG
encoder and decoder are written with zlib, so the port needs no imaging
package.
"""
from __future__ import annotations

import struct
import time
import zlib

import numpy as np

from ..utils import spans


@spans.span("pt_display.u8")
def to_uint8(img: np.ndarray) -> np.ndarray:
    """HDR float [H,W,3] -> clamped 8-bit (image.cpp:28-38); the span
    pt_display.u8."""
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255.0).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def png_bytes(img8: np.ndarray) -> bytes:
    """The bytes of an 8-bit RGB PNG of the uint8 [H, W, 3] image `img8`,
    as it stands (no clamp, no mirror)."""
    h, w, _ = img8.shape
    # filter type 0 (None) before every scanline
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          np.ascontiguousarray(img8).reshape(h, w * 3)],
                         axis=1).tobytes()
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw, 6))
            + _chunk(b"IEND", b""))


def save_png(img, path: str, mirror_x: bool = True) -> str:
    """Save an averaged [H, W, 3] image as an 8-bit RGB PNG."""
    arr = to_uint8(img)
    if mirror_x:
        arr = arr[:, ::-1, :]
    with open(path, "wb") as f:
        f.write(png_bytes(arr))
    return path


def save_hdr(img, path: str, mirror_x: bool = True) -> str:
    """Minimal Radiance RGBE (.hdr) writer, flat (non-RLE) scanlines
    (image.cpp:45-50 equivalent); the JAX package's bytes."""
    arr = np.asarray(img, dtype=np.float32)
    if mirror_x:
        arr = arr[:, ::-1, :]
    h, w, _ = arr.shape
    maxc = arr.max(axis=-1)
    valid = maxc >= 1e-32
    m, e = np.frexp(np.where(valid, maxc, 1.0))
    scale = np.where(valid, m * 256.0 / np.where(valid, maxc, 1.0), 0.0)
    rgbe = np.zeros((h, w, 4), dtype=np.uint8)
    for c in range(3):
        rgbe[..., c] = np.clip(arr[..., c] * scale, 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(valid, e + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())
    return path


_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG colour type -> samples a pixel


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the five PNG scanline filters (PNG spec 9.2); [h, stride]."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind = raw[y * (stride + 1)]
        line = np.frombuffer(raw, np.uint8, stride, y * (stride + 1) + 1)
        cur = line.astype(np.int32)
        if kind == 2:                                   # Up
            cur = (cur + prev) & 0xFF
        elif kind in (1, 3, 4):                         # Sub, Average, Paeth
            row = bytearray(line.tobytes())
            up = prev.tolist()
            for x in range(stride):
                a = row[x - bpp] if x >= bpp else 0
                if kind == 1:
                    pred = a
                elif kind == 3:
                    pred = (a + up[x]) >> 1
                else:
                    b = up[x]
                    c = up[x - bpp] if x >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc
                                                            else c)
                row[x] = (row[x] + pred) & 0xFF
            cur = np.frombuffer(bytes(row), np.uint8).astype(np.int32)
        elif kind != 0:
            raise ValueError(f"PNG: unknown filter type {kind}")
        out[y] = cur
        prev = cur
    return out


def load_png(path: str) -> np.ndarray:
    """An 8-bit, non-interlaced PNG as float32 RGB in [0, 1] [H, W, 3]
    (grey and alpha are converted as PIL's convert("RGB") does)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or interlace or ctype not in _CHANNELS:
        raise ValueError(f"{path}: only 8-bit non-interlaced grey/RGB(A) "
                         f"PNGs are read (depth {depth}, colour type "
                         f"{ctype}, interlace {interlace})")
    ch = _CHANNELS[ctype]
    pix = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch,
                    ch).reshape(h, w, ch)
    rgb = pix[..., :3] if ch >= 3 else np.repeat(pix[..., :1], 3, axis=-1)
    return rgb.astype(np.float32) / 255.0


def reference_style_name(image_name: str, samples: int,
                         ext: str = "png") -> str:
    """"<FILE>.<UTC timestamp>.<N>samp.<ext>" (main.cpp:398-404)."""
    ts = time.strftime("%Y-%m-%d_%H-%M-%Sz", time.gmtime())
    return f"{image_name}.{ts}.{samples}samp.{ext}"
