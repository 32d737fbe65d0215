"""Image output (counterpart of raytracegr_jl_tpu/utils/image.py).

The canvas is indexed ``(i, j)`` with ``i`` along ``widthx``; images are
row = j, column = i, as the reference writes them. PNGs are encoded and
decoded with the standard library's zlib (8-bit RGB or RGBA,
non-interlaced), so neither torch, Pillow nor a compiler is needed.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"


def canvas_to_image(rgb) -> np.ndarray:
    """Canvas rgb [ni, nj, 3] in [0, 1] (array or CPU/CUDA tensor) -> uint8
    image [nj, ni, 3], rounded to nearest."""
    if hasattr(rgb, "detach"):
        rgb = rgb.detach().cpu().numpy()
    img = np.transpose(np.asarray(rgb), (1, 0, 2))
    return np.round(np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """uint8 [H, W, 3] -> PNG bytes (filter 0 on every row)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img.reshape(h, w * 3)], axis=1).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes (8-bit RGB or RGBA, non-interlaced) -> uint8 [H, W, 3]."""
    if data[:8] != _SIG:
        raise ValueError("not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = hdr
    if depth != 8 or interlace != 0 or color not in (2, 6):
        raise ValueError(f"unsupported PNG: depth {depth}, colour type "
                         f"{color}, interlace {interlace}")
    bpp = 3 if color == 2 else 4
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: a running sum along the row, per channel
            cur = (np.cumsum(line.reshape(w, bpp), axis=0) & 0xFF).ravel()
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        else:  # Average and Paeth need the left neighbour: per pixel
            cur = np.zeros(stride, np.int32)
            for x in range(0, stride, bpp):
                left = cur[x - bpp:x] if x else np.zeros(bpp, np.int32)
                up = prev[x:x + bpp]
                ul = prev[x - bpp:x] if x else np.zeros(bpp, np.int32)
                if ftype == 3:
                    pred = (left + up) // 2
                elif ftype == 4:
                    pred = _paeth(left, up, ul)
                else:
                    raise ValueError(f"bad PNG filter {ftype}")
                cur[x:x + bpp] = (line[x:x + bpp] + pred) & 0xFF
        out[y] = cur
        prev = cur
    return out.reshape(h, w, bpp)[..., :3].astype(np.uint8)


def save_png(path: str, rgb) -> str:
    """Write canvas rgb to a PNG file; returns the path."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(canvas_to_image(rgb)))
    return path


def load_png(path: str) -> np.ndarray:
    """Read a PNG into float64 [H, W, 3] in [0, 1]."""
    with open(path, "rb") as f:
        return decode_png(f.read()).astype(np.float64) / 255.0
