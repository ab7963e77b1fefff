"""Minimal PNG writer (zlib, 8-bit RGB or gray) for the debug panels, so
the port needs no image library."""
from __future__ import annotations

import struct
import zlib

import numpy as np


def to_u8(img01: np.ndarray) -> np.ndarray:
    """[0, 1] float -> uint8, truncating as the JAX package's vis does."""
    return np.clip(np.asarray(img01) * 255.0, 0, 255).astype(np.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """img (H, W) or (H, W, 3) uint8, RGB channel order."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        color = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        color = 2
    else:
        raise ValueError(f"unsupported PNG shape {img.shape}")
    h, w = img.shape[:2]
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw, 6))
                + _chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Reads back what write_png writes (filter type 0 only)."""
    with open(path, "rb") as f:
        data = f.read()
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, _, color = hdr[:4]
    ch = 3 if color == 2 else 1
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    img = rows[:, 1:].reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img
