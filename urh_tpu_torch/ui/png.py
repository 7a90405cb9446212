"""Minimal dependency-free PNG writer (stdlib zlib only; a copy of
urh_tpu.ui.png).

The web UI serves spectrogram renders as PNG; the image arrays come
from dsp/spectrogram.py as (H, W, 4) BGRA uint8 (the reference's
QImage Format_ARGB32 memory layout).  No PIL/matplotlib at runtime.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def encode_rgba(image: np.ndarray) -> bytes:
    """(H, W, 4) uint8 RGBA -> PNG bytes."""
    image = np.ascontiguousarray(image, dtype=np.uint8)
    h, w, channels = image.shape
    if channels != 4:
        raise ValueError("expected RGBA")
    # filter byte 0 (None) per scanline
    raw = np.zeros((h, 1 + w * 4), dtype=np.uint8)
    raw[:, 1:] = image.reshape(h, w * 4)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def encode_bgra(image: np.ndarray) -> bytes:
    """(H, W, 4) uint8 BGRA (QImage ARGB32 layout) -> PNG bytes."""
    return encode_rgba(np.ascontiguousarray(image[..., [2, 1, 0, 3]]))
