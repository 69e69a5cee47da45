"""Image metrics and golden IO — a NumPy copy of ``mrt_tpu/utils/image.py``:
golden renders are kept as compressed arrays and compared by RMSE; and
``write_png``, the port's PNG writer (zlib only, no imaging library)."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    return float(np.sqrt(np.mean((a - b) ** 2)))


def relative_rmse(a: np.ndarray, b: np.ndarray) -> float:
    """RMSE normalized by the reference's RMS (the '1% RMSE' metric)."""
    b = np.asarray(b, np.float64)
    denom = float(np.sqrt(np.mean(b**2)))
    return rmse(a, b) / max(denom, 1e-12)


def save_golden(path: str, image: np.ndarray):
    np.savez_compressed(path, image=np.asarray(image, np.float32))


def load_golden(path: str) -> np.ndarray:
    return np.load(path)["image"]


def write_png(path: str, image_u8: np.ndarray):
    """Write an (H,W,3) uint8 RGB image as an 8-bit PNG, row 0 at the top."""
    img = np.ascontiguousarray(image_u8, np.uint8)
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"write_png wants (H,W,3) RGB, got {img.shape}")
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + chunk(b"IEND", b""))
