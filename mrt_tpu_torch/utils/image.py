"""Image metrics and golden IO — a NumPy copy of ``mrt_tpu/utils/image.py``:
golden renders are kept as compressed arrays and compared by RMSE."""

from __future__ import annotations

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
