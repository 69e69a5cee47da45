"""Spatial upscaler — counterpart of ``mrt_tpu/upscale/spatial.py``. At equal
size it is the identity; resampling (Lanczos-3) is not ported yet."""

from __future__ import annotations

import torch


def upscale(color: torch.Tensor, out_height: int, out_width: int,
            method: str = "lanczos3") -> torch.Tensor:
    """color: (H,W,3) linear radiance -> (out_height,out_width,3)."""
    if color.shape[0] == out_height and color.shape[1] == out_width:
        return color
    raise NotImplementedError(
        f"spatial {method} resampling {tuple(color.shape[:2])} -> {(out_height, out_width)} "
        "is not ported yet (ROADMAP Slice C); use upscaler_mode 'off'")
