"""Temporal accumulation — counterpart of ``mrt_tpu/render/accumulate.py``:
an EMA blend with the history, with a motion-adaptive history weight."""

from __future__ import annotations

import torch

from ..core import types as T
from .shade import length2

def accumulate(settings: T.RenderSettings, uniforms: T.FrameUniforms, color: torch.Tensor,
               motion: torch.Tensor, prev_motion: torch.Tensor,
               prev_accum: torch.Tensor) -> torch.Tensor:
    """color (..., 3) this frame's radiance; motion/prev_motion (..., 2) in
    pixels; prev_accum (..., 3) history. Frame 0 returns ``color``."""
    if uniforms.frame_index <= 0:
        return color
    history_weight = torch.clamp(uniforms.accumulation_weight, 0.0, 0.95)
    if settings.enable_motion_adaptive_accumulation:
        motion_mag = torch.maximum(length2(motion), length2(prev_motion))
        low = torch.clamp(uniforms.motion_accum_low_px, min=0.0)
        high = torch.maximum(uniforms.motion_accum_high_px, low + 1e-3)
        t = torch.clamp((motion_mag - low) / (high - low), 0.0, 1.0)
        min_weight = torch.clamp(uniforms.motion_accum_min_weight, 0.0, 0.95)
        min_weight = torch.minimum(min_weight, history_weight)
        history_weight = (history_weight + (min_weight - history_weight) * t)[..., None]
    return color + (prev_accum - color) * history_weight
