"""Temporal upscaler — counterpart of ``mrt_tpu/upscale/temporal.py``: the
current frame resampled to output size, the output-size history reprojected
through the motion vectors, rejected where its stored depth disagrees with
the current surface (disocclusion), clamped to the current frame's 3x3
neighbourhood, and blended with a weight that falls with motion.

The resize is kernel K12 (``spatial.resize``: colour, depth and motion read
where they lie, written as one (out_h,out_w,6) buffer); the rest is kernel
K11 ``temporal_resolve`` (``kernels/presenter.py``, ``csrc/presenter.cu``);
on CPU tensors their plain versions.

Motion is in render pixels, +X right and +Y down in display space; render
rows store v bottom-up, so the history row is ``row + motion.y`` and the
history column ``col - motion.x``.
"""

from __future__ import annotations

import torch

from ..kernels import presenter as K
from ..kernels.presenter import bilinear_sample  # noqa: F401  (temporal.bilinear_sample)
from . import spatial


def temporal_upscale(color: torch.Tensor, depth: torch.Tensor, motion: torch.Tensor,
                     history: torch.Tensor, out_h: int, out_w: int, history_weight=0.9,
                     quantize: bool = False):
    """color (h,w,3), depth (h,w), motion (h,w,2) at render size; history
    (out_h,out_w,4) of rgb + depth. ``history_weight``: 0.0 on the first
    frame after a reset. Returns (output (out_h,out_w,3), new history
    (out_h,out_w,4)); with ``quantize`` the output is tonemapped to uint8
    in K11's epilogue (its uint8 form)."""
    h, w = color.shape[0], color.shape[1]
    sy = out_h / h
    sx = out_w / w

    # colour, depth and motion in one bilinear resample (the same weights
    # on each channel as three separate resizes), then K11
    up = spatial.resize((color.contiguous(), depth.contiguous(), motion.contiguous()), out_h,
                        out_w, "bilinear")
    return K.temporal_resolve(up, history.contiguous(), history_weight, sx, sy, quantize)
