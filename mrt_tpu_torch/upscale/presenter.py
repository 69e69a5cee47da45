"""Presenter — counterpart of ``mrt_tpu/upscale/presenter.py``: upscale,
tonemap and quantize the accumulation to a uint8 image with kernel K1. The
off and (equal-size) spatial modes are ported; temporal and denoised raise."""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.present import tonemap_quantize
from . import spatial


def present_device(renderer) -> torch.Tensor:
    """The uint8 (H,W,3) image on the renderer's device, in texture row
    order (not yet flipped)."""
    from ..engine import renderer as R

    if renderer.upscaler_mode in (R.UPSCALER_TEMPORAL, R.UPSCALER_DENOISED):
        raise NotImplementedError(
            f"the {renderer.upscaler_mode} presenter is not ported yet (ROADMAP Slice C)")
    up = spatial.upscale(renderer.accum, renderer.output_height, renderer.output_width)
    return tonemap_quantize(up.contiguous())


def present(renderer) -> np.ndarray:
    """The uint8 RGB image on the host, row 0 at the top."""
    return present_device(renderer).cpu().numpy()[::-1]


def write_png(path: str, image_u8: np.ndarray):
    from PIL import Image

    Image.fromarray(np.ascontiguousarray(image_u8), "RGB").save(path)
