"""Presenter — counterpart of ``mrt_tpu/upscale/presenter.py``: upscale the
accumulation to output size, then tonemap and quantize it to uint8 with
kernel K1.

Three chains, as pure functions that each return (linear (H,W,3) f32, new
state): ``present_spatial`` (Lanczos-3, also the off mode's identity),
``present_temporal`` (history reprojection at output size) and
``present_denoised`` (SVGF-lite at render size feeding the temporal
upscaler). ``present_linear`` picks the renderer's chain and its state;
``present_device`` runs it, applies K1 and keeps the new state on the
renderer. The renderer drops that state whenever accumulation restarts
(``Renderer._clear_presenter_history``), so a camera move cannot ghost stale
history into the new view.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.present import tonemap_quantize
from . import denoise, spatial, temporal


def present_spatial(color, out_h: int, out_w: int, method: str = "lanczos3"):
    """-> (linear (out_h,out_w,3), None): spatial upscaling keeps no state."""
    return spatial.upscale(color, out_h, out_w, method=method), None


def present_temporal(color, depth, motion, history, history_weight, out_h: int, out_w: int):
    """-> (linear, new history (out_h,out_w,4))."""
    return temporal.temporal_upscale(color, depth, motion, history, out_h, out_w,
                                     history_weight=history_weight)


def present_denoised(color, gbuffer: dict, depth, motion, dstate: denoise.DenoiseState,
                     history, history_weight, out_h: int, out_w: int):
    """-> (linear, (new history, new DenoiseState))."""
    den, new_dstate = denoise.svgf_filter(color, gbuffer, depth, motion, dstate)
    up, new_history = temporal.temporal_upscale(den, depth, motion, history, out_h, out_w,
                                                history_weight=history_weight)
    return up, (new_history, new_dstate)


def present_linear(renderer):
    """The renderer's presenter chain on its current buffers and state,
    without changing either: (linear (H,W,3) f32, new upscale history or
    None, new DenoiseState or None)."""
    from ..engine import renderer as R

    mode = renderer.upscaler_mode
    out_h, out_w = renderer.output_height, renderer.output_width
    color = renderer.accum
    if mode not in (R.UPSCALER_TEMPORAL, R.UPSCALER_DENOISED):
        return present_spatial(color, out_h, out_w, "lanczos3")[0], None, None

    history = renderer._upscale_history
    fresh = history is None or tuple(history.shape) != (out_h, out_w, 4)
    if fresh:
        history = torch.zeros((out_h, out_w, 4), dtype=torch.float32, device=color.device)
    # the first frame after a reset contributes fully; afterwards the blend
    # follows the renderer's accumulation weight
    weight = 0.0 if fresh else float(renderer.accumulation_weight)
    if mode == R.UPSCALER_DENOISED and renderer.gbuffer is not None:
        h, w = color.shape[0], color.shape[1]
        dstate = renderer._denoise_state
        if dstate is None or tuple(dstate.demod.shape) != (h, w, 3):
            dstate = denoise.init_state(h, w, color.device)
        up, (new_history, new_dstate) = present_denoised(
            color, renderer.gbuffer, renderer.depth, renderer.motion, dstate, history, weight,
            out_h, out_w)
        return up, new_history, new_dstate
    up, new_history = present_temporal(color, renderer.depth, renderer.motion, history, weight,
                                       out_h, out_w)
    return up, new_history, None


def present_device(renderer) -> torch.Tensor:
    """The uint8 (H,W,3) image on the renderer's device, in texture row
    order (not yet flipped); keeps the chain's new state on the renderer
    (written past the reset idiom, which must not fire)."""
    up, new_history, new_dstate = present_linear(renderer)
    img = tonemap_quantize(up.contiguous())
    if new_history is not None:
        object.__setattr__(renderer, "_upscale_history", new_history)
    if new_dstate is not None:
        object.__setattr__(renderer, "_denoise_state", new_dstate)
    return img


def present(renderer) -> np.ndarray:
    """The uint8 RGB image on the host, row 0 at the top."""
    return present_device(renderer).cpu().numpy()[::-1]


def write_png(path: str, image_u8: np.ndarray):
    from PIL import Image

    Image.fromarray(np.ascontiguousarray(image_u8), "RGB").save(path)
