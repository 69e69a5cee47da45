"""The least time an NVIDIA H100 could take for a present: a frozen copy of
the arithmetic of the port's ``mrt_tpu_torch/utils/bounds.py`` that the
benchmark's rooflines use, so that a later change to the port cannot move
them.

A bound is the larger of two times: the bytes the work must move (each
input read once, each output written once) over 3.35 TB/s of HBM3, and the
f32 operations over 33.5e12 a second (the data sheet's 67 TFLOP/s counts a
fused multiply-add as two; the port's kernels build with ``-fmad=false``,
so each add, multiply, compare or division is one instruction). The
temporal present counts bytes only.
"""

from __future__ import annotations

PEAK_BYTES = 3.35e12
PEAK_F32_OPS = 67e12 / 2


def present(mode: str, h: int, w: int, out_h: int, out_w: int) -> tuple[float, str] | None:
    """(ms, what binds) of one present in ``mode`` of an (h,w) render
    upscaled to (out_h,out_w), as ``presenter.present_device`` runs it; None
    for a mode without a frozen bound. The temporal present (K12's bilinear
    resize, then K11 writing the uint8 image): colour, depth and motion read
    at render size, the (out_h,out_w,4) f32 history read and written, the
    (out_h,out_w,3) image written as uint8."""
    if mode != "temporal":
        return None
    nbytes = (h * w * 6 + out_h * out_w * (4 + 4 + 0.75)) * 4
    return nbytes / PEAK_BYTES * 1e3, "bytes"
