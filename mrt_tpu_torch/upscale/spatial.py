"""Spatial upscaler — counterpart of ``mrt_tpu/upscale/spatial.py``: Lanczos-3
(default) or bilinear resampling as ``jax.image.resize`` computes it.

The resize is separable: each axis whose size changes gets a dense
(in, out) weight matrix, built as ``jax/_src/image/scale.py:compute_weight_mat``
builds it (half-pixel centres, the kernel widened by 1/scale when shrinking,
columns normalised by their sum, columns whose sample falls outside the input
zeroed), and the image is contracted with each matrix in turn by a full-f32
2-D product (``torch.mm``) — the JAX package computes the same contraction
as a plain ``einsum`` outside any Pallas kernel. The width is contracted first, the
cheaper order when both axes grow by the same factor. An axis of equal size
is skipped, so an equal-size resize returns its input.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..core.device import require_full_f32

METHODS = ("lanczos3", "bilinear")


def _lanczos3(x: torch.Tensor) -> torch.Tensor:
    radius = 3.0
    px = math.pi * x
    y = radius * torch.sin(px) * torch.sin(px / radius)
    denom = torch.where(x != 0, (math.pi ** 2) * (x * x), torch.ones_like(x))
    out = torch.where(x > 1e-3, y / denom, torch.ones_like(x))
    return torch.where(x > radius, torch.zeros_like(x), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(1.0 - x.abs(), 0.0)


@functools.lru_cache(maxsize=32)
def weight_matrix(n_in: int, n_out: int, method: str, device: torch.device) -> torch.Tensor:
    """(n_in, n_out) f32 resampling weights for one axis (antialiased), on
    ``device``; built in f32 on the host and cached per arguments."""
    if method not in METHODS:
        raise ValueError(f"unknown resize method {method!r}; expected one of {METHODS}")
    f32 = torch.float32
    inv_scale = 1.0 / (n_out / n_in)  # in double, then used in f32
    inv_scale_f = torch.tensor(inv_scale, dtype=f32)
    kernel_scale = torch.tensor(max(inv_scale, 1.0), dtype=f32)
    sample_f = (torch.arange(n_out, dtype=f32) + 0.5) * inv_scale_f - 0.5
    x = (sample_f[None, :] - torch.arange(n_in, dtype=f32)[:, None]).abs() / kernel_scale
    w = _lanczos3(x) if method == "lanczos3" else _triangle(x)
    total = w.sum(dim=0, keepdim=True)
    safe = torch.where(total != 0, total, torch.ones_like(total))
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps), w / safe,
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    w = torch.where(inside[None, :], w, torch.zeros_like(w))
    return w.to(device)


def resize(x: torch.Tensor, out_height: int, out_width: int, method: str) -> torch.Tensor:
    """``jax.image.resize`` of (H,W,C) f32 to (out_height,out_width,C)."""
    h, w, c = x.shape
    if (h, w) == (out_height, out_width):
        return x
    require_full_f32(x, "spatial.resize")
    # both contractions as single 2-D products on contiguous operands (a
    # permuted 3-D operand would send torch.matmul to a batched product of
    # h tiny (c, w) x (w, out_width) products)
    t = x.permute(0, 2, 1).reshape(h * c, w)
    if w != out_width:
        t = torch.mm(t, weight_matrix(w, out_width, method, x.device))
    t = t.reshape(h, c * out_width)
    if h != out_height:
        t = torch.mm(weight_matrix(h, out_height, method, x.device).t(), t)
    return t.reshape(out_height, c, out_width).permute(0, 2, 1).contiguous()


def upscale(color: torch.Tensor, out_height: int, out_width: int,
            method: str = "lanczos3") -> torch.Tensor:
    """color: (H,W,3) linear radiance -> (out_height,out_width,3)."""
    if color.shape[0] == out_height and color.shape[1] == out_width:
        return color
    out = resize(color, out_height, out_width, method)
    # Lanczos ringing can undershoot below zero; radiance must stay >= 0
    return torch.clamp_min(out, 0.0)
