"""Spatial upscaler — counterpart of ``mrt_tpu/upscale/spatial.py``: Lanczos-3
(default) or bilinear resampling as ``jax.image.resize`` computes it.

The resize is separable: each axis whose size changes gets a dense
(in, out) weight matrix, built as ``jax/_src/image/scale.py:compute_weight_mat``
builds it (half-pixel centres, the kernel widened by 1/scale when shrinking,
columns normalised by their sum, columns whose sample falls outside the input
zeroed) — the JAX package contracts the image with each as a plain
``einsum`` outside any Pallas kernel. Each output sample has a few non-zero
weights (6 in Lanczos-3 upscaling, 2 in bilinear), so ``resize`` keeps each
matrix as a banded table (``band_table``: per output the first input and K
weights) and resamples through kernel K12 (``kernels/presenter.py:resize``;
on CPU tensors its plain version), the width first, then the height. An axis
of equal size is the identity (``jax.image.resize`` skips it).
``resize_dense``, the two full-f32 ``torch.mm`` products over the dense
matrices, is kept as a second reference for the tests. ``upscale(...,
quantize=True)`` ends the spatial present: K12's uint8 form, or K1 where
the size is kept.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..core.device import require_full_f32
from ..kernels import presenter as K
from ..kernels.present import tonemap_quantize

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


@functools.lru_cache(maxsize=32)
def band_table(n_in: int, n_out: int, method: str, device: torch.device) -> K.Band:
    """``weight_matrix(n_in, n_out, method)`` as K12's banded table, on
    ``device``; the identity where the size is kept. Built on the host and
    cached per arguments."""
    if method not in METHODS:
        raise ValueError(f"unknown resize method {method!r}; expected one of {METHODS}")
    if n_in == n_out:
        return K.identity_band(n_in).to(device)
    return K.band_of(weight_matrix(n_in, n_out, method, torch.device("cpu"))).to(device)


def resize(x, out_height: int, out_width: int, method: str, clamp: bool = False) -> torch.Tensor:
    """``jax.image.resize`` of (H,W,C) f32 to (out_height,out_width,C) by
    K12. ``x`` may also be a sequence of up to three (H,W) or (H,W,c)
    sources, resized as their concatenation along the channels into one
    contiguous buffer; with ``clamp``, ``clamp_min(out, 0)`` is folded in."""
    sources = tuple(x) if isinstance(x, (tuple, list)) else (x,)
    h, w = sources[0].shape[0], sources[0].shape[1]
    dev = sources[0].device
    return K.resize(sources, band_table(h, out_height, method, dev),
                    band_table(w, out_width, method, dev), clamp)


def resize_dense(x: torch.Tensor, out_height: int, out_width: int, method: str) -> torch.Tensor:
    """The same resize as two full-f32 products over the dense matrices (a
    reference for the tests; an axis of equal size skipped)."""
    h, w, c = x.shape
    if (h, w) == (out_height, out_width):
        return x
    require_full_f32(x, "spatial.resize_dense")
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


def upscale(color: torch.Tensor, out_height: int, out_width: int, method: str = "lanczos3",
            quantize: bool = False) -> torch.Tensor:
    """color: (H,W,3) linear radiance -> (out_height,out_width,3); with
    ``quantize`` tonemapped to uint8 in the resize's epilogue, or by K1
    where the size is kept (``color`` itself is the image)."""
    if color.shape[0] == out_height and color.shape[1] == out_width:
        return tonemap_quantize(color.contiguous()) if quantize else color
    # Lanczos ringing can undershoot below zero; radiance must stay >= 0
    # (the clamp runs inside the resize)
    dev = color.device
    return K.resize((color.contiguous(),), band_table(color.shape[0], out_height, method, dev),
                    band_table(color.shape[1], out_width, method, dev), True, quantize)
