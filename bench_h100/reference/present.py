"""The presented image in plain torch ops: a frozen copy of the port's
temporal present (``mrt_tpu_torch/upscale/presenter.py:present_linear``,
``upscale/temporal.py``, ``upscale/spatial.py``'s weights) with the plain
versions of its kernels (``kernels/presenter.py``: K12 ``resize_plain``,
K11 ``temporal_resolve_plain``; ``kernels/present.py``: K1's
``tonemap_quantize_plain``). The resize's weights are kept as banded
tables (per output its first input and the non-zero weights).
"""

from __future__ import annotations

from typing import NamedTuple

import math

import numpy as np
import torch

METHODS = ("bilinear",)  # the temporal present's; the spatial Lanczos-3 is left out


class Band(NamedTuple):
    """One axis's resampling: output i reads inputs ``first[i]`` ..
    ``first[i] + K - 1`` with ``weights[i]``."""

    first: torch.Tensor  # (n_out,) int64
    weights: torch.Tensor  # (n_out, K) f32


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(1.0 - x.abs(), 0.0)


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
    w = _triangle(x)
    total = w.sum(dim=0, keepdim=True)
    safe = torch.where(total != 0, total, torch.ones_like(total))
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps), w / safe,
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    w = torch.where(inside[None, :], w, torch.zeros_like(w))
    return w.to(device)


def band_table(n_in: int, n_out: int, method: str, device) -> Band:
    """The banded table of ``weight_matrix(n_in, n_out, method)``; one tap
    of weight 1 where the size is kept."""
    if n_in == n_out:
        return Band(torch.arange(n_in, device=device), torch.ones((n_in, 1), device=device))
    m = weight_matrix(n_in, n_out, method, torch.device("cpu")).numpy()
    nz = m != 0
    has = nz.any(axis=0)
    lo = np.where(has, nz.argmax(axis=0), 0)
    hi = np.where(has, n_in - 1 - nz[::-1].argmax(axis=0), 0)
    k = int((hi - lo).max()) + 1
    first = np.maximum.accumulate(np.minimum(lo, n_in - k))
    weights = m[first[:, None] + np.arange(k), np.arange(n_out)[:, None]]
    return Band(torch.as_tensor(first.astype(np.int64)).to(device),
                torch.as_tensor(np.ascontiguousarray(weights, np.float32)).to(device))


def bilinear_sample(img: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor):
    """Sample (H,W,C) at fractional (rows, cols) with clamped addressing.
    Returns (values (..., C), in_bounds mask). Four row gathers, the same
    taps and blend order as the JAX package's packed-quad gather; each is a
    ``torch.take`` of single values (a row gather of (H*W, C) rows of 16
    bytes, by ``flat[idx]`` or ``torch.gather``, takes PyTorch's vectorized
    row-gather kernel on the card, 5 ms per 4K tap on an H100)."""
    h, w, c_ch = img.shape
    in_bounds = (rows >= 0) & (rows <= h - 1) & (cols >= 0) & (cols <= w - 1)
    r = torch.clamp(rows, 0.0, h - 1.0)
    c = torch.clamp(cols, 0.0, w - 1.0)
    r0 = torch.floor(r)
    c0 = torch.floor(c)
    fr = (r - r0)[..., None]
    fc = (c - c0)[..., None]
    r0i = r0.to(torch.int64)
    c0i = c0.to(torch.int64)
    r1i = torch.clamp_max(r0i + 1, h - 1)
    c1i = torch.clamp_max(c0i + 1, w - 1)
    flat = img.reshape(-1)
    chan = torch.arange(c_ch, device=img.device)

    def tap(ri, ci):
        return torch.take(flat, (ri * w + ci)[..., None] * c_ch + chan)

    v00, v01, v10, v11 = tap(r0i, c0i), tap(r0i, c1i), tap(r1i, c0i), tap(r1i, c1i)
    top = v00 * (1 - fc) + v01 * fc
    bot = v10 * (1 - fc) + v11 * fc
    return top * (1 - fr) + bot * fr, in_bounds


def edge_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """(H,W,...) padded by ``pad`` on both spatial axes, repeating the edge
    (``jnp.pad(mode="edge")``)."""
    h, w = x.shape[0], x.shape[1]
    ri = torch.arange(-pad, h + pad, device=x.device).clamp(0, h - 1)
    ci = torch.arange(-pad, w + pad, device=x.device).clamp(0, w - 1)
    return x[ri][:, ci]


def temporal_resolve_plain(up, history, history_weight, sx: float, sy: float):
    """K11's function on the resize's (H,W,6) output (colour 3, depth 1,
    motion 2 in render pixels): motion scaled to output pixels by (sx, sy),
    the bilinear reprojection of the (H,W,4) history (rgb + depth), the
    depth test, the clamp to the current colour's 3x3 neighbourhood (edges
    clamped) and the motion-aware blend. Returns (output (H,W,3), new
    history (H,W,4))."""
    out_h, out_w = up.shape[0], up.shape[1]
    dev = up.device
    cur, dep = up[..., 0:3], up[..., 3:4]
    mot = up[..., 4:6] * torch.tensor([sx, sy], dtype=torch.float32, device=dev)

    out_rows = torch.arange(out_h, dtype=torch.float32, device=dev)[:, None]
    out_cols = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :]
    prev_r = out_rows + mot[..., 1]
    prev_c = out_cols - mot[..., 0]
    hist4, valid = bilinear_sample(history, prev_r, prev_c)
    hist = hist4[..., :3]
    hist_depth = hist4[..., 3:4]

    # depth disocclusion: history more than 10 % off the current depth is stale
    depth_ok = (hist_depth - dep).abs() <= 0.1 * torch.clamp_min(dep, 1e-3)

    # 3x3 neighbourhood clamp of the current frame, as a running min/max over
    # the shifted rows, then over the shifted columns (no 9-deep stack)
    p = edge_pad(cur, 1)
    rmin = torch.minimum(torch.minimum(p[:-2], p[1:-1]), p[2:])
    rmax = torch.maximum(torch.maximum(p[:-2], p[1:-1]), p[2:])
    nmin = torch.minimum(torch.minimum(rmin[:, :-2], rmin[:, 1:-1]), rmin[:, 2:])
    nmax = torch.maximum(torch.maximum(rmax[:, :-2], rmax[:, 1:-1]), rmax[:, 2:])
    hist = torch.minimum(torch.maximum(hist, nmin), nmax)

    # motion-aware blend: fast motion trusts the current frame more
    mag = torch.sqrt(mot[..., 0:1] * mot[..., 0:1] + mot[..., 1:2] * mot[..., 1:2])
    weight = history_weight * torch.clamp(1.0 - mag / 16.0, 0.25, 1.0)
    weight = torch.where(valid[..., None] & depth_ok, weight, torch.zeros_like(weight))
    out = cur + (hist - cur) * weight
    return out, torch.cat([out, dep], dim=-1)


def resize_plain(sources, rows: Band, cols: Band, clamp: bool = False):
    """K12's function: the sources ((h,w) or (h,w,c) each) as one (h,w,C)
    image of their channels in order, resampled by the width's table
    ``cols`` and then the height's ``rows``, each output the first tap's
    product and then one add per tap in increasing input index, every
    intermediate an f32 tensor; with ``clamp``, ``clamp_min(out, 0)``.
    Returns (n_out rows, n_out cols, C)."""
    x = torch.cat([s.reshape(s.shape[0], s.shape[1], -1) for s in sources], dim=-1)
    first = cols.first.long()
    t = None
    for k in range(cols.weights.shape[1]):
        p = x[:, first + k] * cols.weights[:, k, None]
        t = p if t is None else t + p
    first = rows.first.long()
    out = None
    for k in range(rows.weights.shape[1]):
        p = t[first + k] * rows.weights[:, k, None, None]
        out = p if out is None else out + p
    return torch.clamp_min(out, 0.0) if clamp else out



def tonemap_quantize_plain(color: torch.Tensor) -> torch.Tensor:
    """(H,W,3) linear f32 -> (H,W,3) uint8."""
    tone = color / (1.0 + color)
    return (torch.clamp(tone, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def temporal_present(color, depth, motion, history, out_h: int, out_w: int,
                     accumulation_weight: float, bf16: bool = False) -> torch.Tensor:
    """The temporal present of a render-size frame (colour (h,w,3), depth
    (h,w), motion (h,w,2)) over the presenter's ``history`` (None after a
    reset: a fresh history with weight 0): the uint8 (out_h,out_w,3) image.
    ``bf16``: the control, its resampled buffer and output stored in
    bfloat16."""
    h, w = color.shape[0], color.shape[1]
    dev = color.device
    fresh = history is None or tuple(history.shape) != (out_h, out_w, 4)
    if fresh:
        history = torch.zeros((out_h, out_w, 4), dtype=torch.float32, device=dev)
    weight = 0.0 if fresh else float(accumulation_weight)
    up = resize_plain((color, depth, motion), band_table(h, out_h, "bilinear", dev),
                      band_table(w, out_w, "bilinear", dev))
    if bf16:
        up = up.to(torch.bfloat16).to(torch.float32)
    out, _ = temporal_resolve_plain(up, history, weight, out_w / w, out_h / h)
    if bf16:
        out = out.to(torch.bfloat16).to(torch.float32)
    return tonemap_quantize_plain(out)
