"""Temporal upscaler — counterpart of ``mrt_tpu/upscale/temporal.py``: the
current frame resampled to output size, the output-size history reprojected
through the motion vectors, rejected where its stored depth disagrees with
the current surface (disocclusion), clamped to the current frame's 3x3
neighbourhood, and blended with a weight that falls with motion.

Motion is in render pixels, +X right and +Y down in display space; render
rows store v bottom-up, so the history row is ``row + motion.y`` and the
history column ``col - motion.x``.
"""

from __future__ import annotations

import torch

from . import spatial


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


def temporal_upscale(color: torch.Tensor, depth: torch.Tensor, motion: torch.Tensor,
                     history: torch.Tensor, out_h: int, out_w: int, history_weight=0.9):
    """color (h,w,3), depth (h,w), motion (h,w,2) at render size; history
    (out_h,out_w,4) of rgb + depth. ``history_weight``: 0.0 on the first
    frame after a reset. Returns (output (out_h,out_w,3), new history
    (out_h,out_w,4))."""
    h, w = color.shape[0], color.shape[1]
    sy = out_h / h
    sx = out_w / w
    dev = color.device

    # colour, depth and motion in one bilinear resample (the same weights
    # on each channel as three separate resizes)
    up = spatial.resize(torch.cat([color, depth[..., None], motion], dim=-1), out_h, out_w,
                        "bilinear")
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
