"""Kernels K9 ``svgf_reproject``, K10 ``atrous_pass``, K11
``temporal_resolve`` — the stateful presenter chains — and K12 ``resize``
(``csrc/presenter.cu``), their wrappers, their plain PyTorch versions and the
plain versions' building blocks (``luma``, ``pow2k``, ``bilinear_sample``,
``edge_pad``), and K12's banded weight tables (``Band``, ``band_of``,
``identity_band``).

K9 and K10 replace the torch ops of ``mrt_tpu/upscale/denoise.py:svgf_filter``
(the SVGF-lite denoiser: the reprojection and moments, then the three
à-trous passes); K11 replaces those of ``mrt_tpu/upscale/temporal.py:
temporal_upscale`` after its bilinear resize (the history reprojection,
the depth test, the 3x3 clamp and the blend). On the TPU these are XLA
programs (the JAX package's Pallas à-trous kernel lost to XLA's fusion and
was deleted); in eager PyTorch each is dozens to thousands of launches.
K12 replaces ``jax.image.resize`` (``mrt_tpu/upscale/spatial.py:15``,
``temporal.py:91-93``; an XLA ``einsum`` of dense weight matrices): it
resamples up to three sources (the temporal chain's colour, depth and
motion, read where they lie) into one contiguous buffer through banded
tables, the width first, then the height, with the spatial chain's clamp
folded in: for the path's two shapes in its strip form (a thread an output
column and a tile's rows, ``resize_strip_rows``), for any other in 32x32
tiles.

The plain versions are the port's torch-op code, cut at the kernels'
boundaries: ``svgf_filter`` = K9, then K10 at steps 1, 2 and 4, the last
with the remodulation; ``temporal_upscale`` = K12, then K11. A
wrapper checks its inputs (float32, shapes, contiguous, and on the card
16-byte aligned) and raises on what its kernel does not take; it runs its
plain version for CPU tensors only, and on CUDA tensors launches its kernel.

K11 and K12 have uint8 forms (``quantize=True``), for the kernel that ends
an upscaled present: the output is K1's tonemapped bytes of the f32 output
(``kernels/present.py``), written in the kernel's epilogue; their plain
version is ``tonemap_quantize_plain`` of the f32 plain version. Their
launches count under ``resize_u8`` and ``temporal_resolve_u8``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..utils import telemetry as tm
from .present import tonemap_quantize_plain

# kernel launches by the wrappers in this process, by kernel (the uint8
# forms of K11 and K12 apart)
launches = {"svgf_reproject": 0, "atrous_pass": 0, "temporal_resolve": 0, "resize": 0,
            "temporal_resolve_u8": 0, "resize_u8": 0}
KERNELS = tuple(launches)

_LUMA = (0.2126, 0.7152, 0.0722)
# the B3 spline's taps per axis (the à-trous pass takes their products)
_B3 = (1 / 16, 1 / 4, 3 / 8, 1 / 4, 1 / 16)
ATROUS_STEPS = (1, 2, 4)
# K12's output tile (csrc/presenter.cuh RESIZE_TW x RESIZE_TH, a block of
# RESIZE_WARPS warps), its most channels (RESIZE_MAX_C) and the shared
# memory a block may take (floats): its staged input pixels and horizontal
# sums, in chunks of input rows and columns, and an output row a warp
RESIZE_TILE_W, RESIZE_TILE_H, RESIZE_WARPS, RESIZE_MAX_C = 32, 32, 8, 8
RESIZE_SMEM_FLOATS = 48 * 1024 // 4
# K12's strip form (csrc/presenter.cuh RESIZE_STRIP_W output columns, a
# block of RESIZE_STRIP_WARPS warps, by RESIZE_STRIP_ROWS output rows): the
# shapes it is compiled for (the sources' channels, the taps of both axes)
# and the shared memory a block may take (floats: two stage buffers and two
# output rows a warp; two blocks fit an H100 SM)
RESIZE_STRIP_W, RESIZE_STRIP_WARPS, RESIZE_STRIP_ROWS = 256, 8, 16
# (the uint8 form takes 3 channels, so its strip form is the first's)
RESIZE_STRIP_FORMS = {((3,), 6), ((3, 1, 2), 2)}
RESIZE_STRIP_SMEM_FLOATS = 112 * 1024 // 4


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# --- the plain versions' building blocks ------------------------------------------------------

def pow2k(x: torch.Tensor, k: int) -> torch.Tensor:
    """x ** (2 ** k) as k squarings (``lax.integer_pow``'s rounding)."""
    for _ in range(k):
        x = x * x
    return x


def luma(x: torch.Tensor) -> torch.Tensor:
    """(…,3) -> (…) Rec. 709 luminance."""
    return x[..., 0] * _LUMA[0] + x[..., 1] * _LUMA[1] + x[..., 2] * _LUMA[2]


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(…,3) · (…,3) -> (…), summed in order: the bits of ``(a * b).sum(-1)``
    on the CPU, and an order the kernels can repeat on the card."""
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


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


def albedo_of(diffuse: torch.Tensor, specular: torch.Tensor) -> torch.Tensor:
    """The denoiser's demodulation albedo, kept off zero."""
    return torch.clamp_min(diffuse + specular, 1e-3)


class Band(NamedTuple):
    """One axis of K12's resampling as a banded table: output i reads the
    inputs ``first[i]`` to ``first[i] + K - 1`` with ``weights[i]`` (zero
    where the dense matrix has no weight), in increasing index."""

    n_in: int
    first: torch.Tensor  # (n_out,) int32, non-decreasing
    weights: torch.Tensor  # (n_out, K) float32
    # the most inputs that a tile's RESIZE_TILE_H (as the height's table) or
    # RESIZE_TILE_W (as the width's) consecutive outputs read; for the strip
    # form, RESIZE_STRIP_ROWS (as the height's) and RESIZE_STRIP_W
    span_h: int
    span_w: int
    strip_span_h: int
    strip_span_w: int

    def to(self, device) -> "Band":
        return self._replace(first=self.first.to(device), weights=self.weights.to(device))


def _band(n_in: int, first: np.ndarray, weights: np.ndarray) -> Band:
    n_out, k = weights.shape

    def span(tile):
        starts = np.arange(0, n_out, tile)
        return int((first[np.minimum(starts + tile, n_out) - 1] + k - first[starts]).max())

    return Band(n_in, torch.from_numpy(first.astype(np.int32)),
                torch.from_numpy(np.ascontiguousarray(weights, dtype=np.float32)),
                span(RESIZE_TILE_H), span(RESIZE_TILE_W),
                span(RESIZE_STRIP_ROWS), span(RESIZE_STRIP_W))


def band_of(matrix: torch.Tensor) -> Band:
    """The banded table of a dense (n_in, n_out) f32 resampling matrix (on
    the CPU): K is the widest span of non-zero weights of any column, each
    band starts at its column's first non-zero weight (moved down where it
    would end past the input; a column without weights follows the one
    before). Raises if a non-zero weight falls outside its band."""
    m = matrix.detach().cpu().numpy()
    n_in, n_out = m.shape
    nz = m != 0
    has = nz.any(axis=0)
    lo = np.where(has, nz.argmax(axis=0), 0)
    hi = np.where(has, n_in - 1 - nz[::-1].argmax(axis=0), 0)
    k = int((hi - lo).max()) + 1
    first = np.maximum.accumulate(np.minimum(lo, n_in - k))
    weights = m[first[:, None] + np.arange(k), np.arange(n_out)[:, None]]
    if not np.array_equal(np.count_nonzero(weights, axis=1), np.count_nonzero(m, axis=0)):
        raise ValueError("band_of: a column's non-zero weights fall outside its band")
    return _band(n_in, first, weights)


def identity_band(n: int) -> Band:
    """The table of an axis that keeps its size: one tap of weight 1 (a
    product by 1 is exact, as ``jax.image.resize`` skipping the axis)."""
    return _band(n, np.arange(n), np.ones((n, 1), np.float32))


# --- the plain versions --------------------------------------------------------------------

def svgf_reproject_plain(color, diffuse, specular, normal_enc, depth, motion, state):
    """K9's function: albedo demodulation, the bilinear reprojection of
    every field of ``state`` (a ``DenoiseState``) at ``row + motion.y``,
    ``col - motion.x``, the depth and normal tests, the history length and
    blend weight, the integrated demodulated colour and luminance moments,
    the variance (inflated for young pixels) and the first pass's luminance.
    Returns (demod (h,w,3), m1, m2, history_length, decoded normal (h,w,3),
    var, lum)."""
    h, w = color.shape[0], color.shape[1]
    dev = color.device
    albedo = albedo_of(diffuse, specular)
    normal = normal_enc * 2.0 - 1.0
    demod = color / albedo
    lum = luma(demod)

    # display +Y down is -row (see upscale/temporal.py)
    out_rows = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    out_cols = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    prev_r = out_rows + motion[..., 1]
    prev_c = out_cols - motion[..., 0]
    # one bilinear sample of every state field, packed into 10 channels
    packed = torch.cat([state.demod, state.m1[..., None], state.m2[..., None],
                        state.history_length[..., None], state.depth[..., None], state.normal],
                       dim=-1)
    prev, in_b = bilinear_sample(packed, prev_r, prev_c)
    prev_demod = prev[..., 0:3]
    prev_m1 = prev[..., 3]
    prev_m2 = prev[..., 4]
    prev_len = prev[..., 5]
    prev_depth = prev[..., 6]
    prev_normal = prev[..., 7:10]

    depth_ok = (prev_depth - depth).abs() <= 0.1 * torch.clamp_min(depth, 1e-3)
    normal_ok = dot3(prev_normal, normal) > 0.8
    valid = in_b & depth_ok & normal_ok

    hist_len = torch.where(valid, torch.clamp_max(prev_len + 1.0, 32.0), torch.ones_like(prev_len))
    alpha = torch.clamp_min(1.0 / hist_len, 0.2)

    demod_i = torch.where(valid[..., None], prev_demod + (demod - prev_demod) * alpha[..., None],
                          demod)
    m1 = torch.where(valid, prev_m1 + (lum - prev_m1) * alpha, lum)
    m2 = torch.where(valid, prev_m2 + (lum * lum - prev_m2) * alpha, lum * lum)
    var = torch.clamp_min(m2 - m1 * m1, 0.0)
    # young pixels have unreliable moments: inflate the variance so that the
    # spatial filter works harder until history builds up
    var = var * torch.clamp(4.0 / hist_len, 1.0, 4.0)
    return demod_i, m1, m2, hist_len, normal, var, luma(demod_i)


def atrous_pass_plain(filtered, var, lum, normal, depth, step: int, diffuse=None, specular=None):
    """K10's function: one edge-aware à-trous pass (the 5x5 B3 taps at
    dilation ``step``, edges clamped), weighted by normals (``w_n``), depth
    (``w_z``) and luminance against the variance (``w_l``). Returns
    (filtered (h,w,3), var, luma(filtered)); given ``diffuse`` and
    ``specular`` (the last pass), the remodulated colour (h,w,3) alone."""
    h, w = filtered.shape[0], filtered.shape[1]
    sigma_l = torch.sqrt(torch.clamp_min(var, 0.0)) * 4.0 + 1e-4
    depth_scale = 0.1 * torch.clamp_min(depth, 1e-3)
    acc = torch.zeros_like(filtered)
    acc_var = torch.zeros_like(var)
    wsum = torch.zeros_like(var)
    pad = 2 * step
    dp, vp, lp, np_, zp = (edge_pad(t, pad) for t in (filtered, var, lum, normal, depth))
    for i, wr in enumerate(_B3):
        for j, wc in enumerate(_B3):
            r0 = pad + (i - 2) * step
            c0 = pad + (j - 2) * step
            win = (slice(r0, r0 + h), slice(c0, c0 + w))
            nb, nv, nl, nn, nz = dp[win], vp[win], lp[win], np_[win], zp[win]
            w_n = pow2k(torch.clamp(dot3(nn, normal), 0.0, 1.0), 5)
            w_z = torch.exp(-(nz - depth).abs() / depth_scale)
            w_l = torch.exp(-(nl - lum).abs() / sigma_l)
            wgt = (wr * wc) * w_n * w_z * w_l
            acc = acc + nb * wgt[..., None]
            acc_var = acc_var + nv * wgt * wgt
            wsum = wsum + wgt
    out = acc / torch.clamp_min(wsum[..., None], 1e-6)
    if diffuse is not None:
        return out * albedo_of(diffuse, specular)
    out_var = acc_var / torch.clamp_min(wsum * wsum, 1e-6)
    return out, out_var, luma(out)


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


# --- the wrappers ---------------------------------------------------------------------------

def _check(fn: str, tensors: dict, device) -> None:
    """Each of ``tensors`` (name -> (tensor, shape[, dtype])) of its dtype
    (float32 unless given), of its shape, contiguous, on ``device``; on the
    card 16-byte aligned. Raises."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {device}")
    for name, (t, shape, *dtype) in tensors.items():
        want = dtype[0] if dtype else torch.float32
        if t.device != device:
            raise ValueError(f"{fn}: {name} is on {t.device}, not {device}")
        if t.dtype != want:
            raise TypeError(f"{fn}: {name} is {t.dtype}, expected {want}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} is not contiguous")
        if device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} is not 16-byte aligned")


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _launch(name: str, fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    launches[name] += 1


def _lib_stream(device):
    from . import build

    return build.load(), ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def svgf_reproject(color, diffuse, specular, normal_enc, depth, motion, state):
    """K9 (see ``svgf_reproject_plain``): every input (h,w[,c]) float32;
    ``state`` a ``DenoiseState`` of (h,w) fields. Returns (demod, m1, m2,
    history_length, decoded normal, var, lum)."""
    with tm.span("mrt.svgf_reproject"):
        h, w = depth.shape
        dev = depth.device
        v3, v1 = (h, w, 3), (h, w)
        _check("svgf_reproject", dict(
            color=(color, v3), diffuse_albedo=(diffuse, v3), specular_albedo=(specular, v3),
            normal=(normal_enc, v3), depth=(depth, v1), motion=(motion, (h, w, 2)),
            state_demod=(state.demod, v3), state_m1=(state.m1, v1), state_m2=(state.m2, v1),
            state_history_length=(state.history_length, v1), state_depth=(state.depth, v1),
            state_normal=(state.normal, v3)), dev)
        if dev.type == "cpu":
            return svgf_reproject_plain(color, diffuse, specular, normal_enc, depth, motion, state)
        outs = [torch.empty(s, dtype=torch.float32, device=dev)
                for s in (v3, v1, v1, v1, v3, v1, v1)]
        if h * w:
            lib, stream = _lib_stream(dev)
            _launch("svgf_reproject", lib.mrt_svgf_reproject,
                    *(_ptr(t) for t in (color, diffuse, specular, normal_enc, depth, motion)),
                    *(_ptr(t) for t in (state.demod, state.m1, state.m2, state.history_length,
                                        state.depth, state.normal)),
                    *(_ptr(t) for t in outs), h, w, stream)
        return tuple(outs)


def atrous_pass(filtered, var, lum, normal, depth, step: int, diffuse=None, specular=None):
    """K10 (see ``atrous_pass_plain``) at ``step`` 1, 2 or 4; with
    ``diffuse`` and ``specular`` (both or neither) the last pass, which
    returns the remodulated colour."""
    with tm.span("mrt.atrous_pass"):
        h, w = depth.shape
        dev = depth.device
        if step not in ATROUS_STEPS:
            raise ValueError(f"atrous_pass: step {step} is not one of {ATROUS_STEPS}")
        if (diffuse is None) != (specular is None):
            raise ValueError("atrous_pass: give diffuse and specular together, or neither")
        v3, v1 = (h, w, 3), (h, w)
        ins = dict(filtered=(filtered, v3), var=(var, v1), lum=(lum, v1), normal=(normal, v3),
                   depth=(depth, v1))
        last = diffuse is not None
        if last:
            ins.update(diffuse_albedo=(diffuse, v3), specular_albedo=(specular, v3))
        _check("atrous_pass", ins, dev)
        if dev.type == "cpu":
            return atrous_pass_plain(filtered, var, lum, normal, depth, step, diffuse, specular)
        out = torch.empty(v3, dtype=torch.float32, device=dev)
        out_var = None if last else torch.empty(v1, dtype=torch.float32, device=dev)
        out_lum = None if last else torch.empty(v1, dtype=torch.float32, device=dev)
        if h * w:
            lib, stream = _lib_stream(dev)
            null = ctypes.c_void_p(None)
            _launch("atrous_pass", lib.mrt_atrous_pass,
                    *(_ptr(t) for t in (filtered, var, lum, normal, depth)),
                    *((_ptr(diffuse), _ptr(specular)) if last else (null, null)),
                    _ptr(out), *((null, null) if last else (_ptr(out_var), _ptr(out_lum))),
                    h, w, step, stream)
        return out if last else (out, out_var, out_lum)


def temporal_resolve(up, history, history_weight: float, sx: float, sy: float,
                     quantize: bool = False):
    """K11 (see ``temporal_resolve_plain``): ``up`` (H,W,6) and ``history``
    (H,W,4) float32; ``history_weight``, ``sx``, ``sy`` Python numbers.
    Returns (output (H,W,3), new history (H,W,4)); with ``quantize`` (its
    uint8 form) the output is K1's bytes of it."""
    with tm.span("mrt.temporal_resolve"):
        out_h, out_w = up.shape[0], up.shape[1]
        dev = up.device
        _check("temporal_resolve", dict(up=(up, (out_h, out_w, 6)),
                                        history=(history, (out_h, out_w, 4))), dev)
        if dev.type == "cpu":
            out, new_history = temporal_resolve_plain(up, history, history_weight, sx, sy)
            return (tonemap_quantize_plain(out) if quantize else out), new_history
        out = torch.empty((out_h, out_w, 3), dtype=torch.uint8 if quantize else torch.float32,
                          device=dev)
        new_history = torch.empty((out_h, out_w, 4), dtype=torch.float32, device=dev)
        if out_h * out_w:
            lib, stream = _lib_stream(dev)
            _launch("temporal_resolve_u8" if quantize else "temporal_resolve",
                    lib.mrt_temporal_resolve, _ptr(up), _ptr(history), _ptr(out),
                    _ptr(new_history), out_h, out_w, ctypes.c_float(float(history_weight)),
                    ctypes.c_float(sx), ctypes.c_float(sy), int(quantize), stream)
        return out, new_history


def resize(sources, rows: Band, cols: Band, clamp: bool = False, quantize: bool = False):
    """K12 (see ``resize_plain``): 1-3 float32 sources of one (h, w), each
    (h,w) or (h,w,c), at most RESIZE_MAX_C channels in all; ``rows`` and
    ``cols`` the tables of the height and the width (``n_in`` h and w).
    Returns the contiguous (rows' n_out, cols' n_out, channels); with
    ``quantize`` (its uint8 form, 3 channels in all) K1's bytes of it."""
    with tm.span("mrt.resize"):
        sources = tuple(sources)
        if not 1 <= len(sources) <= 3:
            raise ValueError(f"resize: {len(sources)} sources, expected 1-3")
        if any(s.dim() not in (2, 3) for s in sources):
            raise ValueError(f"resize: sources of shapes {[tuple(s.shape) for s in sources]}, "
                             "expected (h,w) or (h,w,c)")
        h, w = sources[0].shape[0], sources[0].shape[1]
        dev = sources[0].device
        chans = [1 if s.dim() == 2 else s.shape[2] for s in sources]
        if min(chans) < 1 or sum(chans) > RESIZE_MAX_C:
            raise ValueError(f"resize: channels {chans}, expected 1-{RESIZE_MAX_C} in all")
        if (rows.n_in, cols.n_in) != (h, w):
            raise ValueError(f"resize: tables for ({rows.n_in}, {cols.n_in}) inputs, sources "
                             f"({h}, {w})")
        oh, ow, kr, kc = rows.first.shape[0], cols.first.shape[0], rows.weights.shape[1], \
            cols.weights.shape[1]
        ins = {f"source {i}": (s, (h, w) + tuple(s.shape[2:])) for i, s in enumerate(sources)}
        ins.update(row_first=(rows.first, (oh,), torch.int32), row_weights=(rows.weights, (oh, kr)),
                   col_first=(cols.first, (ow,), torch.int32), col_weights=(cols.weights, (ow, kc)))
        if quantize and sum(chans) != 3:
            raise ValueError(f"resize: quantize takes 3 channels in all, not {chans}")
        _check("resize", ins, dev)
        if dev.type == "cpu":
            out = resize_plain(sources, rows, cols, clamp)
            return tonemap_quantize_plain(out) if quantize else out
        c = sum(chans)
        out = torch.empty((oh, ow, c), dtype=torch.uint8 if quantize else torch.float32, device=dev)
        if oh * ow:
            # the strip form where the shape is one it is compiled for and a tile
            # fits, else the 32x32 tiles with their chunks
            rt = resize_strip_rows(rows, cols, chans, kr, kc)
            if rt:
                tiles = (0, 0, rt, rows.strip_span_h, cols.strip_span_w)
            else:
                tiles = (*_resize_chunks(rows, cols, c), 0, 0, 0)
            lib, stream = _lib_stream(dev)
            null = ctypes.c_void_p(None)
            _launch("resize_u8" if quantize else "resize", lib.mrt_resize,
                    *(_ptr(s) for s in sources), *(null,) * (3 - len(sources)), *chans,
                    *(0,) * (3 - len(chans)), h, w, _ptr(rows.first), _ptr(rows.weights), kr,
                    _ptr(cols.first), _ptr(cols.weights), kc, oh, ow, *tiles, int(clamp),
                    int(quantize), _ptr(out), stream)
        return out


def resize_strip_rows(rows: Band, cols: Band, chans, kr: int, kc: int) -> int:
    """The output rows of a strip-form tile: RESIZE_STRIP_ROWS for a shape
    the form is compiled for (RESIZE_STRIP_FORMS) whose two stage buffers
    fit in RESIZE_STRIP_SMEM_FLOATS, else 0 (the 32x32 tiles). (On an H100,
    16 rows were as fast as 32 at run E's 4K and faster at the demo's
    1024^2, where 32 leaves SMs without a tile.)"""
    if kr != kc or (tuple(chans), kr) not in RESIZE_STRIP_FORMS:
        return 0
    c, rt = sum(chans), RESIZE_STRIP_ROWS
    smem = 2 * (rows.strip_span_h * cols.strip_span_w * c + rt * (kr + 1)) + \
        RESIZE_STRIP_WARPS * 64 * c
    return rt if smem <= RESIZE_STRIP_SMEM_FLOATS else 0


def _resize_chunks(rows: Band, cols: Band, channels: int) -> tuple[int, int]:
    """The input rows and columns a K12 block stages at once: all that its
    tile reads where they fit in RESIZE_SMEM_FLOATS beside their sums and
    the output rows, else fewer rows, and where one row does not fit,
    fewer columns too."""
    room = RESIZE_SMEM_FLOATS // channels - RESIZE_WARPS * RESIZE_TILE_W
    cols_chunk = min(cols.span_w, room - RESIZE_TILE_W)
    return min(rows.span_h, room // (cols_chunk + RESIZE_TILE_W)), cols_chunk
