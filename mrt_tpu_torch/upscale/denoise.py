"""Denoiser — counterpart of ``mrt_tpu/upscale/denoise.py``, SVGF-lite at
render size: albedo demodulation, motion-reprojected temporal accumulation
of the demodulated signal with depth and normal validity tests, per-pixel
luminance moments giving a variance estimate, three variance-guided
edge-aware à-trous passes (dilations 1, 2, 4), remodulation.

Torch ops, as the JAX package's are XLA ops (it has no Pallas kernel here).
The integer powers ``x ** 32`` and ``x ** 8`` are written as the squarings
``lax.integer_pow`` computes, so they round as the JAX package's do.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core.device import resolve
from .temporal import bilinear_sample, edge_pad

_LUMA = (0.2126, 0.7152, 0.0722)


class DenoiseState(NamedTuple):
    """Temporal state at render size."""

    demod: torch.Tensor  # (h,w,3) integrated demodulated radiance
    m1: torch.Tensor  # (h,w) integrated luminance
    m2: torch.Tensor  # (h,w) integrated luminance^2
    history_length: torch.Tensor  # (h,w) frames accumulated (capped at 32)
    depth: torch.Tensor  # (h,w) last frame's depth
    normal: torch.Tensor  # (h,w,3) last frame's shading normal (decoded)


def init_state(h: int, w: int, device=None) -> DenoiseState:
    """The empty history at (h, w), on ``device`` (None: the card; raises
    where there is none)."""
    z = dict(dtype=torch.float32, device=resolve(device))
    return DenoiseState(demod=torch.zeros((h, w, 3), **z), m1=torch.zeros((h, w), **z),
                        m2=torch.zeros((h, w), **z), history_length=torch.zeros((h, w), **z),
                        depth=torch.full((h, w), 1.0e8, **z), normal=torch.zeros((h, w, 3), **z))


def pow2k(x: torch.Tensor, k: int) -> torch.Tensor:
    """x ** (2 ** k) as k squarings (``lax.integer_pow``'s rounding)."""
    for _ in range(k):
        x = x * x
    return x


def luma(x: torch.Tensor) -> torch.Tensor:
    """(…,3) -> (…) Rec. 709 luminance."""
    return x[..., 0] * _LUMA[0] + x[..., 1] * _LUMA[1] + x[..., 2] * _LUMA[2]


def _atrous_pass(demod, var, lum, normal, depth, step: int):
    """One edge-aware à-trous pass (5-tap B3 cross per axis, dilation
    ``step``)."""
    h, w = demod.shape[0], demod.shape[1]
    taps = [(-2 * step, 1 / 16), (-step, 1 / 4), (0, 3 / 8), (step, 1 / 4), (2 * step, 1 / 16)]
    sigma_l = torch.sqrt(torch.clamp_min(var, 0.0)) * 4.0 + 1e-4
    depth_scale = 0.1 * torch.clamp_min(depth, 1e-3)
    acc = torch.zeros_like(demod)
    acc_var = torch.zeros_like(var)
    wsum = torch.zeros_like(var)
    pad = 2 * step
    dp, vp, lp, np_, zp = (edge_pad(t, pad) for t in (demod, var, lum, normal, depth))
    for dr, wr in taps:
        for dc, wc in taps:
            r0 = pad + dr
            c0 = pad + dc
            win = (slice(r0, r0 + h), slice(c0, c0 + w))
            nb, nv, nl, nn, nz = dp[win], vp[win], lp[win], np_[win], zp[win]
            w_n = pow2k(torch.clamp((nn * normal).sum(dim=-1), 0.0, 1.0), 5)
            w_z = torch.exp(-(nz - depth).abs() / depth_scale)
            w_l = torch.exp(-(nl - lum).abs() / sigma_l)
            wgt = (wr * wc) * w_n * w_z * w_l
            acc = acc + nb * wgt[..., None]
            acc_var = acc_var + nv * wgt * wgt
            wsum = wsum + wgt
    out = acc / torch.clamp_min(wsum[..., None], 1e-6)
    out_var = acc_var / torch.clamp_min(wsum * wsum, 1e-6)
    return out, out_var


def svgf_filter(color: torch.Tensor, gbuffer: dict, depth: torch.Tensor, motion: torch.Tensor,
                state: DenoiseState, n_passes: int = 3):
    """color (h,w,3) this frame's radiance; gbuffer: diffuse_albedo,
    specular_albedo, normal (encoded to [0,1]), roughness; depth (h,w);
    motion (h,w,2) in pixels, +Y down. Returns (denoised colour (h,w,3),
    new DenoiseState)."""
    h, w = color.shape[0], color.shape[1]
    dev = color.device
    albedo = torch.clamp_min(gbuffer["diffuse_albedo"] + gbuffer["specular_albedo"], 1e-3)
    normal = gbuffer["normal"] * 2.0 - 1.0
    demod = color / albedo
    lum = luma(demod)

    # --- temporal reprojection (display +Y down is -row, see temporal.py) ---
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
    normal_ok = (prev_normal * normal).sum(dim=-1) > 0.8
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

    new_state = DenoiseState(demod=demod_i, m1=m1, m2=m2, history_length=hist_len, depth=depth,
                             normal=normal)

    # --- variance-guided à-trous wavelet filtering ---
    filtered = demod_i
    fvar = var
    flum = luma(filtered)
    for i in range(n_passes):
        filtered, fvar = _atrous_pass(filtered, fvar, flum, normal, depth, 1 << i)
        flum = luma(filtered)
    return filtered * albedo, new_state


def demodulate_filter(color: torch.Tensor, gbuffer: dict, radius: int = 2) -> torch.Tensor:
    """Single-frame fallback without temporal state: albedo demodulation, an
    edge-aware cross-bilateral filter, remodulation."""
    albedo = torch.clamp_min(gbuffer["diffuse_albedo"] + gbuffer["specular_albedo"], 1e-3)
    normal = gbuffer["normal"] * 2.0 - 1.0
    demod = color / albedo

    h, w = color.shape[0], color.shape[1]
    acc = torch.zeros_like(demod)
    wsum = torch.zeros((h, w, 1), dtype=demod.dtype, device=demod.device)
    pad = radius
    demod_p = edge_pad(demod, pad)
    normal_p = edge_pad(normal, pad)
    for dr in range(-radius, radius + 1):
        for dc in range(-radius, radius + 1):
            win = (slice(pad + dr, pad + dr + h), slice(pad + dc, pad + dc + w))
            nb, nn = demod_p[win], normal_p[win]
            w_spatial = math.exp(-(dr * dr + dc * dc) / (2.0 * radius * radius))
            n_dot = torch.clamp((nn * normal).sum(dim=-1, keepdim=True), 0.0, 1.0)
            wgt = w_spatial * pow2k(n_dot, 3)
            acc = acc + nb * wgt
            wsum = wsum + wgt
    filtered = acc / torch.clamp_min(wsum, 1e-6)
    return filtered * albedo
