"""Denoiser — counterpart of ``mrt_tpu/upscale/denoise.py``, SVGF-lite at
render size: albedo demodulation, motion-reprojected temporal accumulation
of the demodulated signal with depth and normal validity tests, per-pixel
luminance moments giving a variance estimate, three variance-guided
edge-aware à-trous passes (dilations 1, 2, 4), remodulation.

``svgf_filter`` runs kernel K9 ``svgf_reproject`` (demodulation,
reprojection, moments) and K10 ``atrous_pass`` three times
(``kernels/presenter.py``, ``csrc/presenter.cu``); on CPU tensors their
plain versions, the torch ops the JAX package's XLA ops are written as (it
has no Pallas kernel here). The integer powers ``x ** 32`` and ``x ** 8``
are written as the squarings ``lax.integer_pow`` computes, so they round as
the JAX package's do.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core.device import resolve
from ..kernels import presenter as K
from ..kernels.presenter import edge_pad, pow2k


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


def svgf_filter(color: torch.Tensor, gbuffer: dict, depth: torch.Tensor, motion: torch.Tensor,
                state: DenoiseState, n_passes: int = 3):
    """color (h,w,3) this frame's radiance; gbuffer: diffuse_albedo,
    specular_albedo, normal (encoded to [0,1]), roughness; depth (h,w);
    motion (h,w,2) in pixels, +Y down. Returns (denoised colour (h,w,3),
    new DenoiseState). ``n_passes`` (1-3): à-trous passes at dilations 1,
    2, 4."""
    if not 1 <= n_passes <= len(K.ATROUS_STEPS):
        raise ValueError(f"svgf_filter: n_passes {n_passes} is not 1-{len(K.ATROUS_STEPS)}")
    gb = {k: gbuffer[k].contiguous() for k in ("diffuse_albedo", "specular_albedo", "normal")}
    depth = depth.contiguous()
    demod_i, m1, m2, hist_len, normal, var, flum = K.svgf_reproject(
        color.contiguous(), gb["diffuse_albedo"], gb["specular_albedo"], gb["normal"], depth,
        motion.contiguous(), state)
    new_state = DenoiseState(demod=demod_i, m1=m1, m2=m2, history_length=hist_len, depth=depth,
                             normal=normal)
    # variance-guided à-trous wavelet filtering; the last pass remodulates
    filtered, fvar = demod_i, var
    for i in range(n_passes - 1):
        filtered, fvar, flum = K.atrous_pass(filtered, fvar, flum, normal, depth, 1 << i)
    out = K.atrous_pass(filtered, fvar, flum, normal, depth, 1 << (n_passes - 1),
                        gb["diffuse_albedo"], gb["specular_albedo"])
    return out, new_state


def demodulate_filter(color: torch.Tensor, gbuffer: dict, radius: int = 2) -> torch.Tensor:
    """Single-frame fallback without temporal state: albedo demodulation, an
    edge-aware cross-bilateral filter, remodulation."""
    albedo = K.albedo_of(gbuffer["diffuse_albedo"], gbuffer["specular_albedo"])
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
