"""Kernel K1 — present: Reinhard tonemap + clamp + uint8 quantize
(``csrc/present.cu``), its wrapper and its plain PyTorch version.

Replaces ``mrt_tpu/kernels/present.py:tonemap_quantize`` (the repository's
only Pallas kernel). The wrapper launches the CUDA kernel for CUDA tensors
and takes the plain version only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

launches = 0  # kernel launches by ``tonemap_quantize`` in this process


def tonemap_quantize_plain(color: torch.Tensor) -> torch.Tensor:
    """(H,W,3) linear f32 -> (H,W,3) uint8, the JAX fallback's expression."""
    tone = color / (1.0 + color)
    return (torch.clamp(tone, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def edge_case_inputs(height: int, width: int, seed: int = 0) -> torch.Tensor:
    """(H,W,3) f32 on the CPU over K1's edge cases, in eighths: zeros, tiny
    values (some denormal), huge values, values whose ``tone * 255`` lands
    exactly on k + 0.5 (with their f32 neighbours), and random [0, 4) for the
    rest. NaN and inf are left out: their quantized value is undefined."""
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((height, width, 3), generator=g) * 4.0
    flat = x.view(-1)
    n8 = flat.numel() // 8
    flat[:n8] = 0.0
    flat[n8:2 * n8] = torch.rand(n8, generator=g) * 1e-37
    flat[2 * n8:3 * n8] = torch.rand(n8, generator=g) * 3e38
    k = torch.arange(255, dtype=torch.float32)
    tone = (k + 0.5) / 255.0
    c = tone / (1.0 - tone)
    cands = torch.cat([c, torch.nextafter(c, torch.full_like(c, 10.0)),
                       torch.nextafter(c, torch.zeros_like(c))])
    t255 = cands / (1.0 + cands) * 255.0
    halves = torch.cat([cands[(t255 - torch.floor(t255)) == 0.5], cands])
    reps = max(n8 // halves.numel(), 1)
    block = halves.repeat(reps)[:n8]
    flat[3 * n8:3 * n8 + block.numel()] = block
    return x


def tonemap_quantize(color: torch.Tensor) -> torch.Tensor:
    """(H,W,3) linear f32 -> (H,W,3) uint8 (Reinhard + quantize)."""
    global launches
    if color.device.type == "cpu":
        return tonemap_quantize_plain(color)
    if color.device.type != "cuda":
        raise ValueError(f"tonemap_quantize: unsupported device {color.device}")
    if color.dtype != torch.float32:
        raise TypeError(f"tonemap_quantize: expected float32, got {color.dtype}")
    if color.ndim != 3 or color.shape[2] != 3:
        raise ValueError(f"tonemap_quantize: expected (H, W, 3), got {tuple(color.shape)}")
    if not color.is_contiguous():
        raise ValueError("tonemap_quantize: input is not contiguous")
    if color.data_ptr() % 16:
        raise ValueError("tonemap_quantize: input is not 16-byte aligned (the kernel loads float4)")
    out = torch.empty(color.shape, dtype=torch.uint8, device=color.device)
    if color.numel() == 0:
        return out
    from . import build

    lib = build.load()
    stream = torch.cuda.current_stream(color.device).cuda_stream
    rc = lib.mrt_present(ctypes.c_void_p(color.data_ptr()), ctypes.c_void_p(out.data_ptr()),
                         color.numel(), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"present kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
