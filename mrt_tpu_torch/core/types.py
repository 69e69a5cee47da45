"""Core shared types — the PyTorch counterpart of ``mrt_tpu/core/types.py``.

Same vocabulary as the JAX package (``Camera``, ``Lights`` and the four light
types, ``Materials``, ``FrameUniforms``, ``RenderSettings``, ``Rays``,
``Hits``), as ``NamedTuple``s of torch tensors. Constants keep their values so
both packages read the same tables.

``RenderSettings`` accepts every field of the JAX settings. The fields that
only steer how XLA schedules work on a TPU (tile size, chunking, sorting,
streaming, priming, VMEM placement) leave the result unchanged and are
ignored here; :func:`check_supported` raises ``NotImplementedError`` for the
settings this port does not cover yet.
"""

from __future__ import annotations

import dataclasses
import os as _os
from typing import NamedTuple

import numpy as np
import torch

# --- geometry / ray masks ------------------------------------------------------
GEOMETRY_MASK_TRIANGLE = 1
GEOMETRY_MASK_LIGHT = 2
GEOMETRY_MASK_GEOMETRY = GEOMETRY_MASK_TRIANGLE
RAY_MASK_PRIMARY = GEOMETRY_MASK_GEOMETRY | GEOMETRY_MASK_LIGHT
RAY_MASK_SHADOW = GEOMETRY_MASK_GEOMETRY
RAY_MASK_SECONDARY = GEOMETRY_MASK_GEOMETRY

# --- light types -----------------------------------------------------------------
LIGHT_TYPE_UNUSED = 0
LIGHT_TYPE_SUNLIGHT = 1
LIGHT_TYPE_SPOTLIGHT = 2
LIGHT_TYPE_POINTLIGHT = 3
LIGHT_TYPE_AREA = 4

# --- shading modes -----------------------------------------------------------------
SHADING_MODE_PBR = 0
SHADING_MODE_LEGACY = 1

# --- material texture-flag bits ------------------------------------------------------
MATERIAL_TEXTURE_BASECOLOR = 1 << 0
MATERIAL_TEXTURE_NORMAL = 1 << 1
MATERIAL_TEXTURE_ROUGHNESS = 1 << 2
MATERIAL_TEXTURE_METALLIC = 1 << 3
MATERIAL_TEXTURE_AO = 1 << 4
MATERIAL_TEXTURE_EMISSION = 1 << 5
MATERIAL_TEXTURE_OPACITY = 1 << 6

# --- debug texture modes ---------------------------------------------------------------
DEBUG_MODE_NONE = 0
DEBUG_MODE_BASECOLOR = 1
DEBUG_MODE_NORMAL = 2
DEBUG_MODE_ROUGHNESS = 3
DEBUG_MODE_METALLIC = 4
DEBUG_MODE_AO = 5
DEBUG_MODE_EMISSION = 6
DEBUG_MODE_MOTION = 7

# Compile-time AO gate, default off; the same switch as the JAX package.
ENABLE_AO = _os.environ.get("MRT_ENABLE_AO", "0") == "1"


def to_device(nt, device):
    """Move every tensor field of a NamedTuple (recursively) to ``device``."""
    vals = []
    for v in nt:
        if isinstance(v, torch.Tensor):
            v = v.to(device)
        elif isinstance(v, tuple) and hasattr(v, "_fields"):
            v = to_device(v, device)
        vals.append(v)
    return type(nt)(*vals)


def _f3(v) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, np.float32).reshape(1, 3))


class Camera(NamedTuple):
    """Pinhole camera; ``right``/``up`` are pre-scaled by the image-plane half
    extents, so a ray is ``normalize(u*right + v*up + forward)``."""

    position: torch.Tensor  # (3,) f32
    right: torch.Tensor  # (3,) f32
    up: torch.Tensor  # (3,) f32
    forward: torch.Tensor  # (3,) f32, unit


class Lights(NamedTuple):
    """SoA light array. Leading dim = light count."""

    type: torch.Tensor  # (L,) int32
    position: torch.Tensor  # (L,3) f32
    color: torch.Tensor  # (L,3) f32
    forward: torch.Tensor  # (L,3) f32 (area)
    right: torch.Tensor  # (L,3) f32 (area)
    up: torch.Tensor  # (L,3) f32 (area)
    cone_angle: torch.Tensor  # (L,) f32 (spot)
    direction: torch.Tensor  # (L,3) f32 (spot/sun)

    @property
    def count(self) -> int:
        return self.type.shape[0]


def make_light(type: int, position=(0.0, 0.0, 0.0), color=(0.0, 0.0, 0.0),
               forward=(0.0, 0.0, 0.0), right=(0.0, 0.0, 0.0), up=(0.0, 0.0, 0.0),
               cone_angle: float = 0.0, direction=(0.0, 0.0, 0.0)) -> Lights:
    """Single light as an SoA batch of one."""
    return Lights(
        type=torch.tensor([type], dtype=torch.int32),
        position=_f3(position),
        color=_f3(color),
        forward=_f3(forward),
        right=_f3(right),
        up=_f3(up),
        cone_angle=torch.as_tensor(np.asarray([cone_angle], np.float32)),
        direction=_f3(direction),
    )


def area_light(position, forward, right, up, color) -> Lights:
    return make_light(LIGHT_TYPE_AREA, position=position, color=color, forward=forward,
                      right=right, up=up)


def sun_light(direction, color) -> Lights:
    return make_light(LIGHT_TYPE_SUNLIGHT, direction=direction, color=color)


def point_light(position, color) -> Lights:
    return make_light(LIGHT_TYPE_POINTLIGHT, position=position, color=color)


def spot_light(position, direction, cone_angle, color) -> Lights:
    return make_light(LIGHT_TYPE_SPOTLIGHT, position=position, direction=direction,
                      cone_angle=cone_angle, color=color)


def concat_lights(*lights: Lights) -> Lights:
    return Lights(*(torch.cat(parts, dim=0) for parts in zip(*lights)))


class Materials(NamedTuple):
    """SoA per-resource materials. Leading dim = resource count."""

    base_color: torch.Tensor  # (R,3) f32
    specular: torch.Tensor  # (R,3) f32
    emission: torch.Tensor  # (R,3) f32
    specular_exponent: torch.Tensor  # (R,) f32
    refraction_index: torch.Tensor  # (R,) f32
    opacity: torch.Tensor  # (R,) f32
    texture_flags: torch.Tensor  # (R,) int32 (bits <= 127)


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Render configuration; the same fields and defaults as the JAX
    package's ``RenderSettings``."""

    width: int = 512
    height: int = 512
    samples_per_pixel: int = 2
    max_bounces: int = 2
    shading_mode: int = SHADING_MODE_PBR
    debug_mode: int = DEBUG_MODE_NONE
    enable_gbuffer: bool = False
    enable_motion_adaptive_sampling: bool = True
    motion_sampling_max_extra_samples: int = 2
    enable_motion_adaptive_accumulation: bool = True
    # --- TPU execution knobs: accepted, ignored (results do not depend on them)
    tile_pixels: int = 32768
    traversal_chunks: int = 16
    traversal_unroll: int = 4
    persistent_samples: bool = False
    sort_rays: bool = True
    workload_sort: bool = True
    workload_sort_rolling: bool = False
    sort_shadow_rays: bool = True
    traversal_stream: int = 0
    stream_refill: int = 8
    # ---
    traversal_backend: str = "wide"
    # Shadow rays are always traced as their own batch after the closest-hit
    # batch here; fusing them changes only the order of the radiance sums.
    fuse_shadow_rays: bool = True
    geometry_axis: str | None = None
    two_level: bool = True
    hit_priming: bool = False  # ignored: priming re-tests its candidates
    use_mipmaps: bool = False
    light_sampling: str = "uniform"

    @property
    def base_samples(self) -> int:
        return max(self.samples_per_pixel, 1)

    @property
    def max_extra_samples(self) -> int:
        if self.enable_motion_adaptive_sampling:
            return max(self.motion_sampling_max_extra_samples, 0)
        return 0

    @property
    def sample_stride(self) -> int:
        return self.base_samples + self.max_extra_samples


def check_supported(settings: RenderSettings) -> None:
    """Raise ``NotImplementedError`` for settings outside the ported slice
    (each names its ROADMAP item); never ignore them silently."""
    if not settings.two_level or settings.traversal_backend != "wide":
        raise NotImplementedError("only the two-level wide BVH is ported (flat path: ROADMAP Slice F)")
    if settings.geometry_axis:
        raise NotImplementedError("geometry sharding is not ported yet (ROADMAP Slice G)")
    if settings.light_sampling not in ("uniform", "power"):
        raise ValueError(f"unknown light_sampling {settings.light_sampling!r}")


class FrameUniforms(NamedTuple):
    """Per-frame scalars (0-d f32 tensors, so f32 arithmetic matches the
    JAX package's)."""

    camera: Camera
    previous_camera: Camera
    frame_index: int
    accumulation_weight: torch.Tensor
    motion_accum_min_weight: torch.Tensor
    motion_accum_low_px: torch.Tensor
    motion_accum_high_px: torch.Tensor
    motion_sampling_low_px: torch.Tensor
    motion_sampling_high_px: torch.Tensor


def make_frame_uniforms(camera: Camera, previous_camera: Camera | None = None,
                        frame_index: int = 0, accumulation_weight: float = 0.9,
                        motion_accum_min_weight: float = 0.1, motion_accum_low_px: float = 0.5,
                        motion_accum_high_px: float = 4.0, motion_sampling_low_px: float = 1.0,
                        motion_sampling_high_px: float = 6.0, device=None) -> FrameUniforms:
    device = camera.position.device if device is None else device

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    return FrameUniforms(
        camera=camera,
        previous_camera=camera if previous_camera is None else previous_camera,
        frame_index=int(frame_index),
        accumulation_weight=f32(accumulation_weight),
        motion_accum_min_weight=f32(motion_accum_min_weight),
        motion_accum_low_px=f32(motion_accum_low_px),
        motion_accum_high_px=f32(motion_accum_high_px),
        motion_sampling_low_px=f32(motion_sampling_low_px),
        motion_sampling_high_px=f32(motion_sampling_high_px),
    )


class Rays(NamedTuple):
    origin: torch.Tensor  # (R,3) f32
    direction: torch.Tensor  # (R,3) f32
    max_distance: torch.Tensor  # (R,) f32


class Hits(NamedTuple):
    t: torch.Tensor  # (R,) f32; inf = miss
    triangle: torch.Tensor  # (R,) int32 global triangle id; -1 = miss
    u: torch.Tensor  # (R,) f32 barycentric for vertex 1
    v: torch.Tensor  # (R,) f32 barycentric for vertex 2

    @property
    def hit(self) -> torch.Tensor:
        return self.triangle >= 0


def orbit_camera(width: int, height: int, target, azimuth: float, elevation: float,
                 distance: float, fov_degrees: float = 45.0) -> Camera:
    """Orbit camera; the same NumPy arithmetic as the JAX package, so the
    two cameras are bit-equal."""
    target = np.asarray(target, np.float32)
    safe_distance = max(0.001, float(distance))
    limit = np.pi / 2.0 - 0.001
    el = float(np.clip(elevation, -limit, limit))
    x = safe_distance * np.cos(el) * np.sin(azimuth)
    y = safe_distance * np.sin(el)
    z = safe_distance * np.cos(el) * np.cos(azimuth)
    position = target + np.array([x, y, z], np.float32)

    fwd = target - position
    forward = fwd / np.linalg.norm(fwd)
    world_up = np.array([0.0, 1.0, 0.0], np.float32)
    right = np.cross(forward, world_up)
    n = np.linalg.norm(right)
    right = right / n if n >= 1e-4 else np.array([1.0, 0.0, 0.0], np.float32)
    up = np.cross(right, forward)
    up = up / np.linalg.norm(up)

    fov = fov_degrees * np.pi / 180.0
    image_plane_height = np.tan(fov / 2.0)
    image_plane_width = (width / height) * image_plane_height

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    return Camera(position=t(position), right=t(right * image_plane_width),
                  up=t(up * image_plane_height), forward=t(forward))
