"""Shading math — counterpart of ``mrt_tpu/render/shade.py``. Everything
operates on (R, ...) ray batches; dot products and norms write their adds
out in a fixed order."""

from __future__ import annotations

import torch

from ..core import types as T

PI = 3.14159265358979323846


def dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def length(v):
    return torch.sqrt(dot3(v, v))


def length2(v):
    """Length of (..., 2) vectors (motion in pixels)."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])


def normalize(v):
    return v / torch.clamp(length(v), min=1e-20)[..., None]


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def sample_cosine_hemisphere(u: torch.Tensor) -> torch.Tensor:
    """u: (R,2) -> (R,3) with +Y up."""
    phi = 2.0 * PI * u[:, 0]
    cos_phi = torch.cos(phi)
    sin_phi = torch.sin(phi)
    cos_theta = torch.sqrt(u[:, 1])
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    return torch.stack([sin_theta * cos_phi, cos_theta, sin_theta * sin_phi], dim=-1)


def align_hemisphere_with_normal(sample: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Frame around ``normal`` built with the reference's not-quite-up vector."""
    up = normal
    ref = torch.tensor([0.0072, 1.0, 0.0034], dtype=torch.float32, device=normal.device)
    right = normalize(cross(normal, ref.expand_as(normal)))
    forward = cross(right, up)
    return sample[:, 0:1] * right + sample[:, 1:2] * up + sample[:, 2:3] * forward


def distribution_ggx(n_dot_h, alpha):
    a2 = alpha * alpha
    denom = (n_dot_h * n_dot_h) * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(PI * denom * denom, min=1e-7)


def geometry_schlick_ggx(n_dot_v, k):
    return n_dot_v / torch.clamp(n_dot_v * (1.0 - k) + k, min=1e-7)


def geometry_smith(n_dot_v, n_dot_l, k):
    return geometry_schlick_ggx(n_dot_v, k) * geometry_schlick_ggx(n_dot_l, k)


def fresnel_schlick(cos_theta, f0):
    """f0: (R,3); cos_theta: (R,)."""
    return f0 + (1.0 - f0) * torch.pow(torch.clamp(1.0 - cos_theta, 0.0, 1.0), 5.0)[..., None]


def sample_area_light(light_pos, light_fwd, light_right, light_up, light_color, u, position):
    """Returns (direction, color, distance) of an area-light sample."""
    uu = u * 2.0 - 1.0
    sample_pos = light_pos + light_right * uu[:, 0:1] + light_up * uu[:, 1:2]
    direction = sample_pos - position
    distance = length(direction)
    inv_d = 1.0 / torch.clamp(distance, min=1e-3)
    direction = direction * inv_d[:, None]
    color = light_color * (inv_d * inv_d)[:, None]
    color = color * saturate(dot3(-direction, light_fwd))[:, None]
    return direction, color, distance


def evaluate_light(lights: T.Lights, light_index: torch.Tensor, u_area: torch.Tensor,
                   position: torch.Tensor):
    """One-of-N light evaluation: every light type's formula, selected by the
    picked light's type. Returns (direction (R,3), color (R,3), distance (R,))."""
    li = light_index.long()
    ltype = lights.type[li]
    lpos = lights.position[li]
    lcol = lights.color[li]
    ldir = lights.direction[li]

    a_dir, a_col, a_dist = sample_area_light(lpos, lights.forward[li], lights.right[li],
                                             lights.up[li], lcol, u_area, position)
    s_vec = lpos - position
    s_dist = length(s_vec)
    s_inv = 1.0 / torch.clamp(s_dist, min=1e-3)
    s_dir = s_vec * s_inv[:, None]
    cone_dir = normalize(ldir)
    in_cone = dot3(-s_dir, cone_dir) > torch.cos(lights.cone_angle[li])
    s_col = torch.where(in_cone[:, None], lcol * (s_inv * s_inv)[:, None], 0.0)
    p_col = lcol * (s_inv * s_inv)[:, None]
    sun_dir = -normalize(ldir)
    inf = torch.full_like(s_dist, float("inf"))

    is_area = (ltype == T.LIGHT_TYPE_AREA)[:, None]
    is_spot = (ltype == T.LIGHT_TYPE_SPOTLIGHT)[:, None]
    is_point = (ltype == T.LIGHT_TYPE_POINTLIGHT)[:, None]
    direction = torch.where(is_area, a_dir, torch.where(is_spot | is_point, s_dir, sun_dir))
    color = torch.where(is_area, a_col, torch.where(is_spot, s_col, torch.where(is_point, p_col, lcol)))
    distance = torch.where(is_area[:, 0], a_dist,
                           torch.where(is_spot[:, 0] | is_point[:, 0], s_dist, inf))
    return direction, color, distance


def tangent_basis_rows(p0, p1, p2, uv0, uv1, uv2, eps=1e-8):
    """Tangent basis from per-hit world verts and uvs. Returns
    (valid (R,), tangent (R,3), bitangent (R,3))."""
    e1 = p1 - p0
    e2 = p2 - p0
    duv1 = uv1 - uv0
    duv2 = uv2 - uv0
    denom = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
    valid = denom.abs() >= eps
    r = torch.where(valid, 1.0 / torch.where(valid, denom, 1.0), 0.0)[:, None]
    tangent = (e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2]) * r
    bitangent = (e2 * duv1[:, 0:1] - e1 * duv2[:, 0:1]) * r
    valid = valid & (length(tangent) > eps) & (length(bitangent) > eps)
    return valid, tangent, bitangent
