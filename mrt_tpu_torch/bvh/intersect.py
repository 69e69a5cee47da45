"""Ray/primitive tests and brute-force oracles — counterpart of
``mrt_tpu/bvh/intersect.py``: the Moller-Trumbore triangle test, the slab
ray/AABB test with its guarded reciprocal direction (used by the binary
LBVH oracle, ``bvh/traverse.py``), and the O(R*T) closest- and any-hit
oracles, with which the tests decide whether two traversals that disagree
on a triangle hit an equal-t tie."""

from __future__ import annotations

import torch

from ..core.types import Hits, Rays

_EPS = 1e-9


def ray_triangle(origin, direction, v0, v1, v2, t_min=0.0, t_max=float("inf")):
    """Moller-Trumbore, no culling. Returns (hit, t, u, v) broadcast over the
    leading dims."""
    from ..render.shade import cross, dot3

    e1 = v1 - v0
    e2 = v2 - v0
    pvec = cross(*torch.broadcast_tensors(direction, e2))
    det = dot3(e1, pvec)
    valid = det.abs() > _EPS
    inv_det = torch.where(valid, 1.0 / torch.where(valid, det, 1.0), 0.0)
    tvec = origin - v0
    u = dot3(tvec, pvec) * inv_det
    qvec = cross(*torch.broadcast_tensors(tvec, e1))
    v = dot3(direction, qvec) * inv_det
    t = dot3(e2, qvec) * inv_det
    hit = valid & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= t_min) & (t <= t_max)
    return hit, t, u, v


def ray_aabb(origin, inv_direction, bbox_min, bbox_max, t_max=float("inf")):
    """Slab test over (..., 3) rays and boxes; ``inv_direction`` is 1/d (see
    ``safe_inv_dir``). Returns (hit, t_entry clamped at 0); a ray that starts
    inside the box hits it."""
    t0 = (bbox_min - origin) * inv_direction
    t1 = (bbox_max - origin) * inv_direction
    t_near = torch.amax(torch.minimum(t0, t1), dim=-1)
    t_far = torch.amin(torch.maximum(t0, t1), dim=-1)
    hit = (t_near <= t_far) & (t_far >= 0.0) & (t_near <= t_max)
    return hit, torch.clamp_min(t_near, 0.0)


def safe_inv_dir(direction):
    """1/d with components of magnitude below 1e-12 replaced by +-1e-12 (by
    sign), so the slab test stays free of NaN."""
    d = direction
    tiny = torch.where(d < 0, -1e-12, 1e-12).to(d.dtype)
    return torch.ones_like(d) / torch.where(d.abs() < 1e-12, tiny, d)


def brute_force_closest_hit(rays: Rays, v0, v1, v2, t_min: float = 0.0) -> Hits:
    o = rays.origin[:, None, :]
    d = rays.direction[:, None, :]
    hit, t, u, v = ray_triangle(o, d, v0[None], v1[None], v2[None], t_min=t_min,
                                t_max=rays.max_distance[:, None])
    t = torch.where(hit, t, float("inf"))
    best = torch.argmin(t, dim=1)
    r = torch.arange(t.shape[0], device=t.device)
    best_t = t[r, best]
    found = torch.isfinite(best_t)
    return Hits(t=best_t, triangle=torch.where(found, best.to(torch.int32), -1),
                u=torch.where(found, u[r, best], 0.0), v=torch.where(found, v[r, best], 0.0))


def brute_force_any_hit(rays: Rays, v0, v1, v2, t_min: float = 0.0) -> torch.Tensor:
    o = rays.origin[:, None, :]
    d = rays.direction[:, None, :]
    hit, _, _, _ = ray_triangle(o, d, v0[None], v1[None], v2[None], t_min=t_min,
                                t_max=rays.max_distance[:, None])
    return hit.any(dim=1)
