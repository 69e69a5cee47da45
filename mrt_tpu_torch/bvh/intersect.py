"""Brute-force ray/triangle oracles — counterpart of ``mrt_tpu/bvh/intersect.py``.
O(R*T); the tests use them to decide whether two traversals that disagree on
a triangle hit an equal-t tie."""

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
