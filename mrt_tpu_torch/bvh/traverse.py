"""Binary-BVH traversal oracle — counterpart of ``mrt_tpu/bvh/traverse.py``
(the JAX package's ``lax.while_loop`` traversal, its test oracle).

Plain torch, every lane stepped together until no lane has a stack entry:
a lane pops a node, tests one triangle (a leaf) or two child boxes (an
internal node, the nearer child pushed last so it pops first) per step.
It walks the one-triangle-per-leaf ``lbvh.BVH`` with the brute-force
oracles' triangle test, so it checks the wide tables and kernels K2 and K3
by another route; there is no kernel behind it.
"""

from __future__ import annotations

import torch

from ..core.types import Hits, Rays
from .intersect import ray_aabb, ray_triangle, safe_inv_dir
from .lbvh import BVH

# stack entries per lane (Karras trees over <= 2^20 triangles stay well under it)
STACK_DEPTH = 64


def _push(stack, sp, lane, push, node):
    """Push ``node`` on the lanes where ``push`` holds (the top capped at
    STACK_DEPTH - 1, as the JAX oracle's clamped scatter)."""
    at = torch.clamp(sp, max=STACK_DEPTH - 1).long()
    stack[lane, at] = torch.where(push, node, stack[lane, at])
    return torch.where(push, torch.clamp(sp + 1, max=STACK_DEPTH), sp)


def _single(bvh, v0, v1, v2, rays, t_min):
    tid = bvh.leaf_tri[0].long()
    return ray_triangle(rays.origin, rays.direction, v0[tid], v1[tid], v2[tid], t_min=t_min,
                        t_max=rays.max_distance)


def closest_hit(bvh: BVH, tri_v0, tri_v1, tri_v2, rays: Rays, t_min: float = 0.0,
                mask=None) -> Hits:
    """Closest hit per ray over (T,3) triangle vertices in the original
    order (the hit triangle's id is its index there); ``mask`` (R,) bool
    leaves lanes out (they report a miss)."""
    n = rays.origin.shape[0]
    dev = rays.origin.device
    n_int = bvh.n_internal
    if n_int == 0:
        hit, t, u, v = _single(bvh, tri_v0, tri_v1, tri_v2, rays, t_min)
        if mask is not None:
            hit = hit & mask
        return Hits(t=torch.where(hit, t, float("inf")),
                    triangle=torch.where(hit, bvh.leaf_tri[0], -1).to(torch.int32),
                    u=torch.where(hit, u, 0.0), v=torch.where(hit, v, 0.0))
    inv_dir = safe_inv_dir(rays.direction)
    lane = torch.arange(n, device=dev)
    stack = torch.zeros((n, STACK_DEPTH), dtype=torch.int32, device=dev)  # the root, 0, pushed
    sp = torch.ones(n, dtype=torch.int32, device=dev)
    if mask is not None:
        sp = torch.where(mask, sp, 0)
    best_t = torch.full((n,), float("inf"), device=dev)
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(n, device=dev)
    best_v = torch.zeros(n, device=dev)
    while bool((sp > 0).any()):
        active = sp > 0
        sp_pop = torch.clamp(sp - 1, min=0)
        node = torch.where(active, stack[lane, sp_pop.long()], 0)
        sp = torch.where(active, sp_pop, sp)
        is_leaf = node >= n_int

        # leaf lanes: one triangle
        tri = bvh.leaf_tri[torch.clamp(node - n_int, 0, bvh.n_tris - 1).long()]
        t = tri.long()
        l_hit, l_t, l_u, l_v = ray_triangle(rays.origin, rays.direction, tri_v0[t], tri_v1[t],
                                            tri_v2[t], t_min=t_min,
                                            t_max=torch.minimum(best_t, rays.max_distance))
        take = active & is_leaf & l_hit & (l_t < best_t)
        best_t = torch.where(take, l_t, best_t)
        best_tri = torch.where(take, tri, best_tri)
        best_u = torch.where(take, l_u, best_u)
        best_v = torch.where(take, l_v, best_v)

        # internal lanes: two child boxes, the far one pushed first
        inode = torch.clamp(node, 0, n_int - 1).long()
        lc, rc = bvh.left[inode], bvh.right[inode]
        t_cap = torch.minimum(best_t, rays.max_distance)
        hit_l, t_l = ray_aabb(rays.origin, inv_dir, bvh.bbox_min[lc.long()],
                              bvh.bbox_max[lc.long()], t_max=t_cap)
        hit_r, t_r = ray_aabb(rays.origin, inv_dir, bvh.bbox_min[rc.long()],
                              bvh.bbox_max[rc.long()], t_max=t_cap)
        internal = active & ~is_leaf
        left_near = t_l <= t_r
        sp = _push(stack, sp, lane, internal & torch.where(left_near, hit_r, hit_l),
                   torch.where(left_near, rc, lc))
        sp = _push(stack, sp, lane, internal & torch.where(left_near, hit_l, hit_r),
                   torch.where(left_near, lc, rc))
    return Hits(t=best_t, triangle=best_tri, u=best_u, v=best_v)


def any_hit(bvh: BVH, tri_v0, tri_v1, tri_v2, rays: Rays, t_min: float = 0.0,
            mask=None) -> torch.Tensor:
    """Occlusion per ray within ``rays.max_distance``: a lane stops at its
    first hit. Returns (R,) bool."""
    n = rays.origin.shape[0]
    dev = rays.origin.device
    n_int = bvh.n_internal
    if n_int == 0:
        hit = _single(bvh, tri_v0, tri_v1, tri_v2, rays, t_min)[0]
        return hit if mask is None else hit & mask
    inv_dir = safe_inv_dir(rays.direction)
    lane = torch.arange(n, device=dev)
    stack = torch.zeros((n, STACK_DEPTH), dtype=torch.int32, device=dev)
    sp = torch.ones(n, dtype=torch.int32, device=dev)
    if mask is not None:
        sp = torch.where(mask, sp, 0)
    occluded = torch.zeros(n, dtype=torch.bool, device=dev)
    while bool(((sp > 0) & ~occluded).any()):
        active = (sp > 0) & ~occluded
        sp_pop = torch.clamp(sp - 1, min=0)
        node = torch.where(active, stack[lane, sp_pop.long()], 0)
        sp = torch.where(active, sp_pop, sp)
        is_leaf = node >= n_int
        t = bvh.leaf_tri[torch.clamp(node - n_int, 0, bvh.n_tris - 1).long()].long()
        l_hit = ray_triangle(rays.origin, rays.direction, tri_v0[t], tri_v1[t], tri_v2[t],
                             t_min=t_min, t_max=rays.max_distance)[0]
        occluded = occluded | (active & is_leaf & l_hit)

        inode = torch.clamp(node, 0, n_int - 1).long()
        lc, rc = bvh.left[inode], bvh.right[inode]
        hit_l = ray_aabb(rays.origin, inv_dir, bvh.bbox_min[lc.long()], bvh.bbox_max[lc.long()],
                         t_max=rays.max_distance)[0]
        hit_r = ray_aabb(rays.origin, inv_dir, bvh.bbox_min[rc.long()], bvh.bbox_max[rc.long()],
                         t_max=rays.max_distance)[0]
        internal = active & ~is_leaf
        sp = _push(stack, sp, lane, internal & hit_l, lc)
        sp = _push(stack, sp, lane, internal & hit_r, rc)
    return occluded
