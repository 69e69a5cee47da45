"""The reference's traversal: its own binary BVH over the frame's
world-space triangles, walked in torch ops.

The topology is a Karras radix tree over 30-bit Morton codes (the
topology code is a frozen copy of ``mrt_tpu_torch/bvh/lbvh.py``), built
over clusters of ``LEAF`` triangles consecutive in Morton order, so a leaf
tests up to ``LEAF`` triangles at once and a ray pops fewer nodes. The
triangle and box tests are a frozen copy of ``mrt_tpu_torch/bvh/intersect.py``
(Moller-Trumbore without culling, the slab test). Every lane steps together
until no lane holds a stack entry. Nothing here reads the port's table: the
hits are the closest over the triangles as given, whichever BVH finds them.
"""

from __future__ import annotations

import numpy as np
import torch

from .shade import cross, dot3
from .types import Hits, Rays

LEAF = 16  # triangles a leaf
STACK_DEPTH = 64  # entries a lane (a Karras tree over <= 2^21 leaves stays under it)
SYNC_EVERY = 16  # steps between the host's checks for a live lane (one CUDA graph)


def _bit_length_u32(x: np.ndarray) -> np.ndarray:
    """Exact bit length of uint32 values (frexp exponent; ints < 2^53 exact)."""
    _, e = np.frexp(x.astype(np.float64))
    return e.astype(np.int32)


def _expand_bits(v: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of v so there are 2 zero bits between each."""
    v = v.astype(np.uint32)
    v = (v * np.uint32(0x00010001)) & np.uint32(0xFF0000FF)
    v = (v * np.uint32(0x00000101)) & np.uint32(0x0F00F00F)
    v = (v * np.uint32(0x00000011)) & np.uint32(0xC30C30C3)
    v = (v * np.uint32(0x00000005)) & np.uint32(0x49249249)
    return v


def morton_codes(centroids: np.ndarray, scene_min: np.ndarray, scene_max: np.ndarray) -> np.ndarray:
    """30-bit Morton code per centroid, normalized to the scene AABB."""
    extent = np.maximum(scene_max - scene_min, 1e-12)
    q = np.clip((centroids - scene_min) / extent, 0.0, 1.0)
    q = np.minimum((q * 1024.0).astype(np.uint32), 1023)
    return (_expand_bits(q[:, 0]) << np.uint32(2)) | (_expand_bits(q[:, 1]) << np.uint32(1)) | _expand_bits(q[:, 2])


def _delta_fn(keys_hi: np.ndarray, keys_lo: np.ndarray, n: int):
    """delta(i, j) = common-prefix length of augmented 64-bit keys (morton<<32 | index)."""

    def delta(i: np.ndarray, j: np.ndarray) -> np.ndarray:
        valid = (j >= 0) & (j < n)
        jc = np.clip(j, 0, n - 1)
        xh = keys_hi[i] ^ keys_hi[jc]
        xl = keys_lo[i] ^ keys_lo[jc]
        bl = np.where(xh > 0, 32 + _bit_length_u32(xh), _bit_length_u32(xl))
        return np.where(valid, 64 - bl, -1)

    return delta


def build_topology(tri_centroids: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """Karras 2012 binary radix tree, fully vectorized.

    Returns (left, right, parent, leaf_tri, depth) as NumPy arrays; combined
    node ids as documented on :class:`BVH`.
    """
    n = tri_centroids.shape[0]
    if n == 1:
        # Degenerate: a single leaf; synthesize a 1-node "tree" with no internals.
        return (
            np.zeros((0,), np.int32),
            np.zeros((0,), np.int32),
            np.array([-1], np.int32),
            np.array([0], np.int32),
            1,
        )

    scene_min = tri_centroids.min(axis=0)
    scene_max = tri_centroids.max(axis=0)
    codes = morton_codes(tri_centroids, scene_min, scene_max)
    order = np.argsort(codes, kind="stable").astype(np.int32)
    sorted_codes = codes[order]

    keys_hi = sorted_codes.astype(np.uint32)
    keys_lo = np.arange(n, dtype=np.uint32)  # augmented index bits break ties
    delta = _delta_fn(keys_hi, keys_lo, n)

    i = np.arange(n - 1, dtype=np.int64)
    d = np.sign(delta(i, i + 1) - delta(i, i - 1)).astype(np.int64)
    d = np.where(d == 0, 1, d)
    delta_min = delta(i, i - d)

    # Exponential search for the range length upper bound.
    lmax = np.full(n - 1, 2, np.int64)
    for _ in range(40):  # 2^40 >> any n we will see
        probe = delta(i, i + lmax * d) > delta_min
        if not probe.any():
            break
        lmax = np.where(probe, lmax * 2, lmax)

    # Binary search for the exact range length l.
    l = np.zeros(n - 1, np.int64)
    t = lmax // 2
    while (t > 0).any():
        tt = np.maximum(t, 1)
        cond = (t > 0) & (delta(i, i + (l + tt) * d) > delta_min)
        l = np.where(cond, l + tt, l)
        t = t // 2
    j = i + l * d

    # Binary search for the split position: t walks ceil(l/2), ceil(l/4), ..., 1.
    # Extra trailing t=1 passes are safe: a move is only accepted while
    # delta(i, i+(s+t)d) > delta_node, which bounds s by the true split.
    delta_node = delta(i, j)
    s = np.zeros(n - 1, np.int64)
    div = 2
    max_l = max(1, int(l.max()))
    while True:
        t = -(-l // div)  # ceil(l / div), >= 1 since l >= 1
        cond = delta(i, i + (s + t) * d) > delta_node
        s = np.where(cond, s + t, s)
        if div >= 2 * max_l:
            break
        div *= 2

    gamma = i + s * d + np.minimum(d, 0)

    lo = np.minimum(i, j)
    hi = np.maximum(i, j)
    left_is_leaf = lo == gamma
    right_is_leaf = hi == gamma + 1
    n_internal = n - 1
    left = np.where(left_is_leaf, n_internal + gamma, gamma).astype(np.int32)
    right = np.where(right_is_leaf, n_internal + gamma + 1, gamma + 1).astype(np.int32)

    parent = np.full(2 * n - 1, -1, np.int32)
    parent[left] = np.arange(n_internal, dtype=np.int32)
    parent[right] = np.arange(n_internal, dtype=np.int32)

    # Tree depth via parent pointers (vectorized pointer chase).
    depth = np.zeros(2 * n - 1, np.int32)
    cur = parent.copy()
    dmax = 1
    for _ in range(2 * n):
        active = cur >= 0
        if not active.any():
            break
        depth[active] += 1
        cur = np.where(active, parent[np.clip(cur, 0, None)], -1)
        dmax += 1
    return left, right, parent, order, int(depth.max()) + 1


_EPS = 1e-9


def ray_triangle(origin, direction, v0, v1, v2, t_min=0.0, t_max=float("inf")):
    """Moller-Trumbore, no culling. Returns (hit, t, u, v) broadcast over the
    leading dims."""
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



class Traversal:
    """Closest- and any-hit queries over (T,3) world-space triangles (in
    the scene's triangle order: a hit's id is its index there)."""

    def __init__(self, v0: torch.Tensor, v1: torch.Tensor, v2: torch.Tensor):
        dev = v0.device
        self.v0, self.v1, self.v2 = v0, v1, v2
        n = v0.shape[0]
        cen = ((v0 + v1 + v2) / 3.0).cpu().numpy().astype(np.float64)
        lo, hi = cen.min(axis=0), cen.max(axis=0)
        order = np.argsort(morton_codes(cen, lo, hi), kind="stable")
        n_leaf = -(-n // LEAF)
        pad = np.full(n_leaf * LEAF, -1, np.int64)
        pad[:n] = order
        clusters = pad.reshape(n_leaf, LEAF)
        c_cen = cen[np.where(clusters >= 0, clusters, clusters[:, :1])].mean(axis=1)
        left, right, _parent, leaf_order, depth = build_topology(c_cen)
        self.clusters = torch.as_tensor(clusters[leaf_order]).to(dev)  # (N, LEAF), -1 pads
        self.n_int = n_leaf - 1
        self.left = torch.as_tensor(left.astype(np.int64)).to(dev)
        self.right = torch.as_tensor(right.astype(np.int64)).to(dev)
        # boxes: the leaves' from their triangles, then depth passes upward
        tri = self.clusters.clamp_min(0)
        real = (self.clusters >= 0)[..., None]
        inf = torch.tensor(float("inf"), device=dev)
        tmin = torch.minimum(torch.minimum(v0[tri], v1[tri]), v2[tri])
        tmax = torch.maximum(torch.maximum(v0[tri], v1[tri]), v2[tri])
        leaf_min = torch.where(real, tmin, inf).amin(dim=1) - 1e-7
        leaf_max = torch.where(real, tmax, -inf).amax(dim=1) + 1e-7
        bmin = torch.cat([torch.full((self.n_int, 3), float("inf"), device=dev), leaf_min])
        bmax = torch.cat([torch.full((self.n_int, 3), -float("inf"), device=dev), leaf_max])
        if self.n_int:
            for _ in range(depth):
                bmin = torch.cat([torch.minimum(bmin[self.left], bmin[self.right]),
                                  bmin[self.n_int:]])
                bmax = torch.cat([torch.maximum(bmax[self.left], bmax[self.right]),
                                  bmax[self.n_int:]])
        self.bmin, self.bmax = bmin, bmax
        self._walks: dict = {}  # (lanes, any_hit) -> the walk's buffers
        self._graphs: dict = {}  # (lanes, any_hit) -> its captured steps (on the card)

    def _steps(self, q: dict, any_hit: bool) -> None:
        """SYNC_EVERY traversal steps of every lane of the walk ``q`` (its
        rays and state, updated in place): a lane pops a node and tests a
        leaf's triangles or an internal node's two child boxes."""
        lane, stack = q["lane"], q["stack"]
        sp, best_t, best_tri = q["sp"], q["best_t"], q["best_tri"]
        best_u, best_v = q["best_u"], q["best_v"]
        o, d, inv_dir, t_max = q["origin"], q["direction"], q["inv_dir"], q["t_max"]
        for _ in range(SYNC_EVERY):
            active = sp > 0
            sp_pop = (sp - 1).clamp_min(0)
            node = torch.where(active, stack[lane, sp_pop], 0)
            sp = torch.where(active, sp_pop, sp)
            is_leaf = node >= self.n_int

            # leaf lanes: up to LEAF triangles
            tri = self.clusters[(node - self.n_int).clamp(0, self.clusters.shape[0] - 1)]
            tc = tri.clamp_min(0)
            cap = t_max if any_hit else torch.minimum(best_t, t_max)
            hit, t, u, v = ray_triangle(o[:, None], d[:, None], self.v0[tc], self.v1[tc],
                                        self.v2[tc], t_max=cap[:, None])
            hit = hit & (tri >= 0) & (active & is_leaf)[:, None]
            if any_hit:
                done = hit.any(dim=1)
                best_tri = torch.where(done, 0, best_tri)
                sp = torch.where(done, 0, sp)
            else:
                t = torch.where(hit, t, float("inf"))
                k = torch.argmin(t, dim=1)
                kt = t[lane, k]
                take = kt < best_t
                best_t = torch.where(take, kt, best_t)
                best_tri = torch.where(take, tc[lane, k], best_tri)
                best_u = torch.where(take, u[lane, k], best_u)
                best_v = torch.where(take, v[lane, k], best_v)
            if self.n_int == 0:
                continue

            # internal lanes: two child boxes, the far one pushed first
            inode = node.clamp(0, self.n_int - 1)
            lc, rc = self.left[inode], self.right[inode]
            cap = t_max if any_hit else torch.minimum(best_t, t_max)
            kids = torch.stack([lc, rc], dim=1)
            hit2, t2 = ray_aabb(o[:, None], inv_dir[:, None], self.bmin[kids], self.bmax[kids],
                                t_max=cap[:, None])
            internal = active & ~is_leaf
            left_near = t2[:, 0] <= t2[:, 1]
            for push, child in ((internal & torch.where(left_near, hit2[:, 1], hit2[:, 0]),
                                 torch.where(left_near, rc, lc)),
                                (internal & torch.where(left_near, hit2[:, 0], hit2[:, 1]),
                                 torch.where(left_near, lc, rc))):
                at = sp.clamp(max=STACK_DEPTH - 1)
                stack[lane, at] = torch.where(push, child, stack[lane, at])
                sp = torch.where(push, (sp + 1).clamp(max=STACK_DEPTH), sp)
        for name, value in (("sp", sp), ("best_t", best_t), ("best_tri", best_tri),
                            ("best_u", best_u), ("best_v", best_v)):
            q[name].copy_(value)

    def _walk(self, rays: Rays, mask: torch.Tensor, any_hit: bool):
        """Step every lane until none holds a stack entry. On the card the
        SYNC_EVERY steps are one CUDA graph, captured once per lane count
        and kind of query and replayed on its buffers (the steps are
        hundreds of small launches); elsewhere they run as they are."""
        n = rays.origin.shape[0]
        dev = rays.origin.device
        key = (n, any_hit)
        q = self._walks.get(key)
        if q is None:
            q = dict(lane=torch.arange(n, device=dev),
                     stack=torch.zeros((n, STACK_DEPTH), dtype=torch.int64, device=dev),
                     sp=torch.zeros(n, dtype=torch.int64, device=dev),
                     best_t=torch.zeros(n, device=dev),
                     best_tri=torch.zeros(n, dtype=torch.int64, device=dev),
                     best_u=torch.zeros(n, device=dev), best_v=torch.zeros(n, device=dev),
                     origin=torch.zeros((n, 3), device=dev),
                     direction=torch.zeros((n, 3), device=dev),
                     inv_dir=torch.zeros((n, 3), device=dev), t_max=torch.zeros(n, device=dev))
            self._walks[key] = q
        q["origin"].copy_(rays.origin)
        q["direction"].copy_(rays.direction)
        q["inv_dir"].copy_(safe_inv_dir(rays.direction))
        q["t_max"].copy_(rays.max_distance)

        def reset():
            q["stack"].zero_()  # the root, 0, on every lane's stack
            q["sp"].copy_(mask.to(torch.int64))
            q["best_t"].fill_(float("inf"))
            q["best_tri"].fill_(-1)
            q["best_u"].zero_()
            q["best_v"].zero_()

        run = lambda: self._steps(q, any_hit)  # noqa: E731
        if dev.type == "cuda":
            graph = self._graphs.get(key)
            if graph is None:
                reset()
                side = torch.cuda.Stream(dev)
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side):
                    self._steps(q, any_hit)  # warm-up before capture
                torch.cuda.current_stream(dev).wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    self._steps(q, any_hit)
                self._graphs[key] = graph
            run = graph.replay
        reset()
        while bool((q["sp"] > 0).any()):
            run()
        return (q["best_t"].clone(), q["best_tri"].clone(), q["best_u"].clone(),
                q["best_v"].clone())

    def closest_hit(self, rays: Rays, mask: torch.Tensor) -> Hits:
        """The closest hit of each ray where ``mask`` holds (a miss elsewhere)."""
        t, tri, u, v = self._walk(rays, mask, any_hit=False)
        return Hits(t=t, triangle=tri.to(torch.int32), u=u, v=v)

    def any_hit(self, rays: Rays, mask: torch.Tensor) -> torch.Tensor:
        """Whether each ray where ``mask`` holds hits a triangle within
        ``rays.max_distance``."""
        return self._walk(rays, mask, any_hit=True)[1] >= 0
