"""Karras LBVH topology — counterpart of ``mrt_tpu/bvh/lbvh.py``.

Host NumPy: a binary radix tree over 30-bit Morton codes. ``bvh.wide``
collapses it into the wide layout when a build asks for ``method="lbvh"``
instead of the native SAH builder.
"""

from __future__ import annotations

import numpy as np


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
