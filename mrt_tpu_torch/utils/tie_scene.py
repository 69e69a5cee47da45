"""A flat scene where K3's ties happen: equal t between a leaf's slots, equal
entry distances between an internal row's children, hits at exactly a ray's
tmax and at t = 0.

    v0, v1, v2, rays = tie_scene(seed)

The triangles lie on an integer grid: ``layers`` floors of ``n`` x ``n``
unit quads (y = 0, 2, 4, ...), each quad two triangles sharing its diagonal,
and every triangle twice, the second time with its vertices rotated (the
same t, other u and v) in the same leaf; walls at x = 0, n/2 and n share the
floors' grid lines. The rays are aimed at grid vertices (where up to twelve
triangles meet), edge midpoints and quad centres, from origins above the
scene, between its floors (inside several children's boxes: their entry
distances clamp to 0), on a floor plane (t = 0), and straight down onto
vertices and edges (zero direction components, some of them -0.0). Every
coordinate is a multiple of 1/4 and every direction a difference of two such
points, so the leaf test's products are exact and a fused multiply-add
rounds as separate ones do. Half the rays are shadow rays, their tmax
exactly their target's t (1.0) or inf; one in ten is inactive.
"""

from __future__ import annotations

import numpy as np


def triangles(n: int = 8, layers: int = 3) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(v0, v1, v2), each (T, 3) float32: the floors (each triangle twice,
    the copy's vertices rotated) and the walls."""
    tris = []
    for layer in range(layers):
        y = 2.0 * layer
        for i in range(n):
            for j in range(n):
                p00, p10 = (i, y, j), (i + 1, y, j)
                p11, p01 = (i + 1, y, j + 1), (i, y, j + 1)
                for a, b, c in ((p00, p10, p11), (p00, p11, p01)):
                    tris += [(a, b, c), (b, c, a)]
    top = 2.0 * (layers - 1)
    for x in (0, n // 2, n):
        for j in range(n):
            q0, q1 = (x, 0.0, j), (x, 0.0, j + 1)
            q2, q3 = (x, top, j + 1), (x, top, j)
            tris += [(q0, q1, q2), (q0, q2, q3)]
    arr = np.asarray(tris, np.float32)
    return tuple(np.ascontiguousarray(arr[:, k]) for k in range(3))


def rays(count: int = 4096, n: int = 8, layers: int = 3, seed: int = 0):
    """(origin (R, 3), direction (R, 3), tmax (R,), shadow (R,), active (R,))
    as float32 and bool NumPy arrays, from ``seed``."""
    rng = np.random.default_rng(seed)
    top = 2.0 * (layers - 1)
    kind = rng.integers(0, 4, count)
    # targets: a vertex, an edge midpoint or a quad centre of a random floor
    tx = rng.integers(0, n + 1, count) + rng.choice([0.0, 0.0, 0.5], count)
    tz = rng.integers(0, n + 1, count) + rng.choice([0.0, 0.5, 0.5], count)
    ty = 2.0 * rng.integers(0, layers, count)
    target = np.stack([tx, ty, tz], 1)
    quarter = lambda lo, hi: np.floor(rng.uniform(lo, hi, count) * 4.0) / 4.0  # noqa: E731
    origin = np.stack([quarter(-1.0, n + 1.0), np.full(count, top + 1.5), quarter(-1.0, n + 1.0)], 1)
    # between two floors: inside several children's boxes
    between = kind == 1
    origin[between, 1] = 2.0 * rng.integers(0, max(layers - 1, 1), int(between.sum())) + 1.0
    # on a floor plane: hits at t = 0
    on_floor = kind == 2
    origin[on_floor, 1] = 2.0 * rng.integers(0, layers, int(on_floor.sum()))
    direction = target - origin
    # straight down (or up) onto the target's vertex or edge, from above it
    down = kind == 3
    origin[down] = target[down]
    origin[down, 1] = top + 1.5
    direction[down] = np.array([0.0, -1.0, 0.0])
    direction[down & (rng.random(count) < 0.5)] *= np.array([-0.0, 1.0, -0.0])
    direction[on_floor & (rng.random(count) < 0.25), 1] = 0.0  # in the floor's plane
    zero = np.all(direction == 0.0, axis=1)
    direction[zero] = np.array([0.0, -1.0, 0.0])
    shadow = rng.random(count) < 0.5
    tmax = np.where(shadow & (rng.random(count) < 0.7), 1.0, np.inf)
    # rays straight down reach the target at t = its height above it
    tmax = np.where(down & (tmax == 1.0), origin[:, 1] - target[:, 1], tmax)
    active = rng.random(count) < 0.9
    return (origin.astype(np.float32), direction.astype(np.float32), tmax.astype(np.float32),
            shadow, active)


def tie_scene(seed: int = 0, count: int = 4096, n: int = 8, layers: int = 3):
    """The triangles and ``count`` rays: ``(v0, v1, v2, rays(...))``."""
    return triangles(n, layers) + (rays(count, n, layers, seed),)
