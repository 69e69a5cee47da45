"""The one place that decides which path a BVH takes.

A flat single-level table (``wide.WideBVH``) is refit over the frame's world
triangles and traced by ``wide`` (kernel K3); a two-level BVH
(``twolevel.TwoLevelBVH``) is refit over the object-space positions and the
instance transforms and traced by ``twolevel`` (kernel K2). Only a two-level
BVH has a TLAS, which tells the JAX package's two apart as well
(``convert.bvh``).
"""

from __future__ import annotations

from . import twolevel, wide


def is_flat(b) -> bool:
    """Whether ``b`` is a flat single-level table (the port's or the JAX
    package's ``WideBVH``) rather than a two-level BVH."""
    return not hasattr(b, "tlas_n")


def traversal(b):
    """The module whose ``closest_hit``/``any_hit``/``trace_mixed`` trace
    ``b``."""
    return wide if is_flat(b) else twolevel


def refit(b, scene_data, geom):
    """``b`` refit to a frame's pose: a flat table over ``geom``'s world
    triangles (``render.wavefront.Geometry``), a two-level BVH over
    ``scene_data``'s object-space positions and instance transforms."""
    if is_flat(b):
        return wide.refit(b, geom.tri_v0, geom.tri_v1, geom.tri_v2)
    return twolevel.refit(b, scene_data.positions_obj, scene_data.instance_transform)
