"""Geometry-sharded rendering (the ``gp`` axis) — counterpart of
``mrt_tpu/dist/geometry.py``: for scenes whose BVH exceeds one device's
memory. The triangles are split into spatially coherent shards (contiguous
chunks of their Morton order); each rank holds and refits the flat BVH of
its own shard and that shard's per-triangle rows only; rays are replicated
over ``gp`` and each bounce's hits are combined by min-t over the axis
(``render/wavefront.combine_hits_across``).

Memory per rank, T triangles over n shards (the JAX package's model,
``mrt_tpu/dist/geometry.py:9-19``): the BVH table, leaf ids, shade rows,
motion rows and world triangle vertices, about 240 B per triangle, scale as
1/n, and so does the packed texture atlas when it is banded
(``assets/texture.py:band_atlas``); the vertex pools, indices, the
global-to-local map (4 B per triangle), materials and lights stay
replicated.

Shading: the winning triangle's rows may live on another rank, so each rank
gathers the rows it owns and a psum rebuilds them everywhere
(``wavefront._tri_rows``); every rank then shades the same lanes alike.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..assets import texture as tex
from ..bvh import lbvh, wide
from ..core import types as T
from ..core.device import resolve as resolve_device
from ..engine import renderer as renderer_mod
from ..engine import scene as scene_mod
from ..kernels import refit as refit_k
from ..render import accumulate as acc
from ..render import wavefront as wf
from . import comm
from .sharding import RowBlocks


def shard_triangles(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
                    n_shards: int) -> list[np.ndarray]:
    """Partition triangle ids into ``n_shards`` spatially coherent groups
    (contiguous chunks of the Morton ordering), each sorted."""
    centroids = (v0 + v1 + v2) / 3.0
    codes = lbvh.morton_codes(centroids, centroids.min(axis=0), centroids.max(axis=0))
    order = np.argsort(codes, kind="stable")
    return [np.sort(chunk).astype(np.int32) for chunk in np.array_split(order, n_shards)]


def _equalized(child, leaf, tri_ids, n_internal: int, n_leaf: int, depth: int, ts: int, device):
    """One shard's topology padded to the shapes every shard shares:
    (flat WideBVH with a zero table, gids (ts,), row_gids (n_leaf, LEAF_K)).
    Leaf ids stay shard-local (the refit gathers the shard's vertices);
    ``row_gids`` holds the global ids the leaf rows encode. Padded internal
    rows have no child and padded leaves no triangle: no traversal reaches
    them (the padded leaves turn NaN in a refit; the refit kernel writes the
    padded internal rows apart, ``kernels/refit.py:Walkup``). The stack
    comes from the shared ``depth``, as the JAX package's stacked shards
    take it."""
    ni, nl = child.shape[0], leaf.shape[0]
    pad_i, pad_l = n_internal - ni, n_leaf - nl
    child = np.where(child >= ni, child + pad_i, child)
    child = np.concatenate([child, np.full((pad_i, wide.ARITY), -1, np.int32)]).astype(np.int32)
    leaf_local = np.concatenate([leaf, np.full((pad_l, wide.LEAF_K), -1, np.int32)])
    leaf_local = leaf_local.astype(np.int32)
    row_g = np.where(leaf_local >= 0, tri_ids[np.clip(leaf_local, 0, None)], -1).astype(np.int32)
    gids = np.full(ts, -1, np.int32)
    gids[: len(tri_ids)] = tri_ids
    bvh = wide.WideBVH(
        table=torch.zeros((n_internal + n_leaf, wide.ROW), dtype=torch.float32, device=device),
        node_child=torch.as_tensor(child).to(device),
        leaf_tri=torch.as_tensor(leaf_local).to(device), n_internal=n_internal, depth=depth,
        walkup=refit_k.flat_walkup(child, n_leaf, device))
    return bvh, torch.as_tensor(gids).to(device), torch.as_tensor(row_g).to(device)


def build_sharded_bvhs(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray, n_shards: int, device=None):
    """Every shard's flat BVH over the (T,3) world-space triangles, with
    equal shapes. Returns (list of (WideBVH, gids, row_gids) by shard, the
    shards' triangle id lists). The renderer builds only its own shard
    (``build_rank_shard``)."""
    device = resolve_device(device)
    shards = shard_triangles(v0, v1, v2, n_shards)
    built = [wide.topology(v0[ids], v1[ids], v2[ids])[:3] for ids in shards]
    ni = max(c.shape[0] for c, _, _ in built)
    nl = max(lf.shape[0] for _, lf, _ in built)
    depth = max(d for _, _, d in built)
    ts = max(len(s) for s in shards)
    return [_equalized(c, lf, ids, ni, nl, depth, ts, device)
            for (c, lf, _), ids in zip(built, shards)], shards


def build_rank_shard(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray, device, axis: comm.Axis):
    """Shard ``axis.index`` of ``axis.size`` on ``device``, as
    ``build_sharded_bvhs`` builds it, with only this rank's topology built:
    the shared shapes come from a max over ``axis``. Returns (WideBVH,
    gids, row_gids)."""
    device = resolve_device(device)
    ids = shard_triangles(v0, v1, v2, axis.size)[axis.index]
    child, leaf, depth, _ = wide.topology(v0[ids], v1[ids], v2[ids])
    sizes = comm.pmax(torch.tensor([child.shape[0], leaf.shape[0], depth, len(ids)],
                                   dtype=torch.int64, device=device), axis)
    ni, nl, depth, ts = (int(x) for x in sizes.tolist())
    return _equalized(child, leaf, ids, ni, nl, depth, ts, device)


def build_shard_geometry(scene: scene_mod.SceneData, pos_w, prev_w, nrm_w, gids: torch.Tensor,
                         n_tris_global: int, axis: comm.Axis) -> wf.Geometry:
    """Shard-local Geometry: per-triangle rows for this rank's ``gids`` only
    (padded slots give rows of triangle 0 that no hit selects: ``g2l``
    routes every real hit to its owner)."""
    valid = gids >= 0
    tid = gids.clamp_min(0).long()
    idx = scene.indices[tid].long()  # (Ts,3)

    def g(pool, col):
        return pool[idx[:, col]]

    v0, v1, v2 = g(pos_w, 0), g(pos_w, 1), g(pos_w, 2)
    n0, n1, n2 = g(nrm_w, 0), g(nrm_w, 1), g(nrm_w, 2)
    uv0, uv1, uv2 = g(scene.uvs, 0), g(scene.uvs, 1), g(scene.uvs, 2)
    res_f = scene.tri_resource[tid].to(torch.float32)
    shade_rows = torch.cat([n0, n1, n2, uv0, uv1, uv2, res_f[:, None]], dim=1)
    p0, p1, p2 = g(prev_w, 0), g(prev_w, 1), g(prev_w, 2)
    motion_rows = torch.cat([v0, v1, v2, p0, p1, p2], dim=1)
    g2l = torch.full((n_tris_global,), -1, dtype=torch.int32, device=gids.device)
    g2l[gids[valid].long()] = torch.arange(gids.shape[0], dtype=torch.int32,
                                           device=gids.device)[valid]
    return wf.Geometry(pos_w, prev_w, nrm_w, v0, v1, v2, shade_rows, motion_rows,
                       wf.pack_mat_rows(scene.materials), g2l=g2l, axis=axis)


def gp_settings(settings: T.RenderSettings, statics, banded: bool) -> T.RenderSettings:
    """The gp step's settings: the flat BVH on the ``gp`` axis, no priming,
    and mipmaps off only when the atlas is banded (the bands hold the
    packed level-0 texels only). Raises for a scene with geometry masks."""
    if statics.has_masks:
        raise ValueError(
            "geometry masks require the two-level backend; the gp-sharded "
            "step runs the flat wide BVH, which has no per-instance mask "
            "filtering — remove the non-default geometry_mask or render "
            "single-device/dp")
    overrides = dict(geometry_axis="gp", two_level=False, hit_priming=False)
    if banded:
        overrides["use_mipmaps"] = False
    return dataclasses.replace(settings, **overrides)


class GeometryShardedRenderer(RowBlocks):
    """The frame loop of the gp-sharded path, on a ``("gp",)`` mesh (default:
    every rank) or a combined ``("dp", "gp")`` mesh, whose image rows shard
    over dp while the geometry shards over gp. Each frame poses the scene
    (replicated skinning), builds this rank's shard geometry, refits its
    shard table (``wide.refit`` with the global ``row_gids``), traces its
    row block and accumulates. ``banded`` (the JAX package's default for a
    scene with an atlas, which every compiled scene has) keeps only this
    rank's band of the packed atlas.
    ``offsets``, ``seed`` and ``device`` as ``DistributedRenderer``'s."""

    def __init__(self, scene: scene_mod.Scene, settings: T.RenderSettings,
                 mesh: comm.Mesh | None = None, banded: bool = True, seed: int = 0,
                 offsets=None, device=None):
        self.mesh = mesh if mesh is not None else comm.Mesh({"gp": comm.world()[1]}, device)
        if "gp" not in self.mesh.shape:
            raise ValueError(f"the mesh {self.mesh.shape} has no 'gp' axis")
        self.device = self.mesh.device
        self.scene = scene
        sd, self.statics = scene.compile(self.device)
        gp = self.mesh.axis("gp")
        self.banded = banded
        self.settings = gp_settings(settings, self.statics, banded)
        v0, v1, v2 = renderer_mod.world_triangles(scene, sd)
        self.bvh, self.gids, self.row_gids = build_rank_shard(v0, v1, v2, self.device, gp)
        if self.banded:
            sd = sd._replace(atlas=tex.atlas_band(sd.atlas, gp.size, gp.index))
        self.scene_data = sd
        self._init_rows(scene, self.mesh, seed, offsets)

    def draw(self) -> torch.Tensor:
        """Render one frame; returns the full (H,W,3) accumulation."""
        settings = self.settings
        uniforms = self._uniforms()
        gp = self.mesh.axis("gp")
        sd = renderer_mod.pose(self.statics, self.scene_data, self.skin_bundle,
                               self._joint_matrices)
        pos_w, prev_w, nrm_w = scene_mod.world_geometry(sd)
        geom = build_shard_geometry(sd, pos_w, prev_w, nrm_w, self.gids, self.statics.n_triangles,
                                    gp)
        bvh = wide.refit(self.bvh, geom.tri_v0, geom.tri_v1, geom.tri_v2, row_ids=self.row_gids)
        out = wf.trace_frame(settings, self.statics, sd, bvh, geom, uniforms, self.offsets,
                             self.motion, y0=self.y0)
        self.accum = acc.accumulate(settings, uniforms, out.color, out.motion, self.motion,
                                    self.accum)
        self.depth, self.motion = out.depth, out.motion
        # every gp rank traced the same lanes: the sum over gp over n_gp is
        # one rank's count; the dp row blocks add up
        self.last_rays_local = out.rays_traced.sum(dtype=torch.int64)
        self.last_rays_traced = comm.psum(comm.psum(self.last_rays_local, gp) // gp.size,
                                          self.mesh.axis("dp"))
        self.frame_index += 1
        return self.gather(self.accum)
