"""Two-level BVH (BLAS/TLAS with instancing) — counterpart of
``mrt_tpu/bvh/twolevel.py``.

One unified table of 128-float rows: TLAS internal rows first, then every
BLAS's internal rows, then all leaf rows, then one row per instance
({world->object 3x4 inverse, world AABB, BLAS root, instance id, mask}).
The host build and the row layout are the JAX package's, so for the same
scene the tables are equal. Under ``MRT_SBVH=1`` the static groups are
built with SBVH reference splits, as the JAX package builds them: the BVH
then holds per-leaf clip boxes (``leaf_clip``, +-inf for the other groups)
that every refit intersects with the leaf boxes. An instance's geometry
mask is tested against the ray's mask on its instance row, only when some
instance has a
non-default mask (``has_masks``). A skinned instance gets a BLAS of its own;
``refit`` rewrites every skinned BLAS from the posed vertex pool (kernel
K4 ``blas``), then the instance and TLAS rows (kernel K5), and at build
time every BLAS (``kernels/refit.py``).
Traversal runs kernel K2 (``kernels/traverse2.py``).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..core.types import GEOMETRY_MASK_GEOMETRY, Hits, Rays
from ..kernels import refit as refit_k
from ..kernels import traverse2
from . import lbvh
from .wide import ARITY, LEAF_K, ROW, _stack_alloc, build_topology_wide, exact_stack_bound

# instance-row layout (floats)
_I_MINV = 0  # 12: rows of the 3x4 world->object affine
_I_WBMIN = 12
_I_WBMAX = 15
_I_ROOT = 18
_I_ID = 19
_I_MASK = 20


@dataclasses.dataclass
class TwoLevelBVH:
    """Unified two-level table + refit metadata (tensors on one device)."""

    table: torch.Tensor  # (N, ROW) f32
    node_child: torch.Tensor  # (NI, ARITY) int32 global entry ids
    leaf_tri: torch.Tensor  # (NL, LEAF_K) int32 LOCAL mesh tri ids
    root_bmin: torch.Tensor  # (G, 3) per-mesh-group root AABB (object)
    root_bmax: torch.Tensor
    flat_tri_base: torch.Tensor  # (I,) int32 flat tri base per instance
    n_internal: int
    n_leaf: int
    n_instances: int
    tlas_n: int
    tlas_depth: int
    # per mesh group: (int_lo, int_len, leaf_lo, leaf_len, depth, root_entry,
    #                  v_start, v_count, skin_slot or -1)
    mesh_meta: tuple
    inst_mesh: tuple  # (I,) group ids
    stack_bound: int
    inst_masks: tuple
    # one (Tm,3) local index tensor per SKINNED group, by skin_slot
    skin_indices: tuple = ()
    # SBVH: (NL, 6) f32 per-leaf clip boxes [min xyz, max xyz] (+-inf rows
    # clip nothing), or None when no group was built with spatial splits
    leaf_clip: torch.Tensor | None = None
    # what the refit kernels read besides the table
    # (``kernels/refit.py:TwoLevelMeta``), made where the BVH is made; a
    # refit on the card needs it
    refit_meta: object | None = None

    def _replace(self, **kw) -> "TwoLevelBVH":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "TwoLevelBVH":
        """The same BVH with every tensor on ``device``."""
        return self._replace(**{f.name: getattr(self, f.name).to(device)
                                for f in dataclasses.fields(self)
                                if hasattr(getattr(self, f.name), "to")},
                             skin_indices=tuple(t.to(device) for t in self.skin_indices))

    @property
    def has_masks(self) -> bool:
        """True when some instance has a non-default geometry mask: only then
        do traversals take ray masks (and K2 its masked variant)."""
        return any(m != GEOMETRY_MASK_GEOMETRY for m in self.inst_masks)

    @property
    def stack_size(self) -> int:
        """Traversal stack entries a lane needs (exact worst case)."""
        return _stack_alloc(self.stack_bound,
                            self.tlas_depth + 1 + max(m[4] for m in self.mesh_meta))


# ---------------------------------------------------------------------------
# Host build
# ---------------------------------------------------------------------------

def _tlas_topology(n_inst: int):
    """Wide TLAS topology over instance ids: preorder internal nodes, each a
    list of ('I', internal idx) / ('L', instance idx) children."""
    nodes: list = []

    def build(ids):
        nodes.append(None)
        me = len(nodes) - 1
        if len(ids) <= ARITY:
            nodes[me] = [("L", i) for i in ids]
            return me
        per = -(-len(ids) // ARITY)
        children = []
        for k in range(0, len(ids), per):
            sub = ids[k : k + per]
            if len(sub) == 1:
                children.append(("L", sub[0]))
            else:
                children.append(("I", build(sub)))
        nodes[me] = children
        return me

    build(list(range(n_inst)))
    d = [1] * len(nodes)
    for i in range(len(nodes) - 1, -1, -1):
        for kind, c in nodes[i]:
            if kind == "I":
                d[i] = max(d[i], d[c] + 1)
    return nodes, d[0]


def _mesh_topology(obj_tris: np.ndarray, method: str, spatial: bool = False):
    """(Tm,9) object-space tris -> (node_child_local, leaf_tri, depth,
    leaf_clip or None). ``method``: "sah" (native binned-SAH builder; with
    ``spatial``, SBVH reference splits and their clip boxes) or "lbvh"
    (Karras tree)."""
    if method == "sah":
        from ..utils import native

        return native.build_wide_bvh_sah(obj_tris, ARITY, LEAF_K, spatial=spatial)
    if method != "lbvh":
        raise ValueError(f"unknown BVH build method {method!r}")
    centroids = (obj_tris[:, 0:3] + obj_tris[:, 3:6] + obj_tris[:, 6:9]) / 3.0
    bl, br, _, order, _ = lbvh.build_topology(centroids)
    return (*build_topology_wide(bl, br, order), None)


def build(models, scene_data, host_mirror: dict, method: str = "sah") -> TwoLevelBVH:
    """Host-side build over a compiled scene (``host_mirror`` is
    ``Scene.host_mirror`` from ``Scene.compile``), then a full refit on the
    scene's device. Models with a ``skin`` get exclusive mesh groups: their
    pose is refit every frame. With ``MRT_SBVH=1`` (read at each build) the
    static groups take SBVH spatial splits (off by default, as in the JAX
    package, where it measured a loss: docs/PERF.md round 4h)."""
    vertex_instance = host_mirror["vertex_instance"]
    tri_instance = host_mirror["tri_instance"]
    n_inst = len(models)
    v_starts = np.searchsorted(vertex_instance, np.arange(n_inst))
    flat_tri_base = np.searchsorted(tri_instance, np.arange(n_inst)).astype(np.int32)

    groups: list = []
    by_mesh: dict = {}
    inst_group = np.zeros(n_inst, np.int32)
    for i, m in enumerate(models):
        skinned = getattr(m, "skin", None) is not None
        key = ("skin", i) if skinned else id(m.mesh)
        if key in by_mesh:
            groups[by_mesh[key]]["insts"].append(i)
            inst_group[i] = by_mesh[key]
            continue
        idx_local = np.concatenate([s.indices.reshape(-1, 3) for s in m.mesh.submeshes]).astype(np.int32)
        groups.append(dict(insts=[i], v_start=int(v_starts[i]), indices_local=idx_local,
                           positions=m.mesh.positions, skinned=skinned))
        by_mesh[key] = len(groups) - 1
        inst_group[i] = len(groups) - 1

    tlas_nodes, tlas_depth = _tlas_topology(n_inst)
    tlas_n = len(tlas_nodes)
    # SBVH splits for static groups only: a skinned group re-poses every
    # frame, and a clip box holds only for the vertices the builder saw
    sbvh = os.environ.get("MRT_SBVH", "0") == "1"
    topos = []
    for g in groups:
        pos = np.asarray(g["positions"], np.float32)
        idx = g["indices_local"]
        tris = np.concatenate([pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]], axis=1)
        topos.append(_mesh_topology(tris, method, spatial=sbvh and not g["skinned"]))

    n_int_total = tlas_n + sum(t[0].shape[0] for t in topos)
    n_leaf_total = sum(t[1].shape[0] for t in topos)
    inst_base = n_int_total + n_leaf_total

    node_child = np.full((n_int_total, ARITY), -1, np.int32)
    leaf_tri = np.full((n_leaf_total, LEAF_K), -1, np.int32)
    leaf_clip = None
    if any(t[3] is not None for t in topos):  # +-inf: no clamp in the other groups
        leaf_clip = np.full((n_leaf_total, 6), np.inf, np.float32)
        leaf_clip[:, :3] = -np.inf
    device = scene_data.positions_obj.device
    mesh_meta = []
    skin_indices = []
    int_cursor = tlas_n
    leaf_cursor = 0
    for g, (child, leaf, depth, clip) in zip(groups, topos):
        ni, nl = child.shape[0], leaf.shape[0]
        if clip is not None:
            leaf_clip[leaf_cursor : leaf_cursor + nl] = clip
        c = child.copy()
        is_int = (c >= 0) & (c < ni)
        is_lf = c >= ni
        c[is_int] += int_cursor
        c[is_lf] = n_int_total + leaf_cursor + (c[is_lf] - ni)
        node_child[int_cursor : int_cursor + ni] = c
        leaf_tri[leaf_cursor : leaf_cursor + nl] = leaf
        root_entry = int_cursor if ni > 0 else n_int_total + leaf_cursor
        skin_slot = -1
        if g["skinned"]:
            skin_slot = len(skin_indices)
            skin_indices.append(torch.as_tensor(g["indices_local"]).to(device))
        mesh_meta.append((int_cursor, ni, leaf_cursor, nl, depth, root_entry,
                          g["v_start"], int(np.asarray(g["positions"]).shape[0]), skin_slot))
        int_cursor += ni
        leaf_cursor += nl

    for t, children in enumerate(tlas_nodes):
        for j, (kind, c) in enumerate(children):
            node_child[t, j] = c if kind == "I" else inst_base + c

    def _kids(n):
        if n < n_int_total:
            return [int(c) for c in node_child[n] if c >= 0]
        if n >= inst_base:
            return [int(mesh_meta[inst_group[n - inst_base]][5])]
        return []

    stack_bound = exact_stack_bound(_kids) if n_int_total else 1
    inst_masks = tuple(int(getattr(m, "geometry_mask", GEOMETRY_MASK_GEOMETRY)) for m in models)

    bvh = TwoLevelBVH(
        table=torch.zeros((inst_base + n_inst, ROW), dtype=torch.float32, device=device),
        node_child=torch.as_tensor(node_child).to(device),
        leaf_tri=torch.as_tensor(leaf_tri).to(device),
        root_bmin=torch.zeros((len(groups), 3), dtype=torch.float32, device=device),
        root_bmax=torch.zeros((len(groups), 3), dtype=torch.float32, device=device),
        flat_tri_base=torch.as_tensor(flat_tri_base).to(device),
        n_internal=n_int_total,
        n_leaf=n_leaf_total,
        n_instances=n_inst,
        tlas_n=tlas_n,
        tlas_depth=tlas_depth,
        mesh_meta=tuple(mesh_meta),
        inst_mesh=tuple(int(x) for x in inst_group),
        stack_bound=stack_bound,
        inst_masks=inst_masks,
        skin_indices=tuple(skin_indices),
        leaf_clip=None if leaf_clip is None else torch.as_tensor(leaf_clip).to(device),
        refit_meta=refit_k.twolevel_meta(node_child, tlas_n, n_leaf_total, mesh_meta, inst_group,
                                         inst_masks, skin_indices, device),
    )
    all_indices = tuple(torch.as_tensor(g["indices_local"]).to(device) for g in groups)
    return refit(bvh, scene_data.positions_obj, scene_data.instance_transform,
                 group_indices=all_indices)


# ---------------------------------------------------------------------------
# Refit (kernels K4 and K5)
# ---------------------------------------------------------------------------

def refit(bvh: TwoLevelBVH, positions_obj, instance_transform, *,
          group_indices: tuple | None = None) -> TwoLevelBVH:
    """Rewrite every skinned BLAS (``skin_slot >= 0``) from the object-space
    vertex pool ``positions_obj`` (V,3), then the instance rows and the TLAS
    rows from ``instance_transform`` (I,4,4); with ``group_indices`` (one
    (Tm,3) local index tensor per mesh group, as at build time) every BLAS
    is refit. Static BLASes are never refit per frame. Kernels K4 ``blas``
    and K5 on the card (``kernels/refit.py``), their plain versions on the
    CPU. Returns a new BVH; the input's table is not modified (the whole
    table is copied first)."""
    table, rbmin, rbmax = refit_k.twolevel(bvh, positions_obj, instance_transform, group_indices)
    return bvh._replace(table=table, root_bmin=rbmin, root_bmax=rbmax)


# ---------------------------------------------------------------------------
# Traversal (kernel K2)
# ---------------------------------------------------------------------------

def _traverse(bvh: TwoLevelBVH, rays: Rays, shadow, mask, t_min: float, ray_mask=None):
    n = rays.origin.shape[0]
    dev = rays.origin.device
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=dev)
    return traverse2.traverse(
        bvh.table, bvh.n_internal, bvh.n_leaf, bvh.tlas_n, bvh.stack_size,
        rays.origin.contiguous(), rays.direction.contiguous(),
        rays.max_distance.contiguous(), shadow.contiguous(), mask.contiguous(), t_min,
        ray_mask=None if ray_mask is None else ray_mask.contiguous())


def _hits(bvh: TwoLevelBVH, out) -> Hits:
    return traverse2.hits_of(out, bvh.flat_tri_base)


# ``ray_mask``: optional (R,) int32 per-ray mask bits; an instance whose
# geometry mask shares no bit with a ray's mask is skipped by that ray
# (Raytracing.metal:733-735). None: no filtering.

def closest_hit(bvh: TwoLevelBVH, rays: Rays, t_min: float = 0.0, mask=None,
                ray_mask=None) -> Hits:
    """Closest hit per ray; triangle ids are FLAT (instance tri base + local)."""
    shadow = torch.zeros(rays.origin.shape[0], dtype=torch.bool, device=rays.origin.device)
    return _hits(bvh, _traverse(bvh, rays, shadow, mask, t_min, ray_mask))


def closest_raw(bvh: TwoLevelBVH, rays: Rays, flags, mask=None,
                ray_mask=None) -> traverse2.TraverseOut:
    """The closest-hit traversal's own record (LOCAL triangle and instance
    ids; t is the ray's max distance on a miss), for a caller that reads it
    itself, as the wavefront's K7 does (``traverse2.hits_of`` gives
    ``closest_hit``'s record from it). ``flags``: an all-False (R,) bool,
    the traversal's shadow flags, made once by a caller that traces many
    batches."""
    return _traverse(bvh, rays, flags, mask, 0.0, ray_mask)


def trace_mixed(bvh: TwoLevelBVH, rays: Rays, shadow, t_min: float = 0.0, mask=None,
                ray_mask=None):
    """One traversal over a mixed batch: ``shadow`` lanes retire at their first
    hit, the others find the closest. Returns (Hits, occluded)."""
    out = _traverse(bvh, rays, shadow, mask, t_min, ray_mask)
    return _hits(bvh, out), out.found & shadow


def any_hit(bvh: TwoLevelBVH, rays: Rays, t_min: float = 0.0, mask=None,
            ray_mask=None, flags=None) -> torch.Tensor:
    """Occlusion per ray within ``rays.max_distance``. ``flags``: an
    all-True (R,) bool to use as the traversal's shadow flags (made once by
    a caller that traces many batches; made here if None)."""
    if flags is None:
        flags = torch.ones(rays.origin.shape[0], dtype=torch.bool, device=rays.origin.device)
    return _traverse(bvh, rays, flags, mask, t_min, ray_mask).found
