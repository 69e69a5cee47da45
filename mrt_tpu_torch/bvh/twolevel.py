"""Two-level BVH (BLAS/TLAS with instancing) — counterpart of
``mrt_tpu/bvh/twolevel.py``.

One unified table of 128-float rows: TLAS internal rows first, then every
BLAS's internal rows, then all leaf rows, then one row per instance
({world->object 3x4 inverse, world AABB, BLAS root, instance id, mask}).
The host build and the row layout are the JAX package's, so for the same
scene the tables are equal. An instance's geometry mask is tested against
the ray's mask on its instance row, only when some instance has a
non-default mask (``has_masks``). A skinned instance gets a BLAS of its own;
``refit`` rewrites every skinned BLAS from the posed vertex pool, then the
instance and TLAS rows (and, at build time, every BLAS), with torch ops.
Traversal runs kernel K2 (``kernels/traverse2.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.types import GEOMETRY_MASK_GEOMETRY, Hits, Rays
from ..kernels import traverse2
from . import lbvh
from .wide import ARITY, LEAF_K, ROW, _stack_alloc, build_topology_wide, encode_ids, \
    exact_stack_bound

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

    def _replace(self, **kw) -> "TwoLevelBVH":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "TwoLevelBVH":
        """The same BVH with every tensor on ``device``."""
        return self._replace(**{f.name: getattr(self, f.name).to(device)
                                for f in dataclasses.fields(self)
                                if isinstance(getattr(self, f.name), torch.Tensor)},
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


def _mesh_topology(obj_tris: np.ndarray, method: str):
    """(Tm,9) object-space tris -> (node_child_local, leaf_tri, depth).
    ``method``: "sah" (native binned-SAH builder) or "lbvh" (Karras tree)."""
    if method == "sah":
        from ..utils import native

        return native.build_wide_bvh_sah(obj_tris, ARITY, LEAF_K)
    if method != "lbvh":
        raise ValueError(f"unknown BVH build method {method!r}")
    centroids = (obj_tris[:, 0:3] + obj_tris[:, 3:6] + obj_tris[:, 6:9]) / 3.0
    bl, br, _, order, _ = lbvh.build_topology(centroids)
    return build_topology_wide(bl, br, order)


def build(models, scene_data, host_mirror: dict, method: str = "sah") -> TwoLevelBVH:
    """Host-side build over a compiled scene (``host_mirror`` is
    ``Scene.host_mirror`` from ``Scene.compile``), then a full refit on the
    scene's device. Models with a ``skin`` get exclusive mesh groups: their
    pose is refit every frame."""
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
    topos = []
    for g in groups:
        pos = np.asarray(g["positions"], np.float32)
        idx = g["indices_local"]
        tris = np.concatenate([pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]], axis=1)
        topos.append(_mesh_topology(tris, method))

    n_int_total = tlas_n + sum(t[0].shape[0] for t in topos)
    n_leaf_total = sum(t[1].shape[0] for t in topos)
    inst_base = n_int_total + n_leaf_total

    node_child = np.full((n_int_total, ARITY), -1, np.int32)
    leaf_tri = np.full((n_leaf_total, LEAF_K), -1, np.int32)
    device = scene_data.positions_obj.device
    mesh_meta = []
    skin_indices = []
    int_cursor = tlas_n
    leaf_cursor = 0
    for g, (child, leaf, depth) in zip(groups, topos):
        ni, nl = child.shape[0], leaf.shape[0]
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
        inst_masks=tuple(int(getattr(m, "geometry_mask", GEOMETRY_MASK_GEOMETRY)) for m in models),
        skin_indices=tuple(skin_indices),
    )
    all_indices = tuple(torch.as_tensor(g["indices_local"]).to(device) for g in groups)
    return refit(bvh, scene_data.positions_obj, scene_data.instance_transform,
                 group_indices=all_indices)


# ---------------------------------------------------------------------------
# Refit (torch ops)
# ---------------------------------------------------------------------------

def _pack_leaf_rows(w0, w1, w2, leaf_ids):
    """(nl, K, 3) leaf verts -> (nl, ROW) leaf rows + leaf AABBs."""
    pad = (leaf_ids < 0)[..., None]
    nan = torch.tensor(float("nan"), dtype=torch.float32, device=w0.device)
    w0 = torch.where(pad, nan, w0)
    w1 = torch.where(pad, nan, w1)
    w2 = torch.where(pad, nan, w2)
    comps = [w[:, :, a] for w in (w0, w1, w2) for a in range(3)]
    rows = torch.cat(comps + [encode_ids(leaf_ids)], dim=1)
    rows = torch.nn.functional.pad(rows, (0, ROW - rows.shape[1]))
    stacked = torch.stack([w0, w1, w2], dim=2)  # (nl, K, 3, 3)
    valid = ~pad[..., None]
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=w0.device)
    bmin = torch.where(valid, stacked, inf).amin(dim=(1, 2)) - 1e-7
    bmax = torch.where(valid, stacked, -inf).amax(dim=(1, 2)) + 1e-7
    return rows, bmin, bmax


def _internal_rows(child, empty, local, ebmin, ebmax, depth):
    """Bottom-up child AABB propagation (``depth`` passes over entry boxes
    ``ebmin/ebmax``, internal entries first) and the packed internal rows."""
    n = child.shape[0]
    flat = local.reshape(-1).long()
    inf = float("inf")

    def child_boxes(bmin, bmax):
        cmin = bmin[flat].reshape(n, ARITY, 3).masked_fill(empty[..., None], inf)
        cmax = bmax[flat].reshape(n, ARITY, 3).masked_fill(empty[..., None], -inf)
        return cmin, cmax

    for _ in range(depth):
        cmin, cmax = child_boxes(ebmin, ebmax)
        ebmin = torch.cat([cmin.amin(dim=1), ebmin[n:]])
        ebmax = torch.cat([cmax.amax(dim=1), ebmax[n:]])
    cmin, cmax = child_boxes(ebmin, ebmax)
    rows = torch.cat([cmin[:, :, 0], cmin[:, :, 1], cmin[:, :, 2],
                      cmax[:, :, 0], cmax[:, :, 1], cmax[:, :, 2], encode_ids(child)], dim=1)
    rows = torch.nn.functional.pad(rows, (0, ROW - rows.shape[1]))
    return rows, ebmin[0], ebmax[0]


def _refit_group(table, root_bmin, root_bmax, bvh, gi, verts, idx):
    """Rewrite one group's BLAS rows (leaf packing + internal AABBs) from
    (Vm,3) object-space verts and (Tm,3) local indices (in place)."""
    int_lo, ni, leaf_lo, nl, depth = bvh.mesh_meta[gi][:5]
    leaf_ids = bvh.leaf_tri[leaf_lo : leaf_lo + nl]
    tid = leaf_ids.clamp_min(0).reshape(-1).long()
    idx = idx.long()

    def g(col):
        return verts[idx[:, col]][tid].reshape(nl, LEAF_K, 3)

    leaf_rows, leaf_bmin, leaf_bmax = _pack_leaf_rows(g(0), g(1), g(2), leaf_ids)
    table[bvh.n_internal + leaf_lo : bvh.n_internal + leaf_lo + nl] = leaf_rows
    if ni == 0:
        root_bmin[gi] = leaf_bmin[0]
        root_bmax[gi] = leaf_bmax[0]
        return
    child = bvh.node_child[int_lo : int_lo + ni]
    empty = child < 0
    local = torch.where(child < bvh.n_internal, child - int_lo, ni + (child - bvh.n_internal - leaf_lo))
    local = torch.where(empty, 0, local).clamp(0, ni + nl - 1)
    dev = verts.device
    ebmin = torch.cat([torch.full((ni, 3), float("inf"), device=dev), leaf_bmin])
    ebmax = torch.cat([torch.full((ni, 3), -float("inf"), device=dev), leaf_bmax])
    rows, rmin, rmax = _internal_rows(child, empty, local, ebmin, ebmax, depth)
    table[int_lo : int_lo + ni] = rows
    root_bmin[gi] = rmin
    root_bmax[gi] = rmax


def _affine_inverse(M: torch.Tensor) -> torch.Tensor:
    """(I,4,4) -> (I,3,4) inverse of the affine [R|t]."""
    Rinv = torch.linalg.inv(M[:, :3, :3])
    t = M[:, :3, 3]
    tinv = -(Rinv[:, :, 0] * t[:, None, 0] + Rinv[:, :, 1] * t[:, None, 1]
             + Rinv[:, :, 2] * t[:, None, 2])
    return torch.cat([Rinv, tinv[:, :, None]], dim=2)


def refit(bvh: TwoLevelBVH, positions_obj, instance_transform, *,
          group_indices: tuple | None = None) -> TwoLevelBVH:
    """Rewrite every skinned BLAS (``skin_slot >= 0``) from the object-space
    vertex pool ``positions_obj`` (V,3), then the instance rows and the TLAS
    rows from ``instance_transform`` (I,4,4); with ``group_indices`` (one
    (Tm,3) local index tensor per mesh group, as at build time) every BLAS
    is refit. Static BLASes are never refit per frame. Returns a new BVH;
    the input's table is not modified (the whole table is copied first)."""
    table = bvh.table.clone()
    rbmin, rbmax = bvh.root_bmin.clone(), bvh.root_bmax.clone()
    for gi, meta in enumerate(bvh.mesh_meta):
        v_start, v_count, slot = meta[6], meta[7], meta[8]
        if slot >= 0:
            idx = bvh.skin_indices[slot]
        elif group_indices is not None:
            idx = group_indices[gi]
        else:
            continue
        _refit_group(table, rbmin, rbmax, bvh, gi, positions_obj[v_start : v_start + v_count], idx)

    # --- instance rows --------------------------------------------------------
    I = bvh.n_instances
    dev = table.device
    M = instance_transform
    minv = _affine_inverse(M)
    gidx = torch.as_tensor(bvh.inst_mesh, dtype=torch.long, device=dev)
    bmin = rbmin[gidx]
    bmax = rbmax[gidx]
    sel = torch.tensor([[(c >> a) & 1 for a in range(3)] for c in range(8)],
                       dtype=torch.float32, device=dev)
    corners = bmin[:, None, :] * (1 - sel)[None] + bmax[:, None, :] * sel[None]  # (I,8,3)
    wc = torch.stack([M[:, None, a, 0] * corners[:, :, 0] + M[:, None, a, 1] * corners[:, :, 1]
                      + M[:, None, a, 2] * corners[:, :, 2] + M[:, None, a, 3]
                      for a in range(3)], dim=2)
    wbmin = wc.amin(dim=1)
    wbmax = wc.amax(dim=1)
    roots = torch.as_tensor([m[5] for m in bvh.mesh_meta], dtype=torch.int32, device=dev)
    inst_rows = torch.cat([
        minv.reshape(I, 12), wbmin, wbmax,
        encode_ids(roots[gidx])[:, None],
        encode_ids(torch.arange(I, dtype=torch.int32, device=dev))[:, None],
        encode_ids(torch.as_tensor(bvh.inst_masks, dtype=torch.int32, device=dev))[:, None],
    ], dim=1)
    inst_base = bvh.n_internal + bvh.n_leaf
    table[inst_base:] = torch.nn.functional.pad(inst_rows, (0, ROW - inst_rows.shape[1]))

    # --- TLAS rows (world space) ------------------------------------------------
    tn = bvh.tlas_n
    child = bvh.node_child[:tn]
    empty = child < 0
    local = torch.where(child >= inst_base, tn + (child - inst_base), child)
    local = torch.where(empty, 0, local).clamp(0, tn + I - 1)
    ebmin = torch.cat([torch.full((tn, 3), float("inf"), device=dev), wbmin])
    ebmax = torch.cat([torch.full((tn, 3), -float("inf"), device=dev), wbmax])
    rows, _, _ = _internal_rows(child, empty, local, ebmin, ebmax, bvh.tlas_depth)
    table[:tn] = rows
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


def _to_flat(bvh: TwoLevelBVH, local, inst):
    ok = (local >= 0) & (inst >= 0)
    flat = bvh.flat_tri_base[inst.clamp_min(0).long()] + local.clamp_min(0)
    return torch.where(ok, flat, -1)


def _hits(bvh, out) -> Hits:
    found = (out.tri >= 0) & (out.inst >= 0)
    return Hits(t=torch.where(found, out.t, float("inf")),
                triangle=torch.where(found, _to_flat(bvh, out.tri, out.inst), -1),
                u=out.u, v=out.v)


# ``ray_mask``: optional (R,) int32 per-ray mask bits; an instance whose
# geometry mask shares no bit with a ray's mask is skipped by that ray
# (Raytracing.metal:733-735). None: no filtering.

def closest_hit(bvh: TwoLevelBVH, rays: Rays, t_min: float = 0.0, mask=None,
                ray_mask=None) -> Hits:
    """Closest hit per ray; triangle ids are FLAT (instance tri base + local)."""
    shadow = torch.zeros(rays.origin.shape[0], dtype=torch.bool, device=rays.origin.device)
    return _hits(bvh, _traverse(bvh, rays, shadow, mask, t_min, ray_mask))


def trace_mixed(bvh: TwoLevelBVH, rays: Rays, shadow, t_min: float = 0.0, mask=None,
                ray_mask=None):
    """One traversal over a mixed batch: ``shadow`` lanes retire at their first
    hit, the others find the closest. Returns (Hits, occluded)."""
    out = _traverse(bvh, rays, shadow, mask, t_min, ray_mask)
    return _hits(bvh, out), out.found & shadow


def any_hit(bvh: TwoLevelBVH, rays: Rays, t_min: float = 0.0, mask=None,
            ray_mask=None) -> torch.Tensor:
    """Occlusion per ray within ``rays.max_distance``."""
    shadow = torch.ones(rays.origin.shape[0], dtype=torch.bool, device=rays.origin.device)
    return _traverse(bvh, rays, shadow, mask, t_min, ray_mask).found
