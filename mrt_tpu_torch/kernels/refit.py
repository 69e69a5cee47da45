"""Kernels K4 — refit_rows — and K5 — refit_tlas — (``csrc/refit.cu``), their
wrappers, their plain PyTorch versions and the per-BVH metadata they read.

K4 replaces ``mrt_tpu/bvh/twolevel.py:_refit_group`` (with ``_pack_leaf_rows``)
as looped by ``refit`` over the mesh groups, and ``mrt_tpu/bvh/wide.py:refit``:
the leaf rows and boxes of a table region, then its internal rows bottom-up.
It has two instantiations: ``blas`` (every skinned BLAS of a
``TwoLevelBVH`` in one launch, or every BLAS at build time, from the
object-space vertex pool through each group's local indices; it writes the
groups' root boxes) and ``flat`` (the whole ``WideBVH`` table from world
triangles, with the optional ``row_ids`` and SBVH ``leaf_clip``). K5
replaces the instance and TLAS part of ``mrt_tpu/bvh/twolevel.py:refit``:
the instance rows (the 3x4 inverse, the world box of the 8 transformed
corners of the group's root box, the root, id and mask) and the TLAS rows.
A two-level refit is one launch: K5 runs in the block that finishes K4's
launch last, and computes the instances' 3x3 inverse itself (Gaussian
elimination with partial pivoting, the sequence of ``_affine_inverse``;
the JAX package takes ``jnp.linalg.inv``, an LU with partial pivoting).

The wrappers ``twolevel`` and ``flat`` take the plain versions only for CPU
tensors; on CUDA tensors they launch the kernels or raise. The plain
versions are the port's torch-op refit (``blas_plain``, ``tlas_plain``,
``flat_plain``, with ``twolevel_plain`` running the first two): ``depth``
passes of child-box gathers. The kernel walks up instead: a warp writes a
leaf row and its box, then adds one to its parent's arrival count; the
warp whose arrival is the last writes the parent's row and walks on. Min
and max are exact in any order, so the bits do not depend on which child
came last. The parent of every entry, the arrivals each internal row waits
for and the internal rows no leaf reaches are derived once per BVH from
``node_child`` (``Walkup``), where the BVH is made; a two-level BVH also
carries the count of K4's finished blocks that elects K5's block.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..bvh.wide import ARITY, LEAF_K, ROW, encode_ids
from .traverse2 import _check

K4_VARIANTS = ("blas", "flat")
rows_launches = dict.fromkeys(K4_VARIANTS, 0)  # K4 launches in this process, by instantiation
tlas_launches = 0  # K5 launches in this process


def reset_launches():
    """Set every launch count to 0."""
    global tlas_launches
    tlas_launches = 0
    for k in rows_launches:
        rows_launches[k] = 0


# ---------------------------------------------------------------------------
# Walk-up metadata (derived once per BVH)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Walkup:
    """What K4's walk-up reads, for the entries [0, n_internal + n_leaf) of
    a table (internal rows first, then leaf rows).

    ``parent``: each entry's parent internal row; -1 for a root and for an
    entry no row holds (a padded leaf); -(g + 2) for the root of the
    two-level BVH's mesh group g (the walk writes its root box there).
    ``need``: each internal row's children that a leaf reaches (the
    arrivals it waits for); 0 flags a row no leaf reaches (every child
    empty or itself unreached), whose row K4 writes apart, all boxes empty.
    ``unreached``: those rows (outside a two-level BVH's TLAS, which K5
    writes). ``boxed``: per internal row, bit j set where child j holds a
    box (a leaf, or a row a leaf reaches): the children whose boxes K4
    reads, ``need`` of them. ``arrivals``: K4's arrival counts, all 0
    between launches (the last arrival at a row sets its count back to 0),
    so the refits of one BVH run in stream order."""

    parent: torch.Tensor  # (n_internal + n_leaf,) int32
    need: torch.Tensor  # (n_internal,) int32
    unreached: torch.Tensor  # (U,) int32 row ids
    boxed: torch.Tensor  # (n_internal,) uint8
    arrivals: torch.Tensor  # (max(n_internal, 1),) int32

    def to(self, device) -> "Walkup":
        return Walkup(*(getattr(self, f.name).to(device) for f in dataclasses.fields(self)))


def walkup_arrays(node_child: np.ndarray, n_leaf: int, roots=(), skip: int = 0):
    """(parent, need, unreached, boxed) as NumPy for the (Ni, ARITY)
    ``node_child`` over entries [0, Ni + n_leaf); ``roots``: the root entry of each
    two-level mesh group (marked -(g + 2)); rows below ``skip`` (a TLAS)
    are left out of ``unreached``. Raises if an entry has two parents."""
    child = np.asarray(node_child, np.int64)
    ni = child.shape[0]
    n = ni + n_leaf
    rows, slots = np.nonzero((child >= 0) & (child < n))
    kids = child[rows, slots]
    if np.unique(kids).shape[0] != kids.shape[0]:
        raise ValueError("node_child is not a tree: an entry has two parents")
    parent = np.full(n, -1, np.int32)
    parent[kids] = rows
    for g, r in enumerate(roots):
        parent[r] = -(g + 2)
    reached = np.zeros(n, bool)
    reached[ni:] = True
    need = np.zeros(ni, np.int64)
    while True:  # one more level reached per pass
        need = np.bincount(rows, weights=reached[kids], minlength=ni).astype(np.int64)
        now = need > 0
        if np.array_equal(now, reached[:ni]):
            break
        reached[:ni] = now
    unreached = np.nonzero(need[skip:] == 0)[0].astype(np.int32) + skip
    boxed = np.zeros(ni, np.int64)
    np.add.at(boxed, rows, reached[kids].astype(np.int64) << slots)
    return parent, need.astype(np.int32), unreached.astype(np.int32), boxed.astype(np.uint8)


def _walkup(parent, need, unreached, boxed, device) -> Walkup:
    return Walkup(*(torch.as_tensor(a).to(device) for a in (parent, need, unreached, boxed)),
                  arrivals=torch.zeros(max(need.shape[0], 1), dtype=torch.int32, device=device))


def flat_walkup(node_child: np.ndarray, n_leaf: int, device) -> Walkup:
    """A flat table's ``Walkup`` on ``device``."""
    return _walkup(*walkup_arrays(node_child, n_leaf), device)


@dataclasses.dataclass
class TwoLevelMeta:
    """What K4 and K5 read of a two-level BVH besides its table, made once
    per BVH and kept on its device: the BLAS walk-up, per leaf its mesh
    group, per group its vertex start and root entry, the skinned groups'
    leaves, unreached rows and concatenated local indices (``skin_tris``,
    ``skin_toff`` the first triangle of each group there, -1 for a static
    group, ``skin_tris_at`` the address of that triangle, 0 for a static
    group: what K4 reads), per instance its group and geometry mask, and
    ``done``: the count of a launch's finished blocks (the one that
    completes it runs K5 and sets it back to 0, so it is 0 between
    launches, as the arrival counts)."""

    walkup: Walkup
    leaf_group: torch.Tensor  # (NL,) int32
    group_vstart: torch.Tensor  # (G,) int32
    group_root: torch.Tensor  # (G,) int32 root entry
    group_skinned: torch.Tensor  # (G,) int32 1 = skinned
    skin_leaves: torch.Tensor  # (S,) int32 leaf indices of the skinned groups
    skin_unreached: torch.Tensor  # (Us,) int32
    skin_tris: torch.Tensor  # (sum Tm, 3) int32
    skin_toff: torch.Tensor  # (G,) int32
    skin_tris_at: torch.Tensor  # (G,) int64 device addresses into skin_tris
    inst_group: torch.Tensor  # (I,) int32
    inst_mask: torch.Tensor  # (I,) int32
    done: torch.Tensor  # (1,) int32

    def to(self, device) -> "TwoLevelMeta":
        moved = {f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)
                 if f.name != "skin_tris_at"}
        at = _tris_at(moved["skin_tris"], self.skin_toff, device)
        return TwoLevelMeta(**moved, skin_tris_at=at)


def _tris_at(tris: torch.Tensor, toff: torch.Tensor, device) -> torch.Tensor:
    """(G,) int64 on ``device``: the address of each group's first index
    triple in ``tris`` (on ``device``), 0 where ``toff`` is -1."""
    base, size = tris.data_ptr(), tris.element_size() * 3
    return torch.tensor([0 if o < 0 else base + size * o for o in toff.tolist()],
                        dtype=torch.int64).to(device)


def twolevel_meta(node_child: np.ndarray, tlas_n: int, n_leaf: int, mesh_meta, inst_mesh,
                  inst_masks, skin_indices, device) -> TwoLevelMeta:
    """``TwoLevelMeta`` of a two-level BVH from its host topology
    (``node_child`` as NumPy, global entry ids) and its metadata."""
    ni = node_child.shape[0]
    parent, need, unreached, boxed = walkup_arrays(node_child, n_leaf, [m[5] for m in mesh_meta],
                                                   skip=tlas_n)
    leaf_group = np.zeros(n_leaf, np.int32)
    skin_leaves, skin_toff, toff = [], [], 0
    row_group = np.full(ni, -1, np.int32)
    for g, (int_lo, n_int, leaf_lo, nl, *_rest, slot) in enumerate(mesh_meta):
        leaf_group[leaf_lo:leaf_lo + nl] = g
        row_group[int_lo:int_lo + n_int] = g
        if slot >= 0:
            skin_leaves.append(np.arange(leaf_lo, leaf_lo + nl, dtype=np.int32))
            skin_toff.append(toff)
            toff += int(skin_indices[slot].shape[0])
        else:
            skin_toff.append(-1)
    skinned = np.array([m[8] >= 0 for m in mesh_meta], np.int32)
    skin_unreached = unreached[skinned[row_group[unreached]] > 0] if unreached.size else unreached

    def t(a, dtype=np.int32):
        return torch.as_tensor(np.asarray(a, dtype)).to(device)

    dev = torch.device(device)
    tris = (torch.cat([x.to(dev) for x in skin_indices]) if skin_indices
            else torch.zeros((0, 3), dtype=torch.int32, device=dev)).to(torch.int32).contiguous()
    return TwoLevelMeta(
        walkup=_walkup(parent, need, unreached, boxed, device), leaf_group=t(leaf_group),
        group_vstart=t([m[6] for m in mesh_meta]), group_root=t([m[5] for m in mesh_meta]),
        group_skinned=t(skinned),
        skin_leaves=t(np.concatenate(skin_leaves) if skin_leaves else np.zeros(0)),
        skin_unreached=t(skin_unreached), skin_tris=tris, skin_toff=t(skin_toff),
        skin_tris_at=_tris_at(tris, t(skin_toff), dev), inst_group=t(inst_mesh),
        inst_mask=t(inst_masks),
        done=torch.zeros(1, dtype=torch.int32, device=dev))


# ---------------------------------------------------------------------------
# Plain versions (torch ops; the port's refit before K4 and K5)
# ---------------------------------------------------------------------------

def _pack_leaf_rows(w0, w1, w2, leaf_ids, ids=None):
    """(nl, K, 3) leaf verts -> (nl, ROW) leaf rows + leaf AABBs. Slots where
    ``leaf_ids`` < 0 are pads (NaN vertices, no box); the rows encode ``ids``
    (default ``leaf_ids``)."""
    pad = (leaf_ids < 0)[..., None]
    nan = torch.tensor(float("nan"), dtype=torch.float32, device=w0.device)
    w0 = torch.where(pad, nan, w0)
    w1 = torch.where(pad, nan, w1)
    w2 = torch.where(pad, nan, w2)
    comps = [w[:, :, a] for w in (w0, w1, w2) for a in range(3)]
    rows = torch.cat(comps + [encode_ids(leaf_ids if ids is None else ids)], dim=1)
    rows = torch.nn.functional.pad(rows, (0, ROW - rows.shape[1]))
    stacked = torch.stack([w0, w1, w2], dim=2)  # (nl, K, 3, 3)
    valid = ~pad[..., None]
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=w0.device)
    bmin = torch.where(valid, stacked, inf).amin(dim=(1, 2)) - 1e-7
    bmax = torch.where(valid, stacked, -inf).amax(dim=(1, 2)) + 1e-7
    return rows, bmin, bmax


def _clip_leaf_boxes(bmin, bmax, clip):
    """SBVH: the leaf boxes intersected with the builder's clip boxes (a
    triangle split across leaves would otherwise widen both to its whole
    extent); ``clip`` None leaves them as they are."""
    if clip is None:
        return bmin, bmax
    return torch.maximum(bmin, clip[:, :3]), torch.minimum(bmax, clip[:, 3:])


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


def flat_plain(wbvh, v0, v1, v2, row_ids=None) -> torch.Tensor:
    """K4 ``flat``'s plain version: the table of ``wide.refit``."""
    n_i = wbvh.n_internal
    leaf_tri = wbvh.leaf_tri
    n_l = leaf_tri.shape[0]
    tid = leaf_tri.clamp_min(0).reshape(-1).long()

    def g(v):
        return v[tid].reshape(n_l, LEAF_K, 3)

    ids = None if row_ids is None else torch.where(leaf_tri < 0, -1, row_ids)
    leaf_rows, leaf_bmin, leaf_bmax = _pack_leaf_rows(g(v0), g(v1), g(v2), leaf_tri, ids)
    leaf_bmin, leaf_bmax = _clip_leaf_boxes(leaf_bmin, leaf_bmax, wbvh.leaf_clip)
    if n_i == 0:
        return leaf_rows
    child = wbvh.node_child
    empty = child < 0
    dev = leaf_rows.device
    ebmin = torch.cat([torch.full((n_i, 3), float("inf"), device=dev), leaf_bmin])
    ebmax = torch.cat([torch.full((n_i, 3), -float("inf"), device=dev), leaf_bmax])
    rows, _, _ = _internal_rows(child, empty, child.clamp_min(0), ebmin, ebmax, wbvh.depth)
    return torch.cat([rows, leaf_rows])


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
    leaf_bmin, leaf_bmax = _clip_leaf_boxes(
        leaf_bmin, leaf_bmax, None if bvh.leaf_clip is None else bvh.leaf_clip[leaf_lo : leaf_lo + nl])
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


def _refit_groups(bvh, group_indices):
    """(group, its (Tm,3) local indices) for every group a refit rewrites:
    the skinned ones, or with ``group_indices`` every one (a skinned group
    still by its own indices)."""
    for gi, meta in enumerate(bvh.mesh_meta):
        slot = meta[8]
        if slot >= 0:
            yield gi, bvh.skin_indices[slot]
        elif group_indices is not None:
            yield gi, group_indices[gi]


def blas_plain(table, root_bmin, root_bmax, bvh, positions_obj, group_indices=None):
    """K4 ``blas``'s plain version, in place: every skinned BLAS (with
    ``group_indices``, every BLAS) of ``table`` and its root box."""
    for gi, idx in _refit_groups(bvh, group_indices):
        v_start, v_count = bvh.mesh_meta[gi][6:8]
        _refit_group(table, root_bmin, root_bmax, bvh, gi, positions_obj[v_start : v_start + v_count],
                     idx)


def _swap_rows(c, rows, i, k):
    """Rows ``i`` and ``k`` of the 3x3 list of columns ``rows`` swapped
    where ``c``."""
    for j in range(3):
        x, y = rows[i][j], rows[k][j]
        rows[i][j], rows[k][j] = torch.where(c, y, x), torch.where(c, x, y)


def _inverse3(M: torch.Tensor) -> torch.Tensor:
    """(I,3,3) inverse of ``M[:, :3, :3]`` by Gaussian elimination with
    partial pivoting, each f32 operation on its own, in K5's order
    (``csrc/refit.cu``): the row with the largest |a_i0| (the first on
    ties) to the top, r0 = 1 / a00, multipliers a_i0 * r0, the rows below
    (and the identity's) updated; the same for column 1; r2 = 1 / a22; the
    result's rows from the last up, x_k = b_k * r_k."""
    a = [[M[:, i, j] for j in range(3)] for i in range(3)]
    one, zero = torch.ones_like(a[0][0]), torch.zeros_like(a[0][0])
    b = [[one if i == j else zero for j in range(3)] for i in range(3)]
    p1 = a[1][0].abs() > a[0][0].abs()
    p2 = a[2][0].abs() > torch.where(p1, a[1][0].abs(), a[0][0].abs())
    for rows in (a, b):
        _swap_rows(p1 & ~p2, rows, 0, 1)
        _swap_rows(p2, rows, 0, 2)
    r0 = torch.reciprocal(a[0][0])
    l1, l2 = a[1][0] * r0, a[2][0] * r0
    for j in (1, 2):
        a[1][j] = a[1][j] - l1 * a[0][j]
        a[2][j] = a[2][j] - l2 * a[0][j]
    for j in range(3):
        b[1][j] = b[1][j] - l1 * b[0][j]
        b[2][j] = b[2][j] - l2 * b[0][j]
    s = a[2][1].abs() > a[1][1].abs()
    for rows in (a, b):
        _swap_rows(s, rows, 1, 2)
    r1 = torch.reciprocal(a[1][1])
    l = a[2][1] * r1
    a[2][2] = a[2][2] - l * a[1][2]
    for j in range(3):
        b[2][j] = b[2][j] - l * b[1][j]
    r2 = torch.reciprocal(a[2][2])
    x = [[None] * 3 for _ in range(3)]
    for j in range(3):
        x[2][j] = b[2][j] * r2
        b[1][j] = b[1][j] - x[2][j] * a[1][2]
        b[0][j] = b[0][j] - x[2][j] * a[0][2]
        x[1][j] = b[1][j] * r1
        b[0][j] = b[0][j] - x[1][j] * a[0][1]
        x[0][j] = b[0][j] * r0
    return torch.stack([torch.stack(row, dim=1) for row in x], dim=1)


def _affine_inverse(M: torch.Tensor) -> torch.Tensor:
    """(I,4,4) -> (I,3,4) inverse of the affine [R|t]: the 3x3 by
    ``_inverse3``, the translation -(Rinv t) summed left to right."""
    Rinv = _inverse3(M)
    t = M[:, :3, 3]
    tinv = -(Rinv[:, :, 0] * t[:, None, 0] + Rinv[:, :, 1] * t[:, None, 1]
             + Rinv[:, :, 2] * t[:, None, 2])
    return torch.cat([Rinv, tinv[:, :, None]], dim=2)


def tlas_plain(table, rbmin, rbmax, bvh, instance_transform):
    """K5's plain version, in place: the instance rows and the TLAS rows of
    ``table`` from the root boxes ``rbmin``/``rbmax`` and the (I,4,4)
    ``instance_transform``."""
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

    tn = bvh.tlas_n
    child = bvh.node_child[:tn]
    empty = child < 0
    local = torch.where(child >= inst_base, tn + (child - inst_base), child)
    local = torch.where(empty, 0, local).clamp(0, tn + I - 1)
    ebmin = torch.cat([torch.full((tn, 3), float("inf"), device=dev), wbmin])
    ebmax = torch.cat([torch.full((tn, 3), -float("inf"), device=dev), wbmax])
    rows, _, _ = _internal_rows(child, empty, local, ebmin, ebmax, bvh.tlas_depth)
    table[:tn] = rows


def twolevel_plain(bvh, positions_obj, instance_transform, group_indices=None):
    """The plain two-level refit: (table, root_bmin, root_bmax), the input's
    table copied first."""
    table = bvh.table.clone()
    rbmin, rbmax = bvh.root_bmin.clone(), bvh.root_bmax.clone()
    blas_plain(table, rbmin, rbmax, bvh, positions_obj, group_indices)
    tlas_plain(table, rbmin, rbmax, bvh, instance_transform)
    return table, rbmin, rbmax


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _check_table(what, table, n_rows, dev):
    _check(what, "table", table, torch.float32, (n_rows, ROW), dev)
    if n_rows >= 1 << 30:
        raise ValueError(f"{what}: row ids must stay below 2^30 (the table's id encoding)")
    if table.data_ptr() % 16:
        raise ValueError(f"{what}: the table must be 16-byte aligned (its rows are written as float4)")


def _lib_stream(dev):
    from . import build

    return build.load(), ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def flat(wbvh, v0, v1, v2, row_ids=None) -> torch.Tensor:
    """The refit table of the flat ``wbvh`` from (T,3) world triangles
    ``v0, v1, v2`` (``row_ids``: optional (Nl, LEAF_K) ids to encode in
    the leaf rows in place of ``leaf_tri``). CPU tensors take the plain
    version; CUDA tensors launch K4 ``flat``."""
    if v0.device.type == "cpu":
        return flat_plain(wbvh, v0, v1, v2, row_ids)
    what = "refit_rows"
    dev = v0.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    if wbvh.walkup is None:
        raise ValueError(f"{what}: the BVH carries no walk-up metadata (derive it where the BVH "
                         "is made: kernels.refit.flat_walkup)")
    n_i, n_l = wbvh.n_internal, wbvh.leaf_tri.shape[0]
    T = v0.shape[0]
    for name, v in (("v0", v0), ("v1", v1), ("v2", v2)):
        _check(what, name, v, torch.float32, (T, 3), dev)
    _check(what, "node_child", wbvh.node_child, torch.int32, (n_i, ARITY), dev)
    _check(what, "leaf_tri", wbvh.leaf_tri, torch.int32, (n_l, LEAF_K), dev)
    _check(what, "parent", wbvh.walkup.parent, torch.int32, (n_i + n_l,), dev)
    _check(what, "boxed", wbvh.walkup.boxed, torch.uint8, (n_i,), dev)
    if wbvh.leaf_clip is not None:
        _check(what, "leaf_clip", wbvh.leaf_clip, torch.float32, (n_l, 6), dev)
    if row_ids is not None:
        _check(what, "row_ids", row_ids, torch.int32, (n_l, LEAF_K), dev)
    table = torch.empty((n_i + n_l, ROW), dtype=torch.float32, device=dev)
    _check_table(what, table, n_i + n_l, dev)
    wu = wbvh.walkup
    ebox = torch.empty((n_i + n_l, 6), dtype=torch.float32, device=dev)
    lib, stream = _lib_stream(dev)
    rc = lib.mrt_refit_flat(_ptr(table), n_i, _ptr(wbvh.node_child), _ptr(wu.parent),
                            _ptr(wu.need), _ptr(wu.boxed), _ptr(wbvh.leaf_tri),
                            _ptr(wbvh.leaf_clip), n_l, _ptr(wu.unreached), wu.unreached.shape[0],
                            _ptr(v0), _ptr(v1), _ptr(v2), _ptr(row_ids), _ptr(ebox),
                            _ptr(wu.arrivals), stream)
    if rc != 0:
        raise RuntimeError(f"{what} (flat) kernel launch failed: CUDA error {rc}")
    if n_l + wu.unreached.shape[0]:
        rows_launches["flat"] += 1
    return table


def _group_tris(bvh, group_indices, dev):
    """(index tensors, their addresses) for a build-time refit of every
    group: each group's (Tm,3) local indices as int32 on ``dev`` (a skinned
    group's own), and a (G,) int64 tensor of their addresses on ``dev``."""
    idx = [i.to(dev, torch.int32).contiguous() for _, i in _refit_groups(bvh, group_indices)]
    if len(idx) != len(bvh.mesh_meta):
        raise ValueError("refit: group_indices must hold one index tensor per mesh group")
    return idx, torch.tensor([i.data_ptr() for i in idx], dtype=torch.int64).to(dev)


def twolevel(bvh, positions_obj, instance_transform, group_indices=None):
    """The two-level refit: (table, root_bmin, root_bmax), the input's table
    copied first. CPU tensors take the plain version; CUDA tensors launch
    K4 ``blas`` with K5 in its last block (one launch; one block, K5's work
    alone, when no group is refit)."""
    global tlas_launches
    if positions_obj.device.type == "cpu":
        return twolevel_plain(bvh, positions_obj, instance_transform, group_indices)
    what = "refit_twolevel"
    dev = positions_obj.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    meta = bvh.refit_meta
    if meta is None:
        raise ValueError(f"{what}: the BVH carries no refit metadata (derive it where the BVH "
                         "is made: kernels.refit.twolevel_meta)")
    ni, nl, I, G = bvh.n_internal, bvh.n_leaf, bvh.n_instances, len(bvh.mesh_meta)
    n_rows = ni + nl + I
    _check(what, "positions_obj", positions_obj, torch.float32, (positions_obj.shape[0], 3), dev)
    _check(what, "instance_transform", instance_transform, torch.float32, (I, 4, 4), dev)
    _check(what, "node_child", bvh.node_child, torch.int32, (ni, ARITY), dev)
    _check(what, "leaf_tri", bvh.leaf_tri, torch.int32, (nl, LEAF_K), dev)
    _check(what, "parent", meta.walkup.parent, torch.int32, (ni + nl,), dev)
    _check(what, "boxed", meta.walkup.boxed, torch.uint8, (ni,), dev)
    _check(what, "done", meta.done, torch.int32, (1,), dev)
    _check(what, "skin_tris_at", meta.skin_tris_at, torch.int64, (G,), dev)
    for name in ("root_bmin", "root_bmax"):
        _check(what, name, getattr(bvh, name), torch.float32, (G, 3), dev)
    if bvh.leaf_clip is not None:
        _check(what, "leaf_clip", bvh.leaf_clip, torch.float32, (nl, 6), dev)
    _check_table(what, bvh.table, n_rows, dev)
    table = bvh.table.clone()
    rbmin = torch.empty((G, 3), dtype=torch.float32, device=dev)
    rbmax = torch.empty((G, 3), dtype=torch.float32, device=dev)
    refit_all = group_indices is not None
    if refit_all:
        # the converted indices live in _kept through the launch
        _kept, tris_at = _group_tris(bvh, group_indices, dev)
        leaves, n_leaves, unreached = None, nl, meta.walkup.unreached
    else:
        tris_at = meta.skin_tris_at
        leaves, n_leaves, unreached = meta.skin_leaves, meta.skin_leaves.shape[0], meta.skin_unreached
    # scratch: the entry boxes, then the TLAS rows' and the instances'
    box = torch.empty((ni + nl + bvh.tlas_n + I, 6), dtype=torch.float32, device=dev)
    wu = meta.walkup
    lib, stream = _lib_stream(dev)
    rc = lib.mrt_refit_twolevel(
        _ptr(table), ni, _ptr(bvh.node_child), _ptr(wu.parent), _ptr(wu.need), _ptr(wu.boxed),
        _ptr(bvh.leaf_tri), _ptr(bvh.leaf_clip), _ptr(leaves), n_leaves, _ptr(unreached),
        unreached.shape[0], _ptr(positions_obj), _ptr(tris_at), _ptr(meta.group_vstart),
        _ptr(meta.leaf_group),
        _ptr(rbmin), _ptr(rbmax), _ptr(box), _ptr(wu.arrivals), ni + nl, I, bvh.tlas_n,
        bvh.tlas_depth, G, int(refit_all), _ptr(instance_transform), _ptr(meta.inst_group),
        _ptr(meta.group_root), _ptr(meta.inst_mask), _ptr(meta.group_skinned), _ptr(bvh.root_bmin),
        _ptr(bvh.root_bmax), _ptr(box[ni + nl:]), _ptr(meta.done), stream)
    if rc != 0:
        raise RuntimeError(f"{what} (refit_rows with refit_tlas) kernel launch failed: "
                           f"CUDA error {rc}")
    if n_leaves + unreached.shape[0]:
        rows_launches["blas"] += 1
    tlas_launches += 1
    return table, rbmin, rbmax
