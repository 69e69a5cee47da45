"""The least time an NVIDIA H100 could take for the work of the port's kernels.

A kernel's bound is the larger of two times: the bytes its function must move
(each input read once, each output written once) over the memory rate, and
the f32 operations it does on these inputs over the rate the card issues
them. Where the work depends on the data (K2's and K3's traversals), it is
counted from what one call's data needs, from the plain version's per-row
visits.

Peak rates, H100 SXM (NVIDIA's data sheet, 700 W): 3.35 TB/s of HBM3 and
67 TFLOP/s of f32 outside the tensor cores, a rate that counts a fused
multiply-add as two operations (132 SMs x 128 lanes x 2 x 1.98 GHz). The
kernels are built with ``-fmad=false``, so each add, sub, mul, min, max,
compare and division they count is one instruction, issued at half that:
PEAK_F32_OPS. A product's fused multiply-add is one instruction too.

K4 and K5, the refit kernels (``flat_refit``, ``blas_refit``,
``tlas_refit``, and ``refit`` for a whole two-level refit, one launch of
both), count what one call's table needs: the triangles that are not pads and the children that
are not empty. Besides the kernels: the LBS product of an animated frame's
prepare (``lbs``), and the presenter's chains (``resize``, ``temporal_chain``,
``denoiser``, ``denoised_chain``), whose bounds say what the whole chain
could take, and a whole present per mode (``present``: the chain that
ends in a uint8 form of K11 or K12, or the f32 chain and K1 it replaced). The chain bounds count bytes only: the resize needs 6 taps
per axis (Lanczos-3 at 2x), so its operations take a fraction of its byte
time. K9-K12, the presenter's kernels (``svgf_reproject``,
``atrous_pass``, ``temporal_resolve``, ``resize``), count both. K6-K8, the
wavefront's stages (``k6``, ``k7``, ``k8``), count per lane what the
lane's state needs: K7 from one iteration's lanes that are live, hit,
glass, lit and cast a shadow ray, and the texture work of its textured
instantiations: the packed atlas's taps, the mip chains' taps, the motion
rows, the tangent basis and the debug views' colours (``k7_work``). K7
runs over a lane list and folds K8's add in (``k7_listed``; ``k7`` stays the
bound of a full-width launch), and K8 runs once per sample over the last
list (``k8`` of its lanes). Under geometry sharding, K13 and K14
(``gp_rows``, ``banded_taps``) count bytes per live lane (K13 also the
scan's flags and positions of every lane) and each distinct row or texel
they gather once, and K7's lane-row form reads its rows and taps per lane
(``k7_work(..., rows=)``). A gp step's K13 is its scan (``gp_scan``) and
its gather after the hit combine (``gp_gather``, the rows this rank wins);
K15 and K16, the combine's keys and unpack and the occlusion's two forms
(``gp_hit_keys``, ``gp_lane_unpack``, ``gp_occluded_rows``,
``gp_occluded_lanes``), count bytes per row of the step's map.

Besides the bounds, two readings of what holds K3 back, from its own
outputs and its build: ``simt_share``, the share of lane-steps that do work
when the list's entries are traced ``group`` at a time by lanes that wait
for the group's longest ray (``lane_steps`` per launch, for sums over a
frame), and ``blocks_per_sm``, the H100's occupancy of a kernel from its
registers and shared memory.
"""

from __future__ import annotations

import torch

from ..bvh.wide import _META_MASK, ARITY, IDS_OFF, LEAF_K, META_OFF, ROW, decode_ids

PEAK_BYTES = 3.35e12
PEAK_F32_OPS = 67e12 / 2
# an H100 SM (sm_90): 32-bit registers, allocated per warp in units of 256;
# shared memory for blocks, each of which reserves 1 KB more; resident
# warps and blocks at most
SM_REGISTERS, REGISTER_UNIT = 65536, 256
SM_SHARED_BYTES, BLOCK_RESERVED_SHARED = 233472, 1024
SM_WARPS, SM_BLOCKS = 64, 32

# K1 (csrc/present.cu), per value: 4 B in, 1 B out; Reinhard's add and div,
# the clip's max and min, then the mul and add of the rounding
K1_BYTES, K1_OPS = 5, 6

# K2 (csrc/traverse2.cu, its header note): f32 operations per popped
# internal row (3 guarded reciprocals) and per child that is not empty, per
# popped leaf row and per triangle that is not a pad, per instance cull and
# per entry into an instance's BLAS (the 3x4 transform)
K2_OPS_INTERNAL, K2_OPS_CHILD = 9, 27
K2_OPS_LEAF, K2_OPS_TRIANGLE = 1, 59
K2_OPS_CULL, K2_OPS_ENTER = 34, 33
# the float child sort (tables above 2^20 - 1 rows): the bitonic network's
# compares per popped internal row
K2_OPS_FLOAT_SORT = 24
# bytes of a table row the function needs, in the float4s the rows are
# stored in: an internal row's 6 bound planes and ids; a leaf row's 9 vertex
# planes and ids for each group of 4 triangles up to the first pad; an
# instance row's world box (with root and id), and its 3x4 inverse if a ray
# enters it
K2_BYTES_INTERNAL = 14 * 16
K2_BYTES_LEAF_GROUP = 10 * 16
K2_BYTES_CULL, K2_BYTES_ENTER = 2 * 16, 3 * 16
# the masked variant reads the instance row's mask too (one more float4)
K2_BYTES_MASK = 16
# per lane: origin, direction, tmax, shadow, active in and t, tri, inst, u,
# v, found, pops out (and the ray mask in, when masked); a dead lane reads
# only active and tmax
K2_BYTES_LIVE_LANE = 30 + 25
K2_BYTES_RAY_MASK = 4
K2_BYTES_DEAD_LANE = 5 + 25
# K3 (the flat traversal, K2's kernel without instance rows) needs no
# instance id out
K3_BYTES_NO_INST = 4


def least_ms(ops: float, nbytes: float) -> tuple[float, str]:
    """(ms, "operations" or "bytes"): the larger of the two times and which
    one it is."""
    ops_ms, bytes_ms = ops / PEAK_F32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def k1(shape) -> tuple[float, str]:
    """K1's bound for one (H, W, 3) image."""
    n = shape[0] * shape[1] * shape[2]
    return least_ms(n * K1_OPS, n * K1_BYTES)


def k2_work(table, n_internal: int, n_leaf: int, visits, masked: bool = False) -> dict[str, int]:
    """K2's work in one call, from the plain version's ``visits`` (per table
    row: its pops, and the rays that entered it if it is an instance row)
    and the table's own rows: the pops by row type, the children and
    triangles those pops test, the entries, the ops and the bytes of the
    distinct rows read. ``masked``: the rays carried masks (the masked
    variant); a table above 2^20 - 1 rows takes the float child sort."""
    pops, entered = visits[:, 0], visits[:, 1]
    inst_base = n_internal + n_leaf
    children = (decode_ids(table[:n_internal, META_OFF:META_OFF + ARITY]) >= 0).sum(1)
    tris = (decode_ids(table[n_internal:inst_base, IDS_OFF:IDS_OFF + LEAF_K]) >= 0).sum(1)
    p_int, p_leaf, p_inst = pops[:n_internal], pops[n_internal:inst_base], pops[inst_base:]
    w = dict(
        pops_internal=p_int.sum(), pops_leaf=p_leaf.sum(), pops_instance=p_inst.sum(),
        entered=entered.sum(), children=(p_int * children).sum(), triangles=(p_leaf * tris).sum(),
        rows_internal=(p_int > 0).sum(), rows_instance=(p_inst > 0).sum(),
        rows_entered=(entered > 0).sum(), leaf_groups=((tris + 3) // 4)[p_leaf > 0].sum())
    w = {k: int(v) for k, v in w.items()}
    w["ops"] = (w["pops_internal"] * K2_OPS_INTERNAL + w["children"] * K2_OPS_CHILD
                + w["pops_leaf"] * K2_OPS_LEAF + w["triangles"] * K2_OPS_TRIANGLE
                + w["pops_instance"] * K2_OPS_CULL + w["entered"] * K2_OPS_ENTER)
    if table.shape[0] > _META_MASK:
        w["ops"] += w["pops_internal"] * K2_OPS_FLOAT_SORT
    cull = K2_BYTES_CULL + (K2_BYTES_MASK if masked else 0)
    w["row_bytes"] = (w["rows_internal"] * K2_BYTES_INTERNAL + w["leaf_groups"] * K2_BYTES_LEAF_GROUP
                      + w["rows_instance"] * cull + w["rows_entered"] * K2_BYTES_ENTER)
    return w


def k2(work: dict[str, int], n_lanes: int, n_live: int, masked: bool = False,
       flat: bool = False) -> tuple[float, str]:
    """K2's bound for one call over ``n_lanes`` lanes, ``n_live`` of them
    active, with ``work`` from ``k2_work`` (``masked``: the rays carried
    masks). ``flat``: K3's bound, for ``work`` from ``k3_work``."""
    live_lane = K2_BYTES_LIVE_LANE + (K2_BYTES_RAY_MASK if masked else 0)
    dead_lane = K2_BYTES_DEAD_LANE
    if flat:
        live_lane, dead_lane = live_lane - K3_BYTES_NO_INST, dead_lane - K3_BYTES_NO_INST
    nbytes = (work["row_bytes"] + n_live * live_lane + (n_lanes - n_live) * dead_lane)
    return least_ms(work["ops"], nbytes)


def k3_work(table, n_internal: int, visits) -> dict[str, int]:
    """K3's work in one call over a flat table: ``k2_work`` with every row
    past the internal ones a leaf row, so no instance pops, and the guarded
    reciprocals of the world direction taken once per live lane (as
    ``wide._traverse_flat_rows`` takes them once per ray) rather than once
    per internal pop. Every live lane pops the root, row 0, exactly once."""
    w = k2_work(table, n_internal, table.shape[0] - n_internal, visits)
    w["lanes"] = int(visits[0, 0])
    w["ops"] += (w["lanes"] - w["pops_internal"]) * K2_OPS_INTERNAL
    return w


def lane_steps(pops, live, group: int) -> tuple[int, int]:
    """(the live lanes' pops, the lane-steps they take): one launch's
    per-lane ``pops`` (R,) and ``live`` (R,) bool, its list taken ``group``
    entries at a time in lane order (the compaction's order within each
    block of 1,024 lanes) by ``group`` lanes that each trace one ray, all of
    them until the group's longest ray ends: ``group`` x the largest pops of
    each run of ``group`` consecutive entries (the last run padded)."""
    p = pops[live].to(torch.int64)
    pad = (-p.numel()) % group
    runs = torch.cat([p, p.new_zeros(pad)]).view(-1, group)
    return int(p.sum()), group * int(runs.amax(dim=1).sum()) if runs.numel() else 0


def simt_share(pops, live, group: int) -> float:
    """The share of lane-steps that do work (``lane_steps``' ratio) when the
    live list is traced ``group`` rays at a time, one a lane, each group
    held until its longest ray ends: 1.0 when every ray of a run pops as
    many rows, 1/group when one ray does all the work. K3, a ray a thread,
    is group 32 (a warp of rays); no live lane gives 1.0."""
    work, steps = lane_steps(pops, live, group)
    return work / steps if steps else 1.0


def blocks_per_sm(registers: int, threads: int, shared_bytes: int = 0) -> int:
    """Resident blocks of ``threads`` threads on one H100 SM for a kernel of
    ``registers`` registers a thread and ``shared_bytes`` of shared memory a
    block: the least of what its registers (per warp, in units of 256), its
    shared memory and the SM's warp and block limits allow (the CUDA
    occupancy calculator's arithmetic for sm_90)."""
    warps = -(-threads // 32)
    per_warp = -(-registers * 32 // REGISTER_UNIT) * REGISTER_UNIT
    by_registers = (SM_REGISTERS // per_warp) // warps if per_warp else SM_BLOCKS
    by_shared = (SM_SHARED_BYTES // (shared_bytes + BLOCK_RESERVED_SHARED)
                 if shared_bytes else SM_BLOCKS)
    return min(by_registers, by_shared, SM_WARPS // warps, SM_BLOCKS)


def lbs(n_vertices: int, n_joints: int) -> tuple[float, str]:
    """Bound of ``skinning.lbs.skin`` for one model: the (V,J) weights, the
    rest positions and normals and the (J,4,4) matrices read, the skinned
    positions and normals written; V*J*12 multiply-adds of the product and
    33 operations per vertex of the affine apply."""
    v, j = n_vertices, n_joints
    nbytes = v * j * 4 + v * 6 * 4 + j * 16 * 4 + v * 6 * 4
    return least_ms(v * j * 12 + v * 33, nbytes)


# K4 and K5 (csrc/refit.cu): bytes of a packed row; per gathered triangle
# its three vertices; per leaf row its ids (and row_ids, clip box); per
# internal row its child ids
REFIT_ROW_BYTES = ROW * 4
REFIT_TRI_BYTES = 3 * 12
REFIT_IDS_BYTES, REFIT_CLIP_BYTES, REFIT_CHILD_BYTES = LEAF_K * 4, 6 * 4, ARITY * 4
# operations: a min and a max per vertex coordinate of a triangle that is
# not a pad; per leaf box the +-1e-7 (and the clip clamp); a min and a max
# per coordinate of a child that is not empty
REFIT_OPS_TRI, REFIT_OPS_LEAF, REFIT_OPS_CLIP, REFIT_OPS_CHILD = 18, 6, 6, 6
# K5 per instance: the 3x3 inverse (5 abs and 3 compares for the pivots, 3
# reciprocals, 3 multipliers, 5 mul and 5 sub on the matrix, 9 and 9 on the
# identity's rows, 9 mul for the result's rows and 9 mul and 9 sub between
# them), -(Rinv t) (3 x 3 mul, 2 add, 1 neg), the 8 corners (per coordinate
# 1 - s, 2 mul, 1 add), their transform (per coordinate 3 mul, 3 add) and
# the world box (7 min and 7 max per axis); per instance its 4x4 transform
# read, per group its root box read and written
K5_OPS_INVERSE = 8 + 3 + 3 + 10 + 18 + 9 + 18
K5_OPS_INSTANCE = K5_OPS_INVERSE + 18 + 8 * 3 * 4 + 8 * 3 * 6 + 2 * 3 * 7
K5_BYTES_INSTANCE = 16 * 4
K5_BYTES_GROUP = 2 * 6 * 4


def _rows_work(leaf_tri, node_child, clipped: bool, row_ids: bool = False) -> tuple[int, int]:
    """(ops, bytes) of K4 over the leaf rows ``leaf_tri`` (Nl, LEAF_K) and
    the internal rows ``node_child`` (Ni, ARITY) of one table region."""
    tris = int((leaf_tri >= 0).sum())
    kids = int((node_child >= 0).sum())
    nl, ni = leaf_tri.shape[0], node_child.shape[0]
    leaf_bytes = REFIT_IDS_BYTES * (2 if row_ids else 1) + (REFIT_CLIP_BYTES if clipped else 0)
    nbytes = (tris * REFIT_TRI_BYTES + nl * leaf_bytes + ni * REFIT_CHILD_BYTES
              + (nl + ni) * REFIT_ROW_BYTES)
    ops = (tris * REFIT_OPS_TRI + nl * (REFIT_OPS_LEAF + (REFIT_OPS_CLIP if clipped else 0))
           + kids * REFIT_OPS_CHILD)
    return ops, nbytes


def flat_refit(wbvh, row_ids: bool = False) -> tuple[float, str]:
    """Bound of one ``bvh.wide.refit`` (K4 ``flat``): the gathered
    triangles, the leaf ids (and ``row_ids``, and the SBVH clip boxes) and
    the child ids read, every row written; the leaf boxes' and the child
    boxes' min and max."""
    return least_ms(*_rows_work(wbvh.leaf_tri, wbvh.node_child, wbvh.leaf_clip is not None, row_ids))


def _blas_work(bvh, all_groups: bool) -> tuple[int, int]:
    ops = nbytes = 0
    for int_lo, ni, leaf_lo, nl, _depth, _root, _vs, v_count, slot in bvh.mesh_meta:
        if slot < 0 and not all_groups:
            continue
        o, b = _rows_work(bvh.leaf_tri[leaf_lo:leaf_lo + nl], bvh.node_child[int_lo:int_lo + ni],
                          bvh.leaf_clip is not None)
        n_tris = int((bvh.leaf_tri[leaf_lo:leaf_lo + nl] >= 0).sum())
        # the group's vertices and its local indices in place of gathered
        # triangles, each read once
        ops += o
        nbytes += b - n_tris * REFIT_TRI_BYTES + v_count * 12 + n_tris * 12 + 24
    return ops, nbytes


def _tlas_work(bvh) -> tuple[int, int]:
    tn, n_inst = bvh.tlas_n, bvh.n_instances
    o, b = _rows_work(bvh.leaf_tri[:0], bvh.node_child[:tn], False)
    return (o + n_inst * K5_OPS_INSTANCE,
            b + n_inst * (K5_BYTES_INSTANCE + REFIT_ROW_BYTES) + len(bvh.mesh_meta) * K5_BYTES_GROUP)


def blas_refit(bvh, all_groups: bool = False) -> tuple[float, str]:
    """Bound of K4 ``blas`` in one ``bvh.twolevel.refit``: every skinned
    group (``all_groups``: every group, as at build time): its posed
    vertices and local indices, leaf and child ids read, its rows and root
    box written; the leaf and child boxes' min and max."""
    return least_ms(*_blas_work(bvh, all_groups))


def tlas_refit(bvh) -> tuple[float, str]:
    """Bound of K5: the instance transforms and inverses and the root boxes
    read, the instance rows and the TLAS rows written; each instance's
    corners, their transform and its world box, the TLAS boxes."""
    return least_ms(*_tlas_work(bvh))


def refit(bvh, all_groups: bool = False) -> tuple[float, str]:
    """Bound of one ``bvh.twolevel.refit``, K4 ``blas`` and K5 together (one
    launch): the skinned groups of a frame, or every group
    (``all_groups``, as at build time)."""
    (o1, b1), (o2, b2) = _blas_work(bvh, all_groups), _tlas_work(bvh)
    return least_ms(o1 + o2, b1 + b2)


# f32 values per pixel of the denoiser (upscale/denoise.py:svgf_filter): in,
# colour 3, G-buffer albedos and normal 9, depth 1, motion 2, state 10; out,
# colour 3, state 10
DENOISER_IN, DENOISER_OUT = 25, 13


def _bytes_ms(n_f32: float) -> tuple[float, str]:
    return n_f32 * 4 / PEAK_BYTES * 1e3, "bytes"


def resize(h: int, w: int, out_h: int, out_w: int, channels: int, kr: int,
           kc: int, quantize: bool = False) -> tuple[float, str]:
    """Bound of one K12 launch (``upscale.spatial.resize``) of (h,w,channels)
    f32 to (out_h,out_w,channels) with kr taps per output row and kc per
    output column: each value read and written once, the tables read once;
    the width's kc products and kc - 1 adds per (input row, output column,
    channel), then the height's kr and kr - 1 per output value. With 3
    channels also the spatial chain's. ``quantize``: its uint8 form, each
    output value written as 1 B with K1's operations on it."""
    out_bytes, out_ops = (1, K1_OPS) if quantize else (4, 0)
    ops = (h * out_w * (2 * kc - 1) + out_h * out_w * (2 * kr - 1 + out_ops)) * channels
    tables = (out_h * (kr + 1) + out_w * (kc + 1)) * 4
    return least_ms(ops, (h * w * 4 + out_h * out_w * out_bytes) * channels + tables)


def temporal_chain(h: int, w: int, out_h: int, out_w: int,
                   quantize: bool = False) -> tuple[float, str]:
    """Bound of ``temporal.temporal_upscale``: colour, depth and motion
    read at render size; the (out_h,out_w,4) history read and written and
    the (out_h,out_w,3) output written (``quantize``: as uint8)."""
    return _bytes_ms(h * w * 6 + out_h * out_w * (4 + 4 + (0.75 if quantize else 3)))


def denoiser(h: int, w: int) -> tuple[float, str]:
    """Bound of ``denoise.svgf_filter`` at render size (h,w)."""
    return _bytes_ms(h * w * (DENOISER_IN + DENOISER_OUT))


def denoised_chain(h: int, w: int, out_h: int, out_w: int,
                   quantize: bool = False) -> tuple[float, str]:
    """Bound of the denoised chain (denoiser, then the temporal upscaler):
    the denoised colour between them need not leave the chip
    (``quantize``: the output written as uint8)."""
    return _bytes_ms(h * w * (DENOISER_IN + DENOISER_OUT - 3)
                     + out_h * out_w * (4 + 4 + (0.75 if quantize else 3)))


def present(mode: str, h: int, w: int, out_h: int, out_w: int,
            fused: bool = True) -> tuple[float, str]:
    """Bound of one present in ``mode`` ("spatial", "temporal" or
    "denoised") of an (h,w) render upscaled to (out_h,out_w). ``fused``:
    what ``presenter.present_device`` runs, the chain whose last kernel
    writes the uint8 image (K12's uint8 form, or the temporal or denoised
    chain with a uint8 output; K1 alone where the spatial chain keeps the
    size); else the f32 chain and then K1 over its output, the route it
    replaces. The spatial chain upscales by Lanczos-3, 6 taps an axis. A
    sum of kernels' bounds names what binds the larger."""
    if mode == "spatial" and (h, w) == (out_h, out_w):
        return k1((h, w, 3))
    chain = {"spatial": lambda q: resize(h, w, out_h, out_w, 3, 6, 6, q),
             "temporal": lambda q: temporal_chain(h, w, out_h, out_w, q),
             "denoised": lambda q: denoised_chain(h, w, out_h, out_w, q)}[mode]
    if fused:
        return chain(True)
    (c_ms, c_by), (q_ms, q_by) = chain(False), k1((out_h, out_w, 3))
    return c_ms + q_ms, c_by if c_ms >= q_ms else q_by


# K9-K11, the presenter kernels (csrc/presenter.cuh), counted per pixel
# from the source: f32 values in and out, each once; operations as the
# source writes them (a division, sqrt or expf counts as one, so the count
# is a floor). K9: in colour, albedos and encoded normal 12, depth 1, motion
# 2, the state 10; out the state's demod 3, m1, m2, length, normal 3, var,
# lum; the demodulation, the ten bilinear fields (9 each), the tests and
# the moments
SVGF_REPROJECT_IN, SVGF_REPROJECT_OUT, SVGF_REPROJECT_OPS = 25, 11, 172
# K10: in filtered 3, var, lum, normal 3, depth (the last pass also the two
# albedos, 6); out filtered 3, var, lum (the last pass the colour, 3); per
# tap the normal dot (5), its clamp (2) and squarings (5), w_z and w_l (5
# each), the weight (4) and the sums (10): 36, 25 taps; per pixel 18
ATROUS_IN, ATROUS_OUT, ATROUS_TAP_OPS, ATROUS_PIXEL_OPS = 9, 5, 36, 18
# K11, per output pixel: in the resize's 6 and the history's 4; out 3 and
# the new history's 4; the motion, the bilinear taps (4 blends of 9), the
# depth test, the 3x3 min/max (48), the weight and the blend
TEMPORAL_RESOLVE_IN, TEMPORAL_RESOLVE_OUT, TEMPORAL_RESOLVE_OPS = 10, 7, 134


def svgf_reproject(h: int, w: int) -> tuple[float, str]:
    """Bound of one K9 launch at render size (h, w)."""
    n = h * w
    return least_ms(n * SVGF_REPROJECT_OPS, n * (SVGF_REPROJECT_IN + SVGF_REPROJECT_OUT) * 4)


def atrous_pass(h: int, w: int, last: bool = False,
                tap_ops: float = ATROUS_TAP_OPS) -> tuple[float, str]:
    """Bound of one K10 launch at (h, w); ``last``: the remodulating pass;
    ``tap_ops`` the instructions a tap counts: by default the source's
    floor; ``chip_smoke.py`` also passes the count of the built kernel's
    SASS (``kernels/sass_diff.tap_instructions``: its divisions and
    ``expf`` expanded, so a figure of the build, not of the work), which it
    reports beside the floor as a diagnostic."""
    n = h * w
    f32 = ATROUS_IN + 6 + 3 if last else ATROUS_IN + ATROUS_OUT
    return least_ms(n * (25 * tap_ops + ATROUS_PIXEL_OPS), n * f32 * 4)


def temporal_resolve(out_h: int, out_w: int, quantize: bool = False) -> tuple[float, str]:
    """Bound of one K11 launch at output size (out_h, out_w); ``quantize``:
    its uint8 form, the output's 3 values as 1 B each with K1's operations
    on them (the new history stays f32)."""
    n = out_h * out_w
    if quantize:
        return least_ms(n * (TEMPORAL_RESOLVE_OPS + 3 * K1_OPS),
                        n * ((TEMPORAL_RESOLVE_IN + TEMPORAL_RESOLVE_OUT - 3) * 4 + 3))
    return least_ms(n * TEMPORAL_RESOLVE_OPS,
                    n * (TEMPORAL_RESOLVE_IN + TEMPORAL_RESOLVE_OUT) * 4)


# K6-K8, the wavefront's stages (csrc/wavefront.cu), counted per lane from
# the source. A Halton digit: the quotient's mul and floor, the remainder's
# mul and sub, two compares, the weight's mul, the sum's mul and add
HALTON_DIGIT_OPS = 9
# K6, per lane: pixel x/y, offset and sample count in (16 B); ray origin and
# direction, throughput and radiance (48 B), five int32 (20 B), the active
# flag (1 B), the hit record's u/v and the cone (12 B) out; two 24-digit
# Halton loops and the camera ray's 30 operations
K6_BYTES = 16 + 48 + 20 + 1 + 12
K6_OPS = 2 * 24 * HALTON_DIGIT_OPS + 30
# K7: every lane reads its active flag and writes its shadow mask; a live
# lane reads its hit's triangle, its ray, throughput, radiance, four int32
# and its Halton offset and writes its radiance, active flag and ray count;
# a hit reads t/u/v, the normals and resource of its shade row (10 f32) and
# the albedo, emission, ior and opacity of its material row (8 f32) and
# writes its ray, throughput and three int32; a shadow ray writes origin,
# direction, extent and radiance; a miss with an environment reads 4 texels
K7_BYTES_LANE = 2
K7_BYTES_LIVE = 4 + 64 + 4 + 12 + 1 + 4
K7_BYTES_HIT = 12 + 40 + 32 + 36 + 12
K7_BYTES_SHADOW = 40
K7_BYTES_ENV = 48
# operations: a hit's point, barycentrics, normal and its normalisation and
# the material's clamps (45); the glass branch's Fresnel and directions (60)
# and its 11-digit transparency dimension; a lit lane's five 11-digit
# dimensions, the light's evaluation (40), PBR shading (110) and the
# cosine-hemisphere bounce (60); a miss's environment lookup (35)
K7_OPS_LIVE = 2
K7_OPS_HIT = 45
K7_OPS_GLASS = 60 + 11 * HALTON_DIGIT_OPS
K7_OPS_LIT = 5 * 11 * HALTON_DIGIT_OPS + 40 + 110 + 60
K7_OPS_ENV = 35
# K7's textured and debug instantiations. Bytes, each input read once
# (``k7_work``'s ``tex_bytes``): the texture bits (the material row's 4th
# float4) of each resource hit, and the texels the samples tap, each
# distinct texel once with the channels of the maps read there (4 B each;
# the packed atlas holds every map of a resource in one 16-f32 texel, the
# mip chains 3 f32 a texel), with the resource's packed rect (16 B) or per
# resource and map its level-0 rect, its level count and two level rects
# (52 B); and each distinct triangle's 72-B motion row where the LOD, the
# tangent basis or the motion view needs its vertices. A debug view's hit
# writes only its colour (not the 48 B of ray, throughput and three int32
# of K7_BYTES_HIT). Operations: a packed sample blends 16 channels (9
# each) after its addressing (20); a mipmapped map's sample two 3-channel
# bilinear taps and the lerp; the LOD (45) once per hit with mipmaps; the
# tangent basis and the bent normal (90) per normal-mapped hit; the motion
# view's two projections (80) per hit at sample 0
K7_BYTES_TEX_BITS = 16
K7_BYTES_PACKED_RECT = 16
K7_BYTES_MIP_RECTS = 16 + 4 + 2 * 16
K7_BYTES_MOTION_ROW = 72
K7_BYTES_DEBUG_SAVED = 48
K7_OPS_PACKED = 16 * 9 + 20
K7_OPS_MIP_MAP = 2 * (3 * 9 + 20) + 9
K7_OPS_LOD = 45
K7_OPS_NORMAL_MAP = 90
K7_OPS_MOTION_VIEW = 80
# K8: every lane reads its shadow mask and occlusion; a lane that adds reads
# its radiance and contribution and writes its radiance (3 adds)
K8_BYTES_LANE, K8_BYTES_ADD, K8_OPS_ADD = 2, 36, 3
# the contribution alone: what an add folded into K7 reads for a live lane,
# whose radiance K7 reads and writes already (K7_BYTES_LIVE)
K8_BYTES_CONTRIB = 12


def k6(n_lanes: int) -> tuple[float, str]:
    """K6's bound for one sample of ``n_lanes`` lanes."""
    return least_ms(n_lanes * K6_OPS, n_lanes * K6_BYTES)


def _k7_bytes(work: dict[str, int]) -> int:
    g = work.get
    return (work["lanes"] * K7_BYTES_LANE + work["live"] * K7_BYTES_LIVE
            + work["hit"] * K7_BYTES_HIT + work["shadow"] * K7_BYTES_SHADOW
            + work["env_miss"] * K7_BYTES_ENV + g("tex_bytes", 0)
            + g("motion_rows", 0) * K7_BYTES_MOTION_ROW - g("debug", 0) * K7_BYTES_DEBUG_SAVED)


def _k7_ops(work: dict[str, int]) -> int:
    g = work.get
    return (work["live"] * K7_OPS_LIVE + work["hit"] * K7_OPS_HIT + work["glass"] * K7_OPS_GLASS
            + work["lit"] * K7_OPS_LIT + work["env_miss"] * K7_OPS_ENV
            + g("packed", 0) * K7_OPS_PACKED + g("mip_maps", 0) * K7_OPS_MIP_MAP
            + g("lod", 0) * K7_OPS_LOD + g("normal_mapped", 0) * K7_OPS_NORMAL_MAP
            + g("motion_view", 0) * K7_OPS_MOTION_VIEW)


def k7(work: dict[str, int]) -> tuple[float, str]:
    """K7's bound for one iteration's lane counts (``k7_work``), every lane
    of the wavefront run (the full-width K7)."""
    return least_ms(_k7_ops(work), _k7_bytes(work))


def k8(n_lanes: int, n_added: int) -> tuple[float, str]:
    """K8's bound: ``n_lanes`` lanes, ``n_added`` of them adding radiance
    (the trailing K8's lanes are the last list's)."""
    return least_ms(n_added * K8_OPS_ADD, n_lanes * K8_BYTES_LANE + n_added * K8_BYTES_ADD)


def k7_listed(work: dict[str, int]) -> tuple[float, str]:
    """The listed K7's bound for one step's lane counts
    (``k7_work`` with a list): ``k7``'s over its listed lanes
    (``work["lanes"]``) plus the adds it folds in: each listed lane reads its
    shadow mask and occlusion when a shadow ray may be pending
    (``work["resolved"]``), and each lane that adds (``work["added"]``)
    reads its contribution and, unless it is live (``work["added_live"]``,
    whose radiance K7 moves already), reads and writes its radiance."""
    added, live = work.get("added", 0), work.get("added_live", 0)
    nbytes = (_k7_bytes(work) + work.get("resolved", 0) * K8_BYTES_LANE
              + (added - live) * K8_BYTES_ADD + live * K8_BYTES_CONTRIB)
    ops = _k7_ops(work) + added * K8_OPS_ADD
    return least_ms(ops, nbytes)


def _texel_bytes(fr, st, hits, hit, res, sampled, mipmapped: bool, lane=None) -> int:
    """The bytes of the distinct texels one step's texture samples tap,
    with their rects: per map (``sampled``: map, its f32 width, the hits
    that sample it) the packed atlas's texels (the map's channels of each)
    or, with mipmaps, the texels of the two levels' rects. ``lane``: a gp
    step's per-lane rows (``kernels.wavefront.LaneRows``), whose taps, where
    it has them, are read per lane (64 B each) instead of the atlas."""
    import torch

    from ..assets import texture as tex
    from ..kernels import wavefront as W

    atlas = fr.scene.atlas
    if lane is not None and lane.taps is not None:
        any_sampled = torch.zeros_like(hit)
        for _, _, mask in sampled:
            any_sampled = any_sampled | mask
        return int(any_sampled.sum()) * tex.PACKED_C * 4
    srow = (fr.geom.shade_rows[hits.triangle.clamp_min(0).long()] if lane is None
            else lane.shade)
    u_b1, v_b1 = hits.u[:, None], hits.v[:, None]
    w_b1 = 1.0 - u_b1 - v_b1
    uv = W._tex_coord(srow, u_b1, v_b1, w_b1)
    nbytes, taps, any_sampled = 0, [], torch.zeros_like(hit)
    if mipmapped:
        nrm = W._hit_normal(srow, u_b1, v_b1, w_b1, st.ray_d)
        mrow = (fr.geom.motion_rows[hits.triangle.clamp_min(0).long()] if lane is None
                else lane.motion)
        lod = W._lod_base(fr, st.cone_t + torch.where(hit, hits.t, 0.0), st.ray_d, nrm, srow, mrow)
    for m, width, mask in sampled:
        if not bool(mask.any()):
            continue
        any_sampled = any_sampled | mask
        if mipmapped:
            rect0, rect1, _ = tex.trilinear_rects(atlas, res[mask], m, lod[mask])
            rects, texel_w = (rect0, rect1), atlas.width
            nbytes += int(res[mask].unique().numel()) * K7_BYTES_MIP_RECTS
        else:
            rects, texel_w = (atlas.packed_rects[res[mask]],), atlas.packed.shape[1]
        for rect in rects:
            gx0, gx1, gy0, gy1, _, _ = tex.rect_taps(rect, uv[mask])
            for gy in (gy0, gy1):
                for gx in (gx0, gx1):
                    taps.append((gy * texel_w + gx).long())
        if not mipmapped:  # this map's channels of each distinct texel
            nbytes += int(torch.cat(taps[-4:]).unique().numel()) * width * 4
    if mipmapped and taps:
        nbytes += int(torch.cat(taps).unique().numel()) * 3 * 4
    elif taps:
        nbytes += int(res[any_sampled].unique().numel()) * K7_BYTES_PACKED_RECT
    return nbytes


# K13 (gp_rows): per lane its live flag (1 B) in and its position (4 B)
# out; per live lane its hit id (4 B) in, its lane_of entry (4 B) and its
# rows out; each distinct triangle looked up reads its g2l entry (4 B), each
# distinct one this rank owns its rows (64 B shade, 72 B motion)
K13_BYTES_LIVE, K13_BYTES_POS, K13_BYTES_ID, K13_BYTES_LANE_OF, K13_BYTES_G2L = 1, 4, 4, 4, 4
# K13's gather (a gp step's rows after the hit combine), per row: its lane
# (4 B), the lane's t and triangle (8 B) and the reduced key (8 B) in, the
# payload (12 B) and its rows out; per row this rank won, the lane's u and
# v (8 B); each distinct triangle won reads its g2l entry and its rows once
K13_GATHER_BYTES_ROW, K13_GATHER_BYTES_WON = 4 + 8 + 8 + 12, 8
# K15 (gp_hit_keys), per row: its lane (4 B), the lane's t and triangle
# (8 B) in, the key (8 B) out; its second form the lane's occlusion (1 B)
# in, 1 B out
K15_BYTES_ROW, K15_BYTES_OCC_ROW = 4 + 8 + 8, 4 + 1 + 1
# K16 (gp_lane_unpack), per row: the key (8 B), the payload (12 B), its
# lane (4 B) in, the lane's t, triangle, u, v (16 B) out; its second form
# the row's occlusion (1 B) and lane (4 B) in, the lane's (1 B) out
K16_BYTES_ROW, K16_BYTES_OCC_ROW = 8 + 12 + 4 + 16, 1 + 4 + 1
# K14 (banded_taps), per row: the shade row's uvs and resource (the 32 B of
# its last two float4), its lane (4 B), the lane's u and v (8 B) in, 64 B
# out; each distinct resource's packed rect (16 B) and each distinct texel
# of this rank's band tapped (64 B) once. Operations: the texture
# coordinate (9), the repeat addressing (20) and the 16 channels' blends (9
# each)
K14_BYTES_LANE = 32 + 4 + 8 + 64
K14_BYTES_RECT, K14_BYTES_TEXEL = 16, 64
K14_OPS_LANE = 9 + 20 + 16 * 9


def gp_rows(geom, ids, live, shade: bool = True, motion: bool = False) -> tuple[float, str]:
    """K13's bound for one call (the arguments of
    ``kernels.wavefront.gp_rows``): bytes. The scan reads every lane's flag
    (none when ``live`` is None: every lane live) and writes its position;
    each live lane's id is read and its lane_of entry and rows written; each
    distinct triangle looked up reads its g2l entry, each owned one its
    rows, once."""
    P = ids.shape[0]
    cols = 16 * shade + 18 * motion
    lanes = ids if live is None else ids[live]
    n_live = lanes.shape[0]
    looked = lanes[lanes >= 0].long().unique()
    owned = int((geom.g2l[looked] >= 0).sum())
    nbytes = ((P * K13_BYTES_LIVE if live is not None else 0) + P * K13_BYTES_POS
              + n_live * (K13_BYTES_ID + K13_BYTES_LANE_OF + cols * 4)
              + looked.numel() * K13_BYTES_G2L + owned * cols * 4)
    return least_ms(0, nbytes)


def gp_scan(live) -> tuple[float, str]:
    """K13's bound for a gp step's scan (``kernels.wavefront.gp_scan``):
    bytes, each lane's flag read and its position written, each live lane's
    ``lane_of`` entry written."""
    P = live.shape[0]
    n_live = int(live.sum())
    return least_ms(0, P * (K13_BYTES_LIVE + K13_BYTES_POS) + n_live * K13_BYTES_LANE_OF)


def gp_gather(geom, t, tri, keys, lane_of, shade: bool = True,
              motion: bool = False) -> tuple[float, str]:
    """K13's bound for a gp step's gather (the arguments of
    ``kernels.wavefront.gp_gather``): bytes, from the rows this rank wins
    (as ``gp_gather_plain`` finds them)."""
    from ..kernels import wavefront as W

    axis = geom.axis
    cols = 16 * shade + 18 * motion
    n = lane_of.shape[0]
    ti = tri[lane_of.long()]
    won = (ti >= 0) & (W.hit_keys_of(t[lane_of.long()], ti, axis.index, axis.size > 1) == keys)
    tris = ti[won].long().unique()
    owned = int((geom.g2l[tris] >= 0).sum())
    nbytes = (n * (K13_GATHER_BYTES_ROW + cols * 4) + int(won.sum()) * K13_GATHER_BYTES_WON
              + tris.numel() * K13_BYTES_G2L + owned * cols * 4)
    return least_ms(0, nbytes)


def gp_hit_keys(n: int) -> tuple[float, str]:
    """K15's bound for n rows: bytes."""
    return least_ms(0, n * K15_BYTES_ROW)


def gp_occluded_rows(n: int) -> tuple[float, str]:
    """K15's second form's bound for n rows: bytes."""
    return least_ms(0, n * K15_BYTES_OCC_ROW)


def gp_lane_unpack(n: int) -> tuple[float, str]:
    """K16's bound for n rows: bytes."""
    return least_ms(0, n * K16_BYTES_ROW)


def gp_occluded_lanes(n: int) -> tuple[float, str]:
    """K16's second form's bound for n rows: bytes."""
    return least_ms(0, n * K16_BYTES_OCC_ROW)


def banded_taps(atlas, srow, u, v, lane_of) -> tuple[float, str]:
    """K14's bound for one call (the arguments of
    ``kernels.wavefront.banded_taps``): its rows, the distinct rects and
    the distinct texels of this rank's band that the taps reach."""
    import torch

    from ..assets import texture as tex
    from ..kernels import wavefront as W

    P = srow.shape[0]
    res = srow[:, 15].to(torch.int32).long()
    idx = lane_of.long()
    u_b1, v_b1 = u[idx][:, None], v[idx][:, None]
    uv = W._tex_coord(srow, u_b1, v_b1, 1.0 - u_b1 - v_b1)
    gx0, gx1, gy0, gy1, _, _ = tex.rect_taps(atlas.packed_rects[res], uv)
    hb, width = atlas.packed.shape[0], atlas.packed.shape[1]
    taps = []
    for gy in (gy0, gy1):
        ly = gy.long() - atlas.band_lo
        own = (ly >= 0) & (ly < hb)
        for gx in (gx0, gx1):
            taps.append((ly * width + gx.long())[own])
    texels = int(torch.cat(taps).unique().numel())
    nbytes = (P * K14_BYTES_LANE + int(res.unique().numel()) * K14_BYTES_RECT
              + texels * K14_BYTES_TEXEL)
    return least_ms(P * K14_OPS_LANE, nbytes)


def k7_work(fr, st, hits, shadow, n_listed: int | None = None, pending=None,
            occluded=None, rows=None) -> dict[str, int]:
    """K7's lane counts for one iteration, from the plain version's inputs
    (the ``kernels.wavefront.Frame`` ``fr``, the state ``st`` before it and
    the closest ``hits``) and its shadow rays (None in a debug view): lanes,
    live lanes, hits, glass hits, lit hits, shadow rays and misses that read
    the environment; with texture maps, mipmaps or a debug view also the
    texture bytes the step reads, each once (``tex_bytes``: texture bits,
    rects and the distinct texels tapped), the packed samples (``packed``),
    the mipmapped maps sampled (``mip_maps``, per hit and map), the distinct
    motion rows read, the LODs, the normal-mapped hits and the debug view's
    hits (``debug``; ``motion_view`` those that project their motion). For
    the listed K7, ``n_listed`` is the lanes it ran over,
    and with the ``pending`` shadow rays of the step before and their
    ``occluded`` the work also counts the lanes that resolve one, the lanes
    that add (``need & ~occluded``) and those of them live. ``rows``: a gp
    step's per-lane rows (K7's lane-row form), which it reads per lane: the
    motion rows counted per lane that needs one, the taps per lane that
    samples."""
    import torch

    from ..assets import texture as tex
    from ..core import types as T
    from ..kernels import wavefront as W

    s, statics = fr.settings, fr.statics
    if rows is not None:  # read per lane, as the plain body reads them
        rows = W.at_lanes(rows)
    debug = s.debug_mode != T.DEBUG_MODE_NONE
    live = st.active
    hit = live & (hits.triangle >= 0)
    glass = torch.zeros_like(hit)
    tri = hits.triangle.clamp_min(0).long()
    res = (fr.geom.shade_rows[tri, 15] if rows is None else rows.shade[:, 15]).to(torch.int32)
    res = res.long()
    mat = fr.geom.mat_rows[res]
    if statics.has_refraction and not debug:
        glass = hit & ((torch.clamp(mat[:, 11], 0.0, 1.0) < 0.999)
                       | (torch.clamp(mat[:, 10], min=1.0) > 1.01))
    env_miss = live & ~hit if statics.has_environment else torch.zeros_like(hit)
    lit = hit & ~glass if not debug else torch.zeros_like(hit)
    work = dict(lanes=int(live.numel()) if n_listed is None else n_listed, live=int(live.sum()),
                hit=int(hit.sum()), glass=int(glass.sum()), lit=int(lit.sum()),
                shadow=0 if shadow is None else int(shadow.need.sum()),
                env_miss=int(env_miss.sum()))
    z = torch.zeros_like(hit)
    sampled, normal = [], z  # (map, its width in f32, the hits that sample it)
    mipmapped = bool(s.use_mipmaps) and any(statics.any_map)
    tex_bytes = 0
    if any(statics.any_map):
        bits = mat[:, 12].to(torch.int32)

        def has(m, bit):
            return hit & ((bits & bit) != 0) if statics.any_map[m] else z

        # the maps the output needs: every map the material has, or in a
        # debug view the one it shows
        maps = {tex.MAP_BASECOLOR: (T.MATERIAL_TEXTURE_BASECOLOR, T.DEBUG_MODE_BASECOLOR),
                tex.MAP_NORMAL: (T.MATERIAL_TEXTURE_NORMAL, T.DEBUG_MODE_NORMAL),
                tex.MAP_ROUGHNESS: (T.MATERIAL_TEXTURE_ROUGHNESS, T.DEBUG_MODE_ROUGHNESS),
                tex.MAP_METALLIC: (T.MATERIAL_TEXTURE_METALLIC, T.DEBUG_MODE_METALLIC),
                tex.MAP_OPACITY: (T.MATERIAL_TEXTURE_OPACITY, None),
                tex.MAP_EMISSION: (T.MATERIAL_TEXTURE_EMISSION, T.DEBUG_MODE_EMISSION)}
        if T.ENABLE_AO:
            maps[tex.MAP_AO] = (T.MATERIAL_TEXTURE_AO, T.DEBUG_MODE_AO)
        normal = has(tex.MAP_NORMAL, T.MATERIAL_TEXTURE_NORMAL)
        sampled = [(m, tex._PACKED_SLICE[m][1], has(m, bit)) for m, (bit, view) in maps.items()
                   if not debug or s.debug_mode == view]
        tex_bytes = int(res[hit].unique().numel()) * K7_BYTES_TEX_BITS
        tex_bytes += _texel_bytes(fr, st, hits, hit, res, sampled, mipmapped, rows)
    any_sampled = z
    for _, _, x in sampled:
        any_sampled = any_sampled | x
    mapped = normal if not debug else z
    # the motion view projects at sample 0 (the frame has no had0 yet)
    motion_view = hit if s.debug_mode == T.DEBUG_MODE_MOTION and fr.had0 is None else z
    # the LOD is needed where a map is sampled with mipmaps
    lod = any_sampled if mipmapped else z
    need_rows = lod | mapped | motion_view
    work.update(tex_bytes=tex_bytes, packed=0 if mipmapped else int(any_sampled.sum()),
                mip_maps=sum(int(x.sum()) for _, _, x in sampled) if mipmapped else 0,
                motion_rows=(int(tri[need_rows].unique().numel()) if rows is None
                             else int(need_rows.sum())), lod=int(lod.sum()),
                normal_mapped=int(mapped.sum()),
                debug=work["hit"] if debug else 0, motion_view=int(motion_view.sum()))
    if pending is not None:
        add = pending.need & ~occluded
        work.update(resolved=work["lanes"], added=int(add.sum()),
                    added_live=int((add & live).sum()))
    return work
