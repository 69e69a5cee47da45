"""The least time an NVIDIA H100 could take for the work of the port's kernels.

A kernel's bound is the larger of two times: the bytes its function must move
(each input read once, each output written once) over the memory rate, and
the f32 operations it does on these inputs over the rate the card issues
them. Where the work depends on the data (K2's traversal), it is counted
from what one call's data needs, from the plain version's per-row visits.

Peak rates, H100 SXM (NVIDIA's data sheet, 700 W): 3.35 TB/s of HBM3 and
67 TFLOP/s of f32 outside the tensor cores, a rate that counts a fused
multiply-add as two operations (132 SMs x 128 lanes x 2 x 1.98 GHz). The
kernels are built with ``-fmad=false``, so each add, sub, mul, min, max,
compare and division they count is one instruction, issued at half that:
PEAK_F32_OPS. A product's fused multiply-add is one instruction too.

Besides the kernels: the two torch-op stages of an animated frame's
prepare, the LBS product (``lbs``) and the skinned refit (``refit``), and
the presenter's torch-op chains (``resize``, ``temporal_chain``,
``denoiser``, ``denoised_chain``), whose bounds say what a hand kernel could
gain there. The presenter's bounds count bytes only: a banded resize needs
6 taps per axis (Lanczos-3 at 2x), so its operations take a fraction of
its byte time.
"""

from __future__ import annotations

from ..bvh.wide import _META_MASK, ARITY, IDS_OFF, LEAF_K, META_OFF, ROW, decode_ids

PEAK_BYTES = 3.35e12
PEAK_F32_OPS = 67e12 / 2

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


def k2(work: dict[str, int], n_lanes: int, n_live: int, masked: bool = False) -> tuple[float, str]:
    """K2's bound for one call over ``n_lanes`` lanes, ``n_live`` of them
    active, with ``work`` from ``k2_work`` (``masked``: the rays carried
    masks)."""
    live_lane = K2_BYTES_LIVE_LANE + (K2_BYTES_RAY_MASK if masked else 0)
    nbytes = (work["row_bytes"] + n_live * live_lane + (n_lanes - n_live) * K2_BYTES_DEAD_LANE)
    return least_ms(work["ops"], nbytes)


def lbs(n_vertices: int, n_joints: int) -> tuple[float, str]:
    """Bound of ``skinning.lbs.skin`` for one model: the (V,J) weights, the
    rest positions and normals and the (J,4,4) matrices read, the skinned
    positions and normals written; V*J*12 multiply-adds of the product and
    33 operations per vertex of the affine apply."""
    v, j = n_vertices, n_joints
    nbytes = v * j * 4 + v * 6 * 4 + j * 16 * 4 + v * 6 * 4
    return least_ms(v * j * 12 + v * 33, nbytes)


def refit(bvh) -> tuple[float, str]:
    """Bound of one per-frame ``bvh.twolevel.refit``: the skinned groups'
    posed vertices, indices, leaf and child ids and the instance transforms
    read; the skinned groups' leaf and internal rows, the instance rows,
    the TLAS rows and the root boxes written (512 B a row). Operations: the
    leaf boxes (a min and a max per vertex coordinate), one min and max per
    child box coordinate in each of the depth + 1 internal passes, the 8
    corners and the inverse of each instance, and the TLAS passes."""
    nbytes = ops = 0
    for _il, ni, _ll, nl, depth, _root, _vs, v_count, slot in bvh.mesh_meta:
        if slot < 0:
            continue
        n_tris = bvh.skin_indices[slot].shape[0]
        nbytes += v_count * 12 + n_tris * 12 + nl * LEAF_K * 4 + ni * ARITY * 4
        nbytes += (nl + ni) * ROW * 4 + 24
        ops += nl * LEAF_K * 9 * 2 + ni * ARITY * 3 * 2 * (depth + 1)
    n_inst, tn = bvh.n_instances, bvh.tlas_n
    nbytes += n_inst * 64 + tn * ARITY * 4 + (n_inst + tn) * ROW * 4
    ops += n_inst * (8 * 3 * 8 + 60) + tn * ARITY * 3 * 2 * (bvh.tlas_depth + 1)
    return least_ms(ops, nbytes)


# f32 values per pixel of the denoiser (upscale/denoise.py:svgf_filter): in,
# colour 3, G-buffer albedos and normal 9, depth 1, motion 2, state 10; out,
# colour 3, state 10
DENOISER_IN, DENOISER_OUT = 25, 13


def _bytes_ms(n_f32: float) -> tuple[float, str]:
    return n_f32 * 4 / PEAK_BYTES * 1e3, "bytes"


def resize(h: int, w: int, out_h: int, out_w: int, channels: int) -> tuple[float, str]:
    """Bound of one ``upscale.spatial.resize`` of (h,w,channels) f32 to
    (out_h,out_w,channels); with 3 channels also the spatial chain's."""
    return _bytes_ms((h * w + out_h * out_w) * channels)


def temporal_chain(h: int, w: int, out_h: int, out_w: int) -> tuple[float, str]:
    """Bound of ``temporal.temporal_upscale``: colour, depth and motion
    read at render size; the (out_h,out_w,4) history read and written and
    the (out_h,out_w,3) output written."""
    return _bytes_ms(h * w * 6 + out_h * out_w * (4 + 4 + 3))


def denoiser(h: int, w: int) -> tuple[float, str]:
    """Bound of ``denoise.svgf_filter`` at render size (h,w)."""
    return _bytes_ms(h * w * (DENOISER_IN + DENOISER_OUT))


def denoised_chain(h: int, w: int, out_h: int, out_w: int) -> tuple[float, str]:
    """Bound of the denoised chain (denoiser, then the temporal upscaler):
    the denoised colour between them need not leave the chip."""
    return _bytes_ms(h * w * (DENOISER_IN + DENOISER_OUT - 3) + out_h * out_w * (4 + 4 + 3))
