"""Wavefront path tracer — counterpart of ``mrt_tpu/render/wavefront.py``.

The same per-lane program as the JAX package's ``trace_tile``: per sample,
camera rays with Halton jitter; then a bounce loop in which every divergent
branch is a lane mask (closest hit, environment on miss, primary hit record,
normal and texture fetch, normal mapping, the glass transparency branch,
emission, 1-of-N light sampling over the four light types, PBR or legacy
shading with an any-hit shadow ray, cosine-hemisphere bounce). Depth and
motion are projected from the recorded bounce-0 hit after sample 0. With
motion-adaptive sampling, sample 0's motion and the previous frame's decide
each pixel's extra samples (Raytracing.metal:779-789); a pixel's radiance is
averaged over its own sample count.

Off by default, as in the JAX package: the debug views (``debug_mode`` 1-7,
Raytracing.metal:459-490), which write a colour at the first hit and retire
the lane; mipmapped texture sampling at a ray-cone LOD (``use_mipmaps``);
and geometry-mask filtering, whose ray masks (primary or secondary for
closest-hit rays, shadow for any-hit rays) are passed to the traversal only
when some instance has a non-default mask (``TwoLevelBVH.has_masks``).

The rays traverse the BVH the renderer holds: the two-level one
(``bvh/twolevel.py``, kernel K2) or the flat table (``bvh/wide.py``,
kernel K3), whose hits carry the same global triangle ids. Under geometry
sharding (``settings.geometry_axis``, ``dist/geometry.py``) every rank of
the gp axis traces the same lanes against its own shard's flat table: the
closest hits are combined by min-t (``combine_hits_across``), the shadow
rays' occlusion by a max, and each hit's shade and motion rows, which only
the shard that owns the triangle holds, by a sum (``_tri_rows``), so every
rank then shades identically.

Shadow rays are traced as their own batch right after they are made (the
JAX package may defer them into the next bounce's closest-hit batch; that
changes only the order of the radiance sums). ``rays_traced`` counts the
closest-hit plus any-hit traversals launched for live lanes, as the JAX
package counts them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..assets import texture as tex
from ..bvh import kind, twolevel, wide
from ..core import halton as H
from ..core import types as T
from ..dist import comm
from ..engine.scene import SceneData, SceneStatics
from . import shade as S

# pixels traced per batch by trace_frame; a bound on the frame's lane-state memory
LANE_BATCH = 1 << 22


class Geometry(NamedTuple):
    """Per-frame world-space geometry packed into per-triangle rows."""

    positions_w: torch.Tensor  # (V,3)
    prev_positions_w: torch.Tensor  # (V,3)
    normals_w: torch.Tensor  # (V,3)
    tri_v0: torch.Tensor  # (T,3) world-space triangle verts
    tri_v1: torch.Tensor
    tri_v2: torch.Tensor
    # (T,16): [n0(3) n1(3) n2(3) uv0(2) uv1(2) uv2(2) resource(1)]
    shade_rows: torch.Tensor
    # (T,18): cur verts (9) + prev verts (9)
    motion_rows: torch.Tensor
    # (R,16): [base(3) specular(3) emission(3) spec_exp ior opacity flags pad(3)]
    mat_rows: torch.Tensor
    # geometry sharding (dist/geometry.py): global triangle id -> this
    # shard's row (-1: another rank's); the shade and motion rows are then
    # the shard's own, and ``axis`` (dist.comm.Axis) is the gp axis
    g2l: torch.Tensor | None = None
    axis: object = None


def _tri_rows(table: torch.Tensor, tri: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """Per-hit rows of ``table`` for the (P,) triangle ids ``tri``. Under
    geometry sharding the rank that owns a triangle gathers its row, the
    others add zeros, and a psum over the gp axis gives every rank the row
    (exact; -0.0 comes back as +0.0)."""
    if geom.g2l is None:
        return table[tri]
    loc = geom.g2l[tri].long()
    rows = torch.where((loc >= 0)[:, None], table[loc.clamp_min(0)], 0.0)
    return comm.psum(rows, geom.axis)


def sample_packed_across(atlas: tex.TextureAtlas, resource: torch.Tensor, uv: torch.Tensor,
                         axis) -> torch.Tensor:
    """``tex.sample_packed`` over an atlas banded over the gp ``axis``
    (``dist.comm.Axis``): each rank's share of the taps
    (``tex.sample_packed_banded``), summed over the axis."""
    return comm.psum(tex.sample_packed_banded(atlas, resource, uv), axis)


def combine_hits_across(hits: T.Hits, axis) -> T.Hits:
    """Min-t reduction of the ranks' closest hits over a geometry-sharded
    mesh axis (``dist.comm.Axis``): every rank traced the same rays against
    its own shard; the winner is the globally closest hit, a tie going to
    the lowest rank; the triangle is -1 where no rank hit."""
    t_min = comm.pmin(hits.t, axis)
    mine = (hits.t == t_min) & (hits.triangle >= 0)
    winner_rank = comm.pmin(torch.where(mine, axis.index, 1 << 30).to(torch.int32), axis)
    winner = mine & (winner_rank == axis.index)
    ids = comm.psum(torch.stack([torch.where(winner, hits.triangle, 0), winner.to(torch.int32)]),
                    axis)
    uv = comm.psum(torch.stack([torch.where(winner, hits.u, 0.0),
                                torch.where(winner, hits.v, 0.0)]), axis)
    return T.Hits(t=t_min, triangle=ids[0] - (1 - ids[1]), u=uv[0], v=uv[1])


def pack_mat_rows(m: T.Materials) -> torch.Tensor:
    return torch.cat([
        m.base_color, m.specular, m.emission, m.specular_exponent[:, None],
        m.refraction_index[:, None], m.opacity[:, None],
        m.texture_flags.to(torch.float32)[:, None],
        torch.zeros((m.base_color.shape[0], 3), dtype=torch.float32, device=m.base_color.device),
    ], dim=1)


def build_geometry(scene: SceneData, positions_w, prev_positions_w, normals_w) -> Geometry:
    idx = scene.indices.long()
    v0, v1, v2 = (positions_w[idx[:, k]] for k in range(3))
    n0, n1, n2 = (normals_w[idx[:, k]] for k in range(3))
    uv0, uv1, uv2 = (scene.uvs[idx[:, k]] for k in range(3))
    res_f = scene.tri_resource.to(torch.float32)
    shade_rows = torch.cat([n0, n1, n2, uv0, uv1, uv2, res_f[:, None]], dim=1)
    p0, p1, p2 = (prev_positions_w[idx[:, k]] for k in range(3))
    motion_rows = torch.cat([v0, v1, v2, p0, p1, p2], dim=1)
    return Geometry(positions_w, prev_positions_w, normals_w, v0, v1, v2, shade_rows,
                    motion_rows, pack_mat_rows(scene.materials))


class TileOutputs(NamedTuple):
    """Per-pixel outputs of one traced frame (pre-accumulation)."""

    color: torch.Tensor  # (P,3) averaged over samples
    depth: torch.Tensor  # (P,)
    motion: torch.Tensor  # (P,2) pixel units, +Y down
    rays_traced: torch.Tensor  # (P,) int32 closest + any-hit traversals launched
    samples: torch.Tensor  # (P,) int32 samples traced (base + motion-adaptive extras)
    # G-buffer of sample 0's first hit; None unless settings.enable_gbuffer
    diffuse_albedo: torch.Tensor | None = None  # (P,3) albedo * (1 - metallic)
    specular_albedo: torch.Tensor | None = None  # (P,3) 0.04 + (albedo - 0.04) * metallic
    normal: torch.Tensor | None = None  # (P,3) shading normal * 0.5 + 0.5
    roughness: torch.Tensor | None = None  # (P,) in [0, 1]


def sample_environment(env_map: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """Bilinear equirect lookup. direction (R,3) unit -> (R,3) radiance."""
    d = direction
    u = 0.5 + torch.atan2(d[:, 2], d[:, 0]) / (2.0 * S.PI)
    v = torch.clamp(0.5 - torch.asin(torch.clamp(d[:, 1], -1.0, 1.0)) / S.PI, 0.0, 1.0)
    he, we = env_map.shape[0], env_map.shape[1]
    x = u * we - 0.5
    y = v * he - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    xi0 = torch.remainder(x0.to(torch.int32), we)
    xi1 = torch.remainder(x0.to(torch.int32) + 1, we)
    yi0 = torch.clamp(y0.to(torch.int32), 0, he - 1)
    yi1 = torch.clamp(y0.to(torch.int32) + 1, 0, he - 1)
    flat = env_map.reshape(-1, 3)
    c00 = flat[(yi0 * we + xi0).long()]
    c10 = flat[(yi0 * we + xi1).long()]
    c01 = flat[(yi1 * we + xi0).long()]
    c11 = flat[(yi1 * we + xi1).long()]
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def _project(camera: T.Camera, world_pos: torch.Tensor):
    """Screen projection used for motion vectors."""
    view = world_pos - camera.position
    sx = S.dot3(view, camera.right)
    sy = S.dot3(view, camera.up)
    depth = S.dot3(view, camera.forward)
    denom = torch.clamp(depth, min=0.001)
    return sx / denom, sy / denom, depth


def _screen_motion(uniforms: T.FrameUniforms, mrow, u, v, width_f, height_f):
    """Motion in pixels (+Y down) and depth of the surface point at
    barycentrics (u, v) (each (P,1)) of the (P,18) motion rows."""
    w = 1.0 - u - v
    cam = uniforms.camera
    obj_pos_w = u * mrow[:, 3:6] + v * mrow[:, 6:9] + w * mrow[:, 0:3]
    prev_pos_w = u * mrow[:, 12:15] + v * mrow[:, 15:18] + w * mrow[:, 9:12]
    sx, sy, pdepth = _project(cam, obj_pos_w)
    psx, psy, _ = _project(uniforms.previous_camera, prev_pos_w)
    right_scale = torch.clamp(S.length(cam.right), min=1e-5)
    up_scale = torch.clamp(S.length(cam.up), min=1e-5)
    motion_px_x = (sx - psx) * (width_f / (2.0 * right_scale))
    motion_px_y = -((sy - psy) * (height_f / (2.0 * up_scale)))
    return torch.stack([motion_px_x, motion_px_y], -1), pdepth


def _where3(m, a, b):
    return torch.where(m[:, None], a, b)


def trace_pixels(settings: T.RenderSettings, statics: SceneStatics, scene: SceneData,
                 bvh: twolevel.TwoLevelBVH | wide.WideBVH, geom: Geometry,
                 uniforms: T.FrameUniforms,
                 pixel_x: torch.Tensor, pixel_y: torch.Tensor, offsets: torch.Tensor,
                 prev_motion: torch.Tensor, sample_base: int | None = None) -> TileOutputs:
    """Trace every sample of P pixels (lanes). pixel_x/pixel_y/offsets: (P,)
    int32 on the scene's device; prev_motion (P,2): the previous frame's
    motion at these pixels, for the motion-adaptive extra samples;
    ``sample_base``: the Halton index base (default frame_index *
    sample_stride)."""
    T.check_supported(settings)
    gax = None
    if settings.geometry_axis:
        gax = geom.axis
        if gax is None or not kind.is_flat(bvh):
            raise ValueError("geometry_axis needs a shard's flat table and its shard geometry "
                             "(dist.geometry)")
    P = pixel_x.shape[0]
    dev = pixel_x.device
    f32 = torch.float32
    # 0-d device tensors: a Python scalar numerator would turn ``c / x`` into
    # ``reciprocal(x) * c`` (two roundings), and a CUDA ``x / c`` into ``x * (1/c)``
    width_f = torch.tensor(float(settings.width), dtype=f32, device=dev)
    height_f = torch.tensor(float(settings.height), dtype=f32, device=dev)
    base = uniforms.frame_index * settings.sample_stride if sample_base is None else sample_base
    base_samples = settings.base_samples
    max_extra = settings.max_extra_samples
    # each iteration consumes a bounce or a transparency pass (passes cap at
    # max_bounces), so this bound never cuts a live lane
    max_iters = settings.max_bounces * (settings.max_bounces + 2) + 2
    cam = uniforms.camera
    inf_d = torch.full((P,), float("inf"), dtype=f32, device=dev)
    debug_mode = settings.debug_mode
    motion_view = debug_mode == T.DEBUG_MODE_MOTION
    if settings.use_mipmaps:
        # the pixel's angular size, for the ray cone's footprint
        up_len = torch.sqrt((cam.up ** 2).sum())
        fwd_len = torch.sqrt((cam.forward ** 2).sum())
        pixel_angle = 2.0 * up_len / (height_f * torch.clamp(fwd_len, min=1e-5))
    trav = kind.traversal(bvh)
    # Raytracing.metal:317,733-735: closest-hit rays see the LIGHT bit only
    # from the camera; shadow rays never do
    # the masks reach the traversal only for a masked (two-level) scene
    shadow_kw = ({"ray_mask": torch.full((P,), T.RAY_MASK_SHADOW, dtype=torch.int32, device=dev)}
                 if bvh.has_masks else {})

    def camera_rays(sidx: int):
        hidx0 = offsets + base + sidx
        rx = H.halton(hidx0, 0)
        ry = H.halton(hidx0, 1)
        u = (pixel_x.to(f32) + rx) / width_f * 2.0 - 1.0
        v = (pixel_y.to(f32) + ry) / height_f * 2.0 - 1.0
        ray_d = S.normalize(u[:, None] * cam.right + v[:, None] * cam.up + cam.forward)
        return cam.position.expand(P, 3), ray_d

    total_color = torch.zeros((P, 3), dtype=f32, device=dev)
    rays_total = torch.zeros(P, dtype=torch.int32, device=dev)
    total = torch.full((P,), base_samples, dtype=torch.int32, device=dev)
    n_samples = base_samples
    depth0 = motion0 = had0 = None
    gb = None
    if settings.enable_gbuffer:
        gb = dict(diffuse_albedo=torch.zeros((P, 3), dtype=f32, device=dev),
                  specular_albedo=torch.zeros((P, 3), dtype=f32, device=dev),
                  normal=torch.zeros((P, 3), dtype=f32, device=dev),
                  roughness=torch.zeros(P, dtype=f32, device=dev))
        wrote_gb = torch.zeros(P, dtype=torch.bool, device=dev)
    sidx = 0
    while sidx < n_samples:
        hidx = offsets + base + sidx
        is_sample0 = sidx == 0
        ray_o, ray_d = camera_rays(sidx)
        color = torch.ones((P, 3), dtype=f32, device=dev)
        accumulated = torch.zeros((P, 3), dtype=f32, device=dev)
        bounce = torch.zeros(P, dtype=torch.int32, device=dev)
        step = torch.zeros(P, dtype=torch.int32, device=dev)
        tpasses = torch.zeros(P, dtype=torch.int32, device=dev)
        # a lane past its own sample count neither adds radiance nor counts rays
        active = total > sidx
        depth = torch.full((P,), 1.0e8, dtype=f32, device=dev)
        motion = torch.zeros((P, 2), dtype=f32, device=dev)
        prim_tri = torch.full((P,), -1, dtype=torch.int32, device=dev)
        prim_u = torch.zeros(P, dtype=f32, device=dev)
        prim_v = torch.zeros(P, dtype=f32, device=dev)
        rays = torch.zeros(P, dtype=torch.int32, device=dev)
        cone_t = torch.zeros(P, dtype=f32, device=dev)  # path length, for the mip LOD

        it = 0
        while it < max_iters and bool(active.any()):
            it += 1
            rays = rays + active.to(torch.int32)
            closest_kw = {}
            if bvh.has_masks:
                closest_kw["ray_mask"] = torch.where(bounce == 0, T.RAY_MASK_PRIMARY,
                                                     T.RAY_MASK_SECONDARY).to(torch.int32)
            hits = trav.closest_hit(bvh, T.Rays(ray_o, ray_d, inf_d), mask=active, **closest_kw)
            if gax is not None:
                hits = combine_hits_across(hits, gax)
            hit = hits.hit & active
            if statics.has_environment:
                missed = active & ~hit
                env = sample_environment(scene.env_map, ray_d) * scene.env_intensity
                accumulated = accumulated + _where3(missed, color * env, 0.0)
            active = active & hit

            tri = hits.triangle.clamp_min(0).long()
            srow = _tri_rows(geom.shade_rows, tri, geom)
            res = srow[:, 15].to(torch.int32)
            world_point = ray_o + ray_d * hits.t[:, None]
            u_b1 = hits.u[:, None]
            v_b1 = hits.v[:, None]
            w_b1 = 1.0 - u_b1 - v_b1

            # --- primary hit record (bounce 0, sample 0) ----------------------------
            if is_sample0:
                primary = hit & (bounce == 0)
                prim_tri = torch.where(primary, hits.triangle, prim_tri)
                prim_u = torch.where(primary, hits.u, prim_u)
                prim_v = torch.where(primary, hits.v, prim_v)

            if settings.use_mipmaps or motion_view:
                mrow = _tri_rows(geom.motion_rows, tri, geom)

            # --- surface normal ------------------------------------------------------
            nrm_raw = u_b1 * srow[:, 3:6] + v_b1 * srow[:, 6:9] + w_b1 * srow[:, 0:3]
            degenerate = S.length(nrm_raw) < 1e-10
            nrm = _where3(degenerate, -ray_d, S.normalize(nrm_raw))

            # --- ray-cone mip LOD: the cone's radius grows with the path
            # length; its footprint goes to UV units by the hit triangle's
            # uv-area / world-area ratio
            if settings.use_mipmaps:
                dist = cone_t + torch.where(hit, hits.t, 0.0)
                e1w = mrow[:, 3:6] - mrow[:, 0:3]
                e2w = mrow[:, 6:9] - mrow[:, 0:3]
                world_area = 0.5 * S.length(S.cross(e1w, e2w))
                du1 = srow[:, 11:13] - srow[:, 9:11]
                du2 = srow[:, 13:15] - srow[:, 9:11]
                uv_area = 0.5 * (du1[:, 0] * du2[:, 1] - du1[:, 1] * du2[:, 0]).abs()
                cos_inc = torch.clamp(S.dot3(ray_d, nrm).abs(), min=0.25)
                footprint_w = dist * pixel_angle / cos_inc
                footprint_uv = footprint_w * torch.sqrt(uv_area / torch.clamp(world_area, min=1e-12))
                lod_base = torch.log2(torch.clamp(footprint_uv, min=1e-8))
                cone_t = cone_t + torch.where(hit, hits.t, 0.0)

            # --- material + textures ---------------------------------------------------
            matrow = geom.mat_rows[res.long()]
            albedo = matrow[:, 0:3]
            flags = matrow[:, 12].to(torch.int32)
            tex_coord = u_b1 * srow[:, 11:13] + v_b1 * srow[:, 13:15] + w_b1 * srow[:, 9:11]
            tex_coord = torch.stack([tex_coord[:, 0], 1.0 - tex_coord[:, 1]], dim=1)
            packed = []

            def tex_sample(map_type):
                if settings.use_mipmaps:
                    return tex.sample_trilinear(scene.atlas, res, map_type, tex_coord, lod_base)
                if not packed:
                    if gax is not None and scene.atlas.band_lo is not None:
                        packed.append(sample_packed_across(scene.atlas, res, tex_coord, gax))
                    else:
                        packed.append(tex.sample_packed(scene.atlas, res, tex_coord))
                return tex.packed_map(packed[0], map_type)

            def has(bit):
                return (flags & bit) != 0

            base_sample = None
            if statics.any_map[tex.MAP_BASECOLOR]:
                base_sample = tex_sample(tex.MAP_BASECOLOR)
                albedo = _where3(has(T.MATERIAL_TEXTURE_BASECOLOR), albedo * base_sample, albedo)
            roughness = torch.ones(P, dtype=f32, device=dev)
            if statics.any_map[tex.MAP_ROUGHNESS]:
                s = tex_sample(tex.MAP_ROUGHNESS)[:, 0]
                roughness = torch.where(has(T.MATERIAL_TEXTURE_ROUGHNESS), s, roughness)
            metallic = torch.zeros(P, dtype=f32, device=dev)
            if statics.any_map[tex.MAP_METALLIC]:
                s = tex_sample(tex.MAP_METALLIC)[:, 0]
                metallic = torch.where(has(T.MATERIAL_TEXTURE_METALLIC), s, metallic)
            ao = torch.ones(P, dtype=f32, device=dev)
            if T.ENABLE_AO and statics.any_map[tex.MAP_AO]:
                s = tex_sample(tex.MAP_AO)[:, 0]
                ao = torch.where(has(T.MATERIAL_TEXTURE_AO), s, ao)
            opacity = torch.clamp(matrow[:, 11], 0.0, 1.0)
            if statics.any_map[tex.MAP_OPACITY]:
                s = tex_sample(tex.MAP_OPACITY)[:, 0]
                opacity = torch.where(has(T.MATERIAL_TEXTURE_OPACITY), opacity * s, opacity)
            emission = matrow[:, 6:9]
            if statics.any_map[tex.MAP_EMISSION]:
                s = tex_sample(tex.MAP_EMISSION)
                emission = _where3(has(T.MATERIAL_TEXTURE_EMISSION), s, emission)

            # --- debug views: the colour at the hit, then the lane retires -----------------
            if debug_mode != T.DEBUG_MODE_NONE:
                magenta = torch.tensor([1.0, 0.0, 1.0], dtype=f32, device=dev).expand(P, 3)
                if debug_mode == T.DEBUG_MODE_BASECOLOR:
                    debug = (magenta if base_sample is None
                             else _where3(has(T.MATERIAL_TEXTURE_BASECOLOR), base_sample, magenta))
                elif debug_mode == T.DEBUG_MODE_NORMAL:
                    debug = nrm * 0.5 + 0.5
                    if statics.any_map[tex.MAP_NORMAL]:
                        debug = _where3(has(T.MATERIAL_TEXTURE_NORMAL), tex_sample(tex.MAP_NORMAL), debug)
                elif debug_mode == T.DEBUG_MODE_ROUGHNESS:
                    debug = roughness[:, None].expand(P, 3)
                elif debug_mode == T.DEBUG_MODE_METALLIC:
                    debug = metallic[:, None].expand(P, 3)
                elif debug_mode == T.DEBUG_MODE_AO:
                    debug = ao[:, None].expand(P, 3) if T.ENABLE_AO else magenta
                elif debug_mode == T.DEBUG_MODE_EMISSION:
                    debug = emission
                else:  # the motion view: sample 0's motion (Raytracing.metal:342,482-487)
                    if is_sample0:
                        now, _ = _screen_motion(uniforms, mrow, u_b1, v_b1, width_f, height_f)
                        mp = _where3(hit, now, prev_motion)
                    else:
                        mp = _where3(had0, motion0, prev_motion)
                    scaled = torch.clamp(mp * 0.05, -1.0, 1.0)
                    mag = torch.clamp(S.length2(mp) * 0.1, 0.0, 1.0)
                    debug = torch.stack([scaled[:, 0] * 0.5 + 0.5, scaled[:, 1] * 0.5 + 0.5, mag], -1)
                accumulated = _where3(hit, debug, accumulated)
                active = torch.zeros_like(active)
                continue

            # --- normal mapping ------------------------------------------------------------
            shading_nrm = nrm
            if statics.any_map[tex.MAP_NORMAL]:
                if not (settings.use_mipmaps or motion_view):
                    mrow = _tri_rows(geom.motion_rows, tri, geom)
                valid_tb, tangent, _ = S.tangent_basis_rows(
                    mrow[:, 0:3], mrow[:, 3:6], mrow[:, 6:9],
                    srow[:, 9:11], srow[:, 11:13], srow[:, 13:15])
                world_t = S.normalize(tangent - nrm * S.dot3(tangent, nrm)[:, None])
                world_b = S.normalize(S.cross(nrm, world_t))
                nmap = tex_sample(tex.MAP_NORMAL) * 2.0 - 1.0
                mapped = S.normalize(nmap[:, 0:1] * world_t + nmap[:, 1:2] * world_b
                                     + nmap[:, 2:3] * nrm)
                shading_nrm = _where3(has(T.MATERIAL_TEXTURE_NORMAL) & valid_tb, mapped, nrm)

            # --- G-buffer: sample 0's first hit, before the glass branch -------------------
            if gb is not None and is_sample0:
                write_gb = hit & ~wrote_gb
                m = metallic[:, None]
                gb["diffuse_albedo"] = _where3(write_gb, albedo * (1.0 - m), gb["diffuse_albedo"])
                gb["specular_albedo"] = _where3(write_gb, 0.04 + (albedo - 0.04) * m,
                                                gb["specular_albedo"])
                gb["normal"] = _where3(write_gb, shading_nrm * 0.5 + 0.5, gb["normal"])
                gb["roughness"] = torch.where(write_gb, torch.clamp(roughness, 0.0, 1.0),
                                              gb["roughness"])
                wrote_gb = wrote_gb | write_gb

            # --- glass / transparency branch ---------------------------------------------
            step0 = step
            qmc_cur, qmc_nxt = H.step_bases_pair(step0)
            skip_lighting = torch.zeros(P, dtype=torch.bool, device=dev)
            if statics.has_refraction:
                ior = torch.clamp(matrow[:, 10], min=1.0)
                clamped_op = torch.clamp(opacity, 0.0, 1.0)
                glass = hit & ((clamped_op < 0.999) | (ior > 1.01))
                N = shading_nrm
                I = ray_d
                cosi = torch.clamp(S.dot3(-I, N), -1.0, 1.0)
                inside = cosi < 0.0
                cosi = cosi.abs()
                N = _where3(inside, -N, N)
                one = torch.ones_like(ior)
                eta_i = torch.where(inside, ior, one)
                eta_t = torch.where(inside, one, ior)
                eta = eta_i / eta_t
                k = 1.0 - eta * eta * (1.0 - cosi * cosi)
                f0 = ((eta_t - eta_i) / (eta_t + eta_i)) ** 2
                F = f0 + (1.0 - f0) * torch.pow(torch.clamp(1.0 - cosi, 0.0, 1.0), 5.0)
                transmission = 1.0 - clamped_op
                reflect_w = F
                refract_w = (1.0 - F) * transmission
                total_w = torch.clamp(reflect_w + refract_w, min=1e-4)
                reflect_prob = reflect_w / total_w
                choice = H.halton_base(hidx, qmc_cur["transparency"], H.STEP_MAX_DIGITS)
                do_reflect = (k < 0.0) | (choice < reflect_prob)
                reflect_dir = S.normalize(I - 2.0 * S.dot3(I, N)[:, None] * N)
                cos_t = torch.sqrt(torch.clamp(k, min=0.0))
                refract_dir = S.normalize(eta[:, None] * I + (eta * cosi - cos_t)[:, None] * N)
                new_dir = _where3(do_reflect, reflect_dir, refract_dir)
                new_origin = world_point + new_dir * 1e-3
                new_color = _where3(do_reflect, color * total_w[:, None],
                                    color * total_w[:, None] * albedo)
                ray_d = _where3(glass, new_dir, ray_d)
                ray_o = _where3(glass, new_origin, ray_o)
                color = _where3(glass, new_color, color)
                consume_bounce = ~(glass & ~do_reflect)
                skip_lighting = glass
                g_bounce = torch.where(consume_bounce, bounce + 1, bounce)
                g_tp = torch.where(consume_bounce, 0, tpasses + 1)
                overflow = ~consume_bounce & (g_tp > settings.max_bounces)
                g_bounce = torch.where(overflow, g_bounce + 1, g_bounce)
                g_tp = torch.where(overflow, 0, g_tp)
                step = torch.where(glass, step + 1, step)
                bounce = torch.where(glass, g_bounce, bounce)
                tpasses = torch.where(glass, g_tp, tpasses)

            lit = active & ~skip_lighting
            accumulated = accumulated + _where3(lit, color * emission, 0.0)

            adv = step > step0  # glass lanes advanced one step

            def qmc(name):
                return H.halton_base(hidx, torch.where(adv, qmc_nxt[name], qmc_cur[name]),
                                     H.STEP_MAX_DIGITS)

            light_sample = qmc("light_pick")
            u_area = torch.stack([qmc("area_a"), qmc("area_b")], -1)
            u_b = torch.stack([qmc("bounce_x"), qmc("bounce_y")], -1)

            # --- pick 1 of N lights ----------------------------------------------------------
            n_lights = statics.n_lights
            lights = scene.lights
            if settings.light_sampling == "power" and n_lights > 1:
                lum = torch.clamp(lights.color.abs().sum(dim=1), min=1e-6)
                area = S.length(S.cross(lights.right, lights.up))
                wgt = torch.where(lights.type == T.LIGHT_TYPE_AREA,
                                  lum * torch.clamp(area, min=1e-6), lum)
                pmf = wgt / wgt.sum()
                cdf = torch.cumsum(pmf, dim=0)
                light_index = torch.searchsorted(cdf, light_sample).clamp(0, n_lights - 1)
                light_weight = (1.0 / torch.clamp(pmf[light_index], min=1e-8))[:, None]
            else:
                light_index = torch.clamp((light_sample * n_lights).to(torch.int32),
                                          max=n_lights - 1)
                light_weight = float(n_lights)
            l_dir, l_col, l_dist = S.evaluate_light(lights, light_index, u_area, world_point)
            l_col = l_col * light_weight

            # --- shading ------------------------------------------------------------------------
            shadow_o = world_point + nrm * 1e-3
            shadow_dist = l_dist - 1e-3
            if settings.shading_mode == T.SHADING_MODE_LEGACY:
                L = S.normalize(l_dir)
                n_dot_l = S.saturate(S.dot3(shading_nrm, L))
                legacy_color = color * albedo
                dead_before = S.length(legacy_color) < 0.001
                active = active & ~(lit & dead_before)
                lit = lit & ~dead_before
                need_shadow = lit & (S.length(l_col) > 0.0001) & (n_dot_l > 0.0)
                contrib = legacy_color * l_col * n_dot_l[:, None]
            else:
                perceptual_roughness = torch.clamp(roughness, 0.04, 1.0)
                alpha = perceptual_roughness * perceptual_roughness
                F0 = 0.04 + (albedo - 0.04) * metallic[:, None]
                V = S.normalize(-ray_d)
                has_light = S.length(l_col) > 0.0001
                L = S.normalize(l_dir)
                Hv = S.normalize(V + L)
                n_dot_l = S.saturate(S.dot3(shading_nrm, L))
                n_dot_v = S.saturate(S.dot3(shading_nrm, V))
                n_dot_h = S.saturate(S.dot3(shading_nrm, Hv))
                v_dot_h = S.saturate(S.dot3(V, Hv))
                Fr = S.fresnel_schlick(v_dot_h, F0)
                D = S.distribution_ggx(n_dot_h, alpha)
                kk = perceptual_roughness + 1.0
                kk = (kk * kk) / 8.0
                G = S.geometry_smith(n_dot_v, n_dot_l, kk)
                specular = (D * G)[:, None] * Fr / torch.clamp(4.0 * n_dot_v * n_dot_l, min=1e-4)[:, None]
                kD = (1.0 - Fr) * (1.0 - metallic)[:, None]
                diffuse = kD * albedo / S.PI
                direct = (diffuse + specular) * l_col * n_dot_l[:, None]
                need_shadow = lit & has_light
                contrib = color * direct

            rays = rays + need_shadow.to(torch.int32)
            occluded = trav.any_hit(bvh, T.Rays(shadow_o, l_dir, shadow_dist), mask=need_shadow,
                                    **shadow_kw)
            if gax is not None:
                occluded = comm.pmax(occluded.to(torch.int32), gax) > 0
            accumulated = accumulated + _where3(need_shadow & ~occluded, contrib, 0.0)

            if settings.shading_mode == T.SHADING_MODE_LEGACY:
                new_color = legacy_color * ao[:, None]
            else:
                # throughput: diffuse only, AO on indirect
                new_color = color * albedo * ((1.0 - metallic) * ao)[:, None]
            color = _where3(lit, new_color, color)
            dead = S.length(color) < 0.001
            active = active & ~(lit & dead)
            lit = lit & ~dead

            # --- cosine-hemisphere bounce ---------------------------------------------------------
            bounce_dir = S.align_hemisphere_with_normal(S.sample_cosine_hemisphere(u_b), shading_nrm)
            ray_o = _where3(lit, world_point + nrm * 1e-3, ray_o)
            ray_d = _where3(lit, bounce_dir, ray_d)
            step = torch.where(lit, step + 1, step)
            bounce = torch.where(lit, bounce + 1, bounce)
            tpasses = torch.where(lit, 0, tpasses)
            active = active & (bounce < settings.max_bounces)

        if is_sample0:
            # depth/motion from the recorded bounce-0 hit
            mrow_p = _tri_rows(geom.motion_rows, prim_tri.clamp_min(0).long(), geom)
            mot, pdepth = _screen_motion(uniforms, mrow_p, prim_u[:, None], prim_v[:, None],
                                         width_f, height_f)
            had0 = prim_tri >= 0
            depth0 = torch.where(had0, torch.clamp(pdepth, min=1.0e-3), depth)
            motion0 = _where3(had0, mot, motion)
            if max_extra > 0:
                # decided once, after sample 0 (Raytracing.metal:779-789)
                motion_mag = torch.maximum(S.length2(motion0), S.length2(prev_motion))
                low = torch.clamp(uniforms.motion_sampling_low_px, min=0.0)
                high = torch.maximum(uniforms.motion_sampling_high_px, low + 1e-3)
                t = torch.clamp((motion_mag - low) / (high - low), 0.0, 1.0)
                extra = torch.round(t * max_extra).to(torch.int32).clamp(0, max_extra)
                total = base_samples + extra
                # the loop runs to the batch's largest count: one host sync
                n_samples = min(settings.sample_stride, base_samples + int(extra.max()))
        total_color = total_color + accumulated
        rays_total = rays_total + rays
        sidx += 1

    return TileOutputs(color=total_color / total.to(f32)[:, None], depth=depth0, motion=motion0,
                       rays_traced=rays_total, samples=total, **(gb or {}))


def trace_frame(settings, statics, scene, bvh, geom, uniforms, offsets: torch.Tensor,
                prev_motion: torch.Tensor, y0: int = 0,
                sample_base: int | None = None) -> TileOutputs:
    """Trace the (h,W) row block of ``offsets`` whose first row is image row
    ``y0`` (the whole frame by default; data-parallel ranks each trace their
    own rows), ``LANE_BATCH`` pixels at a time; ``prev_motion`` (h,W,2) is
    the previous frame's motion; ``sample_base`` as ``trace_pixels``'s.
    Returns TileOutputs with (h,W) leading dims."""
    h, w = offsets.shape
    dev = offsets.device
    n = h * w
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    px_all, py_all, offs_all = idx % w, idx // w + y0, offsets.reshape(-1)
    pmot_all = prev_motion.reshape(n, 2)
    parts = []
    for s in range(0, n, LANE_BATCH):
        sl = slice(s, min(s + LANE_BATCH, n))
        parts.append(trace_pixels(settings, statics, scene, bvh, geom, uniforms,
                                  px_all[sl], py_all[sl], offs_all[sl], pmot_all[sl],
                                  sample_base=sample_base))
    return TileOutputs(*(None if f[0] is None else torch.cat(f).reshape((h, w) + f[0].shape[1:])
                         for f in zip(*parts)))
