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
the shard that owns the triangle holds, by a sum, so every rank then shades
identically. On the kernel route all of it covers a step's live lanes
only, compacted in lane order (``kernels/wavefront.lane_rows``): K13's scan
maps them, K15's keys hold each hit's t and rank for one min over gp, the
winner's K13 gather writes the hit and its rows for one psum, K16 writes
the combined hit into the closest-hit record, K14 and a psum give a banded
atlas's taps, and the occlusion goes down to the live lanes for its max
(``lane_occluded``); the live-lane count that sizes them is the one the
loop reads to end it. On the plain route the combine runs over every lane
and K7's plain body gathers and sums the rows itself
(``kernels/wavefront._tri_rows``).

Shadow rays are traced as their own batch right after they are made (the
JAX package may defer them into the next bounce's closest-hit batch; that
changes only the order of the radiance sums). ``rays_traced`` counts the
closest-hit plus any-hit traversals launched for live lanes, as the JAX
package counts them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..bvh import kind, twolevel, wide
from ..core import types as T
from ..dist import comm
from ..engine.scene import SceneData, SceneStatics
from ..kernels import wavefront as W
from ..kernels.wavefront import sample_packed_across  # noqa: F401  (the gp tests' name)
from ..utils import telemetry as tm
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


def trace_pixels(settings: T.RenderSettings, statics: SceneStatics, scene: SceneData,
                 bvh: twolevel.TwoLevelBVH | wide.WideBVH, geom: Geometry,
                 uniforms: T.FrameUniforms,
                 pixel_x: torch.Tensor, pixel_y: torch.Tensor, offsets: torch.Tensor,
                 prev_motion: torch.Tensor, sample_base: int | None = None,
                 plain: bool = False) -> TileOutputs:
    """Trace every sample of P pixels (lanes). pixel_x/pixel_y/offsets: (P,)
    int32 on the scene's device; prev_motion (P,2): the previous frame's
    motion at these pixels, for the motion-adaptive extra samples;
    ``sample_base``: the Halton index base (default frame_index *
    sample_stride). Each sample runs ``sample_start``, then per iteration
    the closest-hit traversal, ``shade_hit`` (which first resolves the
    previous iteration's shadow rays) and the any-hit traversal, and after
    its last iteration ``resolve_shadow`` (``kernels/wavefront.py``):
    kernels K6-K8 (the kernel route), K7 reading the closest-hit
    traversal's raw record; with ``plain`` (the checks' plain route) the
    plain stages, on the traversal's ``Hits``. Under geometry sharding the
    closest hits are combined over gp first, on the kernel route over each
    step's live lanes with their rows (``W.lane_rows``: K13-K16 and their
    collectives), as is the occlusion (``W.lane_occluded``), sized by the
    live-lane count the loop reads anyway (the previous step's; at a
    sample's first step the lanes whose sample count reaches it, read with
    the extra samples' largest count)."""
    T.check_supported(settings)
    gax = None
    if settings.geometry_axis:
        gax = geom.axis
        if gax is None or not kind.is_flat(bvh):
            raise ValueError("geometry_axis needs a shard's flat table and its shard geometry "
                             "(dist.geometry)")
    with tm.span("mrt.trace.setup"):
        P = pixel_x.shape[0]
        dev = pixel_x.device
        f32 = torch.float32
        base = uniforms.frame_index * settings.sample_stride if sample_base is None else sample_base
        route = not plain
        fr = W.make_frame(settings, statics, scene, geom, uniforms, pixel_x, pixel_y, offsets,
                          prev_motion, base,
                          tri_base=None if kind.is_flat(bvh) else bvh.flat_tri_base, plain=plain)
        if route:
            sample_start, shade_hit, resolve_shadow = W.sample_start, W.shade_hit, W.resolve_shadow
        else:
            sample_start, shade_hit, resolve_shadow = (W.sample_start_plain,
                                                       W.shade_hit_listed_plain,
                                                       W.resolve_shadow_listed_plain)
        base_samples = settings.base_samples
        max_extra = settings.max_extra_samples
        # each iteration consumes a bounce or a transparency pass (passes cap at
        # max_bounces), so this bound never cuts a live lane
        max_iters = settings.max_bounces * (settings.max_bounces + 2) + 2
        inf_d = torch.full((P,), float("inf"), dtype=f32, device=dev)
        trav = kind.traversal(bvh)
        # Raytracing.metal:317,733-735: closest-hit rays see the LIGHT bit only
        # from the camera; shadow rays never do
        # the masks reach the traversal only for a masked (two-level) scene
        shadow_kw = ({"ray_mask": torch.full((P,), T.RAY_MASK_SHADOW, dtype=torch.int32,
                                             device=dev)}
                     if bvh.has_masks else {})
        if route:  # the traversals' shadow flags, made once
            closest_flags = torch.zeros(P, dtype=torch.bool, device=dev)
            shadow_kw["flags"] = torch.ones(P, dtype=torch.bool, device=dev)
        wv = W.make_wave(fr, max_iters)

        total_color = torch.zeros((P, 3), dtype=f32, device=dev)
        rays_total = torch.zeros(P, dtype=torch.int32, device=dev)
        total = torch.full((P,), base_samples, dtype=torch.int32, device=dev)
    n_samples = base_samples
    # the lanes live at each extra sample's first step (extra > k at sample base + k)
    extra_live = []
    depth0 = motion0 = None
    st = None
    sidx = 0
    # the loop's counters, summed here and added once after it
    steps = live_lanes = syncs = 0
    with tm.span("mrt.trace.loop"):
        while sidx < n_samples:
            with tm.span("mrt.sample_start"):
                st = sample_start(fr, sidx, total, st)
                wv = W.new_sample(wv)
            # a sample starts with its lanes with total > sidx (at least one); then
            # the loop reads shade_hit's live-lane count: one host sync per iteration
            live = P if sidx < base_samples else extra_live[sidx - base_samples]
            it = 0
            while it < max_iters and live:
                it += 1
                steps += 1
                live_lanes += live
                with tm.span("mrt.closest"):
                    closest_kw = {}
                    if bvh.has_masks:
                        closest_kw["ray_mask"] = torch.where(st.bounce == 0, T.RAY_MASK_PRIMARY,
                                                             T.RAY_MASK_SECONDARY).to(torch.int32)
                    rays = T.Rays(st.ray_o, st.ray_d, inf_d)
                    rows = None
                    if route:
                        hits = trav.closest_raw(bvh, rays, closest_flags, mask=st.active,
                                                **closest_kw)
                        if gax is not None:
                            # the hits combined over gp in the raw record at the live
                            # lanes, where K7 reads them (a flat table's: no tri_base)
                            with tm.span("mrt.lane_rows"):
                                rows = W.lane_rows(fr, st, hits, wv, live)
                    else:
                        hits = trav.closest_hit(bvh, rays, mask=st.active, **closest_kw)
                        if gax is not None:
                            hits = combine_hits_across(hits, gax)
                with tm.span("mrt.shade"):
                    st, wv, n_live = shade_hit(fr, st, hits, sidx, wv, rows)
                if wv.shadow is not None:  # None: a debug view retired every lane at its first hit
                    with tm.span("mrt.any_hit"):
                        sh = wv.shadow
                        occluded = trav.any_hit(bvh, T.Rays(sh.origin, sh.direction, sh.distance),
                                                mask=sh.need, **shadow_kw)
                        if gax is not None and route:
                            with tm.span("mrt.lane_occluded"):
                                occluded = W.lane_occluded(occluded, rows.lane_of, gax, wv)
                        elif gax is not None:
                            occluded = comm.pmax(occluded.to(torch.int32), gax) > 0
                        wv = wv._replace(occluded=occluded)
                with tm.span("mrt.sync.live"):
                    live = int(n_live)
                syncs += 1
            with tm.span("mrt.resolve"):
                st = resolve_shadow(st, wv)

            if sidx == 0:
                with tm.span("mrt.sample0"):
                    # depth/motion from the recorded bounce-0 hit
                    if route and gax is not None:
                        mrow_p = W.gp_motion_rows(geom, st.prim_tri)
                    else:
                        mrow_p = W._tri_rows(geom.motion_rows, st.prim_tri.clamp_min(0).long(),
                                             geom)
                    mot, pdepth = W.screen_motion(uniforms, mrow_p, st.prim_u[:, None],
                                                  st.prim_v[:, None], fr.width_f, fr.height_f)
                    had0 = st.prim_tri >= 0
                    depth0 = torch.where(had0, torch.clamp(pdepth, min=1.0e-3),
                                         torch.full((P,), 1.0e8, dtype=f32, device=dev))
                    motion0 = torch.where(had0[:, None], mot,
                                          torch.zeros((P, 2), dtype=f32, device=dev))
                    fr = fr._replace(had0=had0, motion0=motion0)
                    if max_extra > 0:
                        # decided once, after sample 0 (Raytracing.metal:779-789)
                        motion_mag = torch.maximum(S.length2(motion0), S.length2(prev_motion))
                        low = torch.clamp(uniforms.motion_sampling_low_px, min=0.0)
                        high = torch.maximum(uniforms.motion_sampling_high_px, low + 1e-3)
                        t = torch.clamp((motion_mag - low) / (high - low), 0.0, 1.0)
                        extra = torch.round(t * max_extra).to(torch.int32).clamp(0, max_extra)
                        total = base_samples + extra
                        # the loop runs to the batch's largest count, and each extra
                        # sample starts with the lanes it reaches: one host sync
                        levels = torch.arange(max_extra, dtype=torch.int32, device=dev)
                        with tm.span("mrt.sync.extra"):
                            extra_live = (extra[None, :] > levels[:, None]).sum(1).tolist()
                        syncs += 1
                        tm.count("extra_samples", sum(extra_live))
                        n_samples = min(settings.sample_stride,
                                        base_samples + sum(n > 0 for n in extra_live))
            total_color = total_color + st.accumulated
            rays_total = rays_total + st.rays
            sidx += 1
    tm.count("loop_steps", steps)
    tm.count("live_lanes", live_lanes)
    tm.count("lane_slots", steps * P)
    tm.count("host_syncs", syncs)

    with tm.span("mrt.trace.setup"):
        gb = {}
        if settings.enable_gbuffer:
            gb = {k: getattr(st, k) for k in W.GBUFFER_FIELDS if k != "wrote_gb"}
        return TileOutputs(color=total_color / total.to(f32)[:, None], depth=depth0,
                           motion=motion0, rays_traced=rays_total, samples=total, **gb)


def trace_frame(settings, statics, scene, bvh, geom, uniforms, offsets: torch.Tensor,
                prev_motion: torch.Tensor, y0: int = 0,
                sample_base: int | None = None, plain: bool = False) -> TileOutputs:
    """Trace the (h,W) row block of ``offsets`` whose first row is image row
    ``y0`` (the whole frame by default; data-parallel ranks each trace their
    own rows), ``LANE_BATCH`` pixels at a time; ``prev_motion`` (h,W,2) is
    the previous frame's motion; ``sample_base`` and ``plain`` as
    ``trace_pixels``'s.
    Returns TileOutputs with (h,W) leading dims."""
    h, w = offsets.shape
    dev = offsets.device
    n = h * w
    with tm.span("mrt.trace.setup"):
        idx = torch.arange(n, dtype=torch.int32, device=dev)
        px_all, py_all, offs_all = idx % w, idx // w + y0, offsets.reshape(-1)
        pmot_all = prev_motion.reshape(n, 2)
    parts = []
    for s in range(0, n, LANE_BATCH):
        sl = slice(s, min(s + LANE_BATCH, n))
        parts.append(trace_pixels(settings, statics, scene, bvh, geom, uniforms,
                                  px_all[sl], py_all[sl], offs_all[sl], pmot_all[sl],
                                  sample_base=sample_base, plain=plain))
    with tm.span("mrt.trace.setup"):
        return TileOutputs(*(None if f[0] is None else
                             torch.cat(f).reshape((h, w) + f[0].shape[1:])
                             for f in zip(*parts)))
