"""One frame's lanes traced in torch ops: a frozen copy of the plain route
of ``mrt_tpu_torch/render/wavefront.py`` (``build_geometry`` and
``trace_pixels`` with ``plain=True``) on one device, with the traversal
handed in (``bvh.Traversal``: the benchmark's own BVH over the frame's
world-space triangles, not the port's table).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import shade as S
from . import stages as W
from . import types as T


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
    g2l: None = None


def pack_mat_rows(m: T.Materials) -> torch.Tensor:
    return torch.cat([
        m.base_color, m.specular, m.emission, m.specular_exponent[:, None],
        m.refraction_index[:, None], m.opacity[:, None],
        m.texture_flags.to(torch.float32)[:, None],
        torch.zeros((m.base_color.shape[0], 3), dtype=torch.float32, device=m.base_color.device),
    ], dim=1)


def build_geometry(scene, positions_w, prev_positions_w, normals_w) -> Geometry:
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


class LaneOutputs(NamedTuple):
    """Per-lane outputs of one traced frame (before accumulation)."""

    color: torch.Tensor  # (P,3) averaged over samples
    depth: torch.Tensor  # (P,)
    motion: torch.Tensor  # (P,2) pixel units, +Y down
    rays_traced: torch.Tensor  # (P,) int32 closest + any-hit traversals launched
    samples: torch.Tensor  # (P,) int32 samples traced (base + motion-adaptive extras)


def trace_pixels(settings: T.RenderSettings, statics, scene, trav, geom: Geometry,
                 uniforms: T.FrameUniforms, pixel_x: torch.Tensor, pixel_y: torch.Tensor,
                 offsets: torch.Tensor, prev_motion: torch.Tensor) -> LaneOutputs:
    """Trace every sample of P pixels (lanes): per sample the camera rays,
    then per iteration the closest hits, the shading step (which first
    resolves the previous iteration's shadow rays) and the shadow rays'
    occlusion, and at the sample's end the last shadow rays. ``trav`` has
    ``closest_hit(rays, mask)`` and ``any_hit(rays, mask)``."""
    P = pixel_x.shape[0]
    dev = pixel_x.device
    f32 = torch.float32
    base = uniforms.frame_index * settings.sample_stride
    fr = W.make_frame(settings, statics, scene, geom, uniforms, pixel_x, pixel_y, offsets,
                      prev_motion, base)
    base_samples = settings.base_samples
    max_extra = settings.max_extra_samples
    # each iteration consumes a bounce or a transparency pass (passes cap at
    # max_bounces), so this bound never cuts a live lane
    max_iters = settings.max_bounces * (settings.max_bounces + 2) + 2
    inf_d = torch.full((P,), float("inf"), dtype=f32, device=dev)
    wv = W.Wave()

    total_color = torch.zeros((P, 3), dtype=f32, device=dev)
    rays_total = torch.zeros(P, dtype=torch.int32, device=dev)
    total = torch.full((P,), base_samples, dtype=torch.int32, device=dev)
    n_samples = base_samples
    extra_live = []
    depth0 = motion0 = None
    sidx = 0
    while sidx < n_samples:
        st = W.sample_start_plain(fr, sidx, total)
        wv = W.Wave()  # nothing pending at a sample's start
        live = P if sidx < base_samples else extra_live[sidx - base_samples]
        it = 0
        while it < max_iters and live:
            it += 1
            hits = trav.closest_hit(T.Rays(st.ray_o, st.ray_d, inf_d), st.active)
            st, wv, n_live = W.shade_hit_listed_plain(fr, st, hits, sidx, wv)
            if wv.shadow is not None:
                sh = wv.shadow
                occluded = trav.any_hit(T.Rays(sh.origin, sh.direction, sh.distance), sh.need)
                wv = wv._replace(occluded=occluded)
            live = int(n_live)
        st = W.resolve_shadow_listed_plain(st, wv)

        if sidx == 0:
            # depth/motion from the recorded bounce-0 hit
            mrow_p = W._tri_rows(geom.motion_rows, st.prim_tri.clamp_min(0).long(), geom)
            mot, pdepth = W.screen_motion(uniforms, mrow_p, st.prim_u[:, None], st.prim_v[:, None],
                                          fr.width_f, fr.height_f)
            had0 = st.prim_tri >= 0
            depth0 = torch.where(had0, torch.clamp(pdepth, min=1.0e-3),
                                 torch.full((P,), 1.0e8, dtype=f32, device=dev))
            motion0 = torch.where(had0[:, None], mot, torch.zeros((P, 2), dtype=f32, device=dev))
            if max_extra > 0:
                # decided once, after sample 0 (Raytracing.metal:779-789)
                motion_mag = torch.maximum(S.length2(motion0), S.length2(prev_motion))
                low = torch.clamp(uniforms.motion_sampling_low_px, min=0.0)
                high = torch.maximum(uniforms.motion_sampling_high_px, low + 1e-3)
                t = torch.clamp((motion_mag - low) / (high - low), 0.0, 1.0)
                extra = torch.round(t * max_extra).to(torch.int32).clamp(0, max_extra)
                total = base_samples + extra
                levels = torch.arange(max_extra, dtype=torch.int32, device=dev)
                extra_live = (extra[None, :] > levels[:, None]).sum(1).tolist()
                n_samples = min(settings.sample_stride,
                                base_samples + sum(n > 0 for n in extra_live))
        total_color = total_color + st.accumulated
        rays_total = rays_total + st.rays
        sidx += 1
    return LaneOutputs(color=total_color / total.to(f32)[:, None], depth=depth0, motion=motion0,
                       rays_traced=rays_total, samples=total)
