"""The port's wavefront stages in their plain form: a frozen copy of
``mrt_tpu_torch/kernels/wavefront.py``'s plain versions of K6-K8
(``sample_start_plain``, ``shade_hit_listed_plain``,
``resolve_shadow_listed_plain``) with the helpers they use, taken when the
benchmark was written so that a later change to the port cannot move the
reference. Geometry sharding, the kernels' wrappers and their buffers are
left out: the reference traces one device's lanes in torch ops. So are the
paths no cell of the benchmark reaches (``unsupported`` names them):
texture maps and mipmaps, an environment map, debug views, the G-buffer,
the legacy shading mode and the power light pick.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import halton as H
from . import shade as S
from . import types as T

class LaneState(NamedTuple):
    """Every per-lane tensor of one sample's bounce loop; (P,) unless noted."""

    ray_o: torch.Tensor  # (P,3) f32
    ray_d: torch.Tensor  # (P,3) f32
    color: torch.Tensor  # (P,3) f32 path throughput
    accumulated: torch.Tensor  # (P,3) f32 this sample's radiance
    bounce: torch.Tensor  # int32
    step: torch.Tensor  # int32 Halton step (bounces and transparency passes)
    tpasses: torch.Tensor  # int32 transparency passes since the last bounce
    active: torch.Tensor  # bool
    rays: torch.Tensor  # int32 traversals launched for this lane
    prim_tri: torch.Tensor  # int32 sample 0's bounce-0 hit (-1: none)
    prim_u: torch.Tensor  # f32
    prim_v: torch.Tensor  # f32


class Shadow(NamedTuple):
    """``shade_hit``'s shadow rays: origin, direction and extent are the
    any-hit batch, ``contrib`` the radiance each adds if unoccluded; all are
    defined only where ``need`` is set."""

    origin: torch.Tensor  # (P,3) f32
    direction: torch.Tensor  # (P,3) f32
    distance: torch.Tensor  # (P,) f32
    contrib: torch.Tensor  # (P,3) f32
    need: torch.Tensor  # (P,) bool


class Frame(NamedTuple):
    """What the stages read that stays fixed over one ``trace_pixels`` call."""

    settings: T.RenderSettings
    statics: object  # scene.SceneStatics
    scene: object  # scene.SceneData
    geom: object  # trace.Geometry
    uniforms: T.FrameUniforms
    pixel_x: torch.Tensor  # (P,) int32
    pixel_y: torch.Tensor  # (P,) int32
    offsets: torch.Tensor  # (P,) int32 Halton index offsets
    prev_motion: torch.Tensor  # (P,2) f32
    base: int  # Halton index base of sample 0
    width_f: torch.Tensor  # 0-d f32
    height_f: torch.Tensor  # 0-d f32


def unsupported(settings: T.RenderSettings, statics) -> list[str]:
    """The paths of the port's plain route that this copy leaves out and
    the settings or scene would take."""
    out = []
    if settings.debug_mode != T.DEBUG_MODE_NONE:
        out.append("debug views")
    if settings.enable_gbuffer:
        out.append("the G-buffer (the denoised present)")
    if settings.use_mipmaps:
        out.append("mipmaps")
    if settings.shading_mode != T.SHADING_MODE_PBR:
        out.append("the legacy shading mode")
    if settings.light_sampling != "uniform" and statics.n_lights > 1:
        out.append(f"the {settings.light_sampling!r} light pick")
    if statics.has_textures:
        out.append("texture maps")
    return out


def make_frame(settings, statics, scene, geom, uniforms, pixel_x, pixel_y, offsets, prev_motion,
               base: int) -> Frame:
    """The ``Frame`` of one ``trace_pixels`` call."""
    missing = unsupported(settings, statics)
    if missing:
        raise NotImplementedError("the benchmark's reference leaves out " + ", ".join(missing))
    dev = pixel_x.device
    f32 = torch.float32
    # 0-d device tensors: a Python scalar numerator would turn ``c / x`` into
    # ``reciprocal(x) * c`` (two roundings), and a CUDA ``x / c`` into ``x * (1/c)``
    width_f = torch.tensor(float(settings.width), dtype=f32, device=dev)
    height_f = torch.tensor(float(settings.height), dtype=f32, device=dev)
    return Frame(settings, statics, scene, geom, uniforms, pixel_x, pixel_y, offsets, prev_motion,
                 base, width_f, height_f)


class Wave(NamedTuple):
    """What a sample's steps hand on, beside the lane state: the shadow rays
    the last ``shade_hit`` cast (``need`` set on every lane), their
    occlusion once the any-hit traversal has traced them, and the lanes the
    next step runs over; each step returns new tensors."""

    shadow: Shadow | None = None  # None: no shadow ray pending
    occluded: torch.Tensor | None = None  # (P,) bool, set by the caller after the any-hit
    steps: int = 0  # ``shade_hit`` steps run in this sample


# ---------------------------------------------------------------------------
# Helpers of the plain body
# ---------------------------------------------------------------------------

def _where3(m, a, b):
    return torch.where(m[:, None], a, b)


def _tri_rows(table: torch.Tensor, tri: torch.Tensor, geom) -> torch.Tensor:
    """Per-hit rows of ``table`` for the (P,) triangle ids ``tri``."""
    return table[tri]


def _project(camera: T.Camera, world_pos: torch.Tensor):
    """Screen projection used for motion vectors."""
    view = world_pos - camera.position
    sx = S.dot3(view, camera.right)
    sy = S.dot3(view, camera.up)
    depth = S.dot3(view, camera.forward)
    denom = torch.clamp(depth, min=0.001)
    return sx / denom, sy / denom, depth


def screen_motion(uniforms: T.FrameUniforms, mrow, u, v, width_f, height_f):
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


def _hit_normal(srow, u_b1, v_b1, w_b1, ray_d):
    """The hits' interpolated normals from their (P,16) shade rows at
    barycentrics (u, v, w) (each (P,1)); -ray_d where one degenerates."""
    nrm_raw = u_b1 * srow[:, 3:6] + v_b1 * srow[:, 6:9] + w_b1 * srow[:, 0:3]
    degenerate = S.length(nrm_raw) < 1e-10
    return _where3(degenerate, -ray_d, S.normalize(nrm_raw))


def _hidx(fr: Frame, sidx: int) -> torch.Tensor:
    return fr.offsets + fr.base + sidx


# ---------------------------------------------------------------------------
# Plain versions (the port's torch-op wavefront body)
# ---------------------------------------------------------------------------

def sample_start_plain(fr: Frame, sidx: int, total: torch.Tensor,
) -> LaneState:
    """K6's plain version: sample ``sidx``'s camera rays and fresh lane
    state (``total``: each lane's sample count; a lane at or past it starts
    dead)."""
    P = fr.pixel_x.shape[0]
    dev = fr.pixel_x.device
    f32 = torch.float32
    cam = fr.uniforms.camera
    hidx0 = _hidx(fr, sidx)
    rx = H.halton(hidx0, 0)
    ry = H.halton(hidx0, 1)
    u = (fr.pixel_x.to(f32) + rx) / fr.width_f * 2.0 - 1.0
    v = (fr.pixel_y.to(f32) + ry) / fr.height_f * 2.0 - 1.0
    ray_d = S.normalize(u[:, None] * cam.right + v[:, None] * cam.up + cam.forward)
    return LaneState(
        ray_o=cam.position.expand(P, 3), ray_d=ray_d,
        color=torch.ones((P, 3), dtype=f32, device=dev),
        accumulated=torch.zeros((P, 3), dtype=f32, device=dev),
        bounce=torch.zeros(P, dtype=torch.int32, device=dev),
        step=torch.zeros(P, dtype=torch.int32, device=dev),
        tpasses=torch.zeros(P, dtype=torch.int32, device=dev),
        # a lane past its own sample count neither adds radiance nor counts rays
        active=total > sidx,
        rays=torch.zeros(P, dtype=torch.int32, device=dev),
        prim_tri=torch.full((P,), -1, dtype=torch.int32, device=dev),
        prim_u=torch.zeros(P, dtype=f32, device=dev),
        prim_v=torch.zeros(P, dtype=f32, device=dev))


def shade_hit_plain(fr: Frame, st: LaneState, hits: T.Hits, sidx: int):
    """K7's plain version: one iteration's body between the closest-hit and
    the any-hit traversal of sample ``sidx``, from the closest ``hits`` of
    the lanes ``st.active`` traced. Returns (the next state, the shadow
    rays)."""
    settings, statics, scene, geom = fr.settings, fr.statics, fr.scene, fr.geom
    P = st.active.shape[0]
    dev = st.active.device
    f32 = torch.float32
    is_sample0 = sidx == 0
    hidx = _hidx(fr, sidx)
    ray_o, ray_d, color, accumulated = st.ray_o, st.ray_d, st.color, st.accumulated
    bounce, step, tpasses, active = st.bounce, st.step, st.tpasses, st.active
    prim_tri, prim_u, prim_v = st.prim_tri, st.prim_u, st.prim_v
    rays = st.rays + active.to(torch.int32)

    hit = hits.hit & active
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

    # --- surface normal ------------------------------------------------------
    nrm = _hit_normal(srow, u_b1, v_b1, w_b1, ray_d)
    shading_nrm = nrm

    # --- material (no maps: the scene compiles none) ---------------------------
    matrow = geom.mat_rows[res.long()]
    albedo = matrow[:, 0:3]
    roughness = torch.ones(P, dtype=f32, device=dev)
    metallic = torch.zeros(P, dtype=f32, device=dev)
    opacity = torch.clamp(matrow[:, 11], 0.0, 1.0)
    emission = matrow[:, 6:9]

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
    light_index = torch.clamp((light_sample * n_lights).to(torch.int32), max=n_lights - 1)
    light_weight = float(n_lights)
    l_dir, l_col, l_dist = S.evaluate_light(lights, light_index, u_area, world_point)
    l_col = l_col * light_weight

    # --- shading ------------------------------------------------------------------------
    shadow_o = world_point + nrm * 1e-3
    shadow_dist = l_dist - 1e-3
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

    # --- after the shadow ray: throughput, dead lanes, the next bounce ----------------
    # (reads neither the occlusion nor the radiance sum, so it runs before
    # the any-hit traversal)
    # throughput: diffuse only (the port's AO factor is 1 without an AO map)
    new_color = color * albedo * (1.0 - metallic)[:, None]
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

    nxt = LaneState(ray_o, ray_d, color, accumulated, bounce, step, tpasses, active, rays,
                    prim_tri, prim_u, prim_v)
    return nxt, Shadow(shadow_o, l_dir, shadow_dist, contrib, need_shadow)


def resolve_shadow_plain(st: LaneState, shadow: Shadow, occluded: torch.Tensor) -> LaneState:
    """K8's plain version: the shadow rays' radiance where they are live and
    not ``occluded``."""
    return st._replace(accumulated=st.accumulated
                       + _where3(shadow.need & ~occluded, shadow.contrib, 0.0))


def shade_hit_listed_plain(fr: Frame, st: LaneState, hits: T.Hits, sidx: int, wv: Wave):
    """K7's plain version: ``wv``'s pending shadow rays resolved
    (``resolve_shadow_plain``), then ``shade_hit_plain`` over every lane.
    Returns (the next state, the next ``Wave``, the
    live-lane count as a 0-d int32 tensor)."""
    if wv.shadow is not None:
        st = resolve_shadow_plain(st, wv.shadow, wv.occluded)
    st, sh = shade_hit_plain(fr, st, hits, sidx)
    return st, Wave(sh, None, wv.steps + 1), st.active.sum(dtype=torch.int32)


def resolve_shadow_listed_plain(st: LaneState, wv: Wave) -> LaneState:
    """K8's plain version at a sample's end: ``wv``'s pending shadow rays
    resolved (``resolve_shadow_plain``), if any."""
    return st if wv.shadow is None else resolve_shadow_plain(st, wv.shadow, wv.occluded)

