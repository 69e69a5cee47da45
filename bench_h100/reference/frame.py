"""The reference frame: what one frame of a cell should hold, worked out
again from the cell's configuration and traffic, the seed's inputs and the
number of frames drawn before it.

It rebuilds the scene (``appscene``), replays the renderer's animation
clock and camera moves on the host up to the frame, poses and transforms
the geometry, builds its own BVH over the frame's world-space triangles,
traces the sampled pixels in torch ops (``trace``) and accumulates them:
for the window's last frame over the history the program held before it
(``expected_frame``, which also presents the program's render-size outputs
through the plain presenter, ``present``), for the first frames from the
renderer's starting state, each over the reference's own frame before it
(``Reference.prefix``). The
renderer's defaults it repeats are the port's at the time the benchmark
was written (``mrt_tpu_torch/engine/renderer.py``); they are written out in
``RENDERER_DEFAULTS``.

``precision="bf16"`` is the control: the same frame with the world-space
geometry and every traced colour and presented value stored in bfloat16,
the step below the configuration's float32.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from . import accumulate as acc
from . import animation as anim
from . import appscene, bvh, lbs, present, scene as scene_mod, trace
from . import types as T

# the port's Renderer defaults that a frame's result depends on
RENDERER_DEFAULTS = dict(
    accumulation_weight=0.9, motion_accumulation_min_weight=0.1,
    motion_accumulation_low_threshold_pixels=0.5, motion_accumulation_high_threshold_pixels=4.0,
    motion_sampling_low_threshold_pixels=1.0, motion_sampling_high_threshold_pixels=6.0,
    motion_sampling_max_extra_samples=2, skinning_delta_time=1.0 / 60.0, orbit_sensitivity=0.005,
    camera_elevation_limit=np.pi / 2 - 0.01)


class Program(NamedTuple):
    """What the program held before the compared frame (its own state,
    which the reference follows) and what the frame produced (judged)."""

    prev_accum: torch.Tensor  # (h,w,3) the accumulation before the frame
    prev_motion: torch.Tensor  # (h,w,2) the motion before the frame
    accum: torch.Tensor  # (h,w,3) after the frame
    depth: torch.Tensor  # (h,w)
    motion: torch.Tensor  # (h,w,2)
    samples: torch.Tensor  # (h,w) int32
    rays: int  # the frame's ray count
    image: torch.Tensor | None  # (H,W,3) uint8, the frame's present (None: no present)


class Expected(NamedTuple):
    """The reference's frame at the sampled pixels, and its present."""

    accum: torch.Tensor  # (n,3)
    depth: torch.Tensor  # (n,)
    motion: torch.Tensor  # (n,2)
    samples: torch.Tensor  # (n,) int32
    rays: torch.Tensor  # (n,) int32
    image: torch.Tensor | None  # (H,W,3) uint8


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def render_size(traffic: dict) -> tuple[int, int]:
    """(height, width) the frame is traced at, as the port's Renderer
    rounds ``output * render_scale``."""
    scale = traffic["render_scale"] if traffic["upscaler"] != "off" else 1.0
    return (max(1, int(round(traffic["height"] * scale))),
            max(1, int(round(traffic["width"] * scale))))


def settings(config: dict, traffic: dict) -> T.RenderSettings:
    h, w = render_size(traffic)
    return T.RenderSettings(
        width=w, height=h, samples_per_pixel=traffic["samples_per_pixel"],
        max_bounces=traffic["max_bounces"], enable_gbuffer=traffic["upscaler"] == "denoised",
        enable_motion_adaptive_sampling=config["motion_adaptive_sampling"],
        motion_sampling_max_extra_samples=RENDERER_DEFAULTS["motion_sampling_max_extra_samples"],
        enable_motion_adaptive_accumulation=True)


def build_scene(config: dict, traffic: dict, start_time: float) -> scene_mod.Scene:
    """The cell's scene, sized as its render, with each skinned model's
    clip started at ``start_time``."""
    h, w = render_size(traffic)
    sc = appscene.make_app_scene(w, h, include_robot=config["include_robot"],
                                 dragon_subdivisions=config["dragon_subdivisions"],
                                 asset_models=config["asset_models"])
    for m in sc.models:
        if m.skin is not None:
            m.skin.current_time = start_time
    return sc


def _joint_matrices(sc: scene_mod.Scene, statics, clock: dict, delta_time: float, device):
    """One draw's step of the renderer's 60 Hz animation clock with
    catch-up (``Renderer._update_animation``): the joint matrices per
    skinned model, or the last ones on a throttled frame."""
    step = RENDERER_DEFAULTS["skinning_delta_time"]
    clock["time"] += delta_time
    if clock["last"] is None:
        clock["last"] = clock["time"] - step
    elapsed = clock["time"] - clock["last"]
    if elapsed < step and clock["mats"]:
        return clock["mats"]
    steps = int(elapsed / step)
    step_dt = step * steps
    if steps > 0:
        clock["last"] += step_dt
    mats = []
    for inst, _start, _count in statics.skin_slices:
        sk = sc.models[inst].skin
        if sk.animation is not None:
            sk.current_time = anim.advance_time(sk.current_time, step_dt, sk.animation.duration)
        m = anim.compute_joint_matrices(sk.skeleton, sk.animation, sk.current_time)
        m = lbs.compose_final_matrices(m, sk.geometry_bind)
        mats.append(torch.as_tensor(np.ascontiguousarray(m, np.float32)).to(device))
    clock["mats"] = tuple(mats)
    return clock["mats"]


def _pose(statics, skin_bundle, positions_obj, normals_obj, mats):
    pos = positions_obj.clone()
    nrm = normals_obj.clone()
    for k, (_, start, count) in enumerate(statics.skin_slices):
        sb = skin_bundle[k]
        sp, sn = lbs.skin(sb.weights_dense, mats[k], sb.rest_positions, sb.rest_normals)
        pos[start:start + count] = sp
        nrm[start:start + count] = sn
    return pos, nrm


def _camera(sc: scene_mod.Scene, traffic: dict, frames: int):
    """(azimuth, elevation) after ``frames`` frames' camera moves (each
    ``Renderer.orbit(dx, dy)`` before its draw)."""
    az, el = sc.camera_azimuth, sc.camera_elevation
    dx, dy = traffic["orbit"]
    if dx == 0 and dy == 0:
        return az, el
    lim = RENDERER_DEFAULTS["camera_elevation_limit"]
    sens = RENDERER_DEFAULTS["orbit_sensitivity"]
    for _ in range(frames):
        az += dx * sens
        el = float(np.clip(el + dy * sens, -lim, lim))
    return az, el


class Reference:
    """The cell's scene, rebuilt once, from which ``frame`` works out any
    frame at drawn pixels; ``precision="bf16"`` is the control."""

    def __init__(self, config: dict, traffic: dict, start_time: float, offsets: torch.Tensor,
                 device, precision: str = "f32"):
        if precision not in ("f32", "bf16"):
            raise ValueError(f"unknown precision {precision!r}")
        self.config, self.traffic, self.start_time = config, traffic, start_time
        self.offsets, self.device, self.precision = offsets.to(device).reshape(-1), device, precision
        self.settings = settings(config, traffic)
        self.scene = build_scene(config, traffic, start_time)
        self.data, self.statics = self.scene.compile(device)
        self._static_trav = None  # the BVH of a scene that never moves

    def _geometry(self, frame: int):
        """The frame's scene data, packed geometry and BVH: the clock
        replayed from the start up to ``frame`` (and the pose before it; the
        rest pose before the first)."""
        sc, statics, data0 = self.scene, self.statics, self.data
        for m in sc.models:
            if m.skin is not None:
                m.skin.current_time = self.start_time
        clock = dict(time=0.0, last=None, mats=())
        pos_prev, pos, nrm = data0.positions_obj, data0.positions_obj, data0.normals_obj
        if statics.skin_slices:
            for k in range(frame + 1):
                mats = _joint_matrices(sc, statics, clock, self.traffic["delta_time"], self.device)
                if k == frame:
                    pos, nrm = _pose(statics, sc.skin_bundle, data0.positions_obj,
                                     data0.normals_obj, mats)
                elif k == frame - 1:
                    pos_prev, _ = _pose(statics, sc.skin_bundle, data0.positions_obj,
                                        data0.normals_obj, mats)
        data = data0._replace(positions_obj=pos, prev_positions_obj=pos_prev, normals_obj=nrm)
        pos_w, prev_w, nrm_w = scene_mod.world_geometry(data)
        if self.precision == "bf16":
            pos_w, prev_w, nrm_w = _bf16(pos_w), _bf16(prev_w), _bf16(nrm_w)
        geom = trace.build_geometry(data, pos_w, prev_w, nrm_w)
        if statics.skin_slices or self._static_trav is None:
            trav = bvh.Traversal(geom.tri_v0, geom.tri_v1, geom.tri_v2)
            if not statics.skin_slices:
                self._static_trav = trav
        return data, geom, trav if statics.skin_slices else self._static_trav

    def _uniforms(self, frame: int) -> T.FrameUniforms:
        sc, traffic, st = self.scene, self.traffic, self.settings
        h, w = st.height, st.width

        def camera(frames):
            az, el = _camera(sc, traffic, frames)
            return T.to_device(T.orbit_camera(w, h, np.zeros(3, np.float32), az, el,
                                              sc.camera_distance, sc.camera_fov_degrees),
                               self.device)

        cam = camera(frame + 1)
        d = RENDERER_DEFAULTS
        return T.make_frame_uniforms(
            camera=cam, previous_camera=camera(frame) if frame > 0 else cam,
            frame_index=0 if traffic["orbit"] != [0, 0] else frame,
            accumulation_weight=d["accumulation_weight"],
            motion_accum_min_weight=d["motion_accumulation_min_weight"],
            motion_accum_low_px=d["motion_accumulation_low_threshold_pixels"],
            motion_accum_high_px=d["motion_accumulation_high_threshold_pixels"],
            motion_sampling_low_px=d["motion_sampling_low_threshold_pixels"],
            motion_sampling_high_px=d["motion_sampling_high_threshold_pixels"])

    def frame(self, frame: int, pixels: torch.Tensor, prev_accum: torch.Tensor,
              prev_motion: torch.Tensor, seconds: dict | None = None) -> Expected:
        """Frame number ``frame`` (0 is the first draw) at the flat render
        pixel indices ``pixels``, from the accumulation (n,3) and motion
        (n,2) at those pixels before it; no present. ``seconds``, if given,
        receives the host seconds of its stages."""
        seconds = {} if seconds is None else seconds
        t0 = time.perf_counter()
        data, geom, trav = self._geometry(frame)
        seconds["geometry"] = time.perf_counter() - t0
        uniforms = self._uniforms(frame)
        pix = pixels.to(self.device)
        w = self.settings.width
        out = trace.trace_pixels(self.settings, self.statics, data, trav, geom, uniforms,
                                 (pix % w).to(torch.int32), (pix // w).to(torch.int32),
                                 self.offsets[pix], prev_motion)
        seconds["trace"] = time.perf_counter() - t0 - seconds["geometry"]
        color = _bf16(out.color) if self.precision == "bf16" else out.color
        accum = acc.accumulate(self.settings, uniforms, color, out.motion, prev_motion,
                               prev_accum)
        return Expected(accum, out.depth, out.motion, out.samples, out.rays_traced, None)

    def prefix(self, frames: int, pixels: torch.Tensor) -> list[Expected]:
        """The first ``frames`` frames at ``pixels`` from the renderer's
        starting state (accumulation and motion zero), each from the one
        before: no state of the program's."""
        n = pixels.shape[0]
        prev_accum = torch.zeros((n, 3), dtype=torch.float32, device=self.device)
        prev_motion = torch.zeros((n, 2), dtype=torch.float32, device=self.device)
        out = []
        for k in range(frames):
            e = self.frame(k, pixels, prev_accum, prev_motion)
            out.append(e)
            prev_accum, prev_motion = e.accum, e.motion
        return out


def expected_frame(ref: Reference, frame: int, pixels: torch.Tensor, program: Program,
                   seconds: dict | None = None) -> Expected:
    """The reference's frame number ``frame`` at the flat pixel indices
    ``pixels`` of the render, from the program's state before it, with a
    present where the traffic presents: the render-size outputs the
    program's present started from, through the plain presenter, over a
    fresh history (the traffic's orbit resets the accumulation and drops
    the presenter's history before every draw)."""
    pix = pixels.to(ref.device)
    e = ref.frame(frame, pixels, program.prev_accum.reshape(-1, 3)[pix],
                  program.prev_motion.reshape(-1, 2)[pix], seconds)
    if not ref.traffic["present"]:
        return e
    if ref.traffic["orbit"] == [0, 0]:
        raise NotImplementedError("a present over a history kept from frame to frame is "
                                  "not worked out by this reference")
    t0 = time.perf_counter()
    image = present.temporal_present(program.accum, program.depth, program.motion, None,
                                     ref.traffic["height"], ref.traffic["width"],
                                     RENDERER_DEFAULTS["accumulation_weight"],
                                     bf16=ref.precision == "bf16")
    if seconds is not None:
        seconds["present"] = time.perf_counter() - t0
    return e._replace(image=image)
