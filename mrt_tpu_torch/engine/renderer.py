"""Renderer — the frame loop, counterpart of ``mrt_tpu/engine/renderer.py``.

Owns the compiled scene, the two-level BVH, the accumulation state and the
tunables of the JAX ``Renderer`` (same names and defaults). Every
quality-affecting property assignment restarts accumulation
(``frame_index = 0``) and, like any direct ``frame_index = 0`` (orbit,
zoom, presets), drops the presenter's history. One ``draw`` steps the
animation clock (60 Hz with catch-up; joint matrices on the host),
prepares the frame's geometry when its inputs changed (skinning, world
transform, packed shade/motion rows, BVH refit; every frame of a skinned
scene), traces every pixel of the frame, and accumulates; ``output_image``
presents it (spatial, temporal or SVGF-lite denoised upscaling,
``upscale/presenter.py``) through kernel K1.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..bvh import twolevel
from ..core import halton as H
from ..core import types as T
from ..core.device import resolve as resolve_device
from ..render import accumulate as acc
from ..render import wavefront as wf
from ..skinning import animation as anim
from ..skinning import lbs
from . import scene as scene_mod

# Properties whose change invalidates accumulated history.
_RESET_PROPS = {
    "samples_per_pixel",
    "max_bounces",
    "use_mipmaps",
    "light_sampling",
    "accumulation_weight",
    "use_motion_adaptive_accumulation",
    "motion_accumulation_min_weight",
    "motion_accumulation_low_threshold_pixels",
    "motion_accumulation_high_threshold_pixels",
    "use_motion_adaptive_sampling",
    "motion_sampling_max_extra_samples",
    "motion_sampling_low_threshold_pixels",
    "motion_sampling_high_threshold_pixels",
    "shading_mode",
    "debug_texture_mode",
    "render_scale",
    "upscaler_mode",
    "camera_fov_degrees",
    "view_mode",
}

UPSCALER_OFF = "off"
UPSCALER_SPATIAL = "spatial"
UPSCALER_TEMPORAL = "temporal"
UPSCALER_DENOISED = "denoised"

VIEW_MODE_WORLD = "world"
VIEW_MODE_TPS = "tps"


def prepare_frame(statics, scene_data, bvh, skin_bundle=(), joint_matrices=()):
    """Skinning -> world transform -> packed per-triangle rows -> BVH refit
    (skinned BLASes, instance and TLAS rows; static BLASes are never refit).
    Each skinned model's slice of the vertex pool is re-skinned from its
    rest pose with ``joint_matrices`` (one (J,4,4) tensor per model, in
    ``statics.skin_slices`` order). Returns (scene_data with the skinned
    pose, geometry, BVH)."""
    if statics.skin_slices:
        pos_obj = scene_data.positions_obj.clone()
        nrm_obj = scene_data.normals_obj.clone()
        for k, (_, start, count) in enumerate(statics.skin_slices):
            sb = skin_bundle[k]
            sp, sn = lbs.skin(sb.weights_dense, joint_matrices[k], sb.rest_positions, sb.rest_normals)
            pos_obj[start : start + count] = sp
            nrm_obj[start : start + count] = sn
        scene_data = scene_data._replace(positions_obj=pos_obj, normals_obj=nrm_obj)
    pos_w, prev_w, nrm_w = scene_mod.world_geometry(scene_data)
    geom = wf.build_geometry(scene_data, pos_w, prev_w, nrm_w)
    bvh = twolevel.refit(bvh, scene_data.positions_obj, scene_data.instance_transform)
    return scene_data, geom, bvh


class FrameStats:
    """Frame times (host clock between draws, EMA) and ray totals (int64)."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.frame_ms = None
        self.frames = 0
        self._last = None
        self._pending: list = []  # per-frame int64 device scalars, read at report()
        self.total_rays = 0

    def record(self, rays_traced: torch.Tensor):
        now = time.perf_counter()
        self._pending.append(rays_traced)
        if self._last is not None:
            dt_ms = (now - self._last) * 1e3
            self.frame_ms = dt_ms if self.frame_ms is None else self.ema * self.frame_ms + (1 - self.ema) * dt_ms
        self._last = now
        self.frames += 1

    def report(self) -> dict:
        if self._pending:
            self.total_rays += int(torch.stack(self._pending).sum().item())
            self._pending.clear()
        fps = 1000.0 / self.frame_ms if self.frame_ms else 0.0
        mrays = (self.total_rays / max(self.frames - 1, 1)) * fps / 1e6 if fps else 0.0
        return dict(frames=self.frames, frame_ms=round(self.frame_ms, 3) if self.frame_ms else None,
                    fps=round(fps, 2), total_rays=self.total_rays, mrays_per_s=round(mrays, 3))


class Renderer:
    """Interactive progressive renderer over a compiled scene.

    ``device``: where the scene, BVH and frame state live (default: the card,
    ``"cuda"``; raises when there is none, so CPU use needs ``device="cpu"``).
    ``offsets``: optional (H,W) Halton index
    offsets at render size; by default they are drawn from a
    ``torch.Generator`` seeded with ``seed``.
    """

    def __init__(self, scene: scene_mod.Scene, output_width: int = 512, output_height: int = 512,
                 seed: int = 0, device=None, offsets=None, _compiled=None):
        object.__setattr__(self, "_initialized", False)
        self.device = resolve_device(device)
        self.scene = scene
        self.output_width = output_width
        self.output_height = output_height

        self.render_scale = 0.67
        self.upscaler_mode = UPSCALER_SPATIAL
        self.samples_per_pixel = 2
        self.max_bounces = 2
        self.accumulation_weight = 0.9
        self.use_motion_adaptive_accumulation = True
        self.motion_accumulation_min_weight = 0.1
        self.motion_accumulation_low_threshold_pixels = 0.5
        self.motion_accumulation_high_threshold_pixels = 4.0
        self.use_motion_adaptive_sampling = True
        self.motion_sampling_max_extra_samples = 2
        self.motion_sampling_low_threshold_pixels = 1.0
        self.motion_sampling_high_threshold_pixels = 6.0
        self.shading_mode = T.SHADING_MODE_PBR
        self.debug_texture_mode = T.DEBUG_MODE_NONE
        # TPU execution knobs: kept for API parity, carried into settings(),
        # and ignored by the trace (none of them changes a result)
        for name in ("tile_pixels", "traversal_chunks", "traversal_unroll", "persistent_samples",
                     "sort_shadow_rays", "sort_rays", "workload_sort", "hit_priming",
                     "traversal_stream", "stream_refill"):
            setattr(self, name, getattr(T.RenderSettings, name))
        self.staged_frame = True
        self.tile_program_loop = True
        self.vmem_table = True
        self.vmem_shade_tables = None
        self.traversal_backend = T.RenderSettings.traversal_backend
        self.two_level = T.RenderSettings.two_level
        self.fuse_shadow_rays = None
        self.use_mipmaps = T.RenderSettings.use_mipmaps
        self.light_sampling = T.RenderSettings.light_sampling

        self.view_mode = VIEW_MODE_WORLD
        self.player_model_index = 0
        self.camera_target = np.asarray(scene.camera_target, np.float32)
        self.camera_azimuth = scene.camera_azimuth
        self.camera_elevation = scene.camera_elevation
        self.camera_distance = scene.camera_distance
        self.camera_fov_degrees = scene.camera_fov_degrees
        self.min_camera_distance = 1.5
        self.max_camera_distance = 50.0
        self.camera_elevation_limit = np.pi / 2 - 0.01

        self.frame_index = 0
        self._previous_camera: T.Camera | None = None
        self._generator = torch.Generator().manual_seed(seed)
        self._given_offsets = None if offsets is None else torch.as_tensor(np.array(offsets, np.int32))
        self.stats = FrameStats()
        self.last_rays_traced = None
        self.last_samples = None  # (H,W) int32 samples per pixel of the last frame
        self._prepare_key = None

        # animation clock: 60 Hz throttle with catch-up (SkinningPass.swift:288-312)
        self.skinning_delta_time = 1.0 / 60.0
        self._scene_time = 0.0
        self._last_skinning_update = None
        self._joint_matrices: tuple = ()

        if _compiled is None:
            self.scene_data, self.statics = scene.compile(self.device)
            self.bvh = twolevel.build(scene.models, self.scene_data, scene.host_mirror)
        else:
            self.scene_data, self.statics, self.bvh = _compiled
        self._skin_bundle = tuple(scene_mod.SkinModelData(*(t.to(self.device) for t in sb))
                                  for sb in scene.skin_bundle)
        self._clear_presenter_history()
        self._allocate_state()
        object.__setattr__(self, "_initialized", True)

    @classmethod
    def from_compiled(cls, scene: scene_mod.Scene, scene_data, statics, bvh, **kw) -> "Renderer":
        """Render from state compiled elsewhere (e.g. ``convert.py``'s copy of
        the JAX package's SceneData/SceneStatics/TwoLevelBVH); ``scene``
        supplies the camera, lights and dirty flag."""
        kw.setdefault("device", scene_data.positions_obj.device)
        return cls(scene, _compiled=(scene_data, statics, bvh), **kw)

    # -- accumulation-reset idiom ------------------------------------------------
    def __setattr__(self, name, value):
        old = getattr(self, name, None)
        object.__setattr__(self, name, value)
        if getattr(self, "_initialized", False):
            if name in _RESET_PROPS:
                object.__setattr__(self, "frame_index", 0)
                self._clear_presenter_history()
            if name == "frame_index" and value == 0:
                # direct resets (orbit, zoom, presets) drop the presenter's
                # history too, so that stale output history cannot ghost
                self._clear_presenter_history()
            if name in ("traversal_backend", "two_level") and old is not value:
                if not (self.two_level and self.traversal_backend == "wide"):
                    object.__setattr__(self, name, old)
                    if any(m.geometry_mask != T.GEOMETRY_MASK_GEOMETRY for m in self.scene.models):
                        # as the JAX package's _build_bvh refuses it
                        raise ValueError(
                            "geometry masks require the two-level traversal backend "
                            "(two_level=True, traversal_backend='wide'); the flat backend has "
                            "no per-instance mask filtering")
                    raise NotImplementedError(
                        "only the two-level wide BVH is ported (flat path: ROADMAP Slice F)")

    def _clear_presenter_history(self):
        """Drop the output-size upscale history and the denoiser's state;
        the next present starts them afresh."""
        object.__setattr__(self, "_upscale_history", None)
        object.__setattr__(self, "_denoise_state", None)

    # -- sizes ---------------------------------------------------------------------
    @property
    def render_width(self) -> int:
        scale = self.render_scale if self.upscaler_mode != UPSCALER_OFF else 1.0
        return max(1, int(round(self.output_width * scale)))

    @property
    def render_height(self) -> int:
        scale = self.render_scale if self.upscaler_mode != UPSCALER_OFF else 1.0
        return max(1, int(round(self.output_height * scale)))

    def settings(self) -> T.RenderSettings:
        return T.RenderSettings(
            width=self.render_width,
            height=self.render_height,
            samples_per_pixel=self.samples_per_pixel,
            max_bounces=self.max_bounces,
            shading_mode=self.shading_mode,
            debug_mode=self.debug_texture_mode,
            enable_gbuffer=self.upscaler_mode == UPSCALER_DENOISED,
            enable_motion_adaptive_sampling=self.use_motion_adaptive_sampling,
            motion_sampling_max_extra_samples=self.motion_sampling_max_extra_samples,
            enable_motion_adaptive_accumulation=self.use_motion_adaptive_accumulation,
            tile_pixels=self.tile_pixels,
            traversal_chunks=self.traversal_chunks,
            traversal_unroll=self.traversal_unroll,
            persistent_samples=self.persistent_samples,
            sort_shadow_rays=self.sort_shadow_rays,
            sort_rays=self.sort_rays,
            workload_sort=self.workload_sort,
            traversal_backend=self.traversal_backend,
            hit_priming=self.hit_priming,
            two_level=self.two_level,
            traversal_stream=self.traversal_stream,
            stream_refill=self.stream_refill,
            fuse_shadow_rays=True if self.fuse_shadow_rays is None else bool(self.fuse_shadow_rays),
            use_mipmaps=self.use_mipmaps,
            light_sampling=self.light_sampling,
        )

    # -- state -----------------------------------------------------------------------
    def _allocate_state(self):
        h, w = self.render_height, self.render_width
        given = self._given_offsets
        if given is not None and tuple(given.shape) == (h, w):
            offsets = given
        elif given is not None and self._initialized:
            raise ValueError(f"offsets of shape {tuple(given.shape)} given, the render size is {(h, w)}")
        else:
            offsets = H.make_pixel_offsets(self._generator, h, w)
        self.offsets = offsets.to(self.device)
        self.accum = torch.zeros((h, w, 3), dtype=torch.float32, device=self.device)
        self.motion = torch.zeros((h, w, 2), dtype=torch.float32, device=self.device)
        self.depth = torch.full((h, w), 1.0e8, dtype=torch.float32, device=self.device)
        self.gbuffer = None
        self._state_size = (h, w)
        self.frame_index = 0

    def rebuild_bvh(self):
        """Rebuild the BVH topology from the current scene."""
        self.bvh = twolevel.build(self.scene.models, self.scene_data, self.scene.host_mirror)

    # -- camera controls ------------------------------------------------------------------
    def orbit(self, delta_x: float, delta_y: float):
        if self.view_mode == VIEW_MODE_TPS:
            return
        sensitivity = 0.005
        self.camera_azimuth += delta_x * sensitivity
        self.camera_elevation = self._clamp_elevation(self.camera_elevation + delta_y * sensitivity)
        self.frame_index = 0

    def zoom(self, delta: float):
        scale = max(0.1, 1.0 - delta)
        self.camera_distance = float(np.clip(self.camera_distance * scale, self.min_camera_distance,
                                             self.max_camera_distance))
        self.frame_index = 0

    def apply_view_preset(self, preset: str):
        iso_elevation = float(np.arcsin(1.0 / np.sqrt(3.0)))
        if preset == "free":
            return
        elif preset == "front":
            self.camera_azimuth = 0.0
        elif preset == "back":
            self.camera_azimuth = np.pi
        elif preset == "left":
            self.camera_azimuth = -np.pi / 2
        elif preset == "right":
            self.camera_azimuth = np.pi / 2
        elif preset == "top":
            self.camera_elevation = self.camera_elevation_limit
        elif preset == "bottom":
            self.camera_elevation = -self.camera_elevation_limit
        elif preset == "isometric":
            self.camera_azimuth = np.pi / 4
            self.camera_elevation = iso_elevation
        self.camera_elevation = self._clamp_elevation(self.camera_elevation)
        self.frame_index = 0

    def _clamp_elevation(self, v: float) -> float:
        return float(np.clip(v, -self.camera_elevation_limit, self.camera_elevation_limit))

    def current_camera(self) -> T.Camera:
        if self.view_mode == VIEW_MODE_TPS and self.player_model_index < len(self.scene.models):
            target = self.scene.models[self.player_model_index].position + np.array([0, 1.0, 0], np.float32)
        else:
            target = np.zeros(3, np.float32)
        self.camera_target = target
        cam = T.orbit_camera(self.render_width, self.render_height, target, self.camera_azimuth,
                             self.camera_elevation, self.camera_distance, self.camera_fov_degrees)
        return T.to_device(cam, self.device)

    # -- scene sync -----------------------------------------------------------------------
    def _sync_scene(self):
        """Host-side scene changes (moves, light intensity) into the device
        transforms, keeping the previous frame's for motion vectors."""
        prev = self.scene_data.instance_transform
        if self.scene.is_dirty:
            new = torch.as_tensor(self.scene.instance_transforms()).to(self.device)
            self.scene_data = self.scene_data._replace(
                instance_transform=new, prev_instance_transform=prev,
                lights=T.to_device(self.scene.lights, self.device))
            self.scene.is_dirty = False
        else:
            self.scene_data = self.scene_data._replace(prev_instance_transform=prev)

    def _update_animation(self, delta_time: float | None):
        """60 Hz-throttled animation stepping with catch-up
        (SkinningPass.swift:288-312): host-side joint matrices per skinned
        model (Model.update analog, Model.swift:207-261). A throttled frame
        keeps the last matrices."""
        if not self.statics.skin_slices:
            return
        dt = self.skinning_delta_time if delta_time is None else delta_time
        self._scene_time += dt
        if self._last_skinning_update is None:
            self._last_skinning_update = self._scene_time - self.skinning_delta_time
        elapsed = self._scene_time - self._last_skinning_update
        if elapsed < self.skinning_delta_time and self._joint_matrices:
            return  # skip this frame (throttle)
        steps = int(elapsed / self.skinning_delta_time)
        step_dt = self.skinning_delta_time * steps
        if steps > 0:
            self._last_skinning_update += step_dt

        mats = []
        for inst, _start, _count in self.statics.skin_slices:
            sk = self.scene.models[inst].skin
            if sk.animation is not None:
                sk.current_time = anim.advance_time(sk.current_time, step_dt, sk.animation.duration)
            if sk.skeleton is not None:
                m = anim.compute_joint_matrices(sk.skeleton, sk.animation, sk.current_time)
            else:
                m = np.tile(np.eye(4, dtype=np.float32), (sk.rest_joints.shape[0], 1, 1))
            m = lbs.compose_final_matrices(m, sk.geometry_bind)
            mats.append(torch.as_tensor(np.ascontiguousarray(m, np.float32)).to(self.device))
        self._joint_matrices = tuple(mats)

    def prepare(self):
        """This frame's prepare stage on the current state (no state change):
        (scene_data with the skinned pose, geometry, BVH)."""
        return prepare_frame(self.statics, self.scene_data, self.bvh, self._skin_bundle,
                             self._joint_matrices)

    # -- frame loop -------------------------------------------------------------------------
    def draw(self, delta_time: float | None = None) -> torch.Tensor:
        """Render one frame; returns the accumulation buffer (render size).
        ``delta_time``: seconds since the last draw, for the animation
        clock (default 1/60)."""
        settings = self.settings()
        T.check_supported(settings)
        if self._state_size != (self.render_height, self.render_width):
            self._allocate_state()
        self._sync_scene()
        self._update_animation(delta_time)
        camera = self.current_camera()
        uniforms = T.make_frame_uniforms(
            camera=camera,
            previous_camera=self._previous_camera or camera,
            frame_index=self.frame_index,
            accumulation_weight=self.accumulation_weight,
            motion_accum_min_weight=self.motion_accumulation_min_weight,
            motion_accum_low_px=self.motion_accumulation_low_threshold_pixels,
            motion_accum_high_px=self.motion_accumulation_high_threshold_pixels,
            motion_sampling_low_px=self.motion_sampling_low_threshold_pixels,
            motion_sampling_high_px=self.motion_sampling_high_threshold_pixels,
        )

        # prepare only when its inputs changed (keyed by tensor identity; the
        # key holds references, so an identity cannot be recycled). A skinned
        # scene's pose is handed forward every frame, so it misses every
        # frame, throttled ones included (re-skinned with the same matrices)
        sd = self.scene_data
        key = (sd.instance_transform, sd.prev_instance_transform, sd.positions_obj, self.bvh)
        if self._prepare_key is None or any(a is not b for a, b in zip(self._prepare_key, key)):
            self._prepared = self.prepare()
            self._prepare_key = key
        sd_frame, geom, bvh_frame = self._prepared

        out = wf.trace_frame(settings, self.statics, sd_frame, bvh_frame, geom, uniforms,
                             self.offsets, self.motion)
        self.accum = acc.accumulate(settings, uniforms, out.color, out.motion, self.motion, self.accum)
        self.depth, self.motion = out.depth, out.motion
        self.gbuffer = None if out.normal is None else dict(
            diffuse_albedo=out.diffuse_albedo, specular_albedo=out.specular_albedo,
            normal=out.normal, roughness=out.roughness)
        self.last_samples = out.samples
        self.last_rays_traced = out.rays_traced.sum(dtype=torch.int64)
        self.stats.record(self.last_rays_traced)
        if self.statics.skin_slices:
            # this frame's skinned pose becomes the next frame's pose and
            # previous pose (normals are re-skinned from rest every frame)
            self.scene_data = sd._replace(positions_obj=sd_frame.positions_obj,
                                          prev_positions_obj=sd_frame.positions_obj)
        object.__setattr__(self, "frame_index", self.frame_index + 1)
        self._previous_camera = camera
        return self.accum

    # -- present -----------------------------------------------------------------------------
    def present_device(self) -> torch.Tensor:
        """uint8 (H,W,3) image on the device (texture row order)."""
        from ..upscale import presenter

        return presenter.present_device(self)

    def output_image(self) -> np.ndarray:
        """Tonemapped uint8 image at output resolution, row 0 at the top."""
        from ..upscale import presenter

        return presenter.present(self)
