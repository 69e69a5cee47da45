"""Multi-device rendering over pixels and samples — counterpart of
``mrt_tpu/dist/sharding.py``.

* **dp** (data parallel over pixels): the image's rows are split over the
  ``dp`` axis; each rank traces its own row block against a replicated
  scene and BVH. Bit-identical to the single-device ``Renderer`` at the same
  offsets.
* **sp** (sample parallel): the ranks along ``sp`` trace the same rows with
  disjoint Halton sample windows, ``sample_base = (frame_index * sp +
  sp_rank) * sample_stride``, and take the mean of colour, depth and motion
  over ``sp``.

One process per rank (``dist/comm.py``). The frame is staged as the JAX
package's is: a replicated prepare (skinning, world transform, packed rows,
BVH refit; skipped on clean frames), this rank's trace, and ``accumulate``
on its row block. ``draw`` returns the full (H,W,3) accumulation on every
rank; the renderer keeps ``accum``, ``motion``, ``depth`` and ``offsets`` as
row blocks. Rays are summed in int64.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import halton as H
from ..core import types as T
from ..engine import renderer as renderer_mod
from ..engine import scene as scene_mod
from ..render import accumulate as acc
from ..render import wavefront as wf
from . import comm


def make_mesh(n_devices: int | None = None, sp: int = 1, device=None) -> comm.Mesh:
    """A (dp, sp) mesh over the world's ranks, (n // sp, sp) as the JAX
    package's ``make_mesh`` lays out devices: rank r at (r // sp, r % sp).
    ``n_devices`` defaults to (and must be) the world size."""
    size = comm.world()[1]
    n = size if n_devices is None else n_devices
    if n != size:
        raise ValueError(f"{n} devices asked for, the world has {size} ranks (one per device)")
    if n % sp:
        raise ValueError(f"{n} devices not divisible by sp={sp}")
    return comm.Mesh({"dp": n // sp, "sp": sp}, device)


class RowBlocks:
    """What both sharded renderers share: the dp row block of this rank
    (``y0``, ``local_h``), the per-pixel state kept as row blocks, the orbit
    camera read from the scene, the skin bundle with its joint matrices,
    and the dp gather of a block."""

    def _init_rows(self, scene, mesh: comm.Mesh, seed: int, offsets):
        h, w = self.settings.height, self.settings.width
        dp = mesh.axis("dp")
        if h % dp.size:
            raise ValueError(f"height {h} not divisible by dp={dp.size}")
        self.local_h = h // dp.size
        self.y0 = dp.index * self.local_h
        # every rank draws the full (H,W) offsets from the same seed and keeps
        # its rows, so any dp gives the single device's offsets
        full = (H.make_pixel_offsets(torch.Generator().manual_seed(seed), h, w) if offsets is None
                else torch.as_tensor(np.array(offsets, np.int32)))
        if tuple(full.shape) != (h, w):
            raise ValueError(f"offsets of shape {tuple(full.shape)} given, the render size is {(h, w)}")
        dev = self.device
        self.offsets = full[self.y0 : self.y0 + self.local_h].to(dev)
        self.accum = torch.zeros((self.local_h, w, 3), dtype=torch.float32, device=dev)
        self.motion = torch.zeros((self.local_h, w, 2), dtype=torch.float32, device=dev)
        self.depth = torch.full((self.local_h, w), 1.0e8, dtype=torch.float32, device=dev)
        self.frame_index = 0
        self._previous_camera: T.Camera | None = None
        self.last_rays_traced = None
        self.skin_bundle = tuple(scene_mod.SkinModelData(*(t.to(dev) for t in sb))
                                 for sb in scene.skin_bundle)
        # identity pose until set_joint_matrices drives it
        self._joint_matrices = tuple(
            torch.eye(4, dtype=torch.float32, device=dev).repeat(
                scene.models[i].skin.rest_joints.shape[0], 1, 1)
            for i, _, _ in self.statics.skin_slices)

    def set_joint_matrices(self, mats: tuple):
        """One (J,4,4) matrix stack per skinned model, in
        ``statics.skin_slices`` order."""
        self._joint_matrices = tuple(torch.as_tensor(m, dtype=torch.float32).to(self.device)
                                     for m in mats)

    def _uniforms(self) -> T.FrameUniforms:
        s, sc = self.settings, self.scene
        camera = T.to_device(T.orbit_camera(s.width, s.height, sc.camera_target, sc.camera_azimuth,
                                            sc.camera_elevation, sc.camera_distance,
                                            sc.camera_fov_degrees), self.device)
        uniforms = T.make_frame_uniforms(camera=camera,
                                         previous_camera=self._previous_camera or camera,
                                         frame_index=self.frame_index)
        self._previous_camera = camera
        return uniforms

    def gather(self, block: torch.Tensor) -> torch.Tensor:
        """The full image of a per-rank row block, on every rank."""
        return comm.gather_rows(self.mesh.axis("dp"), block, self.y0, self.settings.height)


class DistributedRenderer(RowBlocks):
    """Multi-device renderer over a (dp, sp) mesh, the staged draw of the
    single-device ``Renderer``. ``offsets``: optional (H,W) Halton index
    offsets (default: drawn from a ``torch.Generator`` seeded with ``seed``,
    as ``Renderer`` draws them); ``device``: this rank's device (default
    ``comm.rank_device``'s)."""

    def __init__(self, scene: scene_mod.Scene, settings: T.RenderSettings,
                 mesh: comm.Mesh | None = None, sp: int = 1, seed: int = 0, offsets=None,
                 device=None):
        self.mesh = mesh if mesh is not None else make_mesh(sp=sp, device=device)
        self.device = self.mesh.device
        self.scene = scene
        self.scene_data, self.statics = scene.compile(self.device)
        self.settings = settings
        # raises as the JAX package's _check_settings does: masks need the
        # two-level BVH
        self.bvh = renderer_mod.build_bvh(scene, self.scene_data, settings.two_level, self.device,
                                          settings.traversal_backend)
        self._prepare_key = None
        self._prepared = None
        self._init_rows(scene, self.mesh, seed, offsets)

    def draw(self) -> torch.Tensor:
        """Render one frame; returns the full (H,W,3) accumulation."""
        settings = self.settings
        uniforms = self._uniforms()
        # clean-frame prepare skip, keyed by input identity (as Renderer.draw;
        # a skinned scene hands its pose forward and misses every frame)
        sd = self.scene_data
        key = (sd.positions_obj, sd.instance_transform, sd.prev_instance_transform, self.bvh,
               *self._joint_matrices)
        if self._prepare_key is None or len(key) != len(self._prepare_key) or any(
                a is not b for a, b in zip(self._prepare_key, key)):
            self._prepared = renderer_mod.prepare_frame(self.statics, sd, self.bvh,
                                                        self.skin_bundle, self._joint_matrices)
            self._prepare_key = key
        sd_frame, geom, bvh_frame = self._prepared

        spx = self.mesh.axis("sp")
        # each sp rank traces its own disjoint Halton window
        sample_base = (self.frame_index * spx.size + spx.index) * settings.sample_stride
        out = wf.trace_frame(settings, self.statics, sd_frame, bvh_frame, geom, uniforms,
                             self.offsets, self.motion, y0=self.y0, sample_base=sample_base)
        # colour, depth and motion averaged over sp in one reduction
        mean = comm.pmean(torch.cat([out.color, out.depth[..., None], out.motion], dim=-1), spx)
        color, depth, motion = mean[..., 0:3], mean[..., 3], mean[..., 4:6]
        rays = out.rays_traced.sum(dtype=torch.int64)
        self.last_rays_traced = comm.psum(comm.psum(rays, self.mesh.axis("dp")), spx)
        self.accum = acc.accumulate(settings, uniforms, color, motion, self.motion, self.accum)
        self.depth, self.motion = depth, motion
        if self.statics.skin_slices:
            self.scene_data = sd._replace(positions_obj=sd_frame.positions_obj,
                                          prev_positions_obj=sd_frame.positions_obj)
        self.frame_index += 1
        return self.gather(self.accum)
