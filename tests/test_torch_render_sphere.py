"""The whole slice against live mrt_tpu on a sphere over a floor under the
default area and spot lights at 64x64, 2 spp, 3 bounces, 3 frames: PBR with
fused and unfused shadow rays on the JAX side, legacy shading, a model moved
between frames (refit, motion vectors), and a render from the JAX package's
own tables carried over by convert.py. Tolerances as in
test_torch_render.py; motion and depth within 1e-3 absolute."""

import numpy as np
import pytest
import torch

from mrt_tpu import Renderer as JRenderer
from mrt_tpu import UPSCALER_OFF as J_OFF
from mrt_tpu.engine.scene import Model as JModel
from mrt_tpu.engine.scene import Scene as JScene
from mrt_tpu_torch import UPSCALER_OFF, Model, Renderer, Scene, convert
from mrt_tpu_torch.render import wavefront
from mrt_tpu_torch.utils import frame_profile
from test_torch_render import compare_frames, one_torch_thread, port_like  # noqa: F401
from test_torch_scene_bvh import jax_sah

SIZE = 64


def jax_renderer(shading_mode=0, fuse=False):
    s = JScene(SIZE, SIZE)
    s.models = [JModel("sphere", position=[0.2, 0.5, 0.3], scale=0.5), JModel("plane", scale=10),
                JModel("sphere", position=[-0.9, 0.3, -0.4], scale=0.3)]
    with jax_sah():  # test_from_compiled_tables_match_own_build compares the tables
        r = JRenderer(s, SIZE, SIZE, seed=7)
    r.upscaler_mode = J_OFF
    r.samples_per_pixel = 2
    r.max_bounces = 3
    r.use_motion_adaptive_sampling = False
    r.shading_mode = shading_mode
    r.fuse_shadow_rays = fuse
    r.draw()
    return r


@pytest.mark.parametrize("shading_mode,fuse", [(0, True), (0, False), (1, False)],
                         ids=["pbr-fused", "pbr-unfused", "legacy"])
def test_sphere_plane_matches_mrt_tpu(shading_mode, fuse):
    rj = jax_renderer(shading_mode, fuse)
    compare_frames(rj, port_like(rj), 3)


def test_moved_model_matches_mrt_tpu():
    """move_model between frames: the dirty frame re-prepares (instance and
    TLAS refit) and both packages see the same motion vectors."""
    rj = jax_renderer()
    rp = port_like(rj)

    def move(f):
        rj.scene.move_model(2, forward=0.15 * f, right=0.1)
        rp.scene.move_model(2, forward=0.15 * f, right=0.1)

    compare_frames(rj, rp, 3, between=move)
    mj, mp = np.asarray(rj.motion), rp.motion.numpy()
    assert np.abs(mp).max() > 0.05
    np.testing.assert_allclose(mp, mj, atol=1e-3)
    np.testing.assert_allclose(rp.depth.numpy(), np.asarray(rj.depth), rtol=1e-5, atol=1e-3)


def test_lane_batches_match_one_batch(monkeypatch):
    """A frame traced in several fixed-size lane batches (the last one
    partial) equals the frame traced in one batch, bit for bit."""

    def render():
        s = Scene(SIZE, SIZE)
        s.models = [Model("sphere", position=[0.2, 0.5, 0.3], scale=0.5), Model("plane", scale=10)]
        r = Renderer(s, SIZE, SIZE, seed=7, device="cpu")
        r.upscaler_mode = UPSCALER_OFF
        r.use_motion_adaptive_sampling = False
        r.samples_per_pixel, r.max_bounces = 2, 3
        r.draw()
        return r

    one = render()
    monkeypatch.setattr(wavefront, "LANE_BATCH", 1000)
    batched = render()
    assert int(batched.last_rays_traced) == int(one.last_rays_traced) > 0
    for f in ("accum", "depth", "motion"):
        assert torch.equal(getattr(batched, f), getattr(one, f)), f


def test_frame_profile_runs_on_cpu():
    """utils/frame_profile.py profiles a frame of any renderer: on the CPU no
    device event is recorded, so the whole frame counts as idle."""
    s = Scene(32, 24)
    s.models = [Model("sphere", position=[0, 0.5, 0], scale=0.5), Model("plane", scale=10)]
    r = Renderer(s, 32, 24, seed=3, device="cpu")
    frame_profile.configure(r)
    r.max_bounces = 2
    line = frame_profile.profile_frame(r)
    assert len(line["frame_wall_s"]) == frame_profile.FRAMES and line["frame_wall_median_s"] > 0
    assert line["device_events"] == 0 and line["idle_share"] == 1.0
    assert line["rays"] == int(r.last_rays_traced) > 0


def test_from_compiled_tables_match_own_build():
    """Rendering from the JAX package's tables (convert.py) gives the same
    frame as the port's own compile and build: the tables are equal."""
    rj = jax_renderer()
    own = port_like(rj)
    carried = port_like(rj, scene=convert.scene(rj.scene))
    carried = Renderer.from_compiled(
        carried.scene, *convert.compiled(rj.scene_data, rj.statics, rj.bvh, device="cpu"),
        output_width=SIZE, output_height=SIZE, offsets=np.asarray(rj.offsets))
    for r in (own, carried):
        r.upscaler_mode = own.upscaler_mode
        r.use_motion_adaptive_sampling = False
        r.samples_per_pixel, r.max_bounces = 2, 3
    for _ in range(2):
        a, b = own.draw(), carried.draw()
        assert int(own.last_rays_traced) == int(carried.last_rays_traced)
    assert np.array_equal(a.numpy(), b.numpy())


def test_frame_profile_takes_given_walls():
    """profile_frame takes frame walls timed elsewhere (before any profiler
    session) for its idle share, and times none itself then."""
    s = Scene(16, 16)
    s.models = [Model("sphere", position=[0, 0.5, 0], scale=0.5), Model("plane", scale=10)]
    r = Renderer(s, 16, 16, seed=3, device="cpu")
    frame_profile.configure(r)
    r.max_bounces = 1
    walls = frame_profile.frame_walls(r, frames=2)
    assert len(walls) == 2 and min(walls) > 0
    line = frame_profile.profile_frame(r, walls=[0.25, 0.5, 0.75])
    assert line["frame_wall_s"] == [0.25, 0.5, 0.75] and line["frame_wall_median_s"] == 0.5
