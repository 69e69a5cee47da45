"""The animated frame against live mrt_tpu: the skinned robot stand-in with
its swing rig over a floor beside a sphere, and a static scene orbited
between frames, at 48x48, 1 spp, 2 bounces, motion-adaptive sampling on
(the Renderer default: up to 2 extra samples between 1 and 6 px of motion;
for the robot, which moves about 1 px a frame at this size, between 0.2 and
0.8 px).

Both scenes are built by hand (the JAX app scene needs the train OBJ); the
JAX renderer's pixel offsets are injected. After each frame: the
accumulation within 1 % relative RMSE, motion within 1e-3 px on at least
99 % of pixels, rays per frame within 0.5 % (skinned positions agree to
ULPs, not bits, so a ray grazing an edge may flip), and the per-pixel
sample totals equal on at least 99 % of pixels. JAX's totals are derived
from its motion and its previous frame's motion with its own formula
(``render/wavefront.py:1154-1161``); the port's must follow the same formula
from its own motion exactly."""

import numpy as np
import pytest

from mrt_tpu import Renderer as JRenderer
from mrt_tpu import UPSCALER_OFF as J_OFF
from mrt_tpu.engine.scene import Model as JModel
from mrt_tpu.engine.scene import Scene as JScene
from mrt_tpu_torch import UPSCALER_OFF, Model, Renderer, Scene
from test_torch_render import rel_rmse
from test_torch_scene_bvh import jax_sah
from test_torch_skinning import _rig, one_torch_thread  # noqa: F401

SIZE = 48
DT = 1 / 15


def _models(pkg, robot: bool):
    model = JModel if pkg == "jax" else Model
    ms = [model("plane", scale=10), model("sphere", position=[0.9, 0.4, 0.2], scale=0.4)]
    if robot:
        r = _rig(pkg)
        # lowered into the floor so that its swinging top stays in view
        r.position = np.array([-0.5, -0.5, 1.0], np.float32)
        r.rotation = np.zeros(3, np.float32)
        ms.insert(0, r)
    return ms


def _configure(r, off, robot: bool):
    r.upscaler_mode = off
    r.samples_per_pixel = 1
    r.max_bounces = 2
    assert r.use_motion_adaptive_sampling and r.motion_sampling_max_extra_samples == 2
    if robot:
        # the robot moves about 1 px a frame at 48x48: thresholds scaled
        # down so that its pixels earn extra samples
        r.motion_sampling_low_threshold_pixels = 0.2
        r.motion_sampling_high_threshold_pixels = 0.8


def _jax(robot: bool):
    s = JScene(SIZE, SIZE)
    s.models = _models("jax", robot)
    r = JRenderer(s, SIZE, SIZE, seed=5)
    _configure(r, J_OFF, robot)
    return r


def _port(robot: bool, offsets):
    s = Scene(SIZE, SIZE)
    s.models = _models("port", robot)
    r = Renderer(s, SIZE, SIZE, device="cpu", offsets=offsets)
    _configure(r, UPSCALER_OFF, robot)
    return r


def sample_totals(r, motion, prev_motion):
    """Per-pixel samples: base + round(t * max_extra), t from the larger of
    this frame's and the previous frame's motion between the thresholds."""
    f32 = np.float32

    def length(m):
        m = m.astype(f32)
        return np.sqrt(m[..., 0] * m[..., 0] + m[..., 1] * m[..., 1])

    mag = np.maximum(length(motion), length(prev_motion))
    low = max(f32(r.motion_sampling_low_threshold_pixels), f32(0.0))
    high = max(f32(r.motion_sampling_high_threshold_pixels), low + f32(1e-3))
    t = np.clip((mag - low) / (high - low), f32(0.0), f32(1.0))
    extra = np.clip(np.round(t * f32(r.motion_sampling_max_extra_samples)), 0, 2).astype(np.int32)
    return r.samples_per_pixel + extra


def _lockstep(robot: bool, between=None):
    """Three frames on both packages; returns per-frame records."""
    rj = _jax(robot)
    rp = None
    records = []
    for f in range(3):
        if f and between is not None:
            between(rj, rp)
        prev_j = np.asarray(rj.motion)
        rj.draw(DT)
        if rp is None:  # JAX's offsets have the render size after its first draw
            rp = _port(robot, np.asarray(rj.offsets))
        prev_p = rp.motion.numpy()
        rp.draw(DT)
        aj, ap = np.asarray(rj.accum), rp.accum.numpy()
        mj, mp = np.asarray(rj.motion), rp.motion.numpy()
        if f == 0:  # the first draw allocates the state at the render size
            prev_j, prev_p = np.zeros_like(mj), np.zeros_like(mp)
        sj = sample_totals(rj, mj, prev_j)
        sp = rp.last_samples.numpy()
        records.append(dict(frame=f, rmse=rel_rmse(ap, aj), finite=bool(np.isfinite(ap).all()),
                            motion_ok=float(np.mean(np.all(np.abs(mp - mj) <= 1e-3, axis=-1))),
                            motion_max=float(np.abs(mj).max()),
                            rays=(int(rj.last_rays_traced), int(rp.last_rays_traced)),
                            samples_ok=float(np.mean(sj == sp)),
                            samples_own=bool(np.array_equal(sp, sample_totals(rp, mp, prev_p))),
                            extras=np.bincount(sp.ravel() - 1, minlength=3).tolist()))
    return records


def _check(records):
    for rec in records:
        f = rec["frame"]
        assert rec["finite"] and rec["rmse"] < 1e-2, rec
        assert rec["motion_ok"] >= 0.99, rec
        rj, rp = rec["rays"]
        assert abs(rp - rj) <= 0.005 * rj, rec
        assert rec["samples_ok"] >= 0.99, rec
        assert rec["samples_own"], f"frame {f}: the port's totals break its own formula"


def test_animated_frame_matches_mrt_tpu():
    """The skinned robot over three draws at 1/15 s: frame 0 is the rest
    pose (the 60 Hz clock has not stepped), frames 1 and 2 move the robot
    by 5 and 4 steps; some pixels earn extra samples."""
    records = _lockstep(robot=True)
    _check(records)
    assert records[0]["motion_max"] == 0.0
    assert records[1]["motion_max"] > 0.5 and records[2]["motion_max"] > 0.5
    assert records[1]["extras"][1] > 0 and records[1]["extras"][2] > 0


def test_orbit_motion_adaptive_matches_mrt_tpu():
    """A static scene orbited between frames: camera motion everywhere, so
    pixels earn one and two extra samples."""

    def orbit(rj, rp):
        for r in (rj, rp):
            r.orbit(60.0, 10.0)

    records = _lockstep(robot=False, between=orbit)
    _check(records)
    assert records[1]["extras"][1] > 0 and records[1]["extras"][2] > 0


def test_animation_clock_matches_mrt_tpu():
    """The 60 Hz throttle with catch-up over uneven frame times: the same
    frames are throttled (matrices kept), the same clip times reached, and
    the joint matrices are bit-equal."""
    rj = _jax(robot=True)
    s = Scene(SIZE, SIZE)
    s.models = _models("port", robot=True)
    rp = Renderer(s, SIZE, SIZE, device="cpu")
    throttled = []
    for dt in [1 / 60] * 10 + [1 / 15, 1 / 240, 1 / 240, 1 / 30, 0.2, None]:
        before_j, before_p = rj._joint_matrices, rp._joint_matrices
        rj._update_animation(dt)
        rp._update_animation(dt)
        assert (rj._joint_matrices is before_j) == (rp._joint_matrices is before_p)
        throttled.append(rp._joint_matrices is before_p)
        assert rj.scene.models[0].skin.current_time == rp.scene.models[0].skin.current_time
        assert np.array_equal(np.asarray(rj._joint_matrices[0]), rp._joint_matrices[0].numpy())
    assert any(throttled) and not all(throttled)


@pytest.mark.parametrize("frames", [1, 2, 3])
def test_pose_handoff(frames):
    """After each frame the skinned pose becomes the next frame's pose and
    previous pose; the first frame's previous pose is the rest pose, so the
    first frame at 1/60 s already has motion; normals stay rest-skinned."""
    s = Scene(SIZE, SIZE)
    s.models = _models("port", robot=True)
    r = Renderer(s, SIZE, SIZE, device="cpu")
    _configure(r, UPSCALER_OFF, robot=True)
    rest = r.scene_data.positions_obj
    rest_normals = r.scene_data.normals_obj
    for f in range(frames):
        prev = r.scene_data.positions_obj
        r.draw(1 / 60)
        sd = r.scene_data
        assert sd.positions_obj is sd.prev_positions_obj
        assert not np.array_equal(sd.positions_obj[:425].numpy(), prev[:425].numpy())
        assert np.array_equal(sd.positions_obj[425:].numpy(), rest[425:].numpy())
        assert sd.normals_obj is rest_normals
        assert float(r.motion.abs().max()) > 0.0


def test_from_compiled_skinned_matches_own_build():
    """Rendering the animated scene from the JAX package's compiled state
    (convert.py: skin slices, skinned BVH groups, SkinData and skin bundle)
    gives the same frames as the port's own compile and build."""
    from mrt_tpu.bvh import twolevel as jtl

    from mrt_tpu_torch import convert

    js = JScene(SIZE, SIZE)
    js.models = _models("jax", robot=True)
    jd, jst = js.compile()
    with jax_sah():
        jb = jtl.build(js.models, jd, jst.skin_slices, host_mirror=js.host_mirror)
    own = Renderer(convert.scene(js), SIZE, SIZE, device="cpu", seed=3)
    carried = Renderer.from_compiled(convert.scene(js), *convert.compiled(jd, jst, jb, device="cpu"),
                                     output_width=SIZE, output_height=SIZE, seed=3)
    for r in (own, carried):
        _configure(r, UPSCALER_OFF, robot=True)
    for _ in range(3):
        a, b = own.draw(DT), carried.draw(DT)
        assert int(own.last_rays_traced) == int(carried.last_rays_traced)
        assert np.array_equal(a.numpy(), b.numpy())
        assert np.array_equal(own.motion.numpy(), carried.motion.numpy())
    assert float(own.motion.abs().max()) > 0.0
