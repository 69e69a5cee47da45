"""Checkpoint / resume of the port's renderer (``engine/checkpoint.py``),
and checkpoints crossing between the port and mrt_tpu.

Within the port on the CPU: a static and an animated scene (the app scene
with the swing-rigged robot, ``asset_models=False``: the JAX package's own
animated round trip, ``test_engine_aux.py:232``, needs the train OBJ) are
saved after a few frames and restored into a fresh renderer; the restored
state is bit-equal to the saved one and the next frames agree within 1e-6
(the bar of ``test_engine_aux.py:84``). A resolution or scene mismatch
raises ValueError. Across packages: a JAX checkpoint restores into the
port and a port checkpoint into JAX, over the same animated scene (the
robot stand-in over a floor with a sphere, 48x48): the restored state is
the saved one, and the next frame agrees within 1 % relative RMSE with
equal rays.
"""

import numpy as np
import pytest
import torch

from mrt_tpu.engine import checkpoint as jcheckpoint
from mrt_tpu_torch import UPSCALER_OFF, Model, Renderer, Scene, make_app_scene
from mrt_tpu_torch.engine import checkpoint
from test_torch_animated import _configure, _jax, _models
from test_torch_render import rel_rmse
from test_torch_scene_bvh import one_torch_thread  # noqa: F401

SIZE = 48
DT = 1 / 15
STATE = ("accum", "motion", "depth", "offsets")


def _static(size=SIZE, seed=0):
    s = Scene(size, size)
    s.models = [Model("sphere", position=[0.0, 0.5, 0.0], scale=0.5), Model("plane", scale=10)]
    r = Renderer(s, size, size, device="cpu", seed=seed)
    r.upscaler_mode = UPSCALER_OFF
    r.samples_per_pixel = 1
    r.max_bounces = 2
    r.use_motion_adaptive_sampling = False
    return r


def _animated(seed=0):
    r = Renderer(make_app_scene(32, 32, include_robot=True, asset_models=False), 32, 32,
                 device="cpu", seed=seed)
    r.upscaler_mode = UPSCALER_OFF
    r.samples_per_pixel = 1
    r.max_bounces = 1
    return r


def _port_robot(seed=0):
    s = Scene(SIZE, SIZE)
    s.models = _models("port", robot=True)
    r = Renderer(s, SIZE, SIZE, device="cpu", seed=seed)
    _configure(r, UPSCALER_OFF, robot=True)
    return r


def _state(r):
    """The resumable state as NumPy arrays (either package)."""
    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    out = {k: host(getattr(r, k)) for k in STATE}
    out["positions_obj"] = host(r.scene_data.positions_obj)
    out["prev_positions_obj"] = host(r.scene_data.prev_positions_obj)
    out["prev_camera"] = np.stack([host(x) for x in r._previous_camera])
    out["skin_times"] = np.asarray([r.scene.models[i].skin.current_time
                                    for i, _, _ in r.statics.skin_slices], np.float64)
    return out


def _assert_state_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_checkpoint_roundtrip_static(tmp_path):
    r = _static()
    for _ in range(3):
        r.draw()
    r.orbit(120.0, 30.0)
    r.draw()
    path = str(tmp_path / "state.npz")
    checkpoint.save(r, path)
    r2 = _static(seed=9)  # other offsets: the checkpoint's must win
    checkpoint.restore(r2, path)
    _assert_state_equal(_state(r2), _state(r))
    assert r2.frame_index == r.frame_index == 1
    assert (r2.camera_azimuth, r2.camera_elevation) == (r.camera_azimuth, r.camera_elevation)
    for _ in range(2):
        a, b = r.draw().numpy(), r2.draw().numpy()
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
        assert int(r.last_rays_traced) == int(r2.last_rays_traced)


def test_checkpoint_roundtrip_animated(tmp_path):
    """Clip times, the 60 Hz clock (one of the next frames is throttled)
    and the skinned pose buffers are part of the state."""
    ra = _animated()
    for _ in range(4):
        ra.draw(1 / 30)
    path = str(tmp_path / "anim.npz")
    checkpoint.save(ra, path)
    rb = _animated(seed=4)
    checkpoint.restore(rb, path)
    _assert_state_equal(_state(rb), _state(ra))
    assert rb.frame_index == ra.frame_index == 4
    assert rb._scene_time == ra._scene_time
    assert rb._last_skinning_update == ra._last_skinning_update
    for dt in (1 / 30, 1 / 120, 1 / 30):
        x, y = ra.draw(dt).numpy(), rb.draw(dt).numpy()
        np.testing.assert_allclose(y, x, rtol=0, atol=1e-6)
        assert np.array_equal(rb.scene_data.positions_obj.numpy(),
                              ra.scene_data.positions_obj.numpy())
    assert float(ra.motion.abs().max()) > 0.0


def test_checkpoint_shape_mismatch_raises(tmp_path):
    r = _static(48)
    r.draw()
    path = str(tmp_path / "s.npz")
    checkpoint.save(r, path)
    with pytest.raises(ValueError, match="resolution"):
        checkpoint.restore(_static(32), path)


def test_checkpoint_scene_mismatch_raises(tmp_path):
    r = _static()
    r.draw()
    path = str(tmp_path / "s.npz")
    checkpoint.save(r, path)
    s = Scene(SIZE, SIZE)
    s.models = [Model("sphere", position=[0.0, 0.5, 0.0], scale=0.5)]
    other = Renderer(s, SIZE, SIZE, device="cpu")
    other.upscaler_mode = UPSCALER_OFF
    with pytest.raises(ValueError, match="fingerprint"):
        checkpoint.restore(other, path)


def test_checkpoint_keys_and_dtypes_match_mrt_tpu(tmp_path):
    """The port writes the JAX package's keys (but the hit-priming caches,
    which it does not keep) with the same dtypes and shapes."""
    rj = _jax(robot=True)
    rj.draw(DT)
    jpath = str(tmp_path / "jax.npz")
    jcheckpoint.save(rj, jpath)
    rp = _port_robot()
    rp.draw(DT)
    ppath = str(tmp_path / "port.npz")
    checkpoint.save(rp, ppath)
    zj, zp = np.load(jpath), np.load(ppath)
    assert set(zj.files) - set(zp.files) == {"prime_primary", "prime_shadow"}
    assert set(zp.files) <= set(zj.files)
    for k in zp.files:
        assert (zp[k].dtype, zp[k].shape) == (zj[k].dtype, zj[k].shape), k


def test_jax_checkpoint_resumes_in_port(tmp_path):
    rj = _jax(robot=True)
    for _ in range(3):
        rj.draw(DT)
    path = str(tmp_path / "jax.npz")
    jcheckpoint.save(rj, path)
    rp = _port_robot(seed=7)
    checkpoint.restore(rp, path)
    _assert_state_equal(_state(rp), _state(rj))
    assert rp.frame_index == rj.frame_index == 3
    rj.draw(DT)
    rp.draw(DT)
    assert rel_rmse(rp.accum.numpy(), np.asarray(rj.accum)) < 1e-2
    assert int(rp.last_rays_traced) == int(rj.last_rays_traced)


def test_port_checkpoint_resumes_in_jax(tmp_path):
    rp = _port_robot(seed=7)
    for _ in range(3):
        rp.draw(DT)
    path = str(tmp_path / "port.npz")
    checkpoint.save(rp, path)
    rj = _jax(robot=True)
    jcheckpoint.restore(rj, path)
    _assert_state_equal(_state(rj), _state(rp))
    assert rj.frame_index == rp.frame_index == 3
    rj.draw(DT)
    rp.draw(DT)
    assert rel_rmse(rp.accum.numpy(), np.asarray(rj.accum)) < 1e-2
    assert int(rp.last_rays_traced) == int(rj.last_rays_traced)
