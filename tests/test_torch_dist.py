"""Multi-device rendering over pixels (dp) and samples (sp) — the port's
``dist/comm.py``, ``dist/sharding.py`` and ``save_dist``/``restore_dist`` —
against the port's single device and mrt_tpu's ``DistributedRenderer``.

One gloo world of 4 ranks on the CPU (``dist.launch.launch``), spawned once
for the module, runs every scenario and returns what the tests check
(``world``); the JAX side runs in this process on the virtual 8-device CPU
mesh, as ``tests/test_dist.py`` runs it (``jax_side``). The scenes are
``test_dist.py``'s 32x32 sphere and plane (1 spp, 2 bounces) and its skinned
tube. Bars: dp bit-equal to the port's single device at the same offsets
(JAX's own bar is 1e-6); sp within 1e-6 of the mean of the two sample
windows traced by the single device (``test_sp_equals_mean_of_sample_windows``'s
contract); against mrt_tpu the port's parity bar, 1 % relative RMSE
(``tests/test_golden.py``'s), with rays equal per frame.
"""

import operator

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from mrt_tpu.core import types as JT
from mrt_tpu.dist.sharding import DistributedRenderer as JDistributedRenderer
from mrt_tpu.dist.sharding import make_mesh as jmake_mesh
from mrt_tpu.engine import checkpoint as jcheckpoint
from mrt_tpu.engine.scene import Model as JModel
from mrt_tpu.engine.scene import Scene as JScene
from mrt_tpu.skinning import animation as janim
from mrt_tpu.skinning import lbs as jlbs
from mrt_tpu_torch import UPSCALER_OFF, Model, Renderer, Scene, convert
from mrt_tpu_torch.core import halton as H
from mrt_tpu_torch.core import types as T
from mrt_tpu_torch.dist import comm
from mrt_tpu_torch.dist import launch as L
from mrt_tpu_torch.dist.sharding import DistributedRenderer, make_mesh
from mrt_tpu_torch.render import wavefront as wf
from test_torch_render import rel_rmse
from test_torch_scene_bvh import one_torch_thread  # noqa: F401

SIZE = 32
WORLD = 4
SEED = 3
CPU = {"device": "cpu"}


def _models(M):
    return [M("sphere", position=[0.0, 0.5, 0.0], scale=0.5), M("plane", position=[0, 0, 0], scale=10)]


def _jscene():
    s = JScene(width=SIZE, height=SIZE)
    s.models = _models(JModel)
    return s


def _scene():
    s = Scene(SIZE, SIZE)
    s.models = _models(Model)
    return s


def _settings(types):
    return types.RenderSettings(width=SIZE, height=SIZE, samples_per_pixel=1, max_bounces=2,
                                enable_motion_adaptive_sampling=False,
                                tile_pixels=SIZE * SIZE // 4)


def _single(offsets, scene=None):
    """The port's single-device renderer at the settings of ``_settings``."""
    r = Renderer(scene or _scene(), SIZE, SIZE, device="cpu", offsets=np.asarray(offsets))
    r.upscaler_mode = UPSCALER_OFF
    r.samples_per_pixel = 1
    r.max_bounces = 2
    r.use_motion_adaptive_sampling = False
    r._allocate_state()  # at the render size, with the given offsets
    return r


def _pose():
    """The skinned tube's joint matrices at t = 0.4 (test_dist.py's pose)."""
    js = graft._tiny_scene(SIZE, SIZE, skinned=True)
    sk = js.models[-1].skin
    m = janim.compute_joint_matrices(sk.skeleton, sk.animation, 0.4)
    return np.asarray(jlbs.compose_final_matrices(m, sk.geometry_bind), np.float32)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """mrt_tpu's DistributedRenderer: dp=4 over three frames with a
    save_dist after the second, (dp, sp) = (2, 2), and the skinned tube at
    dp=4 before and after a pose."""
    d = tmp_path_factory.mktemp("jax_dist")
    out = dict(dir=d, pose=_pose())
    jdr = JDistributedRenderer(_jscene(), _settings(JT), mesh=jmake_mesh(n_devices=WORLD, sp=1))
    out["offsets"] = np.asarray(jdr.offsets)
    frames, rays = [], []
    for k in range(3):
        if k == 2:
            jcheckpoint.save_dist(jdr, str(d / "jax.npz"))
        frames.append(np.asarray(jdr.draw()))
        rays.append(int(float(jdr.last_rays_traced)))
    out.update(dp=frames, dp_rays=rays, jdr=jdr)
    jsp = JDistributedRenderer(_jscene(), _settings(JT), mesh=jmake_mesh(n_devices=WORLD, sp=2))
    assert np.array_equal(np.asarray(jsp.offsets), out["offsets"])
    out["sp"] = np.asarray(jsp.draw())
    out["sp_rays"] = int(float(jsp.last_rays_traced))
    jk = JDistributedRenderer(graft._tiny_scene(SIZE, SIZE, skinned=True), _settings(JT),
                              mesh=jmake_mesh(n_devices=WORLD, sp=1))
    skinned = [np.asarray(jk.draw())]
    skinned_rays = [int(float(jk.last_rays_traced))]
    jk.set_joint_matrices((jnp.asarray(out["pose"]),))
    skinned.append(np.asarray(jk.draw()))
    skinned_rays.append(int(float(jk.last_rays_traced)))
    out.update(skinned=skinned, skinned_rays=skinned_rays)
    return out


def _mesh_calls(axes):
    """Per axis: the rank's index and the four reductions of a per-rank
    float and int value."""
    calls = []
    for name in axes:
        calls.append((name, comm.axis_index, [()] * WORLD))
        for op in (comm.psum, comm.pmin, comm.pmax, comm.pmean):
            calls.append((name, op, [(torch.tensor([r * 1.5 - 2.0, 10.0 - r * r]),)
                                     for r in range(WORLD)]))
        for op in (comm.psum, comm.pmin, comm.pmax):
            calls.append((name, op, [(torch.tensor([(r * 7) % 5, -r], dtype=torch.int64),)
                                     for r in range(WORLD)]))
    return calls


@pytest.fixture(scope="module")
def world(jax_side):
    """Every rank-side scenario in one 4-rank gloo world; results by rank."""
    d = jax_side["dir"]
    joff = jax_side["offsets"]
    jobs = [
        (L.on_mesh, ({"dp": 2, "sp": 2}, _mesh_calls(("dp", "sp"))), CPU),
        (L.on_mesh, ({"dp": 2, "gp": 2}, _mesh_calls(("dp", "gp"))), CPU),
        # the seeded offsets, two frames (the second a clean frame)
        (L.drive, ("dp", _scene(), _settings(T), {"dp": 4}, 2), dict(seed=SEED, **CPU)),
        # JAX's offsets: three frames, saved after the second
        (L.drive, ("dp", _scene(), _settings(T), {"dp": 4}, 3),
         dict(offsets=joff, save=(2, str(d / "port.npz")), **CPU)),
        (L.drive, ("dp", _scene(), _settings(T), {"dp": 4}, 1),
         dict(restore=str(d / "port.npz"), **CPU)),
        (L.drive, ("dp", _scene(), _settings(T), {"dp": 4}, 1),
         dict(restore=str(d / "jax.npz"), **CPU)),
        (L.drive, ("dp", _scene(), _settings(T), {"dp": 2, "sp": 2}, 1), dict(offsets=joff, **CPU)),
        (L.drive, ("dp", convert.scene(graft._tiny_scene(SIZE, SIZE, skinned=True)), _settings(T),
                   {"dp": 4}, 2), dict(offsets=joff, joints=[None, (jax_side["pose"],)], **CPU)),
    ]
    res = L.launch(L.run_jobs, WORLD, jobs, **CPU)
    names = ("mesh_sp", "mesh_gp", "seeded", "dp", "resumed", "resumed_jax", "sp", "skinned")
    return {n: [r[k] for r in res] for k, n in enumerate(names)}


def _single_frames(offsets, n):
    r = _single(offsets)
    frames = [r.draw().numpy().copy() for _ in range(n)]
    return frames, r


def test_mesh_layout_and_reductions(world):
    """Ranks lie as the JAX package's make_mesh lays devices ((n // sp, sp),
    and the combined (dp, gp) mesh alike); axis_index and the four
    reductions over each axis of a (2, 2) mesh equal NumPy's."""
    layout = np.vectorize(lambda dv: dv.id)(jmake_mesh(n_devices=WORLD, sp=2).devices)
    for key, axes in (("mesh_sp", ("dp", "sp")), ("mesh_gp", ("dp", "gp"))):
        per_rank = world[key]
        for r, out in enumerate(per_rank):
            assert np.array_equal(out["ranks"], layout) and out["rank"] == r
        coords = {r: divmod(r, 2) for r in range(WORLD)}
        for a, name in enumerate(axes):
            base = a * 8
            for r, out in enumerate(per_rank):
                res = out["results"]
                assert res[base] == coords[r][a]
                peers = [q for q in range(WORLD) if coords[q][1 - a] == coords[r][1 - a]]
                xf = np.stack([[q * 1.5 - 2.0, 10.0 - q * q] for q in peers]).astype(np.float32)
                xi = np.stack([[(q * 7) % 5, -q] for q in peers]).astype(np.int64)
                np.testing.assert_array_equal(res[base + 1], xf.sum(0))
                np.testing.assert_array_equal(res[base + 2], xf.min(0))
                np.testing.assert_array_equal(res[base + 3], xf.max(0))
                np.testing.assert_array_equal(res[base + 4], xf.sum(0) / 2)
                np.testing.assert_array_equal(res[base + 5], xi.sum(0))
                np.testing.assert_array_equal(res[base + 6], xi.min(0))
                np.testing.assert_array_equal(res[base + 7], xi.max(0))
                assert res[base + 5].dtype == np.int64


def test_dp_bit_equal_to_single_device(world):
    """dp=4 from a seed: every rank draws the full offsets from the seed and
    keeps its rows, so two frames are bit-equal to the single-device
    Renderer at the seed's offsets, with equal rays (int64 sums); the
    second, clean frame reuses the prepared geometry; every rank returns
    the same rays."""
    offsets = H.make_pixel_offsets(torch.Generator().manual_seed(SEED), SIZE, SIZE).numpy()
    single, r = _single_frames(offsets, 2)
    out = world["seeded"][0]
    for a, b in zip(out["images"], single):
        np.testing.assert_array_equal(a, b)
    assert out["prepare_reused"] == [False, True]
    assert all(x["rays"] == out["rays"] for x in world["seeded"])
    r2 = _single(offsets)
    rays = []
    for _ in range(2):
        r2.draw()
        assert r2.last_rays_traced.dtype == torch.int64
        rays.append(int(r2.last_rays_traced))
    assert out["rays"] == rays


def test_dp_matches_mrt_tpu(world, jax_side):
    """dp=4 at the JAX renderer's offsets: bit-equal to the port's single
    device, within the parity bar of mrt_tpu's dp=4 frames, rays equal."""
    out = world["dp"][0]
    single, _ = _single_frames(jax_side["offsets"], 3)
    for k in range(3):
        np.testing.assert_array_equal(out["images"][k], single[k])
        assert rel_rmse(out["images"][k], jax_side["dp"][k]) < 0.01, k
    assert out["rays"] == jax_side["dp_rays"]


def test_sp_is_mean_of_sample_windows(world, jax_side):
    """(dp, sp) = (2, 2): the frame is the mean of the two disjoint Halton
    windows, ``(frame_index * sp + sp_rank) * sample_stride``, traced by the
    single device (within 1e-6), and matches mrt_tpu's sp frame (parity
    bar) with the rays of both windows."""
    out = world["sp"][0]
    settings = _settings(T)
    r = _single(jax_side["offsets"])
    sd, geom, bvh = r.prepare()
    uniforms = T.make_frame_uniforms(camera=r.current_camera(), frame_index=0)
    zeros = torch.zeros((SIZE, SIZE, 2))
    windows = [wf.trace_frame(settings, r.statics, sd, bvh, geom, uniforms, r.offsets, zeros,
                              sample_base=k * settings.sample_stride) for k in (0, 1)]
    expect = ((windows[0].color + windows[1].color) / 2).numpy()
    np.testing.assert_allclose(out["images"][0], expect, atol=1e-6)
    assert out["rays"][0] == sum(int(w.rays_traced.sum()) for w in windows)
    assert rel_rmse(out["images"][0], jax_side["sp"]) < 0.01
    assert out["rays"][0] == jax_side["sp_rays"]
    assert np.abs(out["images"][0] - jax_side["dp"][0]).mean() > 1e-8  # the extra samples count


def test_dp_skinned_scene(world, jax_side):
    """The skinned tube at dp=4, a pose set through set_joint_matrices
    before the second frame: both frames match mrt_tpu's within the parity
    bar with equal rays, and the pose changes the image."""
    out = world["skinned"][0]
    for k in range(2):
        assert np.isfinite(out["images"][k]).all()
        assert rel_rmse(out["images"][k], jax_side["skinned"][k]) < 0.01, k
    assert out["rays"] == jax_side["skinned_rays"]
    assert np.abs(out["images"][1] - out["images"][0]).max() > 0
    assert out["prepare_reused"] == [False, False]


def test_checkpoint_resumes_bit_identically(world):
    """save_dist after two frames, restore_dist into a fresh renderer: its
    next frame is bit-equal to the uninterrupted third frame, rays equal."""
    uninterrupted = world["dp"][0]
    resumed = world["resumed"][0]
    np.testing.assert_array_equal(resumed["images"][0], uninterrupted["images"][2])
    assert resumed["rays"][0] == uninterrupted["rays"][2]


def test_jax_checkpoint_restores_into_port(world, jax_side):
    """mrt_tpu's save_dist file restores into the port's dp=4 renderer; its
    next frame matches mrt_tpu's third frame (parity bar), rays equal."""
    out = world["resumed_jax"][0]
    assert rel_rmse(out["images"][0], jax_side["dp"][2]) < 0.01
    assert out["rays"][0] == jax_side["dp_rays"][2]


def test_port_checkpoint_restores_into_jax(world, jax_side):
    """The port's save_dist file restores into mrt_tpu's renderer, whose
    next frame matches the port's third frame (parity bar), rays equal.
    The file carries the JAX package's keys; ``step_hint`` is all zeros by
    design (a deliberate divergence: the port does no workload sort, and
    JAX's sort is undone bit-exactly, so its hints change no image)."""
    path = jax_side["dir"] / "port.npz"
    z = np.load(path)
    assert set(z.files) == set(np.load(jax_side["dir"] / "jax.npz").files)
    assert z["step_hint"].dtype == np.int32 and z["step_hint"].shape == (SIZE, SIZE)
    assert not z["step_hint"].any() and int(z["frame_index"]) == 2
    jdr = jax_side["jdr"]
    jcheckpoint.restore_dist(jdr, str(path))
    assert jdr.frame_index == 2
    img = np.asarray(jdr.draw())
    port = world["dp"][0]
    assert rel_rmse(img, port["images"][2]) < 0.01
    assert int(float(jdr.last_rays_traced)) == port["rays"][2]


def test_gates_and_refusals(tmp_path):
    """check_supported accepts geometry_axis; a world of one rank needs no
    process group (a dp=1 renderer is the single device, rays int64); a
    mesh that does not fit the world, a flat table with masks under dp, a
    renderer or a launch asked for the card (the default) without one,
    nccl on the CPU or with two ranks on one GPU all raise."""
    T.check_supported(T.RenderSettings(geometry_axis="gp"))
    offsets = H.make_pixel_offsets(torch.Generator().manual_seed(0), SIZE, SIZE).numpy()
    dr = DistributedRenderer(_scene(), _settings(T), device="cpu")
    img = dr.draw()
    single, r = _single_frames(offsets, 1)
    np.testing.assert_array_equal(img.numpy(), single[0])
    assert dr.last_rays_traced.dtype == torch.int64 and int(dr.last_rays_traced) > 0
    with pytest.raises(ValueError, match="world has 1"):
        make_mesh(n_devices=2, device="cpu")
    masked = _scene()
    masked.models[0].geometry_mask = T.GEOMETRY_MASK_LIGHT
    with pytest.raises(ValueError, match="masks"):
        DistributedRenderer(masked, T.RenderSettings(width=SIZE, height=SIZE, two_level=False),
                            device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="none is available"):
            DistributedRenderer(_scene(), _settings(T), device="cuda")
        with pytest.raises(RuntimeError, match="none is available"):
            DistributedRenderer(_scene(), _settings(T))
        with pytest.raises(RuntimeError, match="none is available"):
            L.launch(operator.add, 2, 1, 1)
    with pytest.raises(ValueError, match="CUDA devices only"):
        L.launch(operator.add, 2, 1, 1, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="refuses two ranks on one GPU"):
        comm.check_backend("nccl", torch.cuda.device_count() + 1)
    comm.check_backend("gloo", 8)


def test_rank_device_follows_the_launcher(monkeypatch):
    """A rank that the launcher started on the CPU builds its mesh there by
    default and refuses a mesh on the card: the launcher's device is the
    one device setting of a world."""
    monkeypatch.setenv(comm.RANK_DEVICE_ENV, "cpu")
    assert comm.rank_device() == torch.device("cpu")
    assert comm.Mesh({"dp": 1}).device == torch.device("cpu")
    with pytest.raises(ValueError, match="cannot join its world"):
        comm.rank_device("cuda")
    with pytest.raises(ValueError, match="cannot join its world"):
        comm.Mesh({"dp": 1}, "cuda:0")
