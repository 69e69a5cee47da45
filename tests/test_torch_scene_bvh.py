"""Host scene stack and BVH tables: mrt_tpu_torch against mrt_tpu on the
same models. SceneData arrays and the two-level tables are compared bit for
bit; the refit after a move too.

The JAX package's native loader builds ``build/libmrt_native.so`` in place
and, if loading fails once, uses the LBVH builder for the rest of the
process; a test worker that loads the library while another worker writes
it would then build other tables than the port (which always builds with
SAH). ``jax_sah`` guards every comparison with a JAX-built table: it makes
sure the JAX loader has really loaded the SAH builder, rebuilding the
library atomically under a file lock if needed, and fails the test with the
loader's error if it still does not load."""

import contextlib
import ctypes
import fcntl
import os
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_scenes import add_extra_lights, config3_models
from mrt_tpu.assets import procedural as jproc
from mrt_tpu.bvh import lbvh as jlbvh
from mrt_tpu.bvh import twolevel as jtl
from mrt_tpu.bvh import wide as jwide
from mrt_tpu.core import types as JT
from mrt_tpu.engine.scene import Model as JModel
from mrt_tpu.engine.scene import ModelMaterialOverride as JOverride
from mrt_tpu.engine.scene import Scene as JScene
from mrt_tpu.engine.scene import world_geometry as jworld
from mrt_tpu.utils import native as jnative
from mrt_tpu_torch import convert
from mrt_tpu_torch.bvh import twolevel, wide
from mrt_tpu_torch.core import types as T
from mrt_tpu_torch.engine.scene import world_geometry
from mrt_tpu_torch.utils import native


def _sphere_plane():
    s = JScene(32, 32)
    s.models = [JModel("sphere", position=[0, 0.5, 0], scale=0.5), JModel("plane", scale=10)]
    return s


def _config3():
    s = JScene(32, 32)
    s.models = config3_models()
    add_extra_lights(s)
    return s


def _blob_glass():
    s = JScene(32, 32)
    s.models = [
        JModel("blob", mesh=jproc.blob(subdivisions=3, radius=0.4, seed=5), position=[0.2, 0.5, 0.4],
               scale=1.2, material_override=JOverride.glass()),
        JModel("plane", scale=10),
        JModel("sphere", position=[-1.0, 0.4, -0.5], scale=0.4),
    ]
    return s


SCENES = {"sphere_plane": _sphere_plane, "config3": _config3, "blob_glass": _blob_glass}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run the port's CPU ops on one thread: at these sizes more threads
    are no faster, and idle OpenMP workers spin on the cores that the other
    test workers need. Modules that import this fixture use it too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build_jax_native(force: bool):
    """Compile the JAX package's native library into a temporary file and
    move it onto its path in one step, under a file lock; unless ``force``,
    only when it is missing or older than its source."""
    so = jnative._SO
    so.parent.mkdir(parents=True, exist_ok=True)
    with open(so.with_name(so.name + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not force and so.exists() and so.stat().st_mtime >= jnative._SRC.stat().st_mtime:
            return
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        subprocess.run(["g++", "-O3", "-std=c++17", "-shared", "-fPIC", str(jnative._SRC), "-o",
                        str(tmp)], check=True, capture_output=True, timeout=300)
        os.replace(tmp, so)


def ensure_jax_sah(mp: pytest.MonkeyPatch):
    """The JAX loader's SAH builder, loaded (see the module docstring).
    Resets the loader's ``_tried``/``_lib`` through ``mp``."""
    if not jnative._tried:
        _build_jax_native(force=False)  # a first load finds a whole library
    if jnative.available():
        return
    _build_jax_native(force=True)
    mp.setattr(jnative, "_tried", False)
    mp.setattr(jnative, "_lib", None)
    if jnative.available():
        return
    try:
        ctypes.CDLL(str(jnative._SO))
        err = "it loads, but its entry points do not bind"
    except OSError as e:
        err = str(e)
    pytest.fail(f"the JAX package's native SAH builder does not load: {err}")


@contextlib.contextmanager
def jax_sah():
    """Build JAX tables inside this block: they come from the SAH builder."""
    with pytest.MonkeyPatch.context() as mp:
        ensure_jax_sah(mp)
        yield


def _both(make):
    js = make()
    jd, jst = js.compile()
    with jax_sah():
        jb = jtl.build(js.models, jd, jst.skin_slices, host_mirror=js.host_mirror)
    ps = convert.scene(js)
    pd, pst = ps.compile("cpu")
    pb = twolevel.build(ps.models, pd, ps.host_mirror)
    return (js, jd, jst, jb), (ps, pd, pst, pb)


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.dtype.kind == "f":
        return np.array_equal(a.view(np.int32), b.astype(np.float32).view(np.int32))
    return np.array_equal(a.astype(np.int64), b.astype(np.int64))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_data_equal(name):
    """Every SceneData array (materials, lights, atlas included) is equal."""
    (js, jd, jst, _), (ps, pd, pst, _) = _both(SCENES[name])
    for f in ("positions_obj", "prev_positions_obj", "normals_obj", "uvs", "vertex_instance",
              "indices", "tri_resource", "tri_instance", "instance_transform",
              "prev_instance_transform", "env_map", "env_intensity"):
        assert _bits_equal(getattr(jd, f), getattr(pd, f).numpy()), f
    for f in T.Materials._fields:
        assert _bits_equal(getattr(jd.materials, f), getattr(pd.materials, f).numpy()), f
    for f in T.Lights._fields:
        assert _bits_equal(getattr(jd.lights, f), getattr(pd.lights, f).numpy()), f
    for f in ("texels", "rects", "has_map", "mip_rects", "n_levels", "packed", "packed_rects"):
        assert _bits_equal(getattr(jd.atlas, f), getattr(pd.atlas, f).numpy()), f
    for f in ("n_vertices", "n_triangles", "n_instances", "n_resources", "n_lights", "any_map",
              "has_refraction", "has_environment", "has_masks"):
        assert getattr(jst, f) == getattr(pst, f), f


@pytest.mark.parametrize("name", sorted(SCENES))
def test_twolevel_table_bit_equal(name):
    """The packed table (TLAS, BLAS internal and leaf rows, instance rows) and
    the build metadata equal the JAX package's, bit for bit."""
    (_, _, _, jb), (_, _, _, pb) = _both(SCENES[name])
    assert _bits_equal(jb.table, pb.table.numpy())
    assert _bits_equal(jb.node_child, pb.node_child.numpy())
    assert _bits_equal(jb.leaf_tri, pb.leaf_tri.numpy())
    assert _bits_equal(jb.flat_tri_base, pb.flat_tri_base.numpy())
    assert (jb.n_internal, jb.n_leaf, jb.n_instances, jb.tlas_n, jb.tlas_depth, jb.stack_bound) == (
        pb.n_internal, pb.n_leaf, pb.n_instances, pb.tlas_n, pb.tlas_depth, pb.stack_bound)
    assert tuple(jb.mesh_meta) == pb.mesh_meta and tuple(jb.inst_mesh) == pb.inst_mesh


def test_refit_after_move_equals_jax():
    """move_model -> refit rewrites the instance and TLAS rows exactly as the
    JAX refit does (bit-equal)."""
    (js, jd, _, jb), (ps, pd, _, pb) = _both(_config3)
    for s in (js, ps):
        s.move_model(1, forward=0.35, right=-0.2)
        s.move_model(2, forward=-0.5)
    jd = jd._replace(instance_transform=jnp.asarray(js.instance_transforms()))
    jr = jtl.refit(jb, jd.positions_obj, jd.instance_transform)
    port_r = twolevel.refit(pb, pd.positions_obj, torch.as_tensor(ps.instance_transforms()))
    assert not np.array_equal(np.asarray(jr.table), np.asarray(jb.table))
    assert _bits_equal(jr.table, port_r.table.numpy())
    assert _bits_equal(pb.table.numpy(), np.asarray(jb.table))  # input left untouched


def test_refit_rotated_instance_close():
    """A rotated instance goes through a general 3x3 inverse; LAPACK builds
    may round it differently, so its rows are held to 1e-6 relative."""
    (js, jd, _, jb), (ps, pd, _, pb) = _both(_config3)
    for s in (js, ps):
        s.rotate_model(0, 0.7)
    jr = jtl.refit(jb, jd.positions_obj, jnp.asarray(js.instance_transforms()))
    port_r = twolevel.refit(pb, pd.positions_obj, torch.as_tensor(ps.instance_transforms()))
    np.testing.assert_allclose(port_r.table.numpy(), np.asarray(jr.table), rtol=1e-6, atol=1e-6)


def test_world_geometry_matches():
    """World transform of the vertex pool: within 1e-6 relative of the JAX
    einsum (the port writes each dot product's adds out in a fixed order)."""
    (_, jd, _, _), (_, pd, _, _) = _both(_config3)
    for a, b in zip(jworld(jd), world_geometry(pd)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-6)


def test_lbvh_topology_matches():
    """The Karras-LBVH fallback builds the JAX package's wide topology."""
    mesh = jproc.blob(subdivisions=2, radius=0.5, seed=3)
    idx = mesh.submeshes[0].indices
    pos = mesh.positions
    tris = np.concatenate([pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]], axis=1)
    child, leaf, depth = twolevel._mesh_topology(tris, "lbvh")
    cent = (tris[:, 0:3] + tris[:, 3:6] + tris[:, 6:9]) / 3.0
    bl, br, _, order, _ = jlbvh.build_topology(cent)
    jchild, jleaf, jdepth = jwide.build_topology_wide(bl, br, order)
    assert np.array_equal(child, jchild) and np.array_equal(leaf, jleaf) and depth == jdepth


def test_lbvh_table_traces_like_sah():
    """A table built with method='lbvh' finds the same closest hits."""
    js = _sphere_plane()
    ps = convert.scene(js)
    pd, _ = ps.compile("cpu")
    sah = twolevel.build(ps.models, pd, ps.host_mirror)
    lb = twolevel.build(ps.models, pd, ps.host_mirror, method="lbvh")
    g = torch.Generator().manual_seed(0)
    o = torch.rand((512, 3), generator=g) * 4 - 2
    o[:, 1] = o[:, 1].abs() + 0.1
    d = torch.randn((512, 3), generator=g)
    d = d / d.norm(dim=1, keepdim=True)
    rays = T.Rays(o, d, torch.full((512,), float("inf")))
    a, b = twolevel.closest_hit(sah, rays), twolevel.closest_hit(lb, rays)
    assert torch.equal(a.triangle, b.triangle) and torch.equal(a.t, b.t)


def test_constants_and_encoding():
    assert (wide.ARITY, wide.LEAF_K, wide.ROW, wide._ID_BIAS, wide.META_OFF, wide.IDS_OFF) == (
        jwide.ARITY, jwide.LEAF_K, jwide.ROW, jwide._ID_BIAS, jwide.META_OFF, jwide.IDS_OFF)
    ids = np.array([-1, 0, 1, 7, 123456, (1 << 20) - 1], np.int32)
    enc = wide.encode_ids(torch.as_tensor(ids))
    assert _bits_equal(jwide._encode_ids(jnp.asarray(ids)), enc.numpy())
    assert np.array_equal(wide.decode_ids(enc).numpy(), ids)
    kids = {0: [1, 2, 3], 1: [4, 5], 2: [], 3: [6], 4: [], 5: [], 6: []}
    assert wide.exact_stack_bound(kids.get) == jwide.exact_stack_bound(kids.get)


def test_camera_uniforms_and_lights_equal():
    jc = JT.orbit_camera(64, 48, [0.1, 0.2, 0.0], 0.3, 0.25, 4.0, 50.0)
    pc = T.orbit_camera(64, 48, [0.1, 0.2, 0.0], 0.3, 0.25, 4.0, 50.0)
    for a, b in zip(jc, pc):
        assert _bits_equal(a, b.numpy())
    ju = JT.make_frame_uniforms(jc, frame_index=3, accumulation_weight=0.8)
    pu = T.make_frame_uniforms(pc, frame_index=3, accumulation_weight=0.8)
    for f in ju._fields[2:]:
        assert _bits_equal(getattr(ju, f), np.asarray(getattr(pu, f)))
    jl = JT.concat_lights(JT.point_light((1, 2, 3), (0.5, 0.5, 0.5)),
                          JT.sun_light((0, -1, 0), (1, 1, 1)),
                          JT.spot_light((0, 1, 0), (1, -1, 0), 0.4, (2, 2, 2)),
                          JT.area_light((0, 2, 0), (0, -1, 0), (0.2, 0, 0), (0, 0, 0.2), (3, 3, 3)))
    pl = T.concat_lights(T.point_light((1, 2, 3), (0.5, 0.5, 0.5)),
                         T.sun_light((0, -1, 0), (1, 1, 1)),
                         T.spot_light((0, 1, 0), (1, -1, 0), 0.4, (2, 2, 2)),
                         T.area_light((0, 2, 0), (0, -1, 0), (0.2, 0, 0), (0, 0, 0.2), (3, 3, 3)))
    for f in T.Lights._fields:
        assert _bits_equal(getattr(jl, f), getattr(pl, f).numpy()), f


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A failed g++ build raises instead of switching builders silently."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "_SO", tmp_path / "libbad.so")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build_wide_bvh_sah(np.zeros((1, 9), np.float32), wide.ARITY, wide.LEAF_K)


def test_unported_scene_features_raise():
    """SBVH leaf clip boxes are not ported and raise; a scene with geometry
    masks builds (ported), its BVH flagged ``has_masks``."""
    from types import SimpleNamespace

    from mrt_tpu_torch import Model, Scene

    with pytest.raises(NotImplementedError):
        convert.bvh(SimpleNamespace(leaf_clip=np.zeros((1, 6), np.float32)), device="cpu")
    s = Scene(8, 8)
    s.models = [Model("sphere", geometry_mask=T.GEOMETRY_MASK_LIGHT), Model("plane")]
    d, _ = s.compile("cpu")
    b = twolevel.build(s.models, d, s.host_mirror)
    assert b.has_masks and b.inst_masks == (T.GEOMETRY_MASK_LIGHT, T.GEOMETRY_MASK_GEOMETRY)


def test_jax_sah_guard_recovers_failed_loader(tmp_path, monkeypatch):
    """The JAX loader forced into its failed state (a truncated library,
    newer than its source, as a worker finds one another worker is still
    writing): it loads nothing and would build LBVH tables; under the guard
    it has the SAH builder again and the tables are bit-equal."""
    so = tmp_path / "libmrt_native.so"
    so.write_bytes(b"\x7fELF\x02\x01\x01")
    monkeypatch.setattr(jnative, "_SO", so)
    monkeypatch.setattr(jnative, "_tried", False)
    monkeypatch.setattr(jnative, "_lib", None)
    assert not jnative.available()
    (_, _, _, jb), (_, _, _, pb) = _both(_config3)
    assert not jnative.available()  # the guard's resets are undone after the build
    assert _bits_equal(jb.table, pb.table.numpy())
    assert _bits_equal(jb.node_child, pb.node_child.numpy())
