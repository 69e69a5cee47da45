"""Skinning and the skinned BVH: mrt_tpu_torch against mrt_tpu on the same
inputs. The NumPy host parts (dense weights, final matrices, the swing
clip's joint matrices, quaternion TRS) are bit-equal; the LBS product is
held within 1e-5 (the two packages sum the (V,J)@(J,12) product in other
orders); the tables of a scene with the robot stand-in are bit-equal, and
so is the refit of its skinned BLAS from JAX's own posed vertices (the
other rows within 1e-6: a rotated instance goes through a 3x3 inverse)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrt_tpu.assets import procedural as jproc
from mrt_tpu.bvh import twolevel as jtl
from mrt_tpu.engine.appscene import _attach_swing_rig as j_attach
from mrt_tpu.engine.scene import Model as JModel
from mrt_tpu.engine.scene import Scene as JScene
from mrt_tpu.engine.scene import SkinData as JSkinData
from mrt_tpu.skinning import animation as janim
from mrt_tpu.skinning import lbs as jlbs
from mrt_tpu.utils import math3d as jmath3d
from mrt_tpu_torch import convert, make_app_scene
from mrt_tpu_torch.assets import procedural
from mrt_tpu_torch.bvh import twolevel
from mrt_tpu_torch.engine.appscene import _attach_swing_rig
from mrt_tpu_torch.engine.scene import Model, SkinData
from mrt_tpu_torch.skinning import animation as anim
from mrt_tpu_torch.skinning import lbs
from mrt_tpu_torch.utils import math3d
from test_skinning import naive_lbs
from test_torch_scene_bvh import _bits_equal, _both, jax_sah, one_torch_thread  # noqa: F401


def _rig(pkg):
    """The robot stand-in of ``pkg`` ("jax" or "port"): mesh + SkinData
    with its chain skeleton and swing clip."""
    proc, skin_cls, attach, model = ((jproc, JSkinData, j_attach, JModel) if pkg == "jax"
                                     else (procedural, SkinData, _attach_swing_rig, Model))
    mesh, ji, jw, rest = proc.skinned_cylinder()
    m = model("robot", mesh=mesh, position=[-0.5, 0.0, 1.0], rotation=[0.0, 0.5, 0.0])
    m.skin = skin_cls(joint_indices=ji, joint_weights=jw, rest_joints=rest)
    attach(m)
    return m


def _robot_scene():
    s = JScene(32, 32)
    s.models = [_rig("jax"), JModel("plane", scale=10), JModel("sphere", position=[1.0, 0.5, 0.0],
                                                               scale=0.5)]
    return s


def test_quaternion_trs_bit_equal():
    rng = np.random.default_rng(3)
    for _ in range(20):
        q = rng.standard_normal(4).astype(np.float32)
        q /= np.linalg.norm(q)
        t, s = rng.standard_normal(3), 0.5 + rng.random(3)
        assert _bits_equal(jmath3d.quat_to_matrix(q), math3d.quat_to_matrix(q))
        assert _bits_equal(jmath3d.trs_quat(t, q, s), math3d.trs_quat(t, q, s))


def test_host_skinning_bit_equal():
    """dense_weights (with zero-weight rows), compose_final_matrices with a
    geometry bind, and the swing clip's joint matrices over 20 time steps
    (Skeleton, AnimationClip.sample, advance_time) are bit-equal."""
    rng = np.random.default_rng(0)
    ji = rng.integers(0, 7, (200, 4)).astype(np.int32)
    jw = rng.random((200, 4)).astype(np.float32)
    jw[:5] = 0.0
    assert _bits_equal(jlbs.dense_weights(ji, jw, 7), lbs.dense_weights(ji, jw, 7))

    jm, pm = _rig("jax"), _rig("port")
    assert jm.skin.skeleton.parent_indices.tolist() == pm.skin.skeleton.parent_indices.tolist()
    gb = jmath3d.trs([0.1, 0.2, 0.3], [0.0, 0.4, 0.0], 1.5)
    tj = tp = 0.0
    for _ in range(20):
        tj = janim.advance_time(tj, 0.13, jm.skin.animation.duration)
        tp = anim.advance_time(tp, 0.13, pm.skin.animation.duration)
        assert tj == tp
        mj = janim.compute_joint_matrices(jm.skin.skeleton, jm.skin.animation, tj)
        mp = anim.compute_joint_matrices(pm.skin.skeleton, pm.skin.animation, tp)
        assert _bits_equal(mj, mp)
        assert _bits_equal(jlbs.compose_final_matrices(mj, gb), lbs.compose_final_matrices(mp, gb))
        assert lbs.compose_final_matrices(mp, None) is mp


def test_lbs_skin_matches_mrt_tpu():
    """Random (V=200, J=7) rig with zero-weight rows (the fallback to the
    vertex's first joint): the port within 1e-5 of the JAX package and of
    the per-vertex loop of tests/test_skinning.py."""
    rng = np.random.default_rng(0)
    V, J = 200, 7
    positions = rng.standard_normal((V, 3)).astype(np.float32)
    normals = rng.standard_normal((V, 3)).astype(np.float32)
    ji = rng.integers(0, J, (V, 4)).astype(np.int32)
    jw = rng.random((V, 4)).astype(np.float32)
    jw[:5] = 0.0
    mats = np.stack([jmath3d.trs(rng.standard_normal(3), rng.standard_normal(3) * 0.3,
                                 1.0 + rng.random()) for _ in range(J)])
    dense = lbs.dense_weights(ji, jw, J)
    jp, jn = jlbs.skin(jnp.asarray(dense), jnp.asarray(mats), jnp.asarray(positions),
                       jnp.asarray(normals))
    pp, pn = lbs.skin(torch.as_tensor(dense), torch.as_tensor(mats), torch.as_tensor(positions),
                      torch.as_tensor(normals))
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), rtol=0, atol=1e-5)
    np.testing.assert_allclose(pn.numpy(), np.asarray(jn), rtol=0, atol=1e-5)
    wp, wn = naive_lbs(positions, normals, ji, jw, mats)
    np.testing.assert_allclose(pp.numpy(), wp, rtol=0, atol=1e-5)
    np.testing.assert_allclose(pn.numpy(), wn, rtol=0, atol=1e-5)


def test_skinned_scene_compile_equal():
    """Scene.compile of a scene with the robot: skin slices and skin bundle
    (dense weights, rest positions and normals) equal the JAX package's."""
    (js, jd, jst, _), (ps, pd, pst, _) = _both(_robot_scene)
    assert pst.skin_slices == tuple(jst.skin_slices) == ((0, 0, 425),)
    assert len(ps.skin_bundle) == len(js.skin_bundle) == 1
    for f in ("weights_dense", "rest_positions", "rest_normals"):
        assert _bits_equal(getattr(js.skin_bundle[0], f), getattr(ps.skin_bundle[0], f).numpy()), f
    assert _bits_equal(jd.positions_obj, pd.positions_obj.numpy())


def test_skinned_build_bit_equal():
    """The skinned robot gets a BLAS of its own: table, mesh_meta (with its
    skin slot) and skin_indices equal the JAX package's."""
    (_, _, _, jb), (_, _, _, pb) = _both(_robot_scene)
    assert _bits_equal(jb.table, pb.table.numpy())
    assert tuple(jb.mesh_meta) == pb.mesh_meta and tuple(jb.inst_mesh) == pb.inst_mesh
    assert [m[8] for m in pb.mesh_meta] == [0, -1, -1]
    assert len(pb.skin_indices) == len(jb.skin_indices) == 1
    assert _bits_equal(jb.skin_indices[0], pb.skin_indices[0].numpy())


def test_skinned_refit_from_jax_pose():
    """refit on JAX's posed vertices: the skinned BLAS rows bit-equal, the
    rest (the rotated robot's instance row, the TLAS) within 1e-6; the
    input table untouched."""
    (js, jd, jst, jb), (ps, pd, pst, pb) = _both(_robot_scene)
    sk = js.models[0].skin
    mats = janim.compute_joint_matrices(sk.skeleton, sk.animation, 0.37)
    sb = js.skin_bundle[0]
    sp, _ = jlbs.skin(sb.weights_dense, jnp.asarray(mats), sb.rest_positions, sb.rest_normals)
    pos = jd.positions_obj.at[0:425].set(sp)
    jr = jtl.refit(jb, pos, jd.instance_transform)
    before = pb.table.clone()
    pr = twolevel.refit(pb, torch.as_tensor(np.array(pos)), pd.instance_transform)
    assert _bits_equal(before.numpy(), pb.table.numpy())
    int_lo, ni, leaf_lo, nl = pb.mesh_meta[0][:4]
    rows = np.r_[int_lo:int_lo + ni, pb.n_internal + leaf_lo:pb.n_internal + leaf_lo + nl]
    jt, pt = np.asarray(jr.table), pr.table.numpy()
    assert not np.array_equal(jt[rows], np.asarray(jb.table)[rows])
    assert _bits_equal(jt[rows], pt[rows])
    np.testing.assert_allclose(pt, jt, rtol=1e-6, atol=1e-6)
    for f in ("root_bmin", "root_bmax"):
        assert _bits_equal(getattr(jr, f), getattr(pr, f).numpy()), f


def test_convert_carries_skinned_state():
    """convert.* of a compiled skinned JAX scene: skin slices, the BVH's
    skinned indices and skin slots, each model's SkinData rebuilt as the
    port's classes, and the skin bundle."""
    js = _robot_scene()
    jd, jst = js.compile()
    with jax_sah():
        jb = jtl.build(js.models, jd, jst.skin_slices, host_mirror=js.host_mirror)
    pd, pst, pb = convert.compiled(jd, jst, jb, device="cpu")
    assert pst.skin_slices == ((0, 0, 425),)
    assert pb.mesh_meta == tuple(jb.mesh_meta) and pb.mesh_meta[0][8] == 0
    assert _bits_equal(jb.skin_indices[0], pb.skin_indices[0].numpy())
    ps = convert.scene(js)
    skin = ps.models[0].skin
    assert isinstance(skin, SkinData) and isinstance(skin.skeleton, anim.Skeleton)
    assert isinstance(skin.animation, anim.AnimationClip)
    assert _bits_equal(anim.compute_joint_matrices(skin.skeleton, skin.animation, 0.5),
                       janim.compute_joint_matrices(js.models[0].skin.skeleton,
                                                    js.models[0].skin.animation, 0.5))
    assert ps.models[1].skin is None
    assert _bits_equal(js.skin_bundle[0].weights_dense, ps.skin_bundle[0].weights_dense.numpy())


def test_app_scene_robot_matches_mrt_tpu():
    """make_app_scene(include_robot=True, asset_models=False): the robot
    comes first, at full scale, with the JAX package's stand-in mesh, skin
    and swing rig; the scene compiles with its skin slice."""
    from mrt_tpu.engine.scene import _resolve_mesh_uncached as j_resolve

    s = make_app_scene(32, 32, include_robot=True, asset_models=False)
    robot = s.models[0]
    assert [m.name for m in s.models] == ["robot", "dragon", "plane", "sphere", "sphere",
                                          "plane-back"]
    assert robot.scale == 1.0 and robot.skin is not None
    jmesh = j_resolve("robot")
    ji, jw, rest = jmesh._skin_stub
    for a, b in ((jmesh.positions, robot.mesh.positions), (jmesh.normals, robot.mesh.normals),
                 (ji, robot.skin.joint_indices), (jw, robot.skin.joint_weights),
                 (rest, robot.skin.rest_joints)):
        assert _bits_equal(a, b)
    _, st = s.compile("cpu")
    assert st.skin_slices == ((0, 0, robot.mesh.positions.shape[0]),)


@pytest.mark.parametrize("what", ["tf32", "precision"])
def test_lbs_refuses_tf32_on_the_card(what, monkeypatch):
    """On a CUDA tensor lbs.skin refuses to run while TF32 is allowed (a
    stand-in tensor reports is_cuda; the check comes before any product)."""

    class FakeCuda:
        is_cuda = True

    if what == "tf32":
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    else:
        monkeypatch.setattr(torch, "get_float32_matmul_precision", lambda: "high")
    with pytest.raises(RuntimeError, match="TF32"):
        lbs.skin(FakeCuda(), None, None, None)
