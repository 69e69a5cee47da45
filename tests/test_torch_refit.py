"""The refit kernels' plain versions (``mrt_tpu_torch/kernels/refit.py``: K4
``blas`` and ``flat``, K5) against live mrt_tpu on the same NumPy inputs made
from a seed, and the walk-up metadata K4 reads.

On the CPU ``twolevel.refit`` and ``wide.refit`` run the plain versions, so
these are the tables and root boxes the kernels are held to on the card
(``chip_smoke.py``). Tolerances: bit-equal everywhere (NaN included, as
JAX gives it), except the 12 inverse columns of a rotated instance's row:
the two packages take the 3x3 inverse from different LAPACK builds, which
may round it differently (1e-6 relative, as test_torch_scene_bvh.py holds
it). The walk-up metadata is held to a brute-force inversion of
``node_child``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrt_tpu.bvh import lbvh as jlbvh
from mrt_tpu.bvh import twolevel as jtl
from mrt_tpu.bvh import wide as jwide
from mrt_tpu.dist import geometry as JG
from mrt_tpu.engine.appscene import _attach_swing_rig as j_attach
from mrt_tpu.engine.scene import Model as JModel
from mrt_tpu.engine.scene import ModelMaterialOverride as JOverride
from mrt_tpu.engine.scene import Scene as JScene
from mrt_tpu.engine.scene import SkinData as JSkinData
from mrt_tpu.skinning import animation as janim
from mrt_tpu.skinning import lbs as jlbs
from mrt_tpu_torch import convert, make_app_scene
from mrt_tpu_torch.bvh import twolevel, wide
from mrt_tpu_torch.dist import geometry as G
from mrt_tpu_torch.kernels import refit
from test_torch_flat import _world_tris
from test_torch_scene_bvh import SCENES, _bits_equal, _both, jax_sah, one_torch_thread  # noqa: F401
from test_torch_sbvh import _config3_with_robot

I_INVERSE = 12  # an instance row's 3x4 inverse: its first 12 floats


def _app():
    """The JAX package's app scene as the port's ``make_app_scene(64, 48,
    include_robot=True, asset_models=False)`` builds it: the JAX
    ``make_app_scene``'s models without the train and treefir OBJs (not in
    the repository), the robot its rigged procedural stand-in."""
    s = JScene(64, 48)
    robot = JModel("robot", position=[-0.5, 0.0, 1.0], rotation=[0, 0, 0], scale=0.01)
    ji, jw, rest = robot.mesh._skin_stub
    robot.scale = 1.0
    robot.skin = JSkinData(joint_indices=ji, joint_weights=jw, rest_joints=rest)
    j_attach(robot)
    s.models = [robot,
                JModel("dragon", position=[0.3, 0.38, 2.5], rotation=[0, np.pi / 2 * 1.2, 0],
                       scale=1.2, material_override=JOverride.glass()),
                JModel("plane", position=[0, 0, 0], scale=10),
                JModel("sphere", position=[-1.9, 0.0, 0.3], scale=1),
                JModel("sphere", position=[2.9, 0.0, -0.5], scale=2),
                JModel("plane-back", position=[0, 0, -1.5], scale=10)]
    return s


@pytest.fixture(scope="module")
def app():
    (js, jd, jst, jb), (ps, pd, _, pb) = _both(_app)
    mine = make_app_scene(64, 48, include_robot=True, asset_models=False)
    for a, b in zip(ps.models, mine.models, strict=True):
        assert a.name == b.name and a.scale == b.scale
        assert _bits_equal(a.mesh.positions, b.mesh.positions)
    assert _bits_equal(ps.instance_transforms(), mine.instance_transforms())
    return dict(js=js, jd=jd, jst=jst, jb=jb, pb=pb)


def _group_indices(models, bvh):
    """One (Tm,3) local index array per mesh group (its first instance's
    mesh), as a build refits them."""
    out = []
    for g in range(len(bvh.mesh_meta)):
        m = models[list(bvh.inst_mesh).index(g)]
        out.append(np.concatenate([s.indices.reshape(-1, 3) for s in m.mesh.submeshes]).astype(np.int32))
    return out


def _pose(app, rng):
    """The app scene's vertex pool with the robot posed by its swing clip at
    a seeded time (JAX's LBS), and its instance transforms after a seeded
    move and turn of the dragon."""
    js, jd, jst = app["js"], app["jd"], app["jst"]
    sk = js.models[0].skin
    mats = janim.compute_joint_matrices(sk.skeleton, sk.animation,
                                        float(rng.uniform(0.0, sk.animation.duration)))
    sb = js.skin_bundle[0]
    sp, _ = jlbs.skin(sb.weights_dense, jnp.asarray(mats), sb.rest_positions, sb.rest_normals)
    _, start, count = jst.skin_slices[0]
    pos = np.array(jd.positions_obj)
    pos[start:start + count] = np.asarray(sp)
    M = np.array(js.instance_transforms())
    turn = np.eye(4, dtype=np.float32)
    a = np.float32(rng.uniform(0.2, 1.2))
    turn[0, 0], turn[0, 2], turn[2, 0], turn[2, 2] = np.cos(a), np.sin(a), -np.sin(a), np.cos(a)
    M[1] = (M[1] @ turn).astype(np.float32)
    M[1, :3, 3] += rng.normal(0.0, 0.2, 3).astype(np.float32)
    return pos, M, start, count


def _small_lbvh(orig):
    """JAX's per-mesh topology with meshes of at most LEAF_K triangles built
    as one leaf and no internal row (the Karras path), others unchanged."""
    def topo(tris, spatial=False):
        if tris.shape[0] <= jwide.LEAF_K:
            c = (tris[:, 0:3] + tris[:, 3:6] + tris[:, 6:9]) / 3.0
            bl, br, _, order, _ = jlbvh.build_topology(c)
            return (*jwide.build_topology_wide(bl, br, order), None)
        return orig(tris, spatial=spatial)
    return topo


def _leaf_root_case(monkeypatch, rng):
    """A sphere over a plane whose 2-triangle mesh is one leaf and no
    internal row (ni == 0: its root box is its leaf's box); the port's BVH
    carried over by ``convert.bvh``. Every group refit from noisy vertices
    after a seeded move."""
    js = JScene(32, 32)
    js.models = [JModel("sphere", position=[0, 0.5, 0], scale=0.5), JModel("plane", scale=10)]
    jd, jst = js.compile()
    monkeypatch.setattr(jtl, "_mesh_topology", _small_lbvh(jtl._mesh_topology))
    with jax_sah():
        jb = jtl.build(js.models, jd, jst.skin_slices, host_mirror=js.host_mirror)
    pb = convert.bvh(jb, device="cpu")
    assert [m[1] for m in pb.mesh_meta].count(0) == 1
    js.move_model(0, forward=float(rng.uniform(-0.5, 0.5)))
    pos = (np.asarray(jd.positions_obj) + rng.normal(0, 0.01, jd.positions_obj.shape)).astype(np.float32)
    return jb, pb, pos, np.array(js.instance_transforms()), _group_indices(js.models, pb)


def _sbvh_case(monkeypatch, rng):
    """Config 3 with the robot under MRT_SBVH=1 (clip boxes on the static
    groups, +-inf rows on the robot's): every group refit from scaled,
    noisy vertices, as at build time."""
    monkeypatch.setenv("MRT_SBVH", "1")
    (js, jd, _, jb), (_, _, _, pb) = _both(_config3_with_robot)
    assert pb.leaf_clip is not None
    pos = (np.asarray(jd.positions_obj) * np.float32(0.98)
           + rng.normal(0, 0.01, jd.positions_obj.shape)).astype(np.float32)
    return jb, pb, pos, np.array(js.instance_transforms()), _group_indices(js.models, pb)


TWOLEVEL_CASES = ("pose", "nan", "all_groups", "leaf_root", "sbvh")


@pytest.mark.parametrize("case", TWOLEVEL_CASES)
def test_twolevel_refit_matches_jax(case, app, monkeypatch):
    """K4 ``blas`` and K5's plain versions (``twolevel.refit`` on the CPU)
    against ``mrt_tpu.bvh.twolevel.refit``: the table and the root boxes.
    ``pose``: the robot's BLAS after a seeded pose, a turned and moved
    dragon; ``nan``: the same with a NaN in a real slot of the robot (the
    box and every row above it NaN as JAX gives it); ``all_groups``: every
    group refit (``group_indices``, JAX's ``refit_all``) from noisy
    vertices; ``leaf_root``: a group with no internal row; ``sbvh``: the
    clip clamp."""
    rng = np.random.default_rng(TWOLEVEL_CASES.index(case) + 21)
    groups = None
    if case in ("pose", "nan", "all_groups"):
        jb, pb = app["jb"], app["pb"]
        pos, M, start, count = _pose(app, rng)
        if case == "nan":
            pos[start + int(rng.integers(count)), int(rng.integers(3))] = np.nan
        if case == "all_groups":
            pos = (pos + rng.normal(0, 0.01, pos.shape)).astype(np.float32)
            groups = _group_indices(app["js"].models, pb)
    elif case == "leaf_root":
        jb, pb, pos, M, groups = _leaf_root_case(monkeypatch, rng)
    else:
        jb, pb, pos, M, groups = _sbvh_case(monkeypatch, rng)
    before = pb.table.clone()
    jr = jtl.refit(jb, jnp.asarray(pos), jnp.asarray(M), refit_all=groups is not None,
                   skin_group_indices=None if groups is None else tuple(jnp.asarray(g) for g in groups))
    pr = twolevel.refit(pb, torch.as_tensor(pos), torch.as_tensor(M),
                        group_indices=None if groups is None else tuple(torch.as_tensor(g)
                                                                        for g in groups))
    assert _bits_equal(before.numpy(), pb.table.numpy())  # the input's table untouched
    jt, pt = np.asarray(jr.table), pr.table.numpy()
    assert not _bits_equal(jt, before.numpy())
    inv = np.zeros(jt.shape, bool)
    inv[pb.n_internal + pb.n_leaf:, :I_INVERSE] = True
    assert np.array_equal(jt[~inv].view(np.int32), pt[~inv].view(np.int32))
    np.testing.assert_allclose(pt[inv], jt[inv], rtol=1e-6, atol=1e-6)
    for f in ("root_bmin", "root_bmax"):
        assert _bits_equal(getattr(jr, f), getattr(pr, f).numpy()), f
    if case == "nan":  # the NaN reached the robot's root box and the TLAS root
        assert np.isnan(pr.root_bmin[0].numpy()).any() and np.isnan(pt[0, :48]).any()
    if case == "leaf_root":  # the root box is its one leaf's: the vertices' min - 1e-7 in x
        g = [m[1] for m in pb.mesh_meta].index(0)
        leaf = pb.n_internal + pb.mesh_meta[g][2]
        xs = pt[leaf, :108].reshape(9, 12)[[0, 3, 6]]  # the x planes of v0, v1, v2
        assert np.float32(np.nanmin(xs) - np.float32(1e-7)) == pr.root_bmin[g, 0].numpy()


def _flat_case(case, rng):
    """(JAX WideBVH, the port's, the triangles it refits from, row_ids or
    None) per shard of the case."""
    if case == "padded_shard":
        base = (rng.random((600, 3)) * 2 - 1) * 3
        tris = tuple((base + rng.random((600, 3)) * 0.1).astype(np.float32) for _ in range(3))
        with jax_sah():
            jstack, _, jrowg, _ = JG.build_sharded_bvhs(*tris, 3)
        shards, _ = G.build_sharded_bvhs(*tris, 3, device="cpu")
        out = []
        for k, (pb, gids, rowg) in enumerate(shards):
            jb = jax.tree.map(lambda x, k=k: x[k], jstack)
            tid = np.maximum(gids.numpy(), 0)
            moved = tuple((t[tid] + rng.normal(0, 0.02, t[tid].shape)).astype(np.float32) for t in tris)
            out.append((jb, pb, moved, np.asarray(jrowg[k])))
        assert sum(int(pb.walkup.unreached.numel()) for _, pb, _, _ in out) > 0
        return out
    tris = _world_tris(SCENES["config3"]())
    spatial = case == "sbvh"
    with jax_sah():
        jb = jwide.build(*tris, method="sah", spatial=spatial)
    pb = wide.build(*tris, method="sah", spatial=spatial, device="cpu")
    moved = tuple((t + rng.normal(0, 0.03, t.shape)).astype(np.float32) for t in tris)
    ids = np.asarray(jb.leaf_tri) * 3 + 1 if case == "row_ids" else None
    return [(jb, pb, moved, ids)]


FLAT_CASES = ("flat", "row_ids", "sbvh", "padded_shard")


@pytest.mark.parametrize("case", FLAT_CASES)
def test_flat_refit_matches_jax(case):
    """K4 ``flat``'s plain version (``wide.refit`` on the CPU) against
    ``mrt_tpu.bvh.wide.refit`` from seeded moved triangles, bit for bit:
    the leaf rows' own ids, other ``row_ids``, SBVH clip boxes, and every
    shard of a 3-way gp split padded to shared shapes (internal rows no
    leaf reaches, leaves without a triangle)."""
    rng = np.random.default_rng(FLAT_CASES.index(case) + 31)
    for jb, pb, moved, ids in _flat_case(case, rng):
        jr = jwide.refit(jb, *(jnp.asarray(t) for t in moved),
                         row_ids=None if ids is None else jnp.asarray(ids))
        pr = wide.refit(pb, *(torch.as_tensor(t) for t in moved),
                        row_ids=None if ids is None else torch.as_tensor(ids))
        assert _bits_equal(jr.table, pr.table.numpy())
        assert _bits_equal(pr.table.numpy(), refit.flat_plain(
            pb, *(torch.as_tensor(t) for t in moved), None if ids is None else torch.as_tensor(ids)).numpy())


def _brute(child, n_leaf, roots=()):
    """Parent of every entry and the children a leaf reaches per internal
    row, by walking ``node_child`` row by row and recursing."""
    ni = child.shape[0]
    n = ni + n_leaf
    parent = np.full(n, -1, np.int64)
    for r in range(ni):
        for c in child[r]:
            if 0 <= c < n:
                assert parent[c] == -1
                parent[c] = r
    for g, e in enumerate(roots):
        parent[e] = -(g + 2)
    memo = {}

    def reached(e):
        if e >= ni:
            return True
        if e not in memo:
            memo[e] = any(reached(int(c)) for c in child[e] if 0 <= c < n)
        return memo[e]

    need = np.array([sum(reached(int(c)) for c in child[r] if 0 <= c < n) for r in range(ni)])
    return parent, need


WALKUP_CASES = ("blas", "tlas", "flat", "padded_shard", "leaf_root")


@pytest.mark.parametrize("case", WALKUP_CASES)
def test_walkup_metadata(case, app, monkeypatch):
    """Every entry's parent equals a brute-force inversion of ``node_child``
    (a two-level group's root marked -(g + 2)), every internal row waits for
    the children a leaf reaches, and the rows no leaf reaches are flagged
    (need 0) and listed (outside the TLAS): for each BLAS and the TLAS of
    the app scene, a flat table, every shard of a padded gp split and a
    group with no internal row."""
    rng = np.random.default_rng(41)
    if case in ("blas", "tlas", "leaf_root"):
        pb = app["pb"] if case != "leaf_root" else _leaf_root_case(monkeypatch, rng)[1]
        meta, child = pb.refit_meta, pb.node_child.numpy()
        parent, need = _brute(child, pb.n_leaf, [m[5] for m in pb.mesh_meta])
        rows = slice(0, pb.tlas_n) if case == "tlas" else slice(pb.tlas_n, pb.n_internal + pb.n_leaf)
        assert np.array_equal(meta.walkup.parent.numpy()[rows], parent[rows])
        blas = np.arange(pb.tlas_n, pb.n_internal)
        assert np.array_equal(meta.walkup.need.numpy()[blas], need[blas])
        assert np.array_equal(meta.walkup.unreached.numpy(), blas[need[blas] == 0])
        for g, (int_lo, ni, leaf_lo, nl, *_r, root, vs, _vc, slot) in enumerate(pb.mesh_meta):
            assert parent[root] == -(g + 2) and meta.group_root[g] == root
            assert meta.group_vstart[g] == vs and bool(meta.group_skinned[g]) == (slot >= 0)
            assert (meta.leaf_group.numpy()[leaf_lo:leaf_lo + nl] == g).all()
            assert (ni == 0) == (root >= pb.n_internal)
        skinned = [np.arange(m[2], m[2] + m[3]) for m in pb.mesh_meta if m[8] >= 0]
        assert np.array_equal(meta.skin_leaves.numpy(),
                              np.concatenate(skinned) if skinned else np.zeros(0))
        if case == "tlas":
            assert parent[0] == -1
        return
    if case == "flat":
        tris = _world_tris(SCENES["config3"]())
        tables = [wide.build(*tris, device="cpu")]
    else:
        tables = [pb for _, pb, _, _ in _flat_case("padded_shard", rng)]
    for pb in tables:
        child, n_leaf = pb.node_child.numpy(), pb.leaf_tri.shape[0]
        parent, need = _brute(child, n_leaf)
        wu = pb.walkup
        assert np.array_equal(wu.parent.numpy(), parent) and np.array_equal(wu.need.numpy(), need)
        assert np.array_equal(wu.unreached.numpy(), np.nonzero(need == 0)[0])
        padded = np.nonzero((child < 0).all(axis=1))[0]
        assert np.isin(padded, wu.unreached.numpy()).all()
    if case == "padded_shard":
        assert sum(int(pb.walkup.unreached.numel()) for pb in tables) > 0


@pytest.mark.parametrize("which", ["flat", "twolevel"])
def test_wrappers_refuse_other_devices(which, app):
    """A wrapper runs the plain version only for CPU tensors: on any other
    device it launches its kernel or raises, never falling back (here the
    ``meta`` device, which no kernel takes)."""
    v = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        if which == "flat":
            wide.refit(wide.build(*_world_tris(SCENES["sphere_plane"]()), device="cpu"), v, v, v)
        else:
            twolevel.refit(app["pb"], v, torch.empty((app["pb"].n_instances, 4, 4), device="meta"))
