"""SBVH (spatial reference splits, opt-in through ``MRT_SBVH=1``) against
live mrt_tpu: the native builder's clip boxes through the port's loader,
the two-level BVH whose static groups take them (``leaf_clip``, +-inf rows
for the skinned groups), the clamped refit, the flat table built with
``spatial=True``, ``convert.bvh`` of a clipped BVH, and frames of an SBVH
scene.

Tolerances: clip boxes and tables bit-equal (the same native builder, the
same arithmetic); frames as test_torch_render.py holds them (1 % relative
RMSE, rays equal, the image within 1 LSB)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_scenes import config3_renderer
from mrt_tpu.bvh import twolevel as jtl
from mrt_tpu.bvh import wide as jwide
from mrt_tpu.utils import native as jnative
from mrt_tpu_torch import convert
from mrt_tpu_torch.bvh import twolevel, wide
from mrt_tpu_torch.utils import native
from test_torch_flat import _world_tris
from test_torch_render import compare_frames, port_like
from test_torch_scene_bvh import SCENES, _bits_equal, _both, jax_sah, one_torch_thread  # noqa: F401
from test_torch_skinning import _rig


@pytest.fixture
def sbvh(monkeypatch):
    monkeypatch.setenv("MRT_SBVH", "1")


def _config3_with_robot():
    s = SCENES["config3"]()
    s.models = [_rig("jax")] + list(s.models)
    return s


def test_native_clip_boxes_match_jax():
    """The port's loader returns the native builder's topology and clip
    boxes as the JAX loader does; without spatial splits no boxes."""
    tris = np.concatenate(_world_tris(SCENES["blob_glass"]()), axis=1)
    with jax_sah():
        jc, jl, jd, jclip = jnative.build_wide_bvh_sah(tris, spatial=True)
    pc, pl, pd, pclip = native.build_wide_bvh_sah(tris, wide.ARITY, wide.LEAF_K, spatial=True)
    assert np.array_equal(jc, pc) and np.array_equal(jl, pl) and jd == pd
    assert _bits_equal(jclip, pclip) and pclip.shape == (pl.shape[0], 6)
    assert np.isfinite(pclip).all() and (pclip[:, :3] <= pclip[:, 3:]).all()
    assert native.build_wide_bvh_sah(tris, wide.ARITY, wide.LEAF_K)[3] is None


def test_sbvh_twolevel_tables_match_jax(sbvh):
    """Under MRT_SBVH=1 the static groups are built with spatial splits and
    the skinned robot's group is not: leaf clip boxes and the table equal
    the JAX package's, bit for bit; the robot's rows clip nothing."""
    (_, _, _, jb), (_, _, _, pb) = _both(_config3_with_robot)
    assert jb.leaf_clip is not None and pb.leaf_clip is not None
    assert _bits_equal(jb.leaf_clip, pb.leaf_clip.numpy())
    assert _bits_equal(jb.table, pb.table.numpy())
    assert tuple(jb.mesh_meta) == pb.mesh_meta and jb.stack_bound == pb.stack_bound
    _, _, leaf_lo, nl, *_, slot = pb.mesh_meta[0]
    assert slot >= 0
    robot = pb.leaf_clip[leaf_lo:leaf_lo + nl].numpy()
    assert np.isneginf(robot[:, :3]).all() and np.isposinf(robot[:, 3:]).all()
    assert np.isfinite(pb.leaf_clip.numpy()).all(axis=1).sum() == pb.n_leaf - nl


def test_sbvh_off_by_default():
    (_, _, _, jb), (_, _, _, pb) = _both(_config3_with_robot)
    assert jb.leaf_clip is None and pb.leaf_clip is None


def test_clamped_refit_matches_jax(sbvh):
    """A full refit (every group, as at build time) from moved vertices
    clamps each leaf box by its clip box as the JAX refit does; so does the
    per-frame refit of the skinned group after an instance move."""
    (js, jd, jst, jb), (ps, pd, _, pb) = _both(_config3_with_robot)
    rng = np.random.default_rng(5)
    pos = (np.asarray(jd.positions_obj) * np.float32(0.98)
           + rng.normal(0, 0.01, jd.positions_obj.shape)).astype(np.float32)
    groups = []
    for g in range(len(pb.mesh_meta)):
        first = pb.inst_mesh.index(g)
        groups.append(np.concatenate([s.indices.reshape(-1, 3)
                                      for s in js.models[first].mesh.submeshes]).astype(np.int32))
    jr = jtl.refit(jb, jnp.asarray(pos), jd.instance_transform, refit_all=True,
                   skin_group_indices=tuple(jnp.asarray(g) for g in groups))
    pr = twolevel.refit(pb, torch.as_tensor(pos), pd.instance_transform,
                        group_indices=tuple(torch.as_tensor(g) for g in groups))
    assert _bits_equal(jr.table, pr.table.numpy())
    assert _bits_equal(jr.root_bmin, pr.root_bmin.numpy()) and _bits_equal(jr.root_bmax, pr.root_bmax.numpy())
    unclipped = twolevel.refit(pb._replace(leaf_clip=None), torch.as_tensor(pos),
                               pd.instance_transform,
                               group_indices=tuple(torch.as_tensor(g) for g in groups))
    assert not _bits_equal(unclipped.table.numpy(), pr.table.numpy())
    for s in (js, ps):
        s.move_model(1, forward=0.3)
    jr = jtl.refit(jb, jnp.asarray(pos), jnp.asarray(js.instance_transforms()))
    pr = twolevel.refit(pb, torch.as_tensor(pos), torch.as_tensor(ps.instance_transforms()))
    assert _bits_equal(jr.table, pr.table.numpy())


def test_sbvh_flat_table_matches_jax():
    """wide.build(spatial=True): the clip boxes, the table, and a refit from
    moved vertices (clamped) equal the JAX package's."""
    tris = _world_tris(SCENES["config3"]())
    with jax_sah():
        jb = jwide.build(*tris, method="sah", spatial=True)
    pb = wide.build(*tris, method="sah", spatial=True, device="cpu")
    assert _bits_equal(jb.leaf_clip, pb.leaf_clip.numpy())
    assert _bits_equal(jb.table, pb.table.numpy()) and jb.stack_bound == pb.stack_bound
    rng = np.random.default_rng(9)
    moved = tuple((t + rng.normal(0, 0.02, t.shape)).astype(np.float32) for t in tris)
    jr = jwide.refit(jb, *(jnp.asarray(t) for t in moved))
    pr = wide.refit(pb, *(torch.as_tensor(t) for t in moved))
    assert _bits_equal(jr.table, pr.table.numpy())
    plain = wide.refit(pb._replace(leaf_clip=None), *(torch.as_tensor(t) for t in moved))
    assert not _bits_equal(plain.table.numpy(), pr.table.numpy())


def test_convert_carries_leaf_clip(sbvh):
    """convert.bvh keeps a clipped BVH's clip boxes (two-level and flat), so
    the port's refit of the carried BVH clamps as the JAX one does."""
    (js, jd, _, jb), _ = _both(SCENES["blob_glass"])
    pb = convert.bvh(jb, device="cpu")
    assert _bits_equal(jb.leaf_clip, pb.leaf_clip.numpy()) and _bits_equal(jb.table, pb.table.numpy())
    tris = _world_tris(SCENES["blob_glass"]())
    with jax_sah():
        jw = jwide.build(*tris, spatial=True)
    pw = convert.bvh(jw, device="cpu")
    assert isinstance(pw, wide.WideBVH) and _bits_equal(jw.leaf_clip, pw.leaf_clip.numpy())
    moved = tuple((t * np.float32(1.01)).astype(np.float32) for t in tris)
    assert _bits_equal(jwide.refit(jw, *(jnp.asarray(t) for t in moved)).table,
                       wide.refit(pw, *(torch.as_tensor(t) for t in moved)).table.numpy())


def test_sbvh_frames_match_mrt_tpu(sbvh):
    """The config-3 scene (glass, textures, four light types) with both
    renderers built under MRT_SBVH=1: the same clipped tables, and frames
    within the golden tolerances."""
    with jax_sah():
        rj = config3_renderer(size=32, spp=1, bounces=2)
    assert rj.bvh.leaf_clip is not None
    rj.draw()
    rp = port_like(rj)
    assert _bits_equal(rj.bvh.leaf_clip, rp.bvh.leaf_clip.numpy())
    assert _bits_equal(rj.bvh.table, rp.bvh.table.numpy())
    assert all(r > 0 for r in compare_frames(rj, rp, 2))

