"""Geometry sharding (gp) — the port's ``dist/geometry.py``, the banded
atlas (``assets/texture.py``), ``render/wavefront.combine_hits_across`` and
``convert.sharded_bvhs`` — against the port's single device and mrt_tpu's
gp step and ``GeometryShardedRenderer``.

One gloo world of 4 ranks on the CPU, spawned once for the module
(``world``), runs the rank-side cases; the JAX side runs in this process on
the virtual 8-device CPU mesh, as ``tests/test_dist.py`` runs it
(``jax_side``). Scenes: ``test_dist.py``'s 32x32 sphere and plane and its
textured twin (1 spp, 2 bounces). Bars: the shard tables, the combined
hits and the banded samples equal to JAX's (tables bit for bit); each
sharded frame within 1e-5 of the port's single device (the JAX tests'
bar) and within the port's parity bar (1 % relative RMSE) of JAX's step or
renderer on the same inputs, every gp rank counting the same rays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from mrt_tpu.assets import procedural as jproc
from mrt_tpu.assets import texture as jtex
from mrt_tpu.assets.obj import MaterialDef as JMaterialDef
from mrt_tpu.bvh import wide as jwide
from mrt_tpu.core import types as JT
from mrt_tpu.dist import geometry as JG
from mrt_tpu.engine.scene import Model as JModel
from mrt_tpu.engine.scene import Scene as JScene
from mrt_tpu.render import wavefront as jwf
from mrt_tpu_torch import UPSCALER_OFF, Renderer, convert
from mrt_tpu_torch.assets import texture as tex
from mrt_tpu_torch.bvh import wide
from mrt_tpu_torch.core import halton as H
from mrt_tpu_torch.core import types as T
from mrt_tpu_torch.dist import comm
from mrt_tpu_torch.dist import geometry as G
from mrt_tpu_torch.dist import launch as L
from mrt_tpu_torch.render import wavefront as wf
from test_torch_render import rel_rmse
from test_torch_scene_bvh import _bits_equal, jax_sah, one_torch_thread  # noqa: F401

SIZE = 32
WORLD = 4
CPU = {"device": "cpu"}
LANES = 96


def _models(M, proc=None, Mat=None, nmap=False):
    if proc is None:
        return [M("sphere", position=[0.0, 0.5, 0.0], scale=0.5),
                M("plane", position=[0, 0, 0], scale=10)]
    rng = np.random.default_rng(3)
    img_a = rng.random((16, 16, 3)).astype(np.float32)
    img_b = (np.indices((24, 24)).sum(0) % 2).astype(np.float32)  # checker
    # a tangent-space normal map on the plane (the lane-row form's motion rows)
    nrm = (rng.random((16, 16, 3)) * 0.5 + 0.25).astype(np.float32)
    extra = {"map_normal": nrm} if nmap else {}
    return [M("tex_sphere", position=[0.0, 0.5, 0.0], scale=0.5,
              mesh=proc.uv_sphere(material=Mat(name="a", map_base_color=img_a))),
            M("tex_plane", position=[0, 0, 0], scale=10,
              mesh=proc.plane(material=Mat(name="b", map_base_color=img_b, map_roughness=img_b,
                                           **extra)))]


def _jscene(textured=False, nmap=False):
    s = JScene(width=SIZE, height=SIZE)
    s.models = (_models(JModel, jproc, JMaterialDef, nmap=nmap) if textured or nmap
                else _models(JModel))
    return s


def _scene(textured=False, nmap=False):
    return convert.scene(_jscene(textured, nmap))


def _settings(types):
    return types.RenderSettings(width=SIZE, height=SIZE, samples_per_pixel=1, max_bounces=2,
                                enable_motion_adaptive_sampling=False,
                                tile_pixels=SIZE * SIZE // 4)


OFFSETS = H.make_pixel_offsets(torch.Generator().manual_seed(0), SIZE, SIZE).numpy()


def _single(offsets, textured=False, frames=1, two_level=True, nmap=False):
    r = Renderer(_scene(textured, nmap), SIZE, SIZE, device="cpu", offsets=offsets)
    r.upscaler_mode = UPSCALER_OFF
    r.samples_per_pixel = 1
    r.max_bounces = 2
    r.use_motion_adaptive_sampling = False
    r.two_level = two_level
    r._allocate_state()
    out = [r.draw().numpy().copy() for _ in range(frames)]
    return out, int(r.last_rays_traced)


def _world_tris(data):
    """World-space triangles of a compiled JAX scene, as test_dist.py makes
    them."""
    idx = np.asarray(data.indices)
    pos = np.asarray(data.positions_obj)
    tfm = np.asarray(data.instance_transform)[np.asarray(data.vertex_instance)]
    pw = np.einsum("vij,vj->vi", tfm[:, :3, :3], pos) + tfm[:, :3, 3]
    return pw[idx[:, 0]], pw[idx[:, 1]], pw[idx[:, 2]]


def _random_tris(n=1000, seed=9):
    rng = np.random.default_rng(seed)
    base = (rng.random((n, 3)) * 2 - 1) * 3
    return tuple((base + rng.random((n, 3)) * 0.1).astype(np.float32) for _ in range(3))


def _rank_hits(seed=11):
    """Per-rank closest hits over the same lanes: t from a small set (ties
    across ranks), misses (t inf, triangle -1), a block of lanes every
    rank missed."""
    rng = np.random.default_rng(seed)
    t = rng.choice(np.float32([1.0, 2.0, 2.5, np.inf]), (WORLD, LANES)).astype(np.float32)
    t[:, :8] = np.inf
    tri = np.where(np.isinf(t), -1, rng.integers(0, 500, (WORLD, LANES))).astype(np.int32)
    u = rng.random((WORLD, LANES)).astype(np.float32)
    v = rng.random((WORLD, LANES)).astype(np.float32)
    return t, tri, u, v


def _band_inputs(atlas, seed=12):
    rng = np.random.default_rng(seed)
    n_res = atlas.packed_rects.shape[0]
    res = rng.integers(0, n_res, LANES).astype(np.int32)
    uv = (rng.random((LANES, 2)) * 3 - 1).astype(np.float32)
    return res, uv


def _jax_gp_step(textured, mesh_shape, banded, offsets, nmap=False):
    """mrt_tpu's gp step on ``_jscene(textured, nmap)`` over a mesh of the
    first virtual devices: (accum, rays)."""
    js = _jscene(textured, nmap)
    data, statics = js.compile()
    names = tuple(mesh_shape)
    n = int(np.prod(list(mesh_shape.values())))
    mesh = JMesh(np.asarray(jax.devices()[:n]).reshape(tuple(mesh_shape.values())), names)
    with jax_sah():
        bvhs, gids, row_gids, _ = JG.build_sharded_bvhs(*_world_tris(data), mesh_shape["gp"])
    step = JG.build_gp_render_step(_settings(JT), statics, mesh, banded=banded)
    cam = JT.orbit_camera(SIZE, SIZE, js.camera_target, js.camera_azimuth, js.camera_elevation,
                          js.camera_distance, js.camera_fov_degrees)
    kw = dict(atlas_bands=jtex.band_atlas(data.atlas, mesh_shape["gp"])) if banded else {}
    accum, _, _, rays = step(data, bvhs, JT.make_frame_uniforms(camera=cam, frame_index=0),
                             jnp.asarray(offsets), jnp.zeros((SIZE, SIZE, 3), jnp.float32),
                             jnp.zeros((SIZE, SIZE, 2), jnp.float32), gids=gids,
                             row_gids=row_gids, **kw)
    return np.asarray(accum), int(float(rays))


@pytest.fixture(scope="module")
def jax_side():
    """mrt_tpu's gp cases: combine_hits_across and sample_packed_banded on
    per-device inputs, the gp step at gp=4, banded gp=4 (textured) and
    (dp, gp) = (2, 2) banded, and GeometryShardedRenderer over two frames."""
    out = {}
    mesh = JMesh(np.asarray(jax.devices()[:WORLD]), ("gp",))
    t, tri, u, v = _rank_hits()

    def comb(t, tri, u, v):
        h = jwf.combine_hits_across(JT.Hits(t=t, triangle=tri, u=u, v=v), "gp")
        return h.t, h.triangle, h.u, h.v

    f = jax.jit(jax.shard_map(comb, mesh=mesh, in_specs=(P("gp"),) * 4, out_specs=(P("gp"),) * 4,
                              check_vma=False))
    out["hits"] = [np.asarray(x).reshape(WORLD, LANES)
                   for x in f(*(jnp.asarray(a.reshape(-1)) for a in (t, tri, u, v)))]

    data, _ = _jscene(textured=True).compile()
    bands = jtex.band_atlas(data.atlas, WORLD)
    res, uv = _band_inputs(data.atlas)

    def band(b, res, uv):
        atlas = data.atlas._replace(packed=b[0], band_lo=jax.lax.axis_index("gp") * b.shape[1])
        return jtex.sample_packed_banded(atlas, res, uv, "gp")

    g = jax.jit(jax.shard_map(band, mesh=mesh, in_specs=(P("gp"), P(), P()), out_specs=P("gp"),
                              check_vma=False))
    out["banded"] = np.asarray(g(bands, jnp.asarray(res), jnp.asarray(uv))).reshape(
        WORLD, LANES, -1)
    out["bands_shape"] = tuple(bands.shape)
    out["gp4"] = _jax_gp_step(False, {"gp": 4}, False, OFFSETS)
    out["gp4_banded"] = _jax_gp_step(True, {"gp": 4}, True, OFFSETS)
    out["gp4_nmap"] = _jax_gp_step(True, {"gp": 4}, True, OFFSETS, nmap=True)
    out["gp1_nmap"] = _jax_gp_step(True, {"gp": 1}, False, OFFSETS, nmap=True)  # unsharded
    out["dp_gp"] = _jax_gp_step(False, {"dp": 2, "gp": 2}, True, OFFSETS)
    with jax_sah():
        jgr = JG.GeometryShardedRenderer(_jscene(), _settings(JT), mesh=mesh)
    out["gsr_offsets"] = np.asarray(jax.device_get(jgr.offsets))
    out["gsr"] = [np.asarray(jgr.draw()) for _ in range(2)]
    out["gsr_rays"] = int(float(jgr.last_rays_traced))
    return out


@pytest.fixture(scope="module")
def world(jax_side):
    """The rank-side cases in one 4-rank gloo world; results by rank."""
    t, tri, u, v = _rank_hits()
    hits = [(T.Hits(*(torch.as_tensor(a[r]) for a in (t, tri, u, v))),) for r in range(WORLD)]
    data, _ = _scene(textured=True).compile("cpu")
    res, uv = _band_inputs(data.atlas)
    band_args = [(tex.atlas_band(data.atlas, WORLD, r), torch.as_tensor(res), torch.as_tensor(uv))
                 for r in range(WORLD)]
    tris = _random_tris()
    calls = [("gp", wf.combine_hits_across, hits),
             ("gp", wf.sample_packed_across, band_args),
             ("gp", G.build_rank_shard, [tris + ("cpu",)] * WORLD),
             # psums in place of a size each rank shares, and of sizes that differ
             ("gp", L.caught, [(comm.psum_, torch.ones(5))] * WORLD),
             ("gp", L.caught, [(comm.psum_, torch.ones(10 + r)) for r in range(WORLD)])]
    jobs = [
        (L.on_mesh, ({"gp": 4}, calls), CPU),
        (L.drive, ("gp", _scene(), _settings(T), {"gp": 4}, 1), dict(offsets=OFFSETS, banded=False,
                                                                    check_flat=True,
                                                                    check_route=True,
                                                                    record_rows=True, **CPU)),
        (L.drive, ("gp", _scene(True), _settings(T), {"gp": 4}, 1), dict(offsets=OFFSETS,
                                                                        banded=True, **CPU)),
        (L.drive, ("gp", _scene(), _settings(T), {"dp": 2, "gp": 2}, 1), dict(offsets=OFFSETS,
                                                                             banded=True, **CPU)),
        (L.drive, ("gp", _scene(), _settings(T), {"gp": 4}, 2),
         dict(offsets=jax_side["gsr_offsets"], **CPU)),
        (L.drive, ("gp", _scene(nmap=True), _settings(T), {"gp": 4}, 1),
         dict(offsets=OFFSETS, banded=True, check_route=True, record_rows=True, **CPU)),
    ]
    res = L.launch(L.run_jobs, WORLD, jobs, **CPU)
    names = ("calls", "gp4", "gp4_banded", "dp_gp", "gsr", "gp4_nmap")
    return {n: [r[k] for r in res] for k, n in enumerate(names)}


def _check_tables(v0, v1, v2, n):
    """The port's build_sharded_bvhs against the JAX package's on the same
    triangles: shard ids, topology, gids, row_gids, n_internal, depth, and
    each shard's refit table bit for bit; convert.sharded_bvhs carries
    JAX's shards over equal; the padded tables' exact stack bound is the
    unpadded one and within the stack that the shared depth gives."""
    with jax_sah():
        jstack, jgids, jrowg, jshards = JG.build_sharded_bvhs(v0, v1, v2, n)
    shards, ids = G.build_sharded_bvhs(v0, v1, v2, n, device="cpu")
    assert len(ids) == len(jshards) == n
    for a, b in zip(ids, jshards):
        np.testing.assert_array_equal(a, b)
    carried = convert.sharded_bvhs(jstack, jgids, jrowg, device="cpu")
    for k, ((bvh, gids, rowg), (cb, cg, cr)) in enumerate(zip(shards, carried)):
        jb = jax.tree.map(lambda x, k=k: x[k], jstack)
        assert bvh.n_internal == jb.n_internal == cb.n_internal
        assert bvh.depth == jb.depth == cb.depth and bvh.stack_bound is None
        for mine, theirs, conv in ((bvh.node_child, jb.node_child, cb.node_child),
                                   (bvh.leaf_tri, jb.leaf_tri, cb.leaf_tri),
                                   (gids, jgids[k], cg), (rowg, jrowg[k], cr)):
            assert _bits_equal(theirs, mine.numpy()) and _bits_equal(theirs, conv.numpy())
        tid = np.maximum(gids.numpy(), 0)
        lv = [v[tid] for v in (v0, v1, v2)]
        mine = wide.refit(bvh, *(torch.as_tensor(x) for x in lv), row_ids=rowg).table
        theirs = jwide.refit(jb, *(jnp.asarray(x) for x in lv), row_ids=jnp.asarray(jrowg[k])).table
        assert _bits_equal(theirs, mine.numpy()), k
        # padded rows are never reached: the exact bound is the unpadded one
        child = bvh.node_child.numpy()
        ni = bvh.n_internal
        real = child[: ni - int((child < 0).all(axis=1).sum())]
        bound = wide.exact_stack_bound(lambda m, c=child: [int(x) for x in c[m] if 0 <= x < ni])
        assert bound <= bvh.stack_size
        assert bound == wide.exact_stack_bound(
            lambda m, c=real: [int(x) for x in c[m] if 0 <= x < len(c)] if m < len(c) else [])
    return shards, ids


def test_shard_tables_match_mrt_tpu():
    """On 1,000 random triangles (test_dist.py's invariants case) over 4
    shards, and on the sphere and plane over 4: tables equal to JAX's (see
    ``_check_tables``); the shards partition the triangles; leaf ids are
    shard-local and row_gids = gids[leaf ids]."""
    v = _random_tris()
    shards, ids = _check_tables(*v, 4)
    assert sorted(np.concatenate(ids).tolist()) == list(range(1000))
    for (bvh, gids, rowg), tri_ids in zip(shards, ids):
        leaf = bvh.leaf_tri.numpy()
        assert leaf[leaf >= 0].max() < len(tri_ids)
        np.testing.assert_array_equal(rowg.numpy()[leaf >= 0], gids.numpy()[leaf[leaf >= 0]])
    data, _ = _jscene().compile()
    _check_tables(*_world_tris(data), 4)


def test_rank_shard_build_matches(world):
    """Each rank builds only its own shard (the shapes from a max over gp):
    equal to build_sharded_bvhs's shard of that rank."""
    shards, _ = G.build_sharded_bvhs(*_random_tris(), WORLD, device="cpu")
    for r, out in enumerate(world["calls"]):
        bvh, gids, rowg = out["results"][2]
        want, wgids, wrowg = shards[r]
        assert bvh.n_internal == want.n_internal and bvh.depth == want.depth
        for a, b in ((bvh.node_child, want.node_child), (bvh.leaf_tri, want.leaf_tri),
                     (gids, wgids), (rowg, wrowg)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_combine_hits_across_matches_mrt_tpu(world, jax_side):
    """combine_hits_across on the same per-rank hits (ties between ranks go
    to the lowest, lanes every rank missed give -1): every rank's result
    equals JAX's."""
    for r, out in enumerate(world["calls"]):
        h = out["results"][0]
        for mine, theirs in zip((h.t, h.triangle, h.u, h.v), jax_side["hits"]):
            np.testing.assert_array_equal(mine, theirs[r])
    h = world["calls"][0]["results"][0]
    assert (h.triangle[:8] == -1).all() and np.isinf(h.t[:8]).all()


def test_sample_packed_banded_matches_mrt_tpu(world, jax_side):
    """sample_packed_banded over 4 bands, each rank's share summed over gp
    (wavefront.sample_packed_across): every rank's sample equals JAX's
    (within 1e-6) and the whole atlas's sample_packed bit for bit (a band
    holds whole rows, so each row term is computed whole on its owner);
    band_atlas's shape equals JAX's."""
    data, _ = _scene(textured=True).compile("cpu")
    res, uv = _band_inputs(data.atlas)
    whole = tex.sample_packed(data.atlas, torch.as_tensor(res), torch.as_tensor(uv)).numpy()
    assert tuple(tex.band_atlas(data.atlas, WORLD).shape) == jax_side["bands_shape"]
    for r, out in enumerate(world["calls"]):
        np.testing.assert_allclose(out["results"][1], jax_side["banded"][r], atol=1e-6)
        np.testing.assert_array_equal(out["results"][1], whole)


@pytest.mark.parametrize("job", ["gp4", "gp4_nmap"])
def test_gp_rows_psums_carry_the_live_lanes(world, job):
    """gp=4, untextured with the whole atlas ("gp4") and with a normal map
    on the banded atlas ("gp4_nmap"): every gp step of the drawn frame
    (``drive(record_rows=True)``) was given its live lanes' count, and its
    psums carried n_live rows (n_live x 16 shade floats, x 34 with the
    normal map's motion rows, with the hit combine's 3 payload words a row
    in the same psum, then n_live x 16 taps on the banded atlas), not one a
    lane; the first step has every lane live, later ones fewer; every rank
    recorded the same sizes."""
    recs = [x["rows_psums"] for x in world[job]]
    assert all(r == recs[0] for r in recs[1:])
    steps = recs[0]
    assert len(steps) > 1 and steps[0]["live"] == steps[0]["lanes"] == SIZE * SIZE
    for st in steps:
        assert st["n_live"] == st["live"] > 0
        assert st["cols"] == (34 if job == "gp4_nmap" else 16) and st["taps"] == (job == "gp4_nmap")
        assert st["psums"] == [st["live"] * (st["cols"] + 3)] + [st["live"] * 16] * st["taps"]
    assert min(st["live"] for st in steps) < SIZE * SIZE


def test_psum_sizes_must_agree_over_the_axis(world):
    """``comm.psum_`` in the CPU world: of one size on every rank it sums in
    place; of sizes that differ between ranks it raises ValueError on every
    rank, naming the sizes, and the world goes on."""
    for out in world["calls"]:
        ok, bad = out["results"][3], out["results"][4]
        assert ok[0] == "returned"
        np.testing.assert_array_equal(ok[1], np.full(5, WORLD, np.float32))
        assert bad[0] == "raised" and bad[1] == "ValueError"
        assert "between 10 and 13" in bad[2]


def _check_frame(results, single, jax_frame, single_rays, jax_rays, n_gp=WORLD):
    out = results[0]
    # the ranks of a gp group (one dp row block) traced the same lanes
    for r, x in enumerate(results):
        assert x["rays_local"] == results[r - r % n_gp]["rays_local"], r
    np.testing.assert_allclose(out["images"][-1], single, atol=1e-5)
    assert rel_rmse(out["images"][-1], jax_frame) < 0.01
    assert out["rays"][-1] == single_rays == jax_rays


def test_gp4_matches_single_device(world, jax_side):
    """gp=4, whole atlas: within 1e-5 of the single device, and of JAX's gp
    step within the parity bar, rays equal. In the checked frame after it
    (``drive(check_flat=True)``) every rank held each traversal of its
    shard table, and its refit of it, against the plain versions, and no
    lane reached a padded row of a table that has them."""
    single, rays = _single(OFFSETS)
    _check_frame(world["gp4"], single[0], jax_side["gp4"][0], rays, jax_side["gp4"][1])
    checks = [x["flat_check"] for x in world["gp4"]]
    for check in checks:
        assert check["launches"] > 0 and check["lanes"] > 0
        assert not any(check["mismatches"].values()) and check["max_abs_err"] == 0.0
        assert check["padded_visits"] == 0
        assert check["refit"]["launches"] > 0 and check["refit"]["rows_differing"] == 0
    assert max(check["padded_rows"] for check in checks) > 0


def test_gp4_banded_matches_single_device(world, jax_side):
    """gp=4 on the textured scene with the banded atlas: within 1e-5 of the
    single device, and of JAX's banded step within the parity bar."""
    single, rays = _single(OFFSETS, textured=True)
    _check_frame(world["gp4_banded"], single[0], jax_side["gp4_banded"][0], rays,
                 jax_side["gp4_banded"][1])


@pytest.mark.parametrize("job", ["gp4", "gp4_nmap"])
def test_gp4_kernel_route_is_the_plain_route(world, job):
    """gp=4, untextured with the whole atlas ("gp4") and textured with a
    normal map and the banded atlas ("gp4_nmap"): on every rank the frame
    after the drawn ones (``drive(check_route=True)``) traced on the kernel
    route (K13, K14 and K7's lane-row form through their plain versions
    here, the psums between them) is bit-equal to the plain route (K7's
    plain body with ``_tri_rows`` and the banded taps' psums inside), rays
    equal; a second kernel-route run with each K13 and K14 call and the
    first K7 step held against their plain versions is bit-equal too. The textured frame's K13
    calls carry the motion rows (the normal map's tangent basis) and K14
    ran; the untextured one's carry none and K14 never ran."""
    for check in (x["route_check"] for x in world[job]):
        assert check["bit_equal"], check["fields"]
        assert check["checked_run_differing"] == 0
        assert check["rays"][0] == check["rays"][1] > 0
        assert check["k13"] and not any(c["differing"] for c in check["k13"])
        # a step's rows (shade, and motion where needed), and sample 0's motion rows
        assert {(c["shade"], c["motion"]) for c in check["k13"]} == (
            {(True, True), (False, True)} if job == "gp4_nmap" else {(True, False), (False, True)})
        assert bool(check["k14"]) == (job == "gp4_nmap")
        assert not any(c["differing"] for c in check["k14"])
        # the frame's first K7 step, the lane-row form against its plain body with the same rows
        assert check["k7"]["variant"] == ("rows_maps_taps" if job == "gp4_nmap" else "rows")
        assert check["k7"]["differing"] == 0 and check["k7"]["lanes"] == SIZE * SIZE


@pytest.mark.parametrize("job", ["gp4", "gp4_banded", "dp_gp"])
def test_gp_frames_within_1e5_of_mrt_tpu(world, jax_side, job):
    """The gp frames on the kernel route (K13, K14 and K7's lane-row form
    through their plain versions): untextured, textured with the banded
    atlas, and (dp, gp) = (2, 2), each within 1e-5 of JAX's gp step on the
    same inputs. (The normal-mapped frame: its own case below.)"""
    np.testing.assert_allclose(world[job][0]["images"][-1], jax_side[job][0], atol=1e-5)


def test_gp4_normal_mapped_banded_matches_single_device(world, jax_side):
    """gp=4 on the textured scene with a normal map and the banded atlas
    (the lane-row form's motion rows and per-lane taps): within 1e-5 of the
    flat single device (the shards' tables are flat; the two-level BVH's
    object-space hits differ in their last bits, which the normal map's
    tangent basis carries past 1e-5 at a few pixels), and of JAX's banded
    step within the parity bar."""
    single, rays = _single(OFFSETS, nmap=True, two_level=False)
    _check_frame(world["gp4_nmap"], single[0], jax_side["gp4_nmap"][0], rays,
                 jax_side["gp4_nmap"][1])


def test_gp4_normal_mapped_within_1e4_of_mrt_tpu(world, jax_side):
    """gp=4 on the normal-mapped scene with the banded atlas against JAX's
    gp step: within 1e-4, and at most 2 pixels past 1e-5 (read: 1 pixel, at
    4.78e-5). That gap is the single device's, not the sharding's: the
    port's flat single-device frame differs from JAX's unsharded step (gp=1,
    whole atlas) by the same amounts, per element within 1e-6 (read:
    3.4e-7, the rounding between JAX's banded gp=4 and gp=1 steps)."""
    gap = world["gp4_nmap"][0]["images"][-1] - jax_side["gp4_nmap"][0]
    d = np.abs(gap).max(axis=-1)
    assert d.max() <= 1e-4 and int((d > 1e-5).sum()) <= 2, (d.max(), int((d > 1e-5).sum()))
    single, _ = _single(OFFSETS, nmap=True, two_level=False)
    np.testing.assert_allclose(gap, single[0] - jax_side["gp1_nmap"][0], atol=1e-6)


def test_dp_gp_matches_single_device(world, jax_side):
    """(dp, gp) = (2, 2), banded: image rows over dp, geometry over gp;
    within 1e-5 of the single device, and of JAX's step on a (2, 2) mesh
    within the parity bar."""
    single, rays = _single(OFFSETS)
    _check_frame(world["dp_gp"], single[0], jax_side["dp_gp"][0], rays, jax_side["dp_gp"][1],
                 n_gp=2)
    assert world["dp_gp"][0]["rays_local"] != world["dp_gp"][2]["rays_local"]


def test_gp_renderer_two_frames(world, jax_side):
    """GeometryShardedRenderer over two frames at gp=4: both within 1e-5 of
    the single device, and of JAX's GeometryShardedRenderer within the
    parity bar."""
    single, rays = _single(jax_side["gsr_offsets"], frames=2)
    out = world["gsr"]
    for k in range(2):
        np.testing.assert_allclose(out[0]["images"][k], single[k], atol=1e-5)
        assert rel_rmse(out[0]["images"][k], jax_side["gsr"][k]) < 0.01
    _check_frame(out, single[1], jax_side["gsr"][1], rays, jax_side["gsr_rays"])


def test_gp1_is_the_flat_single_device():
    """A world of one rank (no process group): gp=1 holds the whole flat
    table, and its frames are bit-equal to the flat single-device
    Renderer's (two_level=False), rays equal, as int64."""
    gr = G.GeometryShardedRenderer(_scene(True), _settings(T), offsets=OFFSETS, device="cpu")
    single, rays = _single(OFFSETS, textured=True, frames=2, two_level=False)
    for k in range(2):
        np.testing.assert_array_equal(gr.draw().numpy(), single[k])
    assert gr.last_rays_traced.dtype == torch.int64 and int(gr.last_rays_traced) == rays
    assert gr.banded and gr.scene_data.atlas.band_lo == 0


def test_gp_refusals():
    """Masks with gp raise ValueError (the flat shard tables have no mask
    test), a mesh without a gp axis too, and a frame traced under
    geometry_axis without a shard geometry."""
    s = _scene()
    s.models[0].geometry_mask = T.GEOMETRY_MASK_LIGHT
    with pytest.raises(ValueError, match="geometry masks"):
        G.GeometryShardedRenderer(s, _settings(T), device="cpu")
    with pytest.raises(ValueError, match="no 'gp' axis"):
        G.GeometryShardedRenderer(_scene(), _settings(T), mesh=comm.Mesh({"dp": 1}, "cpu"))
    r = Renderer(_scene(), SIZE, SIZE, device="cpu")
    r.two_level = False
    sd, geom, bvh = r.prepare()
    settings = T.RenderSettings(width=SIZE, height=SIZE, geometry_axis="gp")
    uniforms = T.make_frame_uniforms(camera=r.current_camera())
    with pytest.raises(ValueError, match="geometry_axis"):
        wf.trace_frame(settings, r.statics, sd, bvh, geom, uniforms, r.offsets,
                       torch.zeros(tuple(r.offsets.shape) + (2,)))


def test_chip_smoke_gp_route_checks_on_cpu(world):
    """``chip_smoke.py``'s phase-L reading of the checked gp frames
    (``gp_route_checks``) on this world's CPU results: it passes both gp=4
    jobs with the textured one's K14 required and the untextured one's
    absent, summarises K13's and K14's launches (``launch_summary``), and
    raises where K14 is required but did not run."""
    import chip_smoke

    line = chip_smoke.gp_route_checks("cpu gp=4 textured", world["gp4_nmap"], True)
    assert line["bit_equal"] and line["k13"]["launches"] > 0 and line["k14"]["launches"] > 0
    assert line["k13"]["first"]["lanes"] == SIZE * SIZE and line["k7"]["variant"] == "rows_maps_taps"
    assert chip_smoke.gp_route_checks("cpu gp=4", world["gp4"], False)["k14"]["launches"] == 0
    with pytest.raises(AssertionError, match="kernel route disagrees"):
        chip_smoke.gp_route_checks("cpu gp=4", world["gp4"], True)
