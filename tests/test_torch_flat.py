"""The flat single-level BVH path (``two_level=False``) against live mrt_tpu:
``bvh/wide.py``'s build and refit, kernel K3's plain version behind
``closest_hit``/``any_hit``/``trace_mixed``, the renderer's flat frames, the
BVH switch, and the binary-LBVH traversal oracle (``bvh/lbvh.py``,
``bvh/traverse.py``).

Tolerances: tables (node_child, leaf_tri, depth, stack bound, the packed
rows, the LBVH boxes) bit-equal. Traversals as in test_torch_traversal.py:
hit triangles equal but for equal-t ties (at most 1 % of rays), t within
1e-6 relative, u and v within 1e-4 (XLA:CPU fuses multiply-adds in the leaf
test, ROADMAP Q3-P1), per-lane pops equal to JAX's count_pops but on those
ties, occlusion equal. Frames: the accumulation within 1 % relative RMSE,
rays equal per frame (within 0.5 % for the skinned robot, whose posed
vertices agree to ULPs), the image within 1 LSB. The oracle: closest hits
bit-equal to JAX's oracle on the same tree, and to the brute-force oracle
within 1e-5 relative in t."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrt_tpu.bvh import lbvh as jlbvh
from mrt_tpu.bvh import traverse as jtrav
from mrt_tpu.bvh import wide as jwide
from mrt_tpu.core.types import Rays as JRays
from mrt_tpu.engine.scene import world_geometry as jworld
from mrt_tpu_torch import UPSCALER_OFF, Model, Renderer, Scene, convert
from mrt_tpu_torch.bvh import intersect, lbvh, traverse, wide
from mrt_tpu_torch.core.types import Rays
from mrt_tpu_torch.kernels import traverse2
from mrt_tpu_torch.utils import bounds
from test_torch_animated import _check, _jax, _port, sample_totals
from test_torch_render import compare_frames, port_like
from test_torch_scene_bvh import SCENES, jax_sah, one_torch_thread  # noqa: F401

N = 4096


def _world_tris(js):
    """The JAX scene's world-space triangles (T,3) x 3, as NumPy."""
    jd, _ = js.compile()
    pos_w, _, _ = jworld(jd)
    pos, idx = np.asarray(pos_w), np.asarray(jd.indices)
    return tuple(np.ascontiguousarray(pos[idx[:, k]]) for k in range(3))


def _rays(seed):
    rng = np.random.default_rng(seed)
    o = ((rng.random((N, 3)) * 2 - 1) * 5).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1])
    d = rng.standard_normal((N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dist = (0.5 + 5.5 * rng.random(N)).astype(np.float32)
    return o, d, dist, rng.random(N) < 0.5, rng.random(N) < 0.9


@pytest.fixture(scope="module", params=["config3", "blob_glass"])
def flat(request):
    """A scene's flat tables from both packages (SAH, on the same world
    triangles), and seeded rays."""
    tris = _world_tris(SCENES[request.param]())
    with jax_sah():
        jb = jwide.build(*tris, method="sah")
    pb = wide.build(*tris, method="sah", device="cpu")
    o, d, dist, shadow, mask = _rays(len(request.param))
    return dict(tris=tris, jb=jb, pb=pb, o=o, d=d, dist=dist, shadow=shadow, mask=mask)


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))


def _tables_equal(jb, pb):
    assert pb.n_internal == jb.n_internal and pb.depth == jb.depth
    assert pb.stack_bound == jb.stack_bound and pb.stack_size == jwide._stack_alloc(jb.stack_bound, jb.depth)
    assert np.array_equal(pb.node_child.numpy(), np.asarray(jb.node_child))
    assert np.array_equal(pb.leaf_tri.numpy(), np.asarray(jb.leaf_tri))
    assert _bits_equal(jb.table, pb.table.numpy())


@pytest.mark.parametrize("method", ["sah", "lbvh"])
def test_build_tables_bit_equal(method):
    """wide.build gives the JAX package's table, topology and stack bound."""
    tris = _world_tris(SCENES["config3"]())
    with jax_sah():
        jb = jwide.build(*tris, method=method)
    pb = wide.build(*tris, method=method, device="cpu")
    _tables_equal(jb, pb)
    assert pb.leaf_clip is None and pb.n_rows == pb.table.shape[0] > 2 * pb.n_internal > 0


def test_refit_moved_vertices_bit_equal(flat):
    """The refit from moved vertices (seeded noise on every vertex), with
    the leaf rows' own ids and with other ids, equals the JAX refit."""
    rng = np.random.default_rng(11)
    moved = tuple((t + rng.normal(0, 0.05, t.shape)).astype(np.float32) for t in flat["tris"])
    jr = jwide.refit(flat["jb"], *(jnp.asarray(t) for t in moved))
    pr = wide.refit(flat["pb"], *(torch.as_tensor(t) for t in moved))
    assert _bits_equal(jr.table, pr.table.numpy())
    assert not _bits_equal(pr.table.numpy(), flat["pb"].table.numpy())
    ids = np.asarray(flat["jb"].leaf_tri) * 3 + 1
    jr = jwide.refit(flat["jb"], *(jnp.asarray(t) for t in moved), row_ids=jnp.asarray(ids))
    pr = wide.refit(flat["pb"], *(torch.as_tensor(t) for t in moved), row_ids=torch.as_tensor(ids))
    assert _bits_equal(jr.table, pr.table.numpy())


def _jrays(s, dist):
    return JRays(jnp.asarray(s["o"]), jnp.asarray(s["d"]), jnp.asarray(dist))


def _prays(s, dist):
    return Rays(torch.as_tensor(s["o"]), torch.as_tensor(s["d"]), torch.as_tensor(dist))


def _check_hits(s, jh, ph, live):
    """Hits equal but for equal-t ties (by the brute-force oracle); returns
    the tie lanes."""
    jt, pt = np.asarray(jh.triangle), ph.triangle.numpy()
    assert np.array_equal(jt >= 0, pt >= 0)
    diff = np.nonzero((jt != pt) & live)[0]
    if diff.size:
        o = torch.as_tensor(s["o"][diff])[:, None]
        d = torch.as_tensor(s["d"][diff])[:, None]
        v0, v1, v2 = (torch.stack([torch.as_tensor(t)[jt[diff]], torch.as_tensor(t)[pt[diff]]], 1)
                      for t in s["tris"])
        hit, t, _, _ = intersect.ray_triangle(o, d, v0, v1, v2)
        assert bool(hit.all())
        assert bool(((t[:, 0] - t[:, 1]).abs() <= 1e-5 * t.abs().amax(1).clamp_min(1)).all())
    assert diff.size <= N // 100, f"{diff.size} tie flips"
    both = (jt >= 0) & (jt == pt)
    np.testing.assert_allclose(ph.t.numpy()[both], np.asarray(jh.t)[both], rtol=1e-6)
    for a, b in ((ph.u, jh.u), (ph.v, jh.v)):
        np.testing.assert_allclose(a.numpy()[both], np.asarray(b)[both], rtol=0, atol=1e-4)
    return diff


def _pops_equal(jpops, ppops, skip):
    keep = np.ones(N, bool)
    keep[skip] = False
    assert np.array_equal(ppops.numpy()[keep], np.asarray(jpops)[keep])


def test_closest_hit_matches(flat):
    inf = np.full(N, np.inf, np.float32)
    mask = flat["mask"]
    jh, jpops = jwide.closest_hit(flat["jb"], _jrays(flat, inf), mask=jnp.asarray(mask),
                                  count_pops=True)
    ph, ppops = wide.closest_hit(flat["pb"], _prays(flat, inf), mask=torch.as_tensor(mask),
                                 count_pops=True, chunks=4, sort_rays=True)
    skip = _check_hits(flat, jh, ph, mask)
    _pops_equal(jpops, ppops, skip)
    assert not (ph.triangle.numpy() >= 0)[~mask].any() and not ppops.numpy()[~mask].any()
    assert 0 < int((ph.triangle >= 0).sum()) < N
    assert np.all(np.isinf(ph.t.numpy()[ph.triangle.numpy() < 0]))


def test_any_hit_matches(flat):
    jo, jtri, jpops = jwide.any_hit(flat["jb"], _jrays(flat, flat["dist"]), return_tri=True,
                                    count_pops=True)
    po, ptri, ppops = wide.any_hit(flat["pb"], _prays(flat, flat["dist"]), return_tri=True,
                                   count_pops=True)
    assert np.array_equal(np.asarray(jo), po.numpy()) and 0 < int(po.sum()) < N
    assert np.array_equal(np.asarray(jtri), ptri.numpy())
    _pops_equal(jpops, ppops, [])


def test_trace_mixed_matches(flat):
    dist = np.where(flat["shadow"], flat["dist"], np.inf).astype(np.float32)
    sh, mask = flat["shadow"], flat["mask"]
    jh, jocc, jpops = jwide.trace_mixed(flat["jb"], _jrays(flat, dist), jnp.asarray(sh),
                                        mask=jnp.asarray(mask), count_pops=True)
    ph, pocc, ppops = wide.trace_mixed(flat["pb"], _prays(flat, dist), torch.as_tensor(sh),
                                       mask=torch.as_tensor(mask), count_pops=True)
    assert np.array_equal(np.asarray(jocc), pocc.numpy()) and pocc.any()
    closest = mask & ~sh
    skip = _check_hits(flat, jh._replace(triangle=jnp.where(jnp.asarray(closest), jh.triangle, -1)),
                       ph._replace(triangle=torch.where(torch.as_tensor(closest), ph.triangle, -1)),
                       closest)
    _pops_equal(jpops, ppops, skip)


def test_scheduling_arguments_change_nothing(flat):
    """The JAX package's TPU scheduling arguments are accepted and change no
    result; an unknown argument raises."""
    inf = np.full(N, np.inf, np.float32)
    rays = _prays(flat, inf)
    a = wide.closest_hit(flat["pb"], rays)
    b = wide.closest_hit(flat["pb"], rays, chunks=8, sort_rays=True, stream_window=64,
                         refill_every=4, unroll=2, sort_hint=torch.zeros(N, dtype=torch.int32),
                         prime_tri=torch.zeros(N, dtype=torch.int32), tri_rows=None)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(TypeError):
        wide.closest_hit(flat["pb"], rays, ray_mask=torch.ones(N, dtype=torch.int32))


@pytest.mark.parametrize("kind", ["closest", "any"])
def test_float_sort_pops_match_jax(flat, kind, monkeypatch):
    """The float child sort that tables above 2^20 - 1 rows take (K3's
    flat_float_sort), forced on these small tables in both packages by
    lowering the packed key's row limit: per-lane pops equal the JAX
    package's float-sort traversal, occlusion equal."""
    mask = flat["mask"]
    inf = np.full(N, np.inf, np.float32)
    monkeypatch.setattr(jwide, "_META_MASK", 1)
    monkeypatch.setattr(traverse2, "_META_MASK", 1)
    assert traverse2.flat_variant(flat["pb"].n_rows) == "flat_float_sort"
    if kind == "closest":
        jh, jpops = jwide.closest_hit(flat["jb"], _jrays(flat, inf), mask=jnp.asarray(mask),
                                      count_pops=True)
        ph, ppops = wide.closest_hit(flat["pb"], _prays(flat, inf), mask=torch.as_tensor(mask),
                                     count_pops=True)
        skip = _check_hits(flat, jh, ph, mask)
    else:
        jo, jpops = jwide.any_hit(flat["jb"], _jrays(flat, flat["dist"]), mask=jnp.asarray(mask),
                                  count_pops=True)
        po, ppops = wide.any_hit(flat["pb"], _prays(flat, flat["dist"]), mask=torch.as_tensor(mask),
                                 count_pops=True)
        assert np.array_equal(np.asarray(jo), po.numpy())
        skip = []
    _pops_equal(jpops, ppops, skip)


@pytest.mark.parametrize("n_rows", [2 ** 20 - 1, 2 ** 20, 2 ** 20 + 1])
def test_flat_sort_dispatch_at_the_row_limit(n_rows):
    """K3's instantiation and the child order at the packed key's row limit,
    through sorted_candidates (no 2^20-row table): up to 2^20 - 1 rows the
    packed key, from 2^20 rows the float network, as JAX dispatches."""
    assert traverse2.flat_variant(n_rows) == ("flat" if n_rows < 2 ** 20 else "flat_float_sort")
    rng = np.random.default_rng(n_rows)
    t = rng.choice(np.float32([0.0, 0.5, 0.5000001, 2.0, np.inf]), (2048, 8)).astype(np.float32)
    meta = rng.integers(0, n_rows, (2048, 8)).astype(np.int32)
    meta[np.isinf(t) & (rng.random((2048, 8)) < 0.5)] = -1
    jc, jv = jwide._sorted_candidates(jnp.asarray(t), jnp.asarray(meta), n_rows)
    pc, pv = traverse2.sorted_candidates(torch.as_tensor(t), torch.as_tensor(meta), n_rows)
    jv = np.asarray(jv)
    assert np.array_equal(jv, pv.numpy()) and 0 < jv.sum() < jv.size
    assert np.array_equal(np.asarray(jc)[jv], pc.numpy()[jv])


def test_plain_version_edges_and_work(flat):
    """Every lane dead: the miss record, no pops or visits. One live lane at
    the end: that ray traced alone. The work that utils/bounds.py reads:
    no instance pops, pops by row type summing to the lanes' pops; K3's
    bound prices 51 B a live lane and 26 B a dead one."""
    pb = flat["pb"]
    args = (pb.table, pb.n_internal, pb.stack_size, torch.as_tensor(flat["o"]),
            torch.as_tensor(flat["d"]), torch.as_tensor(flat["dist"]), torch.zeros(N, dtype=torch.bool))
    dead = traverse2.traverse_flat_plain(*args, torch.zeros(N, dtype=torch.bool))
    assert torch.equal(dead.t, args[5]) and bool((dead.tri == -1).all() and (dead.inst == -1).all())
    assert not bool(dead.found.any() or dead.pops.any() or dead.u.any()) and int(dead.visits.sum()) == 0
    last = torch.zeros(N, dtype=torch.bool)
    last[-1] = True
    one = traverse2.traverse_flat_plain(*args, last)
    alone = traverse2.traverse_flat_plain(pb.table, pb.n_internal, pb.stack_size,
                                          *(a[-1:] for a in args[3:]), last[-1:])
    for f in ("t", "tri", "u", "v", "found", "pops"):
        assert torch.equal(getattr(one, f)[-1:], getattr(alone, f)), f
    live = torch.as_tensor(flat["mask"])
    out = traverse2.traverse_flat(*args[:6], torch.as_tensor(flat["shadow"]), live)
    w = bounds.k3_work(pb.table, pb.n_internal, out.visits)
    assert w["pops_instance"] == w["entered"] == w["rows_instance"] == 0
    assert w["pops_internal"] + w["pops_leaf"] == int(out.pops.sum()) > 0
    n_live = int(live.sum())
    # the world direction's guarded reciprocals once per live lane, not per internal pop
    assert w["lanes"] == n_live == int(out.visits[0, 0])
    w2 = bounds.k2_work(pb.table, pb.n_internal, pb.table.shape[0] - pb.n_internal, out.visits)
    assert w["ops"] == w2["ops"] - (w["pops_internal"] - n_live) * bounds.K2_OPS_INTERNAL
    ms, by = bounds.k2(w, N, n_live, flat=True)
    nbytes = w["row_bytes"] + n_live * 51 + (N - n_live) * 26
    assert ms == pytest.approx(max(w["ops"] / 33.5e12, nbytes / 3.35e12) * 1e3, rel=1e-12)
    assert traverse2.flat_launches == 0  # CPU tensors never reach the kernel


def test_kernel_wrapper_rejects_other_devices(flat):
    pb = flat["pb"]
    meta = torch.zeros((4, 3), device="meta")
    flags = torch.zeros(4, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        traverse2.traverse_flat(pb.table, pb.n_internal, pb.stack_size, meta, meta,
                                torch.zeros(4, device="meta"), flags, flags)


def test_plain_version_refuses_a_short_stack(flat):
    """A stack below the table's bound would drop entries (the JAX shift
    stack drops the oldest): the plain version raises instead."""
    pb = flat["pb"]
    with pytest.raises(RuntimeError, match="stack"):
        traverse2.traverse_flat_plain(pb.table, pb.n_internal, 2, torch.as_tensor(flat["o"]),
                                      torch.as_tensor(flat["d"]), torch.full((N,), float("inf")),
                                      torch.zeros(N, dtype=torch.bool), torch.ones(N, dtype=torch.bool))


# ---------------------------------------------------------------------------
# Frames on the flat BVH against JAX's flat renderer
# ---------------------------------------------------------------------------

def test_sphere_plane_flat_frames_match_mrt_tpu():
    """A sphere over a plane, 2 spp, 3 bounces, 3 frames on both packages'
    flat tables (bit-equal), the port's built by its own renderer."""
    from mrt_tpu import Renderer as JRenderer
    from mrt_tpu.engine.scene import Model as JModel
    from mrt_tpu.engine.scene import Scene as JScene

    js = JScene(32, 32)
    js.models = [JModel("sphere", position=[0, 0.5, 0], scale=0.5), JModel("plane", scale=10)]
    rj = JRenderer(js, 32, 32)
    rj.upscaler_mode = "off"
    rj.use_motion_adaptive_sampling = False
    rj.max_bounces = 3
    with jax_sah():
        rj.two_level = False
    rj.draw()
    rp = port_like(rj)
    rp.two_level = False
    assert isinstance(rp.bvh, wide.WideBVH) and _bits_equal(rj.bvh.table, rp.bvh.table.numpy())
    assert all(r > 0 for r in compare_frames(rj, rp, 3))


def test_skinned_robot_flat_frames_match_mrt_tpu():
    """The swing-rigged robot over a floor beside a sphere on the flat BVH
    (the whole table refit from the posed triangles every frame), three
    draws at 1/15 s with motion-adaptive sampling, as
    test_torch_animated.py holds the two-level frames."""
    rj = _jax(robot=True)
    with jax_sah():
        rj.two_level = False
    rp = None
    records = []
    for f in range(3):
        prev_j = np.asarray(rj.motion)
        rj.draw(1 / 15)
        if rp is None:
            rp = _port(robot=True, offsets=np.asarray(rj.offsets))
            rp.two_level = False
        prev_p = rp.motion.numpy()
        rp.draw(1 / 15)
        aj, ap = np.asarray(rj.accum), rp.accum.numpy()
        mj, mp = np.asarray(rj.motion), rp.motion.numpy()
        if f == 0:
            prev_j, prev_p = np.zeros_like(mj), np.zeros_like(mp)
        sj, sp = sample_totals(rj, mj, prev_j), rp.last_samples.numpy()
        records.append(dict(
            frame=f, rmse=float(np.sqrt(np.mean((ap - aj) ** 2)) / np.sqrt(np.mean(aj ** 2))),
            finite=bool(np.isfinite(ap).all()),
            motion_ok=float(np.mean(np.all(np.abs(mp - mj) <= 1e-3, axis=-1))),
            rays=(int(rj.last_rays_traced), int(rp.last_rays_traced)),
            samples_ok=float(np.mean(sj == sp)),
            samples_own=bool(np.array_equal(sp, sample_totals(rp, mp, prev_p)))))
    _check(records)
    assert isinstance(rp.bvh, wide.WideBVH) and float(np.abs(rp.motion.numpy()).max()) > 0.5


# ---------------------------------------------------------------------------
# The BVH switch, rebuild and carried state
# ---------------------------------------------------------------------------

def _small_renderer():
    s = Scene(16, 16)
    s.models = [Model("sphere", position=[0.0, 0.5, 0.0], scale=0.5), Model("plane", scale=4)]
    r = Renderer(s, 16, 16, device="cpu")
    r.upscaler_mode = UPSCALER_OFF
    return r


def test_two_level_toggle():
    """two_level = False builds the flat table, True the two-level BVH
    again; each switch restarts accumulation and drops the presenter's
    history; an unknown backend raises ValueError naming it, and the old
    value and BVH stay."""
    r = _small_renderer()
    two = r.bvh
    r.draw()
    r.draw()
    r._upscale_history = torch.zeros(1)
    r.two_level = False
    assert isinstance(r.bvh, wide.WideBVH) and r.frame_index == 0 and r._upscale_history is None
    flat_img = r.draw().clone()
    assert np.isfinite(flat_img.numpy()).all() and float(flat_img.max()) > 0
    r.two_level = True
    assert type(r.bvh) is type(two) and _bits_equal(r.bvh.table.numpy(), two.table.numpy())
    assert r.frame_index == 0
    kept = r.bvh
    with pytest.raises(ValueError, match="'lbvh'"):
        r.traversal_backend = "lbvh"
    assert r.traversal_backend == "wide" and r.bvh is kept
    r.draw()


def test_rebuild_bvh_sees_current_pose():
    """rebuild_bvh rebuilds the flat table from the LIVE model transforms,
    not the compile-time host mirror (the port of test_engine_aux.py's
    test of the same name)."""
    r = _small_renderer()
    r.two_level = False
    r.scene.models[0].position = np.asarray([50.0, 0.5, 0.0], np.float32)
    r._sync_scene()
    r.rebuild_bvh()
    root = r.bvh.table[0].numpy()
    A = wide.ARITY
    assert np.nanmax(root[3 * A:4 * A]) > 40.0


def test_convert_wide_bvh():
    """convert.bvh carries the JAX renderer's flat WideBVH over; a renderer
    from that compiled state is a flat renderer and draws as the port's own
    flat renderer does."""
    from mrt_tpu import Renderer as JRenderer
    from mrt_tpu.engine.scene import Model as JModel
    from mrt_tpu.engine.scene import Scene as JScene

    js = JScene(16, 16)
    js.models = [JModel("sphere", position=[0, 0.5, 0], scale=0.5), JModel("plane", scale=4)]
    rj = JRenderer(js, 16, 16)
    with jax_sah():
        rj.two_level = False
    pb = convert.bvh(rj.bvh, device="cpu")
    assert isinstance(pb, wide.WideBVH)
    _tables_equal(rj.bvh, pb)
    carried = Renderer.from_compiled(
        convert.scene(js), *convert.compiled(rj.scene_data, rj.statics, rj.bvh, device="cpu"),
        output_width=16, output_height=16, seed=2)
    own = Renderer(convert.scene(js), 16, 16, device="cpu", seed=2)
    own.two_level = False
    assert carried.two_level is False and _bits_equal(own.bvh.table.numpy(), pb.table.numpy())
    for r in (own, carried):
        r.upscaler_mode = UPSCALER_OFF
    for _ in range(2):
        a, b = own.draw(), carried.draw()
        assert np.array_equal(a.numpy(), b.numpy())
        assert int(own.last_rays_traced) == int(carried.last_rays_traced) > 0
    # with no host mirror of its own, the carried renderer reads the scene back to rebuild
    own.two_level = carried.two_level = True
    assert _bits_equal(own.bvh.table.numpy(), carried.bvh.table.numpy())


# ---------------------------------------------------------------------------
# The binary LBVH and its traversal oracle
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def oracle():
    tris = _world_tris(SCENES["blob_glass"]())
    jb = jlbvh.build(*tris)
    pb = lbvh.build(*tris, device="cpu")
    o, d, dist, _, mask = _rays(7)
    return dict(tris=tris, jb=jb, pb=pb, o=o, d=d, dist=dist, mask=mask)


def test_lbvh_build_and_refit_bit_equal(oracle):
    """lbvh.build's topology and boxes, and a refit from moved vertices,
    equal the JAX package's."""
    jb, pb = oracle["jb"], oracle["pb"]
    assert pb.depth == jb.depth and pb.n_tris == jb.n_tris
    for f in ("left", "right", "parent", "leaf_tri"):
        assert np.array_equal(getattr(pb, f).numpy(), np.asarray(getattr(jb, f))), f
    for f in ("bbox_min", "bbox_max"):
        assert _bits_equal(getattr(jb, f), getattr(pb, f).numpy()), f
    rng = np.random.default_rng(3)
    moved = tuple((t + rng.normal(0, 0.05, t.shape)).astype(np.float32) for t in oracle["tris"])
    jr = jlbvh.refit(jb, *(jnp.asarray(t) for t in moved))
    pr = lbvh.refit(pb, *(torch.as_tensor(t) for t in moved))
    assert _bits_equal(jr.bbox_min, pr.bbox_min.numpy()) and _bits_equal(jr.bbox_max, pr.bbox_max.numpy())
    jmin, jmax = jlbvh.triangle_bboxes(*(jnp.asarray(t) for t in moved))
    pmin, pmax = lbvh.triangle_bboxes(*(torch.as_tensor(t) for t in moved))
    assert _bits_equal(jmin, pmin.numpy()) and _bits_equal(jmax, pmax.numpy())


def test_oracle_matches_jax_and_brute_force(oracle):
    """traverse.closest_hit and any_hit on the LBVH: the JAX oracle's hits
    (triangles equal, t/u/v within the P1 tolerances), its occlusion; and
    the brute-force oracle's closest triangles but for equal-t ties."""
    jb, pb, tris = oracle["jb"], oracle["pb"], oracle["tris"]
    jt = tuple(jnp.asarray(t) for t in tris)
    pt = tuple(torch.as_tensor(t) for t in tris)
    inf = np.full(N, np.inf, np.float32)
    mask = oracle["mask"]
    jh = jtrav.closest_hit(jb, *jt, _jrays(oracle, inf), mask=jnp.asarray(mask))
    ph = traverse.closest_hit(pb, *pt, _prays(oracle, inf), mask=torch.as_tensor(mask))
    oracle["tris"] = tris
    _check_hits(oracle, jh, ph, mask)
    hit = (ph.triangle.numpy() >= 0) & (ph.triangle.numpy() == np.asarray(jh.triangle))
    assert 0 < hit.sum() < N and not (ph.triangle.numpy() >= 0)[~mask].any()
    np.testing.assert_allclose(ph.t.numpy()[hit], np.asarray(jh.t)[hit], rtol=1e-6)
    np.testing.assert_allclose(ph.u.numpy()[hit], np.asarray(jh.u)[hit], atol=1e-4)
    jo = jtrav.any_hit(jb, *jt, _jrays(oracle, oracle["dist"]))
    po = traverse.any_hit(pb, *pt, _prays(oracle, oracle["dist"]))
    assert np.array_equal(np.asarray(jo), po.numpy()) and 0 < int(po.sum()) < N
    n = 512
    rays = Rays(*(x[:n] for x in _prays(oracle, inf)))
    bf = intersect.brute_force_closest_hit(rays, *pt)
    got = traverse.closest_hit(pb, *pt, rays)
    assert torch.equal(got.triangle >= 0, bf.triangle >= 0)
    both = bf.triangle >= 0
    np.testing.assert_allclose(got.t[both].numpy(), bf.t[both].numpy(), rtol=1e-5)
    assert float((got.triangle != bf.triangle).float().mean()) <= 0.01
    # the oracle and K3's plain version agree on the flat table of the same triangles
    wb = wide.build(*tris, device="cpu")
    kh = wide.closest_hit(wb, rays)
    np.testing.assert_allclose(kh.t[both].numpy(), got.t[both].numpy(), rtol=1e-5)


def test_oracle_single_triangle_and_guards():
    """A one-triangle BVH takes the direct test; safe_inv_dir keeps zero
    components finite; ray_aabb hits a box a ray starts inside."""
    v = (np.float32([[0, 0, 0]]), np.float32([[1, 0, 0]]), np.float32([[0, 1, 0]]))
    jb, pb = jlbvh.build(*v), lbvh.build(*v, device="cpu")
    o = np.float32([[0.2, 0.2, 1.0], [2.0, 2.0, 1.0]])
    d = np.float32([[0, 0, -1], [0, 0, -1]])
    jr = JRays(jnp.asarray(o), jnp.asarray(d), jnp.full(2, jnp.inf))
    pr = Rays(torch.as_tensor(o), torch.as_tensor(d), torch.full((2,), float("inf")))
    jh = jtrav.closest_hit(jb, *(jnp.asarray(x) for x in v), jr)
    ph = traverse.closest_hit(pb, *(torch.as_tensor(x) for x in v), pr)
    assert ph.triangle.tolist() == np.asarray(jh.triangle).tolist() == [0, -1]
    assert traverse.any_hit(pb, *(torch.as_tensor(x) for x in v), pr).tolist() == [True, False]
    inv = intersect.safe_inv_dir(torch.as_tensor(d))
    assert bool(torch.isfinite(inv).all())
    from mrt_tpu.bvh import intersect as jint

    assert _bits_equal(jint.safe_inv_dir(jnp.asarray(d)), inv.numpy())
    hit, t = intersect.ray_aabb(torch.zeros(3), inv[0], -torch.ones(3), torch.ones(3))
    assert bool(hit) and float(t) == 0.0
    jhit, jtn = jint.ray_aabb(jnp.zeros(3), jnp.asarray(inv[0].numpy()), -jnp.ones(3), jnp.ones(3))
    assert bool(jhit) == bool(hit) and float(jtn) == float(t)
