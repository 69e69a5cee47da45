"""Two-level traversal (kernel K2's plain version on the CPU) against the JAX
package's closest_hit / any_hit / trace_mixed, on the very same tables
carried over by convert.py, for 4096 random rays per scene.

Tolerances: hit triangle and instance equal, except where the brute-force
oracle shows the two triangles at equal t along the ray (an equal-t tie,
which either package may resolve; at most 1% of rays); t within 1e-6
relative; u and v within 1e-4 absolute. XLA:CPU contracts multiply-adds
into FMAs (about 60% of its leaf-test u values differ from the unfused
expression by a few ULPs), and the leaf test's cancelling products carry
those ULPs into the barycentrics (measured up to 2.7e-5 on the 10-unit floor
triangles); the port keeps every product separately rounded so that the
CUDA kernel and this plain version stay bit-equal to each other."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrt_tpu.bvh import twolevel as jtl
from mrt_tpu.bvh import wide as jwide
from mrt_tpu.core.types import Rays as JRays
from mrt_tpu_torch import convert
from mrt_tpu_torch.bvh import intersect, twolevel
from mrt_tpu_torch.core.types import Rays
from mrt_tpu_torch.engine.scene import world_geometry
from mrt_tpu_torch.kernels import traverse2
from mrt_tpu_torch.utils import bounds
from test_torch_scene_bvh import SCENES, jax_sah, one_torch_thread  # noqa: F401

N = 4096


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    js = SCENES[request.param]()
    jd, jst = js.compile()
    with jax_sah():
        jb = jtl.build(js.models, jd, jst.skin_slices, host_mirror=js.host_mirror)
    pd, _, pb = convert.compiled(jd, jst, jb, device="cpu")
    pos_w, _, _ = world_geometry(pd)
    idx = pd.indices.long()
    tris = tuple(pos_w[idx[:, k]] for k in range(3))
    rng = np.random.default_rng(len(request.param))
    o = ((rng.random((N, 3)) * 2 - 1) * 5).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1])
    d = rng.standard_normal((N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dist = (0.5 + 5.5 * rng.random(N)).astype(np.float32)
    shadow = rng.random(N) < 0.5
    mask = rng.random(N) < 0.9
    return dict(jb=jb, pb=pb, tris=tris, o=o, d=d, dist=dist, shadow=shadow, mask=mask)


def _jrays(s, dist):
    return JRays(jnp.asarray(s["o"]), jnp.asarray(s["d"]), jnp.asarray(dist))


def _prays(s, dist):
    return Rays(torch.as_tensor(s["o"]), torch.as_tensor(s["d"]), torch.as_tensor(dist))


def _check_hits(s, jh, ph, live):
    jt, pt = np.asarray(jh.triangle), ph.triangle.numpy()
    assert np.array_equal(jt >= 0, pt >= 0)
    diff = np.nonzero((jt != pt) & live)[0]
    if diff.size:
        # every disagreement must be an equal-t tie by the brute-force oracle
        o = torch.as_tensor(s["o"][diff])[:, None]
        d = torch.as_tensor(s["d"][diff])[:, None]
        v0, v1, v2 = (torch.stack([t[jt[diff]], t[pt[diff]]], 1) for t in s["tris"])
        hit, t, _, _ = intersect.ray_triangle(o, d, v0, v1, v2)
        assert bool(hit.all())
        assert bool(((t[:, 0] - t[:, 1]).abs() <= 1e-5 * t.abs().amax(1).clamp_min(1)).all())
    assert diff.size <= N // 100, f"{diff.size} tie flips"
    both = (jt >= 0) & (jt == pt)
    np.testing.assert_allclose(ph.t.numpy()[both], np.asarray(jh.t)[both], rtol=1e-6)
    for a, b in ((ph.u, jh.u), (ph.v, jh.v)):
        np.testing.assert_allclose(a.numpy()[both], np.asarray(b)[both], rtol=0, atol=1e-4)
    return diff


def test_closest_hit_matches(scene):
    inf = np.full(N, np.inf, np.float32)
    mask = scene["mask"]
    jh = jtl.closest_hit(scene["jb"], _jrays(scene, inf), mask=jnp.asarray(mask))
    ph = twolevel.closest_hit(scene["pb"], _prays(scene, inf), mask=torch.as_tensor(mask))
    _check_hits(scene, jh, ph, mask)
    assert not bool((ph.triangle.numpy() >= 0)[~mask].any())


def test_any_hit_matches(scene):
    jo = np.asarray(jtl.any_hit(scene["jb"], _jrays(scene, scene["dist"])))
    po = twolevel.any_hit(scene["pb"], _prays(scene, scene["dist"])).numpy()
    assert np.array_equal(jo, po)
    assert 0 < po.sum() < N


def test_trace_mixed_matches(scene):
    dist = np.where(scene["shadow"], scene["dist"], np.inf).astype(np.float32)
    sh, mask = scene["shadow"], scene["mask"]
    jh, jocc = jtl.trace_mixed(scene["jb"], _jrays(scene, dist), jnp.asarray(sh),
                               mask=jnp.asarray(mask))
    ph, pocc = twolevel.trace_mixed(scene["pb"], _prays(scene, dist), torch.as_tensor(sh),
                                    mask=torch.as_tensor(mask))
    assert np.array_equal(np.asarray(jocc), pocc.numpy())
    closest = mask & ~sh
    _check_hits(scene, jh._replace(triangle=jnp.where(jnp.asarray(closest), jh.triangle, -1)),
                ph._replace(triangle=torch.where(torch.as_tensor(closest), ph.triangle, -1)), closest)


def test_brute_force_agrees_with_traversal(scene):
    """The torch oracle and the traversal agree on the same port tables."""
    n = 256
    inf = np.full(N, np.inf, np.float32)
    rays = _prays(scene, inf)
    rays = Rays(rays.origin[:n], rays.direction[:n], rays.max_distance[:n])
    want = intersect.brute_force_closest_hit(rays, *scene["tris"])
    got = twolevel.closest_hit(scene["pb"], rays)
    assert torch.equal(got.triangle >= 0, want.triangle >= 0)
    hit = want.triangle >= 0
    np.testing.assert_allclose(got.t[hit].numpy(), want.t[hit].numpy(), rtol=1e-5, atol=1e-6)


def test_brute_force_any_hit_agrees(scene):
    """Occlusion within finite distances: the any-hit oracle and the shadow
    traversal agree, except for rays whose nearest hit lies within 1e-5
    relative of the distance limit (either side may round it in)."""
    n = 256
    rays = _prays(scene, scene["dist"])
    rays = Rays(rays.origin[:n], rays.direction[:n], rays.max_distance[:n])
    want = intersect.brute_force_any_hit(rays, *scene["tris"])
    got = twolevel.any_hit(scene["pb"], rays)
    diff = torch.nonzero(want != got).squeeze(1)
    if diff.numel():
        near = intersect.brute_force_closest_hit(
            Rays(rays.origin[diff], rays.direction[diff], torch.full((diff.numel(),), float("inf"))),
            *scene["tris"])
        lim = rays.max_distance[diff]
        assert bool(((near.t - lim).abs() <= 1e-5 * lim).all())
    assert 0 < int(got.sum()) < n


def _plain(scene, dist, shadow, mask=None):
    n = scene["o"].shape[0]
    return twolevel._traverse(scene["pb"], _prays(scene, dist),
                              torch.as_tensor(np.broadcast_to(shadow, (n,)).copy()),
                              None if mask is None else torch.as_tensor(mask), 0.0)


@pytest.mark.parametrize("kind,sort_rays", [("closest", True), ("any", False)])
def test_pops_match_jax(scene, kind, sort_rays):
    """Per-lane pops of the plain version (what the kernel must equal bit for
    bit on the card) equal the JAX package's count_pops on the same tables
    and rays. Tolerance: exact, except on the closest-hit lanes that
    _check_hits finds to be equal-t ties (the two packages may then keep
    different triangles, and a different best_t culls different rows
    afterwards). Sorting the rays in JAX changes no lane's count."""
    mask = scene["mask"]
    if kind == "closest":
        inf = np.full(N, np.inf, np.float32)
        jh, jpops = jtl.closest_hit(scene["jb"], _jrays(scene, inf), mask=jnp.asarray(mask),
                                    count_pops=True, sort_rays=sort_rays)
        out = _plain(scene, inf, False, mask)
        skip = _check_hits(scene, jh, twolevel._hits(scene["pb"], out), mask)
    else:
        jo, jpops = jtl.any_hit(scene["jb"], _jrays(scene, scene["dist"]), mask=jnp.asarray(mask),
                                count_pops=True, sort_rays=sort_rays)
        out = _plain(scene, scene["dist"], True, mask)
        assert np.array_equal(np.asarray(jo), out.found.numpy())
        skip = np.zeros(0, np.int64)
    keep = np.ones(N, bool)
    keep[skip] = False
    jpops, pops = np.asarray(jpops), out.pops.numpy()
    assert np.array_equal(pops[keep], jpops[keep])
    assert not pops[~mask].any() and pops[mask].min() >= 1


def test_work_totals_sum_to_pops(scene):
    """The work that utils/bounds.py reads from the plain version's per-row
    visits: the pops by row type add up to the per-lane pops; entries are a
    subset of instance pops; each internal pop tests 1 to 8 children and
    each leaf pop 1 to 12 triangles; the bound prices them at the counts of
    the kernel's header note, bytes at the float4s each distinct row needs,
    at half the data sheet's f32 rate (no fused multiply-adds)."""
    pb = scene["pb"]
    dist = np.where(scene["shadow"], scene["dist"], np.inf).astype(np.float32)
    out = _plain(scene, dist, scene["shadow"], scene["mask"])
    w = bounds.k2_work(pb.table, pb.n_internal, pb.n_leaf, out.visits)
    n_int, n_leaf, n_inst = w["pops_internal"], w["pops_leaf"], w["pops_instance"]
    assert n_int + n_leaf + n_inst == int(out.pops.sum()) == int(out.visits[:, 0].sum())
    assert 0 < w["entered"] <= n_inst and 0 < w["rows_entered"] <= w["rows_instance"]
    assert not out.visits[:pb.n_internal + pb.n_leaf, 1].any()
    assert n_int <= w["children"] <= 8 * n_int and 0 < n_leaf <= w["triangles"] <= 12 * n_leaf
    assert 0 < w["rows_internal"] <= pb.n_internal
    assert 0 < w["leaf_groups"] <= 3 * int((out.visits[pb.n_internal:pb.n_internal + pb.n_leaf, 0] > 0).sum())
    n_live = int(scene["mask"].sum())
    ms, by = bounds.k2(w, N, n_live)
    ops = (n_int * 9 + w["children"] * 27 + n_leaf + w["triangles"] * 59 + n_inst * 34
           + w["entered"] * 33)
    nbytes = (w["rows_internal"] * 224 + w["leaf_groups"] * 160 + w["rows_instance"] * 32
              + w["rows_entered"] * 48 + n_live * 55 + (N - n_live) * 30)
    assert w["ops"] == ops
    assert ms == pytest.approx(max(ops / 33.5e12, nbytes / 3.35e12) * 1e3, rel=1e-12)
    assert by == ("operations" if ops / 33.5e12 >= nbytes / 3.35e12 else "bytes")


def test_k1_bound():
    """K1 moves 5 B and does 6 f32 operations per value: bytes bind."""
    ms, by = bounds.k1((1080, 1920, 3))
    assert by == "bytes" and ms == pytest.approx(1080 * 1920 * 3 * 5 / 3.35e12 * 1e3, rel=1e-12)


def test_compaction_edges_on_plain_version(scene):
    """The wavefront edges the kernel's live-lane compaction must get right,
    on the plain version: every lane dead gives the miss record and no pops;
    one live lane at the end of the wavefront equals that ray traced alone."""
    pb = scene["pb"]
    dist = scene["dist"]
    dead = _plain(scene, dist, False, np.zeros(N, bool))
    assert torch.equal(dead.t, torch.as_tensor(dist))
    assert bool((dead.tri == -1).all() and (dead.inst == -1).all() and not dead.found.any())
    assert not bool(dead.u.any() or dead.v.any() or dead.pops.any())
    assert int(dead.visits.sum()) == 0
    last = np.zeros(N, bool)
    last[-1] = True
    one = _plain(scene, dist, False, last)
    alone = traverse2.traverse_plain(
        pb.table, pb.n_internal, pb.n_leaf, pb.tlas_n, pb.stack_size,
        torch.as_tensor(scene["o"][-1:]), torch.as_tensor(scene["d"][-1:]),
        torch.as_tensor(dist[-1:]), torch.zeros(1, dtype=torch.bool), torch.ones(1, dtype=torch.bool))
    for f in ("t", "tri", "inst", "u", "v", "found", "pops"):
        assert torch.equal(getattr(one, f)[-1:], getattr(alone, f)), f
    assert int(one.pops[:-1].abs().sum()) == 0 and int(one.pops[-1]) >= 1


def test_kernel_wrapper_rejects_other_devices(scene):
    pb = scene["pb"]
    meta = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError):
        traverse2.traverse(pb.table, pb.n_internal, pb.n_leaf, pb.tlas_n, pb.stack_size, meta,
                           meta, torch.zeros(4, device="meta"),
                           torch.zeros(4, dtype=torch.bool, device="meta"),
                           torch.zeros(4, dtype=torch.bool, device="meta"))
    assert traverse2.launches == 0  # CPU tensors never reach the kernel


@pytest.mark.parametrize("kind", ["closest", "any"])
def test_float_sort_pops_match_jax(scene, kind, monkeypatch):
    """The float child sort that tables above 2^20 - 1 rows take, forced on
    these small tables in both packages by lowering the packed key's row
    limit: per-lane pops equal the JAX package's float-sort traversal (the
    network's pop order, which K2's float-sort instantiation must equal on
    the card), with the ties of test_pops_match_jax; occlusion equal to the
    packed sort's, and the closest hits, t, u and v bit-equal to its, since
    the order of the visits changes no closest hit but an equal-t tie."""
    mask = scene["mask"]
    inf = np.full(N, np.inf, np.float32)
    dist, shadow = (inf, False) if kind == "closest" else (scene["dist"], True)
    packed = _plain(scene, dist, shadow, mask)
    monkeypatch.setattr(jwide, "_META_MASK", 1)
    monkeypatch.setattr(traverse2, "_META_MASK", 1)
    assert traverse2.variant(scene["pb"].table.shape[0], masked=False) == "float_sort"
    out = _plain(scene, dist, shadow, mask)
    skip = np.zeros(0, np.int64)
    if kind == "closest":
        jh, jpops = jtl.closest_hit(scene["jb"], _jrays(scene, dist), mask=jnp.asarray(mask),
                                    count_pops=True)
        skip = _check_hits(scene, jh, twolevel._hits(scene["pb"], out), mask)
    else:
        jo, jpops = jtl.any_hit(scene["jb"], _jrays(scene, dist), mask=jnp.asarray(mask),
                                count_pops=True, sort_rays=False)
        assert np.array_equal(np.asarray(jo), out.found.numpy())
    keep = np.ones(N, bool)
    keep[skip] = False
    assert np.array_equal(out.pops.numpy()[keep], np.asarray(jpops)[keep])
    assert np.array_equal(out.found.numpy(), packed.found.numpy())
    if kind == "closest":  # a shadow lane keeps whichever hit it finds first
        same = (out.tri == packed.tri).numpy()
        assert same.sum() >= N - N // 100
        for f in ("t", "u", "v"):
            a, b = getattr(out, f).numpy()[same], getattr(packed, f).numpy()[same]
            assert np.array_equal(a.view(np.int32), b.view(np.int32)), f
