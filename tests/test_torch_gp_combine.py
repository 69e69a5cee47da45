"""A gp step's hit combine and shadow occlusion over its live lanes only:
kernels K15 (``kernels/wavefront.gp_hit_keys``), K13's scan and gather
(``gp_scan``, ``gp_gather``) and K16 (``gp_lane_unpack``) with the
in-place collectives between them (``comm.pmin_``, ``psum_``, ``pmax_``),
all through their plain versions here, against the full-width reference
(``render/wavefront.combine_hits_across``, ``_tri_rows``, ``comm.pmax``)
and mrt_tpu's ``combine_hits_across``.

One gloo world of 4 ranks on the CPU, spawned once for the module
(``world``): gp=4 on a ``("gp",)`` mesh and gp=2 on a ``(dp, gp) = (2, 2)``
mesh, the rank-side cases in ``gp_combine_ranks.py``. Hits from a seed per
rank (``_rank_hits``): t from a small set (ties across ranks), lanes every
rank misses, lanes one rank alone hits, lanes where a rank has a finite t
and no triangle, -0.0 in u, v and the rows; live shares 1.0, 0.3 and 0.0.
Bars: bit for bit on every live lane (t, triangle, u, v, the rows of the
hit triangle; zeros for a live lane without a hit); the occlusion on every
lane in need; mrt_tpu's combine bit for bit. The drawn gp frames' steps
issue exactly ``pmin_`` of n_live int64 keys, one ``psum_`` of n_live x
(3 + 16 [+ 18]) int32, ``pmax_`` of n_live uint8 and on a banded atlas
K14's ``psum_`` of n_live x 16, and no collective over a whole tensor copy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P
from torch._subclasses.fake_tensor import FakeTensorMode

import gp_combine_ranks as R
from mrt_tpu.core import types as JT
from mrt_tpu.render import wavefront as jwf
from mrt_tpu_torch.bvh import wide
from mrt_tpu_torch.core import types as T
from mrt_tpu_torch.dist import comm
from mrt_tpu_torch.dist import launch as L
from mrt_tpu_torch.kernels import wavefront as W
from mrt_tpu_torch.render import wavefront as wf
from test_torch_dist_gp import OFFSETS, _scene, _settings
from test_torch_scene_bvh import one_torch_thread  # noqa: F401

WORLD = 4
CPU = {"device": "cpu"}
LANES = 160
GPS = (2, 4)
SHARES = (1.0, 0.3, 0.0)
TRIS_PER_RANK = 64


def _rank_hits(gp: int, seed: int = 31):
    """(t, tri, u, v), each (gp, LANES): each rank's closest hits over the
    same lanes; rank r hits only triangles r + gp k (its shard)."""
    rng = np.random.default_rng(seed + gp)
    t = rng.choice(np.float32([1.0, 2.0, 2.5, np.inf]), (gp, LANES)).astype(np.float32)
    t[:, :8] = np.inf  # every rank misses
    for lane in range(8, 16):  # one rank alone hits
        t[:, lane] = np.inf
        t[lane % gp, lane] = 3.0
    ranks = np.arange(gp)[:, None]
    tri = np.where(np.isinf(t), -1, ranks + gp * rng.integers(0, TRIS_PER_RANK, (gp, LANES)))
    tri = tri.astype(np.int32)
    # a rank with a finite t and no triangle: the combined t is its t, no winner
    t[0, 16:20], tri[0, 16:20] = 0.5, -1
    u = rng.random((gp, LANES)).astype(np.float32)
    v = rng.random((gp, LANES)).astype(np.float32)
    u[:, 20:24] = np.float32(-0.0)
    v[:, 24:28] = np.float32(-0.0)
    return t, tri, u, v


def _shard(gp: int, r: int, seed: int = 32):
    """Rank r's shard of gp: its shade and motion rows (-0.0 among them) and
    g2l over the gp x TRIS_PER_RANK global triangles."""
    rng = np.random.default_rng(seed + 10 * gp + r)
    shade = rng.standard_normal((TRIS_PER_RANK, 16)).astype(np.float32)
    motion = rng.standard_normal((TRIS_PER_RANK, 18)).astype(np.float32)
    shade[::5, 3] = np.float32(-0.0)
    motion[::7, 2] = np.float32(-0.0)
    ids = np.arange(gp * TRIS_PER_RANK)
    g2l = np.where(ids % gp == r, ids // gp, -1).astype(np.int32)
    return shade, motion, g2l


def _lanes(share: float, seed: int = 33):
    """(live, occluded by gp rank, need): the step's live lanes, each gp
    rank's shadow rays' occlusion and the lanes in need (live lanes only,
    the same on every rank)."""
    rng = np.random.default_rng(seed + int(share * 10))
    live = rng.random(LANES) < share
    occluded = rng.random((4, LANES)) < 0.4
    need = live & (rng.random(LANES) < 0.7)
    return live, occluded, need


def _case_args(gp: int, share: float, gp_index):
    t, tri, u, v = _rank_hits(gp)
    live, occluded, need = _lanes(share)
    out = []
    for rank in range(WORLD):
        g = gp_index(rank)
        shade, motion, g2l = _shard(gp, g)
        out.append(tuple(torch.as_tensor(a) for a in (t[g], tri[g], u[g], v[g], live, shade, motion,
                                                      g2l, occluded[g], need)))
    return out


@pytest.fixture(scope="module")
def jax_combined():
    """mrt_tpu's combine_hits_across on ``_rank_hits(gp)`` over gp virtual
    devices, for each gp: (t, triangle, u, v), each (gp, LANES)."""
    out = {}
    for gp in GPS:
        mesh = JMesh(np.asarray(jax.devices()[:gp]), ("gp",))

        def comb(t, tri, u, v):
            h = jwf.combine_hits_across(JT.Hits(t=t, triangle=tri, u=u, v=v), "gp")
            return h.t, h.triangle, h.u, h.v

        f = jax.jit(jax.shard_map(comb, mesh=mesh, in_specs=(P("gp"),) * 4,
                                  out_specs=(P("gp"),) * 4, check_vma=False))
        out[gp] = [np.asarray(x).reshape(gp, LANES)
                   for x in f(*(jnp.asarray(a.reshape(-1)) for a in _rank_hits(gp)))]
    return out


@pytest.fixture(scope="module")
def world():
    """The rank-side cases in one 4-rank gloo world: by gp the combine
    cases of each share and the in-place collectives' cases (results by
    rank), and two drawn gp frames with their steps recorded."""
    meshes = {4: ({"gp": 4}, lambda r: r), 2: ({"dp": 2, "gp": 2}, lambda r: r % 2)}
    jobs = []
    for gp in GPS:
        shape, gp_index = meshes[gp]
        calls = [("gp", R.combine_case, _case_args(gp, s, gp_index)) for s in SHARES]
        calls += [("gp", L.caught, [(R.in_place, fn, torch.full((6,), float(r)))
                                    for r in range(WORLD)]) for fn in (comm.pmin_, comm.pmax_)]
        calls += [("gp", L.caught, [(fn, torch.ones(7 + r, dtype=torch.int64))
                                    for r in range(WORLD)]) for fn in (comm.pmin_, comm.pmax_)]
        jobs.append((L.on_mesh, (shape, calls), CPU))
    jobs += [
        (L.drive, ("gp", _scene(nmap=True), _settings(T), {"gp": 4}, 1),
         dict(offsets=OFFSETS, banded=True, record_rows=True, **CPU)),
        (L.drive, ("gp", _scene(), _settings(T), {"dp": 2, "gp": 2}, 1),
         dict(offsets=OFFSETS, banded=False, record_rows=True, **CPU)),
    ]
    res = L.launch(L.run_jobs, WORLD, jobs, **CPU)
    return {2: [r[0] for r in res], 4: [r[1] for r in res],
            "gp4_nmap": [r[2] for r in res], "dp_gp": [r[3] for r in res]}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


CASES = [(gp, s) for gp in GPS for s in SHARES]


@pytest.mark.parametrize("gp,share", CASES)
def test_live_combine_is_combine_hits_across(world, gp, share):
    """On every rank, at every live lane: the record K16 wrote (t, triangle,
    u, v) equals the full-width ``combine_hits_across`` bit for bit, and the
    rows of the psum (shade and motion) equal ``_tri_rows`` of the combined
    triangle bit for bit, zeros where no rank hit; the payload holds the
    triangle + 1 and u, v's bits; the map is the scan of the live flags.
    The hits hold ties, misses on every rank, one rank alone hitting, a
    rank with a finite t and no triangle, and -0.0 in u, v and the rows."""
    live, _, _ = _lanes(share)
    lanes = np.flatnonzero(live)
    for rank, out in enumerate(world[gp]):
        c = out["results"][SHARES.index(share)]
        np.testing.assert_array_equal(c["lane_of"], lanes)
        np.testing.assert_array_equal(c["pos"], np.where(live, np.cumsum(live) - 1, -1))
        for f in ("t", "tri", "u", "v"):
            assert (_bits(c[f"live_{f}"])[lanes] == _bits(c[f"ref_{f}"])[lanes]).all(), (rank, f)
        hit = c["ref_tri"][lanes] >= 0
        for f in ("shade", "motion"):
            want = np.where(hit[:, None], c[f"ref_{f}"][lanes], np.float32(0.0))
            assert (_bits(c[f"live_{f}"]) == _bits(want)).all(), (rank, f)
        pay = c["payload"]
        np.testing.assert_array_equal(pay[:, 0], c["ref_tri"][lanes] + 1)
        np.testing.assert_array_equal(pay[:, 1], _bits(c["ref_u"])[lanes])
    if share == 1.0:
        tri = world[gp][0]["results"][0]["ref_tri"]
        assert (tri[:8] == -1).all() and (tri[8:16] >= 0).all() and (tri[16:20] == -1).all()
        assert np.isfinite(world[gp][0]["results"][0]["ref_t"][16:20]).all()
    assert (lanes.size == 0) == (share == 0.0)


@pytest.mark.parametrize("gp,share", CASES)
def test_live_occlusion_is_the_full_width_pmax(world, gp, share):
    """K15's second form, ``pmax_`` of the live lanes' uint8 and K16's
    second form: on every rank the occlusion of every lane in need (a live
    lane that cast a shadow ray) equals the full-width ``pmax``'s."""
    for out in world[gp]:
        c = out["results"][SHARES.index(share)]
        need = c["need"]
        np.testing.assert_array_equal(c["live_occ"][need], c["ref_occ"][need])
        assert c["live_occ"].dtype == np.bool_
    assert world[gp][0]["results"][SHARES.index(share)]["need"].any() == (share > 0)


@pytest.mark.parametrize("gp,share", CASES)
def test_live_combine_matches_mrt_tpu(world, jax_combined, gp, share):
    """The live-lane combine on every rank equals mrt_tpu's
    ``combine_hits_across`` on the same hits, bit for bit, at every live
    lane."""
    live, _, _ = _lanes(share)
    for rank, out in enumerate(world[gp]):
        g = rank % gp
        c = out["results"][SHARES.index(share)]
        for f, theirs in zip(("t", "tri", "u", "v"), jax_combined[gp]):
            assert (_bits(c[f"live_{f}"])[live] == _bits(theirs[g])[live]).all(), (rank, f)


@pytest.mark.parametrize("gp", GPS)
def test_in_place_min_max_sizes_must_agree(world, gp):
    """``comm.pmin_`` and ``pmax_`` in the CPU world: of one size on every
    rank they reduce in place (the tensor returned is the one passed); of
    sizes that differ between ranks they raise ValueError on every rank,
    naming the sizes, and the world goes on."""
    for rank, out in enumerate(world[gp]):
        low, high, bad_min, bad_max = out["results"][len(SHARES):]
        # the ranks of this rank's gp group: the (dp, gp) mesh is row-major
        group = list(range(WORLD)) if gp == WORLD else [rank - rank % gp + k for k in range(gp)]
        for res, want in ((low, min(group)), (high, max(group))):
            assert res[0] == "returned" and res[1][0]
            np.testing.assert_array_equal(res[1][1], np.full(6, want, np.float32))
        for bad, name in ((bad_min, "pmin_"), (bad_max, "pmax_")):
            assert bad[0] == "raised" and bad[1] == "ValueError" and name in bad[2]
        lo, hi = 7 + min(group), 7 + max(group)
        assert f"between {lo} and {hi}" in bad_min[2]


def test_in_place_collectives_on_an_axis_of_one_rank():
    """An axis of size 1 reduces nothing: ``pmin_``, ``pmax_`` and
    ``psum_`` return the tensor they were given, unchanged, with no process
    group."""
    axis = comm.Axis("gp", 1, 0, None)
    for fn in (comm.pmin_, comm.pmax_, comm.psum_):
        x = torch.arange(5, dtype=torch.int64)
        assert fn(x, axis) is x
        np.testing.assert_array_equal(x.numpy(), np.arange(5))


@pytest.mark.parametrize("job", ["gp4_nmap", "dp_gp"])
def test_gp_step_issues_three_live_lane_collectives(world, job):
    """The drawn gp frames on the kernel route (``drive(record_rows=True)``
    counting every collective of ``comm``): each step issues exactly
    ``pmin_`` of n_live int64 keys, one ``psum_`` of n_live x (3 + 16 + 18)
    int32 (the normal map's motion rows) or x (3 + 16), on the banded
    atlas K14's ``psum_`` of n_live x 16, and ``pmax_`` of n_live uint8;
    none reduces a whole tensor copy (``comm.psum``/``pmin``/``pmax``) and
    none is sized by the lanes where fewer are live. The ranks of a gp group
    recorded the same (a dp row block each: (dp, gp) = (2, 2) has two)."""
    taps = job == "gp4_nmap"
    n_gp = 4 if taps else 2
    recs = [x["rows_psums"] for x in world[job]]
    assert all(recs[r] == recs[r - r % n_gp] for r in range(WORLD))
    steps = [st for r in range(0, WORLD, n_gp) for st in recs[r]]
    assert len(steps) > 1 and min(st["live"] for st in steps) < steps[0]["lanes"]
    for st in steps:
        n = st["live"]
        cols = 16 + 18 * taps
        want = ([("pmin_", n, 8 * n), ("psum_", n * (3 + cols), 4 * n * (3 + cols))]
                + [("psum_", n * 16, 4 * n * 16)] * taps + [("pmax_", n, n)])
        got = [(c["op"], c["elements"], c["bytes"]) for c in st["collectives"]]
        assert got == want, (st, got)
        assert all(c["ranks"] == (4 if taps else 2) for c in st["collectives"])
    summary = L.collectives_summary(steps)
    assert summary["copying"] == 0 and summary["count"] == [3 + taps] * len(steps)
    assert summary["bytes"] == [st["live"] * (8 + 4 * (3 + 16 + 18 * taps) + 64 * taps + 1)
                                for st in steps]
    assert summary["ops"] == ["pmax_", "pmin_", "psum_"]


def test_hit_keys_order_is_the_reference_order():
    """``hit_keys_of``: over t >= 0 and +inf the keys' order is (t, r')'s,
    r' the rank where the triangle is >= 0 (else ``NO_WINNER``), so their
    minimum gives the reference's t_min and winning rank; over more than
    one rank -0.0 ties +0.0 (the reference compares floats) and the lower
    rank wins."""
    rng = np.random.default_rng(34)
    t = rng.choice(np.float32([0.0, 0.25, 1.0, 1.0000001, 3.0e38, np.inf]), 400).astype(np.float32)
    rank = rng.integers(0, 4, 400)
    tri = np.where(rng.random(400) < 0.8, 5, -1).astype(np.int32)
    keys = torch.cat([W.hit_keys_of(torch.as_tensor(t[k:k + 1]), torch.as_tensor(tri[k:k + 1]),
                                    int(rank[k]), True) for k in range(400)]).numpy()
    low = np.where(tri >= 0, rank, W.NO_WINNER)
    assert (np.argsort(keys, kind="stable") == np.lexsort((low, t))).all()
    zero = W.hit_keys_of(torch.tensor([0.0]), torch.tensor([3], dtype=torch.int32), 1, True)
    neg = W.hit_keys_of(torch.tensor([-0.0]), torch.tensor([3], dtype=torch.int32), 0, True)
    assert int(neg) < int(zero) and int(neg) >> 32 == int(zero) >> 32 == 0
    kept = W.hit_keys_of(torch.tensor([-0.0]), torch.tensor([3], dtype=torch.int32), 0, False)
    assert int(kept) >> 32 == -(1 << 31)  # an axis of one rank keeps the bits as they are


def test_no_hit_has_a_negative_or_nan_t():
    """The key needs every hit's t >= 0 (or +inf on a miss): the flat
    traversal (K3's plain version, as a gp step traces its shard) over
    random triangles with rays from on and around them, some along their
    planes and some with NaN or zero directions, records t >= 0 and not
    NaN wherever it hit a triangle, and the ray's max distance (+inf)
    wherever it did not."""
    rng = np.random.default_rng(35)
    n = 300
    base = rng.random((n, 3)).astype(np.float32) * 4 - 2
    v0, v1, v2 = base, base + rng.random((n, 3)).astype(np.float32), base + rng.random(
        (n, 3)).astype(np.float32)
    bvh = wide.build(*(torch.as_tensor(x) for x in (v0, v1, v2)), device="cpu")
    m = 4000
    pick = rng.integers(0, n, m)
    a, b = rng.random((m, 1)).astype(np.float32) * 0.5, rng.random((m, 1)).astype(np.float32) * 0.5
    on = v0[pick] + a * (v1[pick] - v0[pick]) + b * (v2[pick] - v0[pick])  # on a triangle
    origin = np.where(rng.random((m, 1)) < 0.5, on, rng.random((m, 3)) * 6 - 3).astype(np.float32)
    d = rng.standard_normal((m, 3)).astype(np.float32)
    d[::50] = (v1[pick] - v0[pick])[::50]  # along the triangle's plane
    d[1::97] = np.nan
    d[2::101] = 0.0
    rays = T.Rays(torch.as_tensor(origin), torch.as_tensor(d), torch.full((m,), float("inf")))
    out = wide.closest_raw(bvh, rays, torch.zeros(m, dtype=torch.bool))
    hit = out.tri >= 0
    assert int(hit.sum()) > m // 4
    assert not torch.isnan(out.t[hit]).any() and bool((out.t[hit] >= 0).all())
    assert bool(torch.isinf(out.t[~hit]).all() & (out.t[~hit] > 0).all())


def test_gp_combine_wrappers_raise_on_cuda_tensors_without_a_card():
    """On CUDA tensors (fake ones: there is no card here) the wrappers of
    K13's scan and gather, K15 (both forms) and K16 (both forms) go to their
    kernels, which cannot build or launch here, and raise; they never run
    their plain versions, and count no launch."""
    before = dict(W.launches)
    axis = comm.Axis("gp", 2, 1, None)
    shade, motion, g2l = _shard(2, 1)
    with FakeTensorMode(allow_non_fake_inputs=True):

        def cuda(shape, dtype=torch.float32):  # a fake CUDA tensor
            return torch.zeros(shape, dtype=dtype, device="cuda")

        t, u, v = cuda(8), cuda(8), cuda(8)
        tri, lane_of, counts = cuda(8, torch.int32), cuda(8, torch.int32), cuda(1, torch.int32)
        live, occluded = cuda(8, torch.bool), cuda(8, torch.bool)
        keys, occ = cuda(8, torch.int64), cuda(8, torch.uint8)
        payload = cuda((8, W.PAYLOAD_COLS), torch.int32)
        out = cuda(8 * (16 + W.PAYLOAD_COLS))
        geom = wf.Geometry(None, None, None, None, None, None, cuda(shade.shape),
                           cuda(motion.shape), None, g2l=cuda(g2l.shape, torch.int32), axis=axis)
    calls = [lambda: W.gp_scan(live, 8, pos=lane_of, lane_of=lane_of, counts=counts),
             lambda: W.gp_hit_keys(t, tri, lane_of, axis, out=keys),
             lambda: W.gp_occluded_rows(occluded, lane_of, out=occ),
             lambda: W.gp_gather(geom, t, tri, u, v, keys, lane_of, out=out),
             lambda: W.gp_lane_unpack(keys, payload, lane_of, t, tri, u, v),
             lambda: W.gp_occluded_lanes(occ, lane_of, occluded)]
    for call in calls:
        with pytest.raises(RuntimeError):
            call()
    assert W.launches == before
