"""The gp step's kernel route on the CPU, without a world: kernels K13
(``kernels/wavefront.gp_rows``) and K14 (``banded_taps``) through their
plain versions, against the unsharded rows and the whole atlas's sample, and
against the JAX package's ``build_geometry`` rows and banded share.

Scenes: ``test_torch_dist_gp.py``'s 32x32 textured sphere and plane with a
normal map on the plane, compiled by both packages. The rows cover only the
live lanes, compacted in lane order (row j is lane ``lane_of[j]``'s). Bars:
K13's position map is the scan of the live flags; its rows summed over
every shard (as the psum over gp sums them) equal the unsharded rows and
JAX's at lane ``lane_of[j]`` bit for bit (-0.0 aside: a sum with zeros
makes it +0.0); K14's shares summed over the bands equal the port's
whole-atlas sample at the row's lane's coordinate bit for bit (-0.0
aside), each band's share within 1e-6 of JAX's (the bar of
``test_sample_packed_banded_matches_mrt_tpu``). A gp frame takes the
kernel route (K6-K8's wrappers, ``lane_rows`` and K7's lane-row form), and
on CUDA tensors without a card the wrappers raise rather than run their
plain versions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P
from torch._subclasses.fake_tensor import FakeTensorMode

from mrt_tpu.assets import texture as jtex
from mrt_tpu.render import wavefront as jwf
from mrt_tpu_torch.assets import texture as tex
from mrt_tpu_torch.core import types as T
from mrt_tpu_torch.dist import comm
from mrt_tpu_torch.dist import geometry as G
from mrt_tpu_torch.dist import route_check
from mrt_tpu_torch.engine import scene as scene_mod
from mrt_tpu_torch.kernels import wavefront as W
from mrt_tpu_torch.render import wavefront as wf
from test_torch_dist_gp import _jscene, _scene, _settings
from test_torch_scene_bvh import _bits_equal, one_torch_thread  # noqa: F401
from test_torch_wavefront_list import on_route, route_spy

LANES = 300
N_SHARDS = 4


def _plus_zero(a):
    """``a`` with -0.0 made +0.0 (what a sum with zeros does)."""
    return np.asarray(a, np.float32) + np.float32(0.0)


@pytest.fixture(scope="module")
def scene():
    """The normal-mapped textured scene compiled by the port (its world
    geometry and unsharded Geometry) and by the JAX package."""
    sd, statics = _scene(nmap=True).compile("cpu")
    world = scene_mod.world_geometry(sd)
    jdata, _ = _jscene(nmap=True).compile()
    return dict(sd=sd, statics=statics, world=world, full=wf.build_geometry(sd, *world),
                jdata=jdata)


@pytest.mark.parametrize("form", ["step", "prim"])
def test_gp_rows_summed_over_shards_are_the_rows(scene, form):
    """K13's plain version on every shard of ``build_shard_geometry`` (4
    shards), summed: a step's shade and motion rows of the live lanes
    ("step"; 80 % live), or the motion rows of every lane ("prim", sample
    0's first hits), compacted in lane order, zeros where a lane has no
    hit; every shard gives the same map, and row j equals the unsharded
    rows and JAX's ``build_geometry`` rows from the same world vertices (as
    NumPy) at lane ``lane_of[j]``'s triangle, bit for bit, -0.0 aside."""
    sd, full = scene["sd"], scene["full"]
    n = full.shade_rows.shape[0]
    rng = np.random.default_rng(21)
    ids = rng.integers(-1, n, LANES).astype(np.int32)
    live = rng.random(LANES) < 0.8 if form == "step" else None
    shade, motion = form == "step", True
    shards, _ = G.build_sharded_bvhs(*(t.numpy() for t in (full.tri_v0, full.tri_v1,
                                                            full.tri_v2)), N_SHARDS, device="cpu")
    total, maps = None, []
    for k, (_, gids, _) in enumerate(shards):
        geom = G.build_shard_geometry(sd, *scene["world"], gids, n,
                                      comm.Axis("gp", N_SHARDS, k, None))
        part, pos, lane_of = W.gp_rows_plain(geom, torch.as_tensor(ids),
                                             None if live is None else torch.as_tensor(live),
                                             shade, motion)
        maps.append((pos.numpy(), lane_of.numpy()))
        total = part if total is None else total + part
    lanes = np.arange(LANES) if live is None else np.flatnonzero(live)
    for pos, lane_of in maps:
        np.testing.assert_array_equal(lane_of, lanes)
        np.testing.assert_array_equal(pos[lanes], np.arange(lanes.size))
        assert (pos[np.setdiff1d(np.arange(LANES), lanes)] == -1).all()
    got_s, got_m = W.split_rows(total, lanes.size, shade, motion)
    lid = ids[lanes]
    jgeom = jwf.build_geometry(scene["jdata"], *(jnp.asarray(t.numpy()) for t in scene["world"]))
    for got, mine, theirs in ((got_s, full.shade_rows, jgeom.shade_rows),
                              (got_m, full.motion_rows, jgeom.motion_rows)):
        if got is None:
            continue
        for table in (mine.numpy(), np.asarray(theirs)):
            rows = np.where((lid >= 0)[:, None], table[np.maximum(lid, 0)], np.float32(0.0))
            assert _bits_equal(_plus_zero(got.numpy()), _plus_zero(rows))
    assert int((lid >= 0).sum()) > LANES // 2
    if live is not None:
        assert 0 < lanes.size < LANES


@pytest.mark.parametrize("case", ["random", "none", "all", "one", "tail"])
def test_gp_rows_position_map_is_the_scan_of_active(scene, case):
    """K13's plain version's map against NumPy's scan of the live flags
    (lane counts that fill no whole tile of ``GP_TILE`` lanes, and one
    that ends in a partial tile): ``pos`` the exclusive count of live lanes
    before each live lane, -1 where dead, ``lane_of`` its inverse, the rows
    as many as the live lanes; the wrapper raises where the caller's count
    of live lanes is not the map's."""
    full = scene["full"]
    n = full.shade_rows.shape[0]
    P = {"tail": W.GP_TILE + 37}.get(case, LANES)
    rng = np.random.default_rng(23)
    live = {"random": rng.random(P) < 0.3, "none": np.zeros(P, bool), "all": np.ones(P, bool),
            "one": np.arange(P) == P - 1, "tail": rng.random(P) < 0.6}[case]
    ids = rng.integers(-1, n, P).astype(np.int32)
    geom = full._replace(g2l=torch.arange(n, dtype=torch.int32))
    rows, pos, lane_of = W.gp_rows(geom, torch.as_tensor(ids), torch.as_tensor(live), True, True,
                                   int(live.sum()))
    want = np.where(live, np.cumsum(live) - 1, -1)
    assert pos.dtype == lane_of.dtype == torch.int32
    np.testing.assert_array_equal(pos.numpy(), want)
    np.testing.assert_array_equal(lane_of.numpy(), np.flatnonzero(live))
    assert rows.numel() == int(live.sum()) * 34
    shade, _ = W.split_rows(rows, int(live.sum()), True, True)
    lid = ids[live]
    np.testing.assert_array_equal(
        shade.numpy(), np.where((lid >= 0)[:, None], full.shade_rows.numpy()[np.maximum(lid, 0)],
                                np.float32(0.0)))
    with pytest.raises(ValueError, match="live lanes"):
        W.gp_rows(geom, torch.as_tensor(ids), torch.as_tensor(live), True, True,
                  int(live.sum()) + 1)


@pytest.mark.parametrize("n_bands", [2, 4])
def test_banded_taps_summed_over_bands_are_the_sample(scene, n_bands):
    """K14's plain version on every band of the packed atlas, summed, over
    the compacted rows of the live lanes (70 % of them): seed-made shade
    rows (uvs in [-1, 2), every resource), one a live lane, and the lanes'
    barycentrics, read at ``lane_of[j]``; row j equals the port's
    whole-atlas ``sample_packed`` at that lane's texture coordinate bit for
    bit (-0.0 aside); each band's share within 1e-6 of JAX's
    ``sample_packed_banded`` on that band (on a one-device gp axis, whose
    psum is the identity)."""
    atlas = scene["sd"].atlas
    n_res = atlas.packed_rects.shape[0]
    rng = np.random.default_rng(22)
    lane_of = np.flatnonzero(rng.random(LANES) < 0.7).astype(np.int32)
    n = lane_of.size
    srow = rng.standard_normal((n, 16)).astype(np.float32)
    srow[:, 9:15] = rng.random((n, 6)) * 3 - 1
    srow[:, 15] = rng.integers(0, n_res, n)
    bary = rng.random((LANES, 2)).astype(np.float32)
    bary = np.where(bary.sum(1, keepdims=True) > 1, 1 - bary, bary).astype(np.float32)
    s_t, u, v = torch.as_tensor(srow), torch.as_tensor(bary[:, 0]), torch.as_tensor(bary[:, 1])
    lo_t = torch.as_tensor(lane_of)
    res = s_t[:, 15].to(torch.int32)
    ul, vl = u[lo_t.long()][:, None], v[lo_t.long()][:, None]
    uv = W._tex_coord(s_t, ul, vl, 1.0 - ul - vl)
    whole = tex.sample_packed(atlas, res, uv).numpy()
    jbands = jtex.band_atlas(scene["jdata"].atlas, n_bands)
    mesh = JMesh(np.asarray(jax.devices()[:1]), ("gp",))
    total = 0.0
    for k in range(n_bands):
        band = tex.atlas_band(atlas, n_bands, k)
        share = W.banded_taps_plain(band, s_t, u, v, lo_t).numpy()
        assert share.shape == (n, tex.PACKED_C)
        total = total + share
        jatlas = scene["jdata"].atlas._replace(packed=jbands[k], band_lo=band.band_lo)
        f = jax.jit(jax.shard_map(lambda r, c, a=jatlas: jtex.sample_packed_banded(a, r, c, "gp"),
                                  mesh=mesh, in_specs=(P(), P()), out_specs=P(),
                                  check_vma=False))
        theirs = np.asarray(f(jnp.asarray(res.numpy()), jnp.asarray(uv.numpy())))
        np.testing.assert_allclose(share, theirs, atol=1e-6)
        assert band.packed.shape[0] == jbands.shape[1]
    assert _bits_equal(_plus_zero(total), _plus_zero(whole))
    assert np.abs(whole).max() > 0 and 0 < n < LANES


def test_lane_rows_read_at_positions(scene):
    """``at_lanes`` reads compacted rows per lane: lane i gets row
    ``pos[i]``, a dead lane zeros; with no live lane every lane gets
    zeros."""
    rng = np.random.default_rng(24)
    live = rng.random(LANES) < 0.5
    pos = torch.as_tensor(np.where(live, np.cumsum(live) - 1, -1).astype(np.int32))
    shade = torch.as_tensor(rng.standard_normal((int(live.sum()), 16)).astype(np.float32))
    got = W.at_lanes(W.LaneRows(shade, None, shade[:, :16] * 2, pos))
    want = np.zeros((LANES, 16), np.float32)
    want[live] = shade.numpy()
    np.testing.assert_array_equal(got.shade.numpy(), want)
    np.testing.assert_array_equal(got.taps.numpy(), want * 2)
    assert got.motion is None
    dead = torch.full((LANES,), -1, dtype=torch.int32)
    none = W.at_lanes(W.LaneRows(shade[:0], shade[:0, :2].repeat(1, 9), None, dead))
    assert none.shade.shape == (LANES, 16) and not none.shade.any()
    assert none.motion.shape == (LANES, 18) and not none.motion.any()


def test_kernel_route_for_gp_frames(scene, monkeypatch):
    """A gp frame takes the kernel route: a frame of the gp renderer (a
    world of one rank, in this process) calls K6-K8's wrappers, and
    ``lane_rows`` (K13, K14) and K7's lane-row form at every step. Its K7
    instantiation (``gp_settings``): with the banded
    atlas the per-lane taps, with the whole atlas the packed sample of its
    own."""
    calls = route_spy(monkeypatch)
    gr = G.GeometryShardedRenderer(_scene(nmap=True), _settings(T), device="cpu")
    assert on_route(calls, gr.draw)
    assert calls["lane_rows"] == calls["rows"] == calls["shade_hit"] > 0
    settings = G.gp_settings(_settings(T), scene["statics"], banded=True)
    assert settings.geometry_axis == "gp" and not settings.use_mipmaps
    assert W.K7_VARIANTS[W.k7_variant(settings, scene["statics"], banded=True)] == "rows_maps_taps"
    assert W.K7_VARIANTS[W.k7_variant(settings, scene["statics"])] == "rows_maps"
    assert W.needs_motion_rows(settings, scene["statics"])  # the normal map's tangent basis
    untextured = dataclasses.replace(scene["statics"],
                                     any_map=(False,) * len(scene["statics"].any_map))
    assert W.K7_VARIANTS[W.k7_variant(settings, untextured, banded=True)] == "rows"
    assert not W.needs_motion_rows(settings, untextured)
    mips = dataclasses.replace(settings, use_mipmaps=True)
    assert W.K7_VARIANTS[W.k7_variant(mips, scene["statics"], banded=True)] == "rows_maps_mips"


def test_gp_wrappers_raise_on_cuda_tensors_without_a_card(scene):
    """On CUDA tensors (fake ones: there is no card here) K13's and K14's
    wrappers go to their kernels, which cannot build or launch here, and
    raise; they never run their plain versions, and count no launch."""
    full = scene["full"]
    n = full.shade_rows.shape[0]
    geom = full._replace(g2l=torch.arange(n, dtype=torch.int32))
    before = dict(W.launches)
    band = tex.atlas_band(scene["sd"].atlas, 2, 0)
    with FakeTensorMode(allow_non_fake_inputs=True):

        def cuda(t):  # a fake CUDA tensor of t's shape and dtype
            return torch.zeros(t.shape, dtype=t.dtype, device="cuda")

        g = geom._replace(g2l=cuda(geom.g2l), shade_rows=cuda(geom.shade_rows),
                          motion_rows=cuda(geom.motion_rows))
        ids = cuda(torch.zeros(8, dtype=torch.int32))
        live = cuda(torch.ones(8, dtype=torch.bool))
        out = cuda(torch.empty(8 * 34))
        band = band._replace(packed=cuda(band.packed), packed_rects=cuda(band.packed_rects))
        srow = cuda(torch.empty(8, 16))
        u = cuda(torch.empty(8))
        lane_of = cuda(torch.arange(8, dtype=torch.int32))
        pos = cuda(torch.empty(8, dtype=torch.int32))
        counts = cuda(torch.empty(1, dtype=torch.int32))
        taps = cuda(torch.empty(8, tex.PACKED_C))
    with pytest.raises(RuntimeError):
        W.gp_rows(g, ids, live, True, True, 8, out=out, pos=pos, lane_of=lane_of, counts=counts)
    with pytest.raises(RuntimeError):
        W.banded_taps(band, srow, u, u, lane_of, out=taps)
    assert W.launches == before


@pytest.mark.parametrize("variant", [v for v in W.K7_VARIANTS.values() if v.startswith("rows")])
def test_gp_lane_row_instantiation_route_check(variant):
    """Each of K7's lane-row instantiations at the settings with which
    ``chip_smoke.py``'s phase L drives it (``gp_variant_settings``: the
    whole atlas with and without mipmaps, the motion view untextured, the
    normal view on the whole atlas, with mipmaps and banded), in a gp=1
    frame on the CPU: the checked frame after it
    (``route_check.checked_route_frame``) is bit-equal on the kernel and
    the plain route, its K13 calls, its K14 calls (exactly with the
    per-lane taps) and its first K7 step (this instantiation) bit-equal to
    their plain versions, as phase L's ``gp_route_checks`` reads them."""
    import chip_smoke

    s = _settings(T)
    table = {"rows": (s, False), "rows_maps_taps": (s, True),
             **chip_smoke.gp_variant_settings(s, s)}
    settings, banded = table[variant]
    textured = variant not in ("rows", "rows_debug")
    gr = G.GeometryShardedRenderer(_scene(nmap=textured), settings, banded=banded, device="cpu")
    gr.draw()
    check = route_check.checked_route_frame(gr)
    line = chip_smoke.gp_route_checks(f"cpu gp=1 {variant}", [dict(route_check=check, walls=[])],
                                      "taps" in variant, variant)
    assert line["bit_equal"] and line["k7"]["variant"] == variant
    assert line["k7"]["max_abs"] == 0.0 and line["k13"]["max_abs"] == 0.0
    assert (line["k14"]["launches"] > 0) == ("taps" in variant)
