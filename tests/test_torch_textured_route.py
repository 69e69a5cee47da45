"""Textured frames, mipmaps and the debug views on the kernel route
(``mrt_tpu_torch/kernels/wavefront.py``: K7's textured and debug
instantiations), on the CPU, where the wrappers take the plain versions.

Scene: the config-3 scene of tests/golden_scenes.py (a floor with a
checker and a normal map, glass, an emissive sphere, four light types) at
32x32, 2 spp, 3 bounces; the emissive sphere moves sideways between frames
(so the motion view shows motion).

- A frame with texture maps, with mipmaps and in every debug view takes
  the kernel route (calls K6-K8's wrappers); ``k7_variant`` names the
  instantiation each takes (under gp K7's lane-row form).
- Per case (the packed atlas, mipmaps, each debug view 1-7), every frame's
  ``trace_pixels`` on the kernel route (the listed loop, K7's plain version
  on the traversal's raw record) is bit-identical to the full-width loop
  (``test_torch_wavefront_list._full_width_trace_pixels``): accumulation,
  rays, samples, depth and motion.
- The same frames against live mrt_tpu: the packed atlas and mipmaps within
  1e-2 relative RMSE (tests/test_golden.py's bar) with rays equal, the
  debug views 1-6 within 1e-5 with rays equal, and the motion view (7) as
  tests/test_torch_extras.py holds it (mrt_tpu's motion view does not trace,
  ROADMAP Q3-F3: the colour its roughness view's buffers give).
- K7's bound (``utils/bounds.py:k7_work``, ``k7_listed``) counts a textured
  step's work: the packed samples of the hits whose material has a map, or
  with mipmaps each map's samples, each distinct texel, motion row and
  table entry read once, and in a debug view no shadow ray, no lit lane and
  only the map the view shows.
"""

import dataclasses

import numpy as np
import pytest
import torch

import mrt_tpu.engine.renderer as jrenderer
from golden_scenes import config3_renderer
from mrt_tpu_torch.core import types as T
from mrt_tpu_torch.kernels import wavefront as W
from mrt_tpu_torch.kernels import traverse2
from mrt_tpu_torch.render import wavefront as wf
from mrt_tpu_torch.utils import bounds
from test_torch_extras import _close, _motion_colour
from test_torch_render import port_like, rel_rmse
from test_torch_scene_bvh import one_torch_thread  # noqa: F401
from test_torch_wavefront_list import (_fields_differing, _full_width_trace_pixels, on_route,
                                       route_spy)

SIZE = 32
FRAMES = 2
CASES = ["packed", "mipmaps"] + [f"debug_{m}" for m in range(T.DEBUG_MODE_BASECOLOR,
                                                               T.DEBUG_MODE_MOTION + 1)]


def test_kernel_route_and_instantiation(monkeypatch):
    rj = config3_renderer(size=SIZE, spp=2, bounces=3)
    rj.draw()
    rp = port_like(rj)
    calls = route_spy(monkeypatch)

    def _route(r):
        return on_route(calls, r.draw)

    assert any(rp.statics.any_map) and rp.statics.any_map[1]  # a normal map
    assert _route(rp) and W.K7_VARIANTS[W.k7_variant(rp.settings(), rp.statics)] == "maps"
    rp.use_mipmaps = True
    assert _route(rp) and W.K7_VARIANTS[W.k7_variant(rp.settings(), rp.statics)] == "maps_mips"
    for mode in range(T.DEBUG_MODE_BASECOLOR, T.DEBUG_MODE_MOTION + 1):
        rp.debug_texture_mode = mode
        assert _route(rp), mode
        assert W.K7_VARIANTS[W.k7_variant(rp.settings(), rp.statics)] == "maps_mips_debug"
    rp.use_mipmaps = False
    assert W.K7_VARIANTS[W.k7_variant(rp.settings(), rp.statics)] == "maps_debug"
    untextured = dataclasses.replace(rp.statics, any_map=(False,) * len(rp.statics.any_map))
    assert W.K7_VARIANTS[W.k7_variant(rp.settings(), untextured)] == "debug"
    rp.debug_texture_mode = T.DEBUG_MODE_NONE
    assert W.K7_VARIANTS[W.k7_variant(rp.settings(), untextured)] == "untextured"
    # mipmaps without a map: the maps' instantiation (it carries the ray cone's length)
    rp.use_mipmaps = True
    assert W.K7_VARIANTS[W.k7_variant(rp.settings(), untextured)] == "maps_mips"
    rp.debug_texture_mode = T.DEBUG_MODE_NORMAL
    assert W.K7_VARIANTS[W.k7_variant(rp.settings(), untextured)] == "maps_mips_debug"
    gp = dataclasses.replace(rp.settings(), geometry_axis="gp")
    assert W.K7_VARIANTS[W.k7_variant(gp, rp.statics)] == "rows_maps_mips_debug"


@pytest.mark.parametrize("case", CASES)
def test_textured_route_matches_full_width_and_mrt_tpu(case, monkeypatch):
    mode = int(case.split("_")[1]) if case.startswith("debug") else T.DEBUG_MODE_NONE
    motion_view = mode == T.DEBUG_MODE_MOTION
    rj = config3_renderer(size=SIZE, spp=2, bounces=3)
    rj.use_mipmaps = case == "mipmaps"
    rj.debug_texture_mode = T.DEBUG_MODE_ROUGHNESS if motion_view else mode
    jout, pout, differing = [], [], []
    trace_j, trace_p, orig_tp = jrenderer._trace_all_tiles_frame, wf.trace_frame, wf.trace_pixels

    def flat(out):  # a frame's colour, motion and depth, one row per pixel
        return [np.asarray(x).reshape(SIZE * SIZE, -1) for x in (out.color, out.motion, out.depth)]

    def keep_j(*a, **k):
        out, rays = trace_j(*a, **k)
        jout.append(flat(out))
        return out, rays

    def both(*a, **k):  # the kernel route, then the full-width loop on the same inputs
        new = trace_p(*a, **k)
        wf.trace_pixels = _full_width_trace_pixels
        try:
            old = trace_p(*a, **k)
        finally:
            wf.trace_pixels = orig_tp
        differing.append(_fields_differing(new, old))
        pout.append(flat(new))
        return new

    monkeypatch.setattr(jrenderer, "_trace_all_tiles_frame", keep_j)
    monkeypatch.setattr(wf, "trace_frame", both)
    rj.draw()
    rp = port_like(rj)
    rp.debug_texture_mode = mode
    assert any(rp.statics.any_map)
    calls = route_spy(monkeypatch)
    prev = np.zeros((SIZE * SIZE, 2), np.float32)
    for f in range(FRAMES):
        if f:
            for s in (rj.scene, rp.scene):
                s.move_model(2, right=0.3 * f)
            rj.draw()
        img = []
        assert on_route(calls, lambda: img.append(rp.draw()))  # K6-K8's wrappers
        ap = img[0].numpy()
        assert np.isfinite(ap).all()
        rays = int(rp.last_rays_traced)
        assert rays == int(rj.last_rays_traced), f"frame {f}"
        if motion_view:
            assert rays == SIZE * SIZE * 2
            (hit_share, jmot, jdepth), (pcol, pmot, _) = jout[-1], pout[-1]
            want = _motion_colour(np.where(jdepth < 1e8, jmot, prev)) * hit_share[:, :1]
            assert _close(pmot, jmot, 1e-5) and _close(pcol, want, 1e-5), f"frame {f}"
            prev = jmot
        else:
            aj = np.asarray(rj.accum)
            tol = 1e-5 if mode != T.DEBUG_MODE_NONE else 1e-2
            assert _close(ap, aj, tol), f"frame {f}: {rel_rmse(ap, aj)}"
    assert differing == [[]] * FRAMES, differing
    if motion_view:
        assert float(rp.motion.abs().max()) > 0.5  # the sphere moves


@pytest.mark.parametrize("case", ["packed", "mipmaps", "debug_1"])
def test_k7_bound_counts_texture_work(case, monkeypatch):
    rj = config3_renderer(size=SIZE, spp=1, bounces=2)
    rj.draw()
    rp = port_like(rj)
    rp.use_mipmaps = case == "mipmaps"
    rp.debug_texture_mode = T.DEBUG_MODE_BASECOLOR if case == "debug_1" else T.DEBUG_MODE_NONE
    first = []
    orig = W.shade_hit

    def shade(fr, st, hits, sidx, wv, rows=None):  # the frame's first step, its inputs cloned
        st_in = W.clone_state(st)
        out = orig(fr, st, hits, sidx, wv, rows)
        if not first:
            first.append((fr, st_in, traverse2.hits_of(hits, fr.tri_base), out[1].shadow))
        return out

    monkeypatch.setattr(W, "shade_hit", shade)
    rp.draw()
    fr, st, hits, shadow = first[0]
    work = bounds.k7_work(fr, st, hits, shadow)
    tri = hits.triangle.clamp_min(0).long()
    res = fr.geom.shade_rows[tri, 15].long()
    bits = fr.geom.mat_rows[res, 12].to(torch.int32)
    hit = st.active & (hits.triangle >= 0)
    base_hit = hit & ((bits & T.MATERIAL_TEXTURE_BASECOLOR) != 0)
    normal_hit = hit & ((bits & T.MATERIAL_TEXTURE_NORMAL) != 0)
    base, normal = int(base_hit.sum()), int(normal_hit.sum())
    assert base > 0 and normal > 0
    # each texel, row and table entry once: far fewer bytes than a tap per hit
    assert 0 < work["tex_bytes"] < (base + normal) * 4 * 64
    untextured = {k: v for k, v in work.items()
                  if k not in ("tex_bytes", "packed", "mip_maps", "motion_rows", "lod",
                               "normal_mapped", "debug", "motion_view")}
    if case == "debug_1":  # the base colour view needs the base colour map only
        assert shadow is None and work["shadow"] == work["lit"] == work["glass"] == 0
        assert work["debug"] == work["hit"] and work["packed"] == base
        assert work["motion_rows"] == work["normal_mapped"] == work["lod"] == 0
        # a debug hit writes its colour only, not the next ray and throughput
        assert bounds.k7_listed(work)[0] < bounds.k7_listed(dict(work, debug=0))[0]
        return
    assert work["normal_mapped"] == normal and work["debug"] == 0
    sampled = hit & ((bits & 0x7F) != 0)
    if case == "packed":
        assert work["packed"] == int(sampled.sum()) and work["mip_maps"] == work["lod"] == 0
        assert work["motion_rows"] == int(tri[normal_hit].unique().numel())
    else:
        assert work["packed"] == 0 and work["mip_maps"] == base + normal
        assert work["lod"] == int(sampled.sum())
        assert work["motion_rows"] == int(tri[sampled].unique().numel())
    assert bounds.k7_listed(work)[0] > bounds.k7_listed(untextured)[0]
