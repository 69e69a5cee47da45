"""The listed K7 and the trailing K8 (``mrt_tpu_torch/kernels/wavefront.py``:
``shade_hit`` over a ``Wave``'s lane list, ``resolve_shadow`` once per
sample) on the CPU, where their wrappers take the plain versions.

Scenes: the port's app scene without the robot (the glass dragon stand-in,
two spheres, two planes, the area and spot lights) at 32x24 with a 16x32
equirect environment made from a numpy seed, 2 spp, 3 bounces, two frames
(samples 0 and 1, then a later frame's), in PBR, legacy and ``power``
shading, with the G-buffer (denoised mode), and on the flat BVH (whose
traversal record holds global triangle ids).

- (a) Every step of the new plain stage equals ``resolve_shadow_plain``
  followed by ``shade_hit_plain`` (both unchanged) on the same cloned
  inputs, every field of every lane in its bits; a lane outside the step's
  list comes out as it went in, with no shadow ray (what lets the kernel
  skip it); the trailing resolve equals ``resolve_shadow_plain``.
- (b) Every list holds exactly the lanes that are live or hold a shadow ray
  after its step, once each, and covers the lanes the next step traces and
  resolves.
- (c) ``trace_pixels`` gives ``TileOutputs`` bit-identical to the full-width
  loop (rebuilt below from the unchanged plain stages: a reduction per
  iteration, K8's add after every any-hit, the traversals' ``Hits``).
- The closest-hit traversal's raw record made ``Hits`` by
  ``traverse2.hits_of`` equals ``closest_hit``'s, on both BVHs.
- The listed bounds (``bounds.k7_listed`` + ``bounds.k8``) are at
  most the full-width ``k7`` + ``k8`` on the same lane counts.
"""

import numpy as np
import pytest
import torch

from mrt_tpu_torch import UPSCALER_DENOISED, UPSCALER_OFF, make_app_scene
from mrt_tpu_torch.bvh import kind
from mrt_tpu_torch.core import types as T
from mrt_tpu_torch.engine.renderer import Renderer
from mrt_tpu_torch.kernels import traverse2
from mrt_tpu_torch.kernels import wavefront as W
from mrt_tpu_torch.render import shade as S
from mrt_tpu_torch.render import wavefront as wf
from mrt_tpu_torch.utils import bounds
from test_torch_scene_bvh import one_torch_thread  # noqa: F401

W_, H_ = 32, 24
SETTINGS = ["pbr", "legacy", "power", "gbuffer", "flat"]


def _renderer(setting: str) -> Renderer:
    s = make_app_scene(W_, H_, include_robot=False, asset_models=False)
    rng = np.random.default_rng(5)
    s.set_environment(rng.uniform(0.0, 2.0, (16, 32, 3)).astype(np.float32), intensity=0.8)
    r = Renderer(s, W_, H_, seed=3, device="cpu")
    r.upscaler_mode = UPSCALER_OFF
    r.samples_per_pixel = 2
    r.max_bounces = 3
    r.use_motion_adaptive_sampling = False
    if setting == "legacy":
        r.shading_mode = T.SHADING_MODE_LEGACY
    elif setting == "power":
        r.light_sampling = "power"
    elif setting == "gbuffer":
        r.upscaler_mode = UPSCALER_DENOISED
        r.render_scale = 1.0
    elif setting == "flat":
        r.two_level = False
    assert r.statics.has_environment and r.statics.has_refraction
    return r


ROUTE_STAGES = ("sample_start", "shade_hit", "resolve_shadow", "lane_rows")


def route_spy(monkeypatch) -> dict:
    """Counts, from now on, of ``trace_pixels``'s calls of the kernel
    route's stages (``W.sample_start``, ``W.shade_hit``,
    ``W.resolve_shadow``: the wrappers of K6-K8; ``W.lane_rows``: K13 and
    K14 under gp), and under ``"rows"`` the ``shade_hit`` calls given
    per-lane rows (K7's lane-row form). The plain route calls none."""
    calls = dict.fromkeys(ROUTE_STAGES + ("rows",), 0)
    for name in ROUTE_STAGES:

        def spy(*a, _name=name, _orig=getattr(W, name), **k):
            calls[_name] += 1
            if _name == "shade_hit":
                calls["rows"] += (a[5] if len(a) > 5 else k.get("rows")) is not None
            return _orig(*a, **k)

        monkeypatch.setattr(W, name, spy)
    return calls


def on_route(calls: dict, draw) -> bool:
    """Whether ``draw()`` traced on the kernel route (``route_spy``'s
    ``calls``): K6-K8's wrappers called, each at least once."""
    for k in calls:
        calls[k] = 0
    draw()
    return min(calls[k] for k in ROUTE_STAGES[:3]) > 0


def _full_width_trace_pixels(settings, statics, scene, bvh, geom, uniforms, pixel_x, pixel_y,
                             offsets, prev_motion, sample_base=None,
                             plain=True) -> wf.TileOutputs:
    """The full-width ``trace_pixels`` on the CPU (the plain route whatever
    ``plain`` says): the plain stages as they are
    (``sample_start_plain``, ``shade_hit_plain``, the any-hit, then
    ``resolve_shadow_plain`` after every any-hit), ``closest_hit``'s
    ``Hits`` and one ``active.any()`` per iteration."""
    assert not settings.geometry_axis
    P = pixel_x.shape[0]
    f32 = torch.float32
    base = uniforms.frame_index * settings.sample_stride if sample_base is None else sample_base
    fr = W.make_frame(settings, statics, scene, geom, uniforms, pixel_x, pixel_y, offsets,
                      prev_motion, base)
    max_extra = settings.max_extra_samples
    max_iters = settings.max_bounces * (settings.max_bounces + 2) + 2
    inf_d = torch.full((P,), float("inf"), dtype=f32)
    trav = kind.traversal(bvh)
    shadow_kw = ({"ray_mask": torch.full((P,), T.RAY_MASK_SHADOW, dtype=torch.int32)}
                 if bvh.has_masks else {})
    total_color = torch.zeros((P, 3), dtype=f32)
    rays_total = torch.zeros(P, dtype=torch.int32)
    total = torch.full((P,), settings.base_samples, dtype=torch.int32)
    n_samples = settings.base_samples
    depth0 = motion0 = st = None
    sidx = 0
    while sidx < n_samples:
        st = W.sample_start_plain(fr, sidx, total, st)
        it = 0
        while it < max_iters and bool(st.active.any()):
            it += 1
            closest_kw = {}
            if bvh.has_masks:
                closest_kw["ray_mask"] = torch.where(st.bounce == 0, T.RAY_MASK_PRIMARY,
                                                     T.RAY_MASK_SECONDARY).to(torch.int32)
            hits = trav.closest_hit(bvh, T.Rays(st.ray_o, st.ray_d, inf_d), mask=st.active,
                                    **closest_kw)
            st, shadow = W.shade_hit_plain(fr, st, hits, sidx)
            if shadow is None:
                continue
            occluded = trav.any_hit(bvh, T.Rays(shadow.origin, shadow.direction, shadow.distance),
                                    mask=shadow.need, **shadow_kw)
            st = W.resolve_shadow_plain(st, shadow, occluded)
        if sidx == 0:
            mrow_p = W._tri_rows(geom.motion_rows, st.prim_tri.clamp_min(0).long(), geom)
            mot, pdepth = W.screen_motion(uniforms, mrow_p, st.prim_u[:, None], st.prim_v[:, None],
                                          fr.width_f, fr.height_f)
            had0 = st.prim_tri >= 0
            depth0 = torch.where(had0, torch.clamp(pdepth, min=1.0e-3),
                                 torch.full((P,), 1.0e8, dtype=f32))
            motion0 = torch.where(had0[:, None], mot, torch.zeros((P, 2), dtype=f32))
            fr = fr._replace(had0=had0, motion0=motion0)
            if max_extra > 0:
                motion_mag = torch.maximum(S.length2(motion0), S.length2(prev_motion))
                low = torch.clamp(uniforms.motion_sampling_low_px, min=0.0)
                high = torch.maximum(uniforms.motion_sampling_high_px, low + 1e-3)
                t = torch.clamp((motion_mag - low) / (high - low), 0.0, 1.0)
                extra = torch.round(t * max_extra).to(torch.int32).clamp(0, max_extra)
                total = settings.base_samples + extra
                n_samples = min(settings.sample_stride, settings.base_samples + int(extra.max()))
        total_color = total_color + st.accumulated
        rays_total = rays_total + st.rays
        sidx += 1
    gb = {}
    if settings.enable_gbuffer:
        gb = {k: getattr(st, k) for k in W.GBUFFER_FIELDS if k != "wrote_gb"}
    return wf.TileOutputs(color=total_color / total.to(f32)[:, None], depth=depth0,
                          motion=motion0, rays_traced=rays_total, samples=total, **gb)


def _bits_equal(a, b) -> bool:
    """Equal in every bit (a float's NaN payload included), shape and dtype."""
    if a is None or b is None:
        return a is None and b is None
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))
    return torch.equal(a, b)


def _fields_differing(k, p, lanes=None) -> list:
    """The fields of NamedTuples ``k`` and ``p`` not bit-equal (over
    ``lanes`` if given)."""
    bad = []
    for name in k._fields:
        a, b = getattr(k, name), getattr(p, name)
        if a is not None and b is not None and lanes is not None:
            a, b = a[lanes], b[lanes]
        if not _bits_equal(a, b):
            bad.append(name)
    return bad


def _recorded(setting: str):
    """Two frames of ``setting`` with every ``shade_hit`` and
    ``resolve_shadow`` call recorded: inputs cloned before it ran, and its
    outputs."""
    r = _renderer(setting)
    steps, resolves = [], []
    orig_shade, orig_resolve = W.shade_hit, W.resolve_shadow

    def shade(fr, st, hits, sidx, wv, rows=None):
        st_in, wv_in = W.clone_state(st), W.clone_wave(wv)
        listed_in = None if wv.steps == 0 else W.listed(wv).clone()
        out = orig_shade(fr, st, hits, sidx, wv, rows)
        steps.append(dict(fr=fr, st=st_in, hits=hits, sidx=sidx, wv=wv_in, listed=listed_in,
                          out=out))
        return out

    def resolve(st, wv):
        st_in = W.clone_state(st)
        out = orig_resolve(st, wv)
        resolves.append(dict(st=st_in, wv=W.clone_wave(wv), out=out))
        return out

    W.shade_hit, W.resolve_shadow = shade, resolve
    try:
        r.draw()
        r.draw()
    finally:
        W.shade_hit, W.resolve_shadow = orig_shade, orig_resolve
    assert steps and resolves
    assert {s["sidx"] for s in steps} == {0, 1}
    assert len({s["fr"].base for s in steps}) == 2  # two frames, two Halton bases
    return steps, resolves


@pytest.fixture(scope="module")
def recorded():
    cache = {}

    def get(setting):
        if setting not in cache:
            cache[setting] = _recorded(setting)
        return cache[setting]

    return get


@pytest.mark.parametrize("setting", SETTINGS[:4])
def test_listed_plain_equals_resolve_then_shade(recorded, setting):
    steps, resolves = recorded(setting)
    skipped = 0
    for k, s in enumerate(steps):
        st_in, wv_in = W.clone_state(s["st"]), s["wv"]
        if wv_in.shadow is not None:
            st_in = W.resolve_shadow_plain(st_in, wv_in.shadow, wv_in.occluded)
        ref_st, ref_sh = W.shade_hit_plain(s["fr"], st_in, traverse2.hits_of(s["hits"],
                                                                              s["fr"].tri_base),
                                           s["sidx"])
        st_out, wv_out, live = s["out"]
        assert not _fields_differing(st_out, ref_st), (k, _fields_differing(st_out, ref_st))
        assert not _fields_differing(wv_out.shadow, ref_sh), (k, _fields_differing(wv_out.shadow,
                                                                                   ref_sh))
        assert int(live) == int(ref_st.active.sum())
        if s["listed"] is not None:  # a lane outside the list: unchanged, no shadow ray
            out_of_list = torch.ones(st_out.active.shape[0], dtype=torch.bool)
            out_of_list[s["listed"].long()] = False
            skipped += int(out_of_list.sum())
            assert not _fields_differing(st_out, s["st"], out_of_list), k
            assert not bool(wv_out.shadow.need[out_of_list].any()), k
    assert skipped > 0
    for k, rs in enumerate(resolves):
        ref = W.resolve_shadow_plain(rs["st"], rs["wv"].shadow, rs["wv"].occluded)
        assert _bits_equal(rs["out"].accumulated, ref.accumulated), k


@pytest.mark.parametrize("setting", SETTINGS[:4])
def test_each_list_covers_live_and_shadow_lanes(recorded, setting):
    steps, _ = recorded(setting)
    for k, s in enumerate(steps):
        st_out, wv_out, _ = s["out"]
        lst = W.listed(wv_out)
        want = torch.nonzero(st_out.active | wv_out.shadow.need).squeeze(1).to(torch.int32)
        assert lst.unique().numel() == lst.numel(), k
        assert torch.equal(lst.sort().values, want), k
        if k + 1 < len(steps) and steps[k + 1]["wv"].steps:  # the next step of this sample
            nxt = steps[k + 1]
            assert torch.equal(nxt["listed"], lst), k
            covered = torch.zeros(st_out.active.shape[0], dtype=torch.bool)
            covered[lst.long()] = True
            assert not bool((nxt["st"].active & ~covered).any()), k
            assert not bool((nxt["wv"].shadow.need & ~covered).any()), k


@pytest.mark.parametrize("setting", SETTINGS)
def test_trace_pixels_matches_full_width_loop(setting, monkeypatch):
    r = _renderer(setting)
    orig_tf = wf.trace_frame
    seen = []

    orig_tp = wf.trace_pixels

    def both(*a, **k):
        new = orig_tf(*a, **k)
        wf.trace_pixels = _full_width_trace_pixels
        try:
            old = orig_tf(*a, **k)
        finally:
            wf.trace_pixels = orig_tp
        seen.append(_fields_differing(new, old))
        return new

    monkeypatch.setattr(wf, "trace_frame", both)
    r.draw()
    r.draw()
    assert seen == [[], []], seen
    if setting == "gbuffer":
        assert r.settings().enable_gbuffer


@pytest.mark.parametrize("two_level", [True, False])
def test_raw_record_gives_closest_hit(two_level):
    r = _renderer("pbr" if two_level else "flat")
    bvh = r.prepare()[2]
    rng = np.random.default_rng(11)
    n = 512
    o = torch.as_tensor(rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)) + torch.tensor(
        [0.0, 1.5, 4.0])
    d = torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32))
    d = d / d.norm(dim=1, keepdim=True)
    rays = T.Rays(o, d, torch.full((n,), float("inf")))
    mask = torch.as_tensor(rng.uniform(size=n) < 0.8)
    trav = kind.traversal(bvh)
    raw = trav.closest_raw(bvh, rays, torch.zeros(n, dtype=torch.bool), mask=mask)
    got = traverse2.hits_of(raw, None if kind.is_flat(bvh) else bvh.flat_tri_base)
    want = trav.closest_hit(bvh, rays, mask=mask)
    assert not _fields_differing(got, want)
    assert int((want.triangle >= 0).sum()) > n // 8
    assert torch.equal(trav.any_hit(bvh, rays, mask=mask, flags=torch.ones(n, dtype=torch.bool)),
                       trav.any_hit(bvh, rays, mask=mask))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_listed_bounds_within_full_width(seed):
    """One sample's steps: the full-width K7 and K8 per iteration against
    the listed K7 (with the previous step's adds folded in) and one trailing
    K8, on the same lane counts."""
    rng = np.random.default_rng(seed)
    P = 1 << 16
    live = P
    old_ms = new_ms = 0.0
    listed, prev_add, prev_add_live = P, 0, 0
    for k in range(8):
        hit = int(live * rng.uniform(0.5, 1.0))
        glass = int(hit * rng.uniform(0.0, 0.3))
        shadow = int((hit - glass) * rng.uniform(0.3, 1.0))
        work = dict(live=live, hit=hit, glass=glass, lit=hit - glass, shadow=shadow,
                    env_miss=live - hit)
        add = int(shadow * rng.uniform(0.2, 0.9))
        old_ms += bounds.k7(dict(work, lanes=P))[0] + bounds.k8(P, add)[0]
        new_ms += bounds.k7_listed(dict(work, lanes=listed, resolved=listed if k else 0,
                                        added=prev_add, added_live=prev_add_live))[0]
        next_live = int(hit * rng.uniform(0.3, 0.9))
        listed = min(P, next_live + shadow)
        prev_add, prev_add_live = add, int(add * rng.uniform(0.0, 1.0))
        live = next_live
    new_ms += bounds.k8(listed, prev_add)[0]
    assert new_ms <= old_ms, (new_ms, old_ms)
    assert bounds.k8(listed, prev_add)[0] <= bounds.k8(P, prev_add)[0]
