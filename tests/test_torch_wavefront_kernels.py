"""The wavefront's three stages (``mrt_tpu_torch/kernels/wavefront.py``:
``sample_start``, ``shade_hit``, ``resolve_shadow``, kernels K6-K8 on the
card) on the CPU.

- The stage-split ``trace_pixels`` against live mrt_tpu's ``trace_tile`` on
  the app scene's static models (the glass dragon stand-in, two spheres,
  two planes and the scene's default area and spot lights) at 48x32, 2 spp,
  3 bounces, 2 frames, with the settings K7 covers that the other parity
  tests do not hold together: ``power`` light sampling, legacy shading and
  the G-buffer. The accumulation within 1 % relative RMSE (the bar of
  tests/test_golden.py), the rays equal per lane but for at most one lane
  by one ray (tests/test_torch_render.py's allowance: XLA:CPU's contracted
  multiply-adds can move a hit, ROADMAP Q3-P1), the G-buffer within 1e-5
  on at least 99.9 % of pixels (tests/test_torch_presenter.py's bar).
- The kernel route's truth table: a frame at the settings of runs A, B, C,
  E, G, H and J calls K6-K8's wrappers (``trace_pixels``'s kernel route),
  and so does one in each debug view and with mipmaps (texture maps:
  ``test_torch_textured_route.py``; geometry sharding:
  ``test_torch_gp_route.py``).
- The wrappers take the plain versions for CPU tensors and raise
  ``ValueError`` on another device (a ``meta`` tensor): ``sample_start``,
  the listed ``shade_hit`` (from the closest-hit traversal's raw record,
  with a ``Wave``), ``resolve_shadow`` at a sample's end, ``make_wave``
  (buffers only on the card) and ``halton``.
- ``csrc/halton.cuh``, compiled by the host compiler with
  ``-ffp-contract=off`` (every product and sum rounded on its own, as nvcc's
  ``-fmad=false`` builds it for the card), bit-equal to the port's and to
  the JAX package's ``halton_base`` at 24 and 11 digits over the sweep of
  tests/test_torch_halton.py.
"""

import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mrt_tpu.engine.renderer as jrenderer
from mrt_tpu import Renderer as JRenderer
from mrt_tpu import UPSCALER_DENOISED as J_DENOISED
from mrt_tpu import UPSCALER_OFF as J_OFF
from mrt_tpu.core import halton as JH
from mrt_tpu.engine.scene import Model as JModel
from mrt_tpu.engine.scene import ModelMaterialOverride as JOverride
from mrt_tpu.engine.scene import Scene as JScene
from mrt_tpu_torch import UPSCALER_DENOISED, convert, make_app_scene
from mrt_tpu_torch.core import halton as H
from mrt_tpu_torch.core import types as T
from mrt_tpu_torch.engine.renderer import Renderer
from mrt_tpu_torch.kernels import build
from mrt_tpu_torch.kernels import wavefront as W
from mrt_tpu_torch.render import wavefront as wf
from mrt_tpu_torch.utils import frame_profile as FP
from test_torch_halton import _sweep
from test_torch_render import port_like, rel_rmse
from test_torch_scene_bvh import one_torch_thread  # noqa: F401
from test_torch_wavefront_list import on_route, route_spy

W_, H_ = 48, 32
GB_FIELDS = ("diffuse_albedo", "specular_albedo", "normal", "roughness")


def _app_scene() -> JScene:
    """The JAX app scene's static models without the train/treefir OBJs
    (which the port's runs leave out too), at the app scene's places."""
    s = JScene(width=W_, height=H_)
    s.models = [
        JModel("dragon", position=[0.3, 0.38, 2.5], rotation=[0, np.pi / 2 * 1.2, 0], scale=1.2,
               material_override=JOverride.glass()),
        JModel("plane", position=[0, 0, 0], scale=10),
        JModel("sphere", position=[-1.9, 0.0, 0.3], scale=1),
        JModel("sphere", position=[2.9, 0.0, -0.5], scale=2),
        JModel("plane-back", position=[0, 0, -1.5], scale=10),
    ]
    return s


@pytest.mark.parametrize("setting", ["power", "legacy", "gbuffer"])
def test_stages_match_mrt_tpu(setting, monkeypatch):
    js = _app_scene()
    rj = JRenderer(js, W_, H_, seed=3)
    rj.upscaler_mode = J_OFF
    rj.samples_per_pixel = 2
    rj.max_bounces = 3
    rj.use_motion_adaptive_sampling = False
    if setting == "power":
        rj.light_sampling = "power"
    elif setting == "legacy":
        rj.shading_mode = T.SHADING_MODE_LEGACY
    else:
        rj.upscaler_mode = J_DENOISED
        rj.render_scale = 1.0
    lane_rays = {"j": [], "p": []}
    trace_j, trace_p = jrenderer._trace_all_tiles_frame, wf.trace_frame

    def keep_j(*a, **k):
        out, rays = trace_j(*a, **k)
        lane_rays["j"].append(np.asarray(out.rays_traced).reshape(-1))
        return out, rays

    def keep_p(*a, **k):
        out = trace_p(*a, **k)
        lane_rays["p"].append(out.rays_traced.reshape(-1).numpy())
        return out

    monkeypatch.setattr(jrenderer, "_trace_all_tiles_frame", keep_j)
    monkeypatch.setattr(wf, "trace_frame", keep_p)
    rj.draw()
    rp = port_like(rj, scene=convert.scene(js))
    if setting == "gbuffer":
        rp.upscaler_mode = UPSCALER_DENOISED
        rp.render_scale = 1.0
    settings = rp.settings()
    calls = route_spy(monkeypatch)
    assert rp.statics.has_refraction and rp.statics.n_lights == 2
    assert settings.light_sampling == ("power" if setting == "power" else "uniform")
    assert settings.shading_mode == (T.SHADING_MODE_LEGACY if setting == "legacy"
                                     else T.SHADING_MODE_PBR)
    assert settings.enable_gbuffer == (setting == "gbuffer")
    for f in range(2):
        if f:
            rj.draw()
        ap, aj = rp.draw().numpy(), np.asarray(rj.accum)
        assert min(calls[k] for k in ("sample_start", "shade_hit", "resolve_shadow")) > 0
        assert np.isfinite(ap).all() and ap.max() > 0
        assert rel_rmse(ap, aj) < 1e-2, f"frame {f}: {rel_rmse(ap, aj)}"
        diff = lane_rays["p"][-1] - lane_rays["j"][-1]
        lanes = np.nonzero(diff)[0]
        assert len(lanes) <= 1 and np.abs(diff).max(initial=0) <= 1, (
            f"frame {f}: lanes {lanes.tolist()} differ by {diff[lanes].tolist()}")
    if setting == "gbuffer":
        for k in GB_FIELDS:
            gp, gj = rp.gbuffer[k].numpy(), np.asarray(rj.gbuffer[k])
            assert gp.shape == gj.shape == (H_, W_) + gj.shape[2:], k
            close = np.abs(gp - gj) <= 1e-5
            ok = close.all(axis=-1) if close.ndim == 3 else close
            assert ok.mean() >= 0.999, (k, ok.mean())


@pytest.fixture(scope="module")
def small_app():
    """The port's app scene with the robot (the runs' scene) at 16x12."""
    r = Renderer(make_app_scene(16, 12, include_robot=True, asset_models=False), 16, 12,
                 device="cpu")
    r.draw()  # poses the robot (prepare reads its joint matrices)
    return r


def test_kernel_route_truth_table(small_app, monkeypatch):
    r = small_app
    calls = route_spy(monkeypatch)

    def _route(r):
        return on_route(calls, r.draw)

    assert not any(r.statics.any_map)
    on = {}
    for tag in ("A", "B", "C", "E", "G", "H", "J"):
        run = FP.RUNS[tag]
        FP.configure(r, run.get("motion_adaptive", False),
                     **{k: run[k] for k in ("upscaler", "render_scale", "spp", "bounces", "mipmaps")
                        if k in run})
        on[tag] = _route(r)
    r.upscaler_mode = UPSCALER_DENOISED  # run E's denoised mode: the G-buffer
    assert r.settings().enable_gbuffer
    on["E denoised"] = _route(r)
    r.two_level = False  # run J's flat BVH
    on["J flat"] = _route(r)
    assert all(on.values()), on
    FP.configure(r)
    for mode in range(T.DEBUG_MODE_BASECOLOR, T.DEBUG_MODE_MOTION + 1):
        r.debug_texture_mode = mode
        assert _route(r), mode
    r.debug_texture_mode = T.DEBUG_MODE_NONE
    FP.configure(r, mipmaps=True)  # run F's mipmaps
    assert _route(r)
    FP.configure(r)
    assert _route(r) and calls["rows"] == calls["lane_rows"] == 0  # no gp step


def _frame(r, device="cpu"):
    """A Frame of ``r``'s first lanes (sample 0) and its inputs."""
    sd, geom, bvh = r.prepare()
    settings = r.settings()
    uniforms = T.make_frame_uniforms(r.current_camera(), device="cpu")
    P = r.render_width * r.render_height
    idx = torch.arange(P, dtype=torch.int32)
    px, py = idx % r.render_width, idx // r.render_width
    fr = W.make_frame(settings, r.statics, sd, geom, uniforms, px.to(device), py.to(device),
                      r.offsets.reshape(-1).to(device), torch.zeros((P, 2), device=device), 0,
                      tri_base=bvh.flat_tri_base.to(device))
    return fr, bvh


def _same(a, b):
    """Equal, NaN where NaN (the shadow rays of lanes without one)."""
    assert (a is None) == (b is None)
    if a is not None:
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def test_wrappers_take_plain_on_cpu_and_raise_elsewhere(small_app):
    r = small_app
    FP.configure(r)
    r.two_level = True
    r.draw()  # the state and offsets at the render size
    fr, bvh = _frame(r)
    P = fr.pixel_x.shape[0]
    total = torch.full((P,), 2, dtype=torch.int32)
    st = W.sample_start(fr, 0, total)
    st_p = W.sample_start_plain(fr, 0, total)
    for a, b in zip(st, st_p):
        _same(a, b)
    from mrt_tpu_torch.bvh import twolevel
    from mrt_tpu_torch.kernels import traverse2

    rays = T.Rays(st.ray_o, st.ray_d, torch.full((P,), float("inf")))
    hits = twolevel.closest_hit(bvh, rays, mask=st.active)
    assert bool((hits.triangle >= 0).any())
    # the listed K7: the traversal's raw record, a Wave; its plain version on
    # the CPU, resolve_shadow_plain (nothing pending at a sample's start)
    # then shade_hit_plain on closest_hit's Hits
    raw = twolevel.closest_raw(bvh, rays, torch.zeros(P, dtype=torch.bool), mask=st.active)
    for a, b in zip(traverse2.hits_of(raw, fr.tri_base), hits):
        _same(a, b)
    wv = W.new_sample(W.make_wave(fr, 8))
    assert wv == W.Wave()  # buffers only for the card
    nxt, wv1, live = W.shade_hit(fr, W.clone_state(st), raw, 0, wv)
    nxt_p, sh_p = W.shade_hit_plain(fr, st, hits, 0)
    for a, b in zip(list(nxt) + list(wv1.shadow), list(nxt_p) + list(sh_p)):
        _same(a, b)
    assert wv1.steps == 1 and int(live) == int(nxt_p.active.sum())
    assert torch.equal(W.listed(wv1), torch.nonzero(nxt_p.active | sh_p.need).squeeze(1).int())
    occ = torch.zeros(P, dtype=torch.bool)
    occ[::3] = True
    wv1 = wv1._replace(occluded=occ)
    assert torch.equal(W.resolve_shadow(nxt, wv1).accumulated,
                       W.resolve_shadow_plain(nxt_p, sh_p, occ).accumulated)
    assert W.resolve_shadow(nxt, W.Wave()) is nxt  # nothing pending
    assert fr.camera is None and fr.lights is None  # packed only for the card
    assert not any(W.launches.values())

    meta = torch.device("meta")
    fr_m = fr._replace(pixel_x=fr.pixel_x.to(meta), pixel_y=fr.pixel_y.to(meta),
                       offsets=fr.offsets.to(meta))
    with pytest.raises(ValueError, match="unsupported device"):
        W.sample_start(fr_m, 0, total.to(meta))
    st_m = W.LaneState(*(None if t is None else t.to(meta) for t in st))
    raw_m = traverse2.TraverseOut(*(None if t is None else t.to(meta) for t in raw))
    with pytest.raises(ValueError, match="unsupported device"):
        W.shade_hit(fr_m, st_m, raw_m, 0, W.Wave())
    with pytest.raises(ValueError, match="unsupported device"):
        W.resolve_shadow(st_m, W.Wave(shadow=W.Shadow(*(t.to(meta) for t in sh_p)),
                                      occluded=occ.to(meta), steps=1))
    packed = fr_m._replace(camera=torch.zeros(12, device=meta),
                           lights=torch.zeros((2, W.LIGHT_COLS), device=meta),
                           step_bases=torch.zeros((20, 12), dtype=torch.int32, device=meta))
    with pytest.raises(ValueError, match="unsupported device"):
        W.make_wave(packed, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        W.halton(torch.zeros(4, dtype=torch.int32), torch.full((4,), 2, dtype=torch.int32), 24)


@pytest.fixture(scope="module")
def halton_lib(tmp_path_factory):
    """csrc/halton.cuh compiled by the host compiler into a shared library."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.fail("no host C++ compiler to build csrc/halton.cuh with")
    d = tmp_path_factory.mktemp("halton")
    src = d / "halton_host.cpp"
    src.write_text('#include "halton.cuh"\n'
                   'extern "C" void halton_many(const int* i, const int* b, float* out, int n,\n'
                   '                            int digits) {\n'
                   '    for (int k = 0; k < n; ++k) out[k] = mrt_halton_base(i[k], b[k], digits);\n'
                   '}\n')
    lib = d / "libhalton_host.so"
    subprocess.run([cxx, "-O2", "-ffp-contract=off", "-shared", "-fPIC", f"-I{build.CSRC}",
                    str(src), "-o", str(lib)], check=True, capture_output=True, timeout=120)
    h = ctypes.CDLL(str(lib))
    p = ctypes.c_void_p
    h.halton_many.argtypes = [p, p, p, ctypes.c_int, ctypes.c_int]
    h.halton_many.restype = None
    return h


def _host_halton(h, i: np.ndarray, b: np.ndarray, digits: int) -> np.ndarray:
    i = np.ascontiguousarray(i, np.int32)
    b = np.ascontiguousarray(b, np.int32)
    out = np.empty(i.shape, np.float32)
    h.halton_many(i.ctypes.data, b.ctypes.data, out.ctypes.data, i.size, digits)
    return out


@pytest.mark.parametrize("digits", [24, 11])
def test_halton_cuh_bit_equal(halton_lib, digits):
    rng = np.random.default_rng(7)
    lo = 0 if digits == 24 else 2  # the per-step bases are primes[2:]
    idx, bases = [], []
    for d in range(lo, 100):
        i = _sweep(d, rng)
        idx.append(i)
        bases.append(np.full(i.shape, H.PRIMES[d], np.int32))
    # and indices past 2^24, which wrap
    wrap = np.array([1 << 24, (1 << 24) + 5, (1 << 31) - 1, -1, -(1 << 31)], np.int32)
    idx.append(wrap)
    bases.append(np.full(wrap.shape, 5, np.int32))
    i, b = np.concatenate(idx), np.concatenate(bases)
    got = _host_halton(halton_lib, i, b, digits)
    port = H.halton_base(torch.as_tensor(i), torch.as_tensor(b), digits).numpy()
    jax = np.asarray(JH.halton_base(jnp.asarray(i), jnp.asarray(b), digits))
    assert np.array_equal(got.view(np.int32), port.view(np.int32))
    assert np.array_equal(got.view(np.int32), jax.view(np.int32))
