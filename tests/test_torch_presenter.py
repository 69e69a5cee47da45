"""The G-buffer and the presenter chains against live mrt_tpu.

- The G-buffer of the config-3 frame (glass, a textured floor with a normal
  map) at 64x64: within 1e-5 on at least 99.9 % of pixels (a ray that ties
  at equal t may pick another triangle, ROADMAP Q3-P1); it changes no ray
  and no accumulation.
- Each presenter chain fed the JAX renderer's own buffers and state
  (``convert.*``): linear output, new history and DenoiseState within 1e-5
  relative RMSE of JAX's, the image within 1 LSB.
- Both renderers end to end at a 32x32 output, render scale 0.5, over three
  frames with an orbit: the accumulation within 1 % relative RMSE (the bar
  of test_torch_render.py), rays equal, the image within 1 LSB.
- The history lifecycle and the default Renderer (spatial at 0.67)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_scenes import config3_renderer
from mrt_tpu import Renderer as JRenderer
from mrt_tpu import UPSCALER_DENOISED as J_DENOISED
from mrt_tpu.engine.scene import Model as JModel
from mrt_tpu.engine.scene import Scene as JScene
from mrt_tpu.upscale import denoise as jdenoise
from mrt_tpu.upscale import presenter as jpresenter
from mrt_tpu.upscale import spatial as jspatial
from mrt_tpu.upscale import temporal as jtemporal
from mrt_tpu_torch import (UPSCALER_DENOISED, UPSCALER_OFF, UPSCALER_SPATIAL, UPSCALER_TEMPORAL,
                           Model, Renderer, Scene, convert)
from mrt_tpu_torch.kernels.present import tonemap_quantize
from mrt_tpu_torch.upscale import presenter
from mrt_tpu_torch.utils.image import relative_rmse
from test_torch_render import port_like
from test_torch_scene_bvh import one_torch_thread  # noqa: F401

TOL = 1e-5
MODES = [UPSCALER_SPATIAL, UPSCALER_TEMPORAL, UPSCALER_DENOISED]
GB_FIELDS = ("diffuse_albedo", "specular_albedo", "normal", "roughness")


def _lsb(a, b) -> int:
    return int(np.abs(a.astype(int) - b.astype(int)).max())


def test_gbuffer_matches_mrt_tpu_and_changes_nothing():
    rj = config3_renderer(size=64, spp=1, bounces=2)
    rj.upscaler_mode = J_DENOISED
    rj.render_scale = 1.0
    rj.draw()
    rp = port_like(rj)
    rp.upscaler_mode = UPSCALER_DENOISED
    rp.render_scale = 1.0
    plain = port_like(rj)  # upscaler off: same render size, no G-buffer
    rp.draw()
    plain.draw()
    assert rp.settings().enable_gbuffer and plain.gbuffer is None
    assert int(rp.last_rays_traced) == int(rj.last_rays_traced) == int(plain.last_rays_traced)
    assert np.array_equal(rp.accum.numpy(), plain.accum.numpy())
    assert relative_rmse(rp.accum.numpy(), np.asarray(rj.accum)) < 1e-2
    for k in GB_FIELDS:
        gp, gj = rp.gbuffer[k].numpy(), np.asarray(rj.gbuffer[k])
        assert gp.shape == gj.shape == (64, 64) + gj.shape[2:], k
        close = np.abs(gp - gj) <= TOL
        ok = close.all(axis=-1) if close.ndim == 3 else close
        assert ok.mean() >= 0.999, (k, ok.mean())
    written = rp.gbuffer["normal"].numpy().sum(-1) > 0  # lanes that hit something
    assert 0.5 < written.mean() < 1.0


@pytest.fixture(scope="module")
def jax_buffers():
    """A JAX renderer in denoised mode (32x32 output, 16x16 render) after
    two presented frames with the sphere moving (so motion, history and
    the denoiser's state are not trivial), and a third frame drawn."""
    s = JScene(32, 32)
    s.models = [JModel("sphere", position=[0, 0.5, 0], scale=0.5), JModel("plane", scale=10)]
    r = JRenderer(s, 32, 32, seed=4)
    r.upscaler_mode = J_DENOISED
    r.render_scale = 0.5
    r.samples_per_pixel = 1
    r.max_bounces = 1
    r.use_motion_adaptive_sampling = False
    for _ in range(2):
        r.draw()
        jpresenter.present_device(r)
        s.move_model(0, right=0.6)
    r.draw()
    assert float(np.abs(np.asarray(r.motion)).max()) > 0.5
    return r


@pytest.mark.parametrize("mode", MODES)
def test_presenter_chain_from_jax_buffers(jax_buffers, mode):
    rj = jax_buffers
    color, depth, motion = rj.accum, rj.depth, rj.motion
    hist, dstate, weight = rj._upscale_history, rj._denoise_state, float(rj.accumulation_weight)
    c, d, m = (torch.as_tensor(np.array(a)) for a in (color, depth, motion))
    if mode == UPSCALER_SPATIAL:
        lin_j = jspatial.upscale(color, 32, 32, "lanczos3")
        img_j = jpresenter._present_spatial(color, 32, 32, "lanczos3")
        lin_p, state_p = presenter.present_spatial(c, 32, 32)
        assert state_p is None
    elif mode == UPSCALER_TEMPORAL:
        lin_j, _ = jtemporal.temporal_upscale(color, depth, motion, hist, 32, 32, weight)
        img_j, hist_j = jpresenter._present_temporal(color, depth, motion, hist,
                                                     jnp.float32(weight), 32, 32)
        lin_p, hist_p = presenter.present_temporal(c, d, m, convert.history(hist, "cpu"), weight,
                                                   32, 32)
        assert relative_rmse(hist_p.numpy(), hist_j) < TOL
    else:
        den, _ = jdenoise.svgf_filter(color, rj.gbuffer, depth, motion, dstate)
        lin_j, _ = jtemporal.temporal_upscale(den, depth, motion, hist, 32, 32, weight)
        img_j, hist_j, dstate_j = jpresenter._present_denoised(
            color, rj.gbuffer, depth, motion, dstate, hist, jnp.float32(weight), 32, 32)
        lin_p, (hist_p, dstate_p) = presenter.present_denoised(
            c, convert.gbuffer(rj.gbuffer, "cpu"), d, m, convert.denoise_state(dstate, "cpu"),
            convert.history(hist, "cpu"), weight, 32, 32)
        assert relative_rmse(hist_p.numpy(), hist_j) < TOL
        for f in dstate_p._fields:
            assert relative_rmse(getattr(dstate_p, f).numpy(), getattr(dstate_j, f)) < TOL, f
    assert lin_p.shape == (32, 32, 3)
    assert relative_rmse(lin_p.numpy(), lin_j) < TOL
    assert _lsb(tonemap_quantize(lin_p.contiguous()).numpy(), np.asarray(img_j)) <= 1


@pytest.mark.parametrize("mode", MODES)
def test_renderers_end_to_end(mode):
    """32x32 output at render scale 0.5, 1 spp, 1 bounce; frame 2 follows an
    orbit (history dropped), frame 3 blends it."""
    js = JScene(32, 32)
    js.models = [JModel("sphere", position=[0, 0.5, 0], scale=0.5), JModel("plane", scale=10)]
    rj = JRenderer(js, 32, 32, seed=6)
    rj.upscaler_mode = mode
    rj.render_scale = 0.5
    rj.samples_per_pixel = 1
    rj.max_bounces = 1
    rj.use_motion_adaptive_sampling = False
    rp = None
    for f in range(3):
        if f == 1:
            rj.orbit(40.0, 5.0)
            rp.orbit(40.0, 5.0)
        rj.draw()
        if rp is None:  # JAX's offsets have the render size after its first draw
            rp = Renderer(convert.scene(js), 32, 32, device="cpu", offsets=np.asarray(rj.offsets))
            for k in ("upscaler_mode", "render_scale", "samples_per_pixel", "max_bounces",
                      "use_motion_adaptive_sampling"):
                setattr(rp, k, getattr(rj, k))
        rp.draw()
        assert (rp.render_height, rp.render_width) == (16, 16)
        assert int(rp.last_rays_traced) == int(rj.last_rays_traced), f
        assert relative_rmse(rp.accum.numpy(), np.asarray(rj.accum)) < 1e-2, f
        ij, ip = rj.output_image(), rp.output_image()
        assert ip.shape == ij.shape == (32, 32, 3) and ip.dtype == np.uint8
        assert _lsb(ip, ij) <= 1, f
        assert (rp._upscale_history is None) == (mode == UPSCALER_SPATIAL)
        assert (rp._denoise_state is None) == (mode != UPSCALER_DENOISED)


def _port_renderer(mode):
    s = Scene(32, 32)
    s.models = [Model("sphere", position=[0, 0.5, 0], scale=0.5), Model("plane", scale=6)]
    r = Renderer(s, 32, 32, device="cpu", seed=1)
    r.upscaler_mode = mode
    r.samples_per_pixel = 1
    r.max_bounces = 1
    r.use_motion_adaptive_sampling = False
    return r


@pytest.mark.parametrize("mode", [UPSCALER_TEMPORAL, UPSCALER_DENOISED])
def test_presenter_history_lifecycle(mode):
    """The counterpart of tests/test_upscale.py's orbit test: an orbit drops
    the history, so the first present after it equals a history-free present
    of the same buffers; a reset property drops it too; the present writes
    the state without restarting accumulation."""
    r = _port_renderer(mode)
    for _ in range(3):
        r.draw()
        r.output_image()
    assert r._upscale_history is not None and r.frame_index == 3
    assert (r._denoise_state is not None) == (mode == UPSCALER_DENOISED)
    if mode == UPSCALER_DENOISED:
        assert float(r._denoise_state.history_length.max()) > 1.0
    r.orbit(200.0, 0.0)
    assert r._upscale_history is None and r._denoise_state is None
    r.draw()
    img_after = r.output_image()
    kept = r._upscale_history
    r._clear_presenter_history()
    img_fresh = r.output_image()
    assert np.array_equal(img_after, img_fresh)
    assert torch.equal(kept, r._upscale_history)
    # a still frame blends the history: it differs from a history-free present
    r.draw()
    lin, _, _ = presenter.present_linear(r)
    r._clear_presenter_history()
    fresh, _, _ = presenter.present_linear(r)
    assert not torch.equal(lin, fresh)
    r.output_image()
    r.max_bounces = 2  # a reset property
    assert r._upscale_history is None and r._denoise_state is None and r.frame_index == 0


def test_denoised_without_gbuffer_falls_back_to_temporal():
    r = _port_renderer(UPSCALER_TEMPORAL)
    r.draw()
    object.__setattr__(r, "upscaler_mode", UPSCALER_DENOISED)  # no G-buffer drawn yet
    lin, hist, dstate = presenter.present_linear(r)
    object.__setattr__(r, "upscaler_mode", UPSCALER_TEMPORAL)
    lin_t, hist_t, _ = presenter.present_linear(r)
    assert r.gbuffer is None and dstate is None
    assert torch.equal(lin, lin_t) and torch.equal(hist, hist_t)


def test_default_renderer_presents():
    """Renderer defaults: spatial upscaling from a 0.67-scale render."""
    s = Scene(32, 32)
    s.models = [Model("sphere", position=[0, 0.5, 0], scale=0.5), Model("plane", scale=10)]
    r = Renderer(s, 32, 32, device="cpu")
    assert r.upscaler_mode == UPSCALER_SPATIAL and r.render_scale == 0.67
    r.samples_per_pixel = 1
    r.max_bounces = 1
    r.draw()
    assert (r.render_height, r.render_width) == (21, 21)
    img = r.output_image()
    assert img.shape == (32, 32, 3) and img.dtype == np.uint8 and img.max() > 0
    r.upscaler_mode = UPSCALER_OFF
    r.draw()
    assert r.output_image().shape == (32, 32, 3) and r.accum.shape == (32, 32, 3)


def test_gbuffer_supported_and_wavefront_extras_raise():
    """enable_gbuffer and the wavefront extras (every debug texture mode,
    mipmaps) are ported and pass; the settings still outside the port (the
    flat path, geometry sharding) raise, naming their ROADMAP slice."""
    from mrt_tpu_torch.core import types as T

    T.check_supported(T.RenderSettings(enable_gbuffer=True))
    for kw in [dict(debug_mode=m) for m in range(T.DEBUG_MODE_BASECOLOR, T.DEBUG_MODE_MOTION + 1)] + [
            dict(use_mipmaps=True)]:
        T.check_supported(T.RenderSettings(**kw))
    for kw, slice_ in ((dict(two_level=False), "Slice F"), (dict(traversal_backend="lbvh"), "Slice F"),
                       (dict(geometry_axis="gp"), "Slice G")):
        with pytest.raises(NotImplementedError, match=slice_):
            T.check_supported(T.RenderSettings(**kw))
