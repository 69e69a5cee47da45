"""The presenter's building blocks against the JAX package on the same
inputs, made from a numpy seed: spatial resampling (jax.image.resize),
the temporal upscaler and the SVGF-lite denoiser, each side's state fed
back to itself. Tolerances: 1e-5 relative (RMSE for the multi-frame
chains), because the dot products and the resize contraction add in
another order than XLA:CPU's (which may also fuse them into FMAs); the
integer powers bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrt_tpu.upscale import denoise as jdenoise
from mrt_tpu.upscale import spatial as jspatial
from mrt_tpu.upscale import temporal as jtemporal
from mrt_tpu_torch.upscale import denoise, spatial, temporal
from mrt_tpu_torch.utils.image import relative_rmse
from test_torch_scene_bvh import one_torch_thread  # noqa: F401

TOL = 1e-5


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


@pytest.mark.parametrize("method", ["lanczos3", "bilinear"])
@pytest.mark.parametrize("src,dst", [((43, 43), (64, 64)), ((16, 24), (32, 48)),
                                     ((20, 20), (13, 13)), ((12, 20), (12, 20))],
                         ids=["scale-0.67", "2x", "downscale", "equal"])
def test_spatial_upscale_matches_jax(src, dst, method):
    x = np.random.default_rng(0).random(src + (3,), dtype=np.float32) * 3.0
    want = np.asarray(jspatial.upscale(jnp.asarray(x), *dst, method=method))
    got = spatial.upscale(_t(x), *dst, method=method).numpy()
    assert got.shape == want.shape == dst + (3,)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    if src == dst:
        assert np.array_equal(got, x)
    assert got.min() >= 0.0


def test_weight_matrix_cached_and_validated():
    a = spatial.weight_matrix(8, 16, "lanczos3", torch.device("cpu"))
    assert spatial.weight_matrix(8, 16, "lanczos3", torch.device("cpu")) is a
    assert a.shape == (8, 16) and a.dtype == torch.float32
    np.testing.assert_allclose(a.sum(0).numpy(), 1.0, atol=1e-6)  # columns normalised
    with pytest.raises(ValueError):
        spatial.weight_matrix(8, 16, "bicubic", torch.device("cpu"))


def _frame_inputs(rng, h, w, f):
    color = (rng.random((h, w, 3), dtype=np.float32) * 2.0)
    depth = (1.0 + rng.random((h, w), dtype=np.float32))
    if f == 2:
        depth[4:12, 6:20] = 9.0  # a disoccluded region
    motion = rng.uniform(-3.0, 3.0, (h, w, 2)).astype(np.float32)
    return color, depth, motion


def test_temporal_upscale_matches_jax():
    """Four frames at (24,32) -> (48,64), the first with weight 0, random
    motion within 3 px, a disoccluded depth region in the third; each
    side's history fed back."""
    rng = np.random.default_rng(1)
    h, w, oh, ow = 24, 32, 48, 64
    hist_j = jnp.zeros((oh, ow, 4), jnp.float32)
    hist_p = torch.zeros((oh, ow, 4))
    for f in range(4):
        color, depth, motion = _frame_inputs(rng, h, w, f)
        weight = 0.0 if f == 0 else 0.9
        out_j, hist_j = jtemporal.temporal_upscale(
            jnp.asarray(color), jnp.asarray(depth), jnp.asarray(motion), hist_j, oh, ow,
            history_weight=jnp.float32(weight))
        out_p, hist_p = temporal.temporal_upscale(_t(color), _t(depth), _t(motion), hist_p, oh, ow,
                                                  history_weight=weight)
        assert out_p.shape == (oh, ow, 3) and hist_p.shape == (oh, ow, 4)
        assert relative_rmse(out_p.numpy(), out_j) < TOL, f
        assert relative_rmse(hist_p.numpy(), hist_j) < TOL, f


def test_bilinear_sample_matches_jax_packed_quad():
    """The four-gather sample against the JAX package's packed quad, at
    clamped edges and out-of-bounds coordinates: equal values and masks."""
    rng = np.random.default_rng(11)
    img = rng.normal(size=(17, 23, 4)).astype(np.float32)
    rows = rng.uniform(-3, 20, size=(9, 13)).astype(np.float32)
    cols = rng.uniform(-3, 26, size=(9, 13)).astype(np.float32)
    want, want_ok = jtemporal.bilinear_sample(*(jnp.asarray(a) for a in (img, rows, cols)))
    got, got_ok = temporal.bilinear_sample(_t(img), _t(rows), _t(cols))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    assert np.array_equal(got_ok.numpy(), np.asarray(want_ok))


def _gbuffer(rng, h, w):
    n = rng.normal(size=(h, w, 3))
    n[..., 1] += 3.0
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return dict(diffuse_albedo=rng.random((h, w, 3), dtype=np.float32) * 0.8,
                specular_albedo=rng.random((h, w, 3), dtype=np.float32) * 0.1,
                normal=(n * 0.5 + 0.5).astype(np.float32),
                roughness=rng.random((h, w), dtype=np.float32))


def test_svgf_filter_matches_jax():
    """Five frames at (24,32) with each side's state fed back, motion
    within 1 px, a depth jump (disocclusion) in the fourth: the output and
    every state field within 1e-5 relative RMSE."""
    rng = np.random.default_rng(2)
    h, w = 24, 32
    st_j, st_p = jdenoise.init_state(h, w), denoise.init_state(h, w, "cpu")
    for f in range(5):
        color = rng.random((h, w, 3), dtype=np.float32) * 2.0
        depth = np.ones((h, w), np.float32)
        if f == 3:
            depth[4:10, 4:20] = 3.0
        motion = rng.uniform(-1.0, 1.0, (h, w, 2)).astype(np.float32)
        gb = _gbuffer(rng, h, w)
        gb_j = {k: jnp.asarray(v) for k, v in gb.items()}
        out_j, st_j = jdenoise.svgf_filter(jnp.asarray(color), gb_j, jnp.asarray(depth),
                                           jnp.asarray(motion), st_j)
        out_p, st_p = denoise.svgf_filter(_t(color), {k: _t(v) for k, v in gb.items()}, _t(depth),
                                          _t(motion), st_p)
        assert relative_rmse(out_p.numpy(), out_j) < TOL, f
        for field in denoise.DenoiseState._fields:
            err = relative_rmse(getattr(st_p, field).numpy(), getattr(st_j, field))
            assert err < TOL, (f, field, err)
    lengths = st_p.history_length.numpy()
    assert lengths.max() > 1.0 and lengths.min() == 1.0  # history built, and reset by the jump


def test_demodulate_filter_matches_jax():
    rng = np.random.default_rng(3)
    h, w = 20, 28
    color = rng.random((h, w, 3), dtype=np.float32)
    gb = _gbuffer(rng, h, w)
    want = np.asarray(jdenoise.demodulate_filter(jnp.asarray(color),
                                                 {k: jnp.asarray(v) for k, v in gb.items()}))
    got = denoise.demodulate_filter(_t(color), {k: _t(v) for k, v in gb.items()}).numpy()
    assert relative_rmse(got, want) < TOL


@pytest.mark.parametrize("k", [5, 3], ids=["pow32", "pow8"])
def test_integer_power_squarings_bit_equal(k):
    """The denoiser's ``x ** 32`` and ``x ** 8`` as squarings equal JAX's
    bits over [0, 1] (XLA:CPU flushes subnormal results to zero, so the
    port's CPU ops run with denormals flushed too); ``torch.pow`` does not."""
    x = np.random.default_rng(4).random(200_000, dtype=np.float32)
    want = np.asarray(jnp.asarray(x) ** (1 << k)).view(np.int32)
    assert torch.set_flush_denormal(True)
    try:
        got = denoise.pow2k(_t(x), k).numpy().view(np.int32)
        powed = torch.pow(_t(x), float(1 << k)).numpy().view(np.int32)
    finally:
        torch.set_flush_denormal(False)
    assert np.array_equal(got, want)
    assert not np.array_equal(powed, want)


def test_resize_refuses_tf32_on_the_card(monkeypatch):
    """On a CUDA tensor the resize products refuse to run while TF32 is
    allowed (a stand-in tensor reports is_cuda; the check comes before any
    product)."""

    class FakeCuda:
        is_cuda = True
        shape = (4, 4, 3)

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="TF32"):
        spatial.resize(FakeCuda(), 8, 8, "lanczos3")
