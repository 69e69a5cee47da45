"""The presenter's building blocks against the JAX package on the same
inputs, made from a numpy seed: spatial resampling (jax.image.resize;
K12's plain version and its banded tables), the temporal upscaler and the
SVGF-lite denoiser, each side's state fed back to itself. Tolerances: 1e-5
relative (RMSE for the multi-frame chains), because the dot products and
the resize contraction add in another order than XLA:CPU's (which may also
fuse them into FMAs); the integer powers bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mrt_tpu.upscale import denoise as jdenoise
from mrt_tpu.upscale import spatial as jspatial
from mrt_tpu.upscale import temporal as jtemporal
from mrt_tpu_torch.kernels import presenter as K
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
    """On a CUDA tensor the dense resize products (``resize_dense``, the
    reference K12 is held to on the card) refuse to run while TF32 is
    allowed (a stand-in tensor reports is_cuda; the check comes before any
    product)."""

    class FakeCuda:
        is_cuda = True
        shape = (4, 4, 3)

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="TF32"):
        spatial.resize_dense(FakeCuda(), 8, 8, "lanczos3")


_RESIZES = pytest.mark.parametrize("src,dst", [((43, 43), (64, 64)), ((16, 24), (32, 48)),
                                               ((20, 20), (13, 13)), ((12, 20), (12, 20))],
                                   ids=["scale-0.67", "2x", "downscale", "equal"])


def _tables(src, dst, method):
    cpu = torch.device("cpu")
    return (spatial.band_table(src[0], dst[0], method, cpu),
            spatial.band_table(src[1], dst[1], method, cpu))


@pytest.mark.parametrize("channels", [3, 6])
@pytest.mark.parametrize("method", ["lanczos3", "bilinear"])
@_RESIZES
def test_resize_plain_matches_jax(src, dst, method, channels):
    """K12's plain version against ``jax.image.resize`` (the JAX package's
    resize) within TOL of the largest value, at the spatial chain's scale
    (0.67), 2x, a downscale (K > 6 taps) and an equal size (exact)."""
    x = np.random.default_rng(channels).random(src + (channels,), dtype=np.float32) * 3.0
    want = np.asarray(jax.image.resize(jnp.asarray(x), dst + (channels,), method=method))
    got = K.resize_plain((_t(x),), *_tables(src, dst, method)).numpy()
    assert got.shape == want.shape == dst + (channels,)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    if src == dst:
        assert np.array_equal(got, x)


@pytest.mark.parametrize("method", ["lanczos3", "bilinear"])
@_RESIZES
def test_resize_plain_matches_dense_products(src, dst, method):
    """K12's plain version against the dense ``weight_matrix`` products
    (``resize_dense``) within 1e-6 of the largest value: the same weights,
    summed in another order."""
    x = np.random.default_rng(5).normal(size=src + (6,)).astype(np.float32)
    want = spatial.resize_dense(_t(x), *dst, method).numpy()
    got = K.resize_plain((_t(x),), *_tables(src, dst, method)).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("method", ["lanczos3", "bilinear"])
def test_resize_sources_bit_equal_to_cat(method):
    """Colour, depth and motion as three sources: bit-equal to the resize
    of their ``torch.cat`` (the temporal chain's form), through the
    wrapper; the clamp is ``clamp_min(out, 0)``, NaN kept."""
    rng = np.random.default_rng(9)
    color, depth, motion = (_t(rng.normal(size=(21, 30) + c).astype(np.float32))
                            for c in ((3,), (), (2,)))
    color[3, 4, 1] = float("nan")
    whole = spatial.resize(torch.cat([color, depth[..., None], motion], dim=-1), 40, 57, method)
    parts = spatial.resize((color, depth, motion), 40, 57, method)
    assert parts.shape == (40, 57, 6) and parts.is_contiguous()
    assert torch.equal(parts.view(torch.int32), whole.view(torch.int32))
    clamped = spatial.resize(color, 40, 57, method, clamp=True)
    assert torch.equal(clamped.view(torch.int32),
                       torch.clamp_min(whole[..., :3], 0.0).view(torch.int32))
    assert bool(clamped.isnan().any()) and float(clamped.nan_to_num(0.0).min()) == 0.0


@pytest.mark.parametrize("method,n_in,n_out,k", [
    ("lanczos3", 1080, 2160, 6), ("lanczos3", 686, 1024, 6), ("bilinear", 1080, 2160, 2),
    ("bilinear", 1920, 3840, 2), ("lanczos3", 20, 13, 10), ("bilinear", 20, 13, 4),
    ("bilinear", 12, 12, 1)])
def test_band_tables(method, n_in, n_out, k):
    """The banded tables: K the widest span of non-zero weights (6 for
    Lanczos-3 upscaling, 2 for bilinear, wider when shrinking, 1 for an
    axis kept), first indices rising and inside the input, every weight of
    the dense matrix in its band, the tile spans the most inputs a K12
    tile's consecutive outputs read (its height's and its width's)."""
    band = spatial.band_table(n_in, n_out, method, torch.device("cpu"))
    assert band.weights.shape == (n_out, k) and band.first.dtype == torch.int32
    first = band.first.numpy().astype(np.int64)
    assert (np.diff(first) >= 0).all() and first.min() >= 0 and first.max() + k <= n_in
    if n_in != n_out:
        dense = np.zeros((n_in, n_out), np.float32)
        dense[first[:, None] + np.arange(k), np.arange(n_out)[:, None]] = band.weights.numpy()
        assert np.array_equal(dense, spatial.weight_matrix(n_in, n_out, method,
                                                           torch.device("cpu")).numpy())
    for tile, span in ((K.RESIZE_TILE_H, band.span_h), (K.RESIZE_TILE_W, band.span_w)):
        ends = first[np.minimum(np.arange(0, n_out, tile) + tile, n_out) - 1] + k
        assert span == int((ends - first[::tile]).max())
    assert spatial.band_table(n_in, n_out, method, torch.device("cpu")) is band


def test_band_of_refuses_a_split_column():
    """A column whose non-zero weights do not fit the band its neighbours
    set (the first indices would fall) raises."""
    m = torch.zeros((8, 3))
    m[5, 0] = m[6, 0] = 0.5  # column 0 starts at 5
    m[0, 1] = m[1, 1] = 0.5  # column 1 at 0: not rising
    m[6, 2] = m[7, 2] = 0.5
    with pytest.raises(ValueError, match="outside its band"):
        K.band_of(m)


def test_resize_wrapper_raises():
    x = torch.ones((6, 8, 3))
    rows, cols = _tables((6, 8), (12, 16), "bilinear")
    with pytest.raises(ValueError, match="unsupported device"):
        K.resize((torch.ones((6, 8, 3), device="meta"),), rows, cols)
    with pytest.raises(TypeError, match="float32"):
        K.resize((x.double(),), rows, cols)
    with pytest.raises(ValueError, match="not contiguous"):
        K.resize((torch.ones((8, 6, 3)).transpose(0, 1),), rows, cols)
    with pytest.raises(ValueError, match="channels"):
        K.resize((x, x, x), rows, cols)
    with pytest.raises(ValueError, match="tables"):
        K.resize((x,), cols, rows)
    with pytest.raises(ValueError, match="sources"):
        K.resize((x,) * 4, rows, cols)
    with pytest.raises(ValueError, match="shape"):
        K.resize((x, torch.ones((6, 9))), rows, cols)
    assert K.resize((x, x[..., 0].contiguous()), rows, cols).shape == (12, 16, 4)


@pytest.mark.parametrize("dst", [(108, 192), (80, 143)], ids=["2x", "1.49x"])
def test_interpolate_matches_jax_bilinear(dst):
    """``torch.nn.functional.interpolate(mode="bilinear",
    align_corners=False)``, the PyTorch call ``chip_smoke.py`` times beside
    K12's bilinear form (``library_ms``), computes the same function as
    ``jax.image.resize`` when upscaling: within 1e-6 of the largest value
    on a 54 x 96 x 6 input at 2x and 1.49x."""
    x = np.random.default_rng(12).random((54, 96, 6), dtype=np.float32) * 3.0
    want = np.asarray(jax.image.resize(jnp.asarray(x), dst + (6,), method="bilinear"))
    got = F.interpolate(_t(x).permute(2, 0, 1)[None], size=dst, mode="bilinear",
                        align_corners=False)[0].permute(1, 2, 0).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
