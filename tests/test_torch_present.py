"""Kernel K1 (present) and the presenter: the plain PyTorch version against
the JAX package's tonemap_quantize (its CPU branch, _jnp_fallback) on the
edge set chip_smoke.py uses, and the presenter's modes (the chains in
detail: test_torch_upscale.py, test_torch_presenter.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrt_tpu.kernels.present import tonemap_quantize as jax_tonemap_quantize
from mrt_tpu.upscale import spatial as jax_spatial
from mrt_tpu_torch import UPSCALER_OFF, UPSCALER_TEMPORAL, Model, Renderer, Scene
from mrt_tpu_torch.kernels import present
from mrt_tpu_torch.upscale import spatial


@pytest.mark.parametrize("seed", [0, 1])
def test_present_plain_equals_jax(seed):
    """uint8-equal (tolerance: none) over zeros, tiny/denormal, huge, exact
    .5 landings and random values; NaN/inf are excluded on both sides."""
    x = present.edge_case_inputs(96, 160, seed=seed)
    got = present.tonemap_quantize(x)
    want = np.asarray(jax_tonemap_quantize(jnp.asarray(x.numpy())))
    assert got.dtype == torch.uint8 and got.shape == (96, 160, 3)
    assert np.array_equal(got.numpy(), want)
    assert present.launches == 0  # CPU tensors never reach the kernel


def test_edge_inputs_hit_every_case():
    x = present.edge_case_inputs(64, 64)
    q = present.tonemap_quantize_plain(x)
    assert bool(torch.isfinite(x).all())
    assert int(q.min()) == 0 and int(q.max()) == 255
    tone = x / (1.0 + x) * 255.0
    assert bool(((tone - torch.floor(tone)) == 0.5).any())  # exact .5 landings present


def test_non_cuda_device_raises():
    with pytest.raises(ValueError):
        present.tonemap_quantize(torch.zeros((2, 2, 3), device="meta"))


def test_spatial_identity_and_unported_resample():
    """Identity at equal size; resampling (once unported) matches JAX's."""
    c = torch.rand(8, 10, 3, generator=torch.Generator().manual_seed(0))
    assert spatial.upscale(c, 8, 10) is c
    up = spatial.upscale(c, 16, 20)
    want = np.asarray(jax_spatial.upscale(jnp.asarray(c.numpy()), 16, 20))
    assert up.shape == (16, 20, 3)
    np.testing.assert_allclose(up.numpy(), want, rtol=1e-5, atol=1e-6)


def _renderer():
    scene = Scene(16, 16)
    scene.models = [Model("sphere", position=[0, 0.5, 0], scale=0.5), Model("plane", scale=10)]
    r = Renderer(scene, 16, 16, device="cpu", seed=2)
    r.upscaler_mode = UPSCALER_OFF
    r.use_motion_adaptive_sampling = False
    r.samples_per_pixel = 1
    r.max_bounces = 1
    return r


def test_output_image_flips_rows_and_quantizes():
    r = _renderer()
    r.draw()
    img = r.output_image()
    dev_img = r.present_device()
    assert img.shape == (16, 16, 3) and img.dtype == np.uint8
    assert np.array_equal(img, dev_img.numpy()[::-1])
    assert np.array_equal(dev_img.numpy(), present.tonemap_quantize_plain(r.accum).numpy())


def test_unported_presenter_modes_raise():
    """The temporal mode (once unported) presents: a 0.67-scale render
    upscaled to the output size, with its history kept."""
    r = _renderer()
    r.draw()
    r.upscaler_mode = UPSCALER_TEMPORAL
    r.draw()
    img = r.output_image()
    assert (r.render_height, r.render_width) == (11, 11)
    assert img.shape == (16, 16, 3) and img.dtype == np.uint8 and img.max() > 0
    assert r._upscale_history.shape == (16, 16, 4)
