"""The whole slice against live mrt_tpu on the config-3 scene of
tests/golden_scenes.py (glass, emissive, textured floor with a normal map,
all four light types) at 64x64, 2 spp, 3 bounces, 3 frames.

The port compiles the scene and builds its BVH itself; the JAX renderer's
pixel offsets are injected. Tolerances: the accumulation within 1% relative
RMSE of mrt_tpu (the bar tests/test_golden.py uses), rays_traced equal every
frame, output_image within 1 LSB. JAX runs with fused and with unfused
shadow rays; the port always traces them unfused."""

import numpy as np
import pytest

from golden_scenes import config3_renderer
from mrt_tpu_torch import UPSCALER_OFF, Renderer, convert
from test_torch_scene_bvh import one_torch_thread  # noqa: F401

SIZE = 64


def rel_rmse(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


def port_like(rj, scene=None, **kw):
    """A port renderer with the JAX renderer's settings and pixel offsets
    (read after its first draw, when they have the render size)."""
    rp = Renderer(scene if scene is not None else convert.scene(rj.scene), rj.output_width,
                  rj.output_height, device="cpu", offsets=np.asarray(rj.offsets), **kw)
    rp.upscaler_mode = UPSCALER_OFF
    rp.use_motion_adaptive_sampling = False
    for k in ("samples_per_pixel", "max_bounces", "shading_mode"):
        setattr(rp, k, getattr(rj, k))
    return rp


def compare_frames(rj, rp, frames: int, between=None):
    """Draw ``frames`` frames on both (JAX's first already drawn) and hold
    accumulation, rays and image to the module's tolerances. Returns the
    port's per-frame ray counts."""
    rays = []
    for f in range(frames):
        if f:
            if between is not None:
                between(f)
            rj.draw()
        aj = np.asarray(rj.accum)
        ap = rp.draw().numpy()
        rays.append(int(rp.last_rays_traced))
        assert rays[-1] == int(rj.last_rays_traced), f"frame {f}"
        assert np.isfinite(ap).all() and ap.max() > 0
        assert rel_rmse(ap, aj) < 1e-2, f"frame {f}: {rel_rmse(ap, aj)}"
    ij, ip = rj.output_image(), rp.output_image()
    assert ip.shape == ij.shape and ip.dtype == np.uint8
    assert np.abs(ip.astype(int) - ij.astype(int)).max() <= 1
    return rays


@pytest.mark.parametrize("fuse", [True, False])
def test_config3_matches_mrt_tpu(fuse):
    rj = config3_renderer(size=SIZE, spp=2, bounces=3)
    rj.fuse_shadow_rays = fuse
    rj.draw()
    rp = port_like(rj)
    rays = compare_frames(rj, rp, 3)
    report = rp.stats.report()
    assert report["frames"] == 3 and report["total_rays"] == sum(rays)
