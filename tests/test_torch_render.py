"""The whole slice against live mrt_tpu on the config-3 scene of
tests/golden_scenes.py (glass, emissive, textured floor with a normal map,
all four light types) at 64x64, 2 spp, 3 bounces, 3 frames.

The port compiles the scene and builds its BVH itself; the JAX renderer's
pixel offsets are injected. Tolerances: the accumulation within 1% relative
RMSE of mrt_tpu (the bar tests/test_golden.py uses), rays_traced equal every
frame, output_image within 1 LSB. JAX runs with fused and with unfused
shadow rays; the port always traces them unfused. Power-weighted light
sampling and the third-person (TPS) view run at 48x48, 2 spp, 3 bounces, 3
frames. In the TPS view one lane of frame 2 (lane 409: row 8, column 25)
traces one ray more in the port: its camera ray hits the glass sphere at
t = 5.687241 in the port and 5.687242 in mrt_tpu, the same leaf test
rounded unfused and with XLA:CPU's contracted multiply-adds (ROADMAP
Q3-P1; the scalar float64 intersection of tests/oracle_renderer.py gives
5.6872416), and the path through the glass parts there. That lane, by one
ray, is the only difference the test allows."""

import numpy as np
import pytest

import mrt_tpu.engine.renderer as jrenderer
from golden_scenes import config3_renderer
from mrt_tpu_torch import UPSCALER_OFF, Renderer, convert
from mrt_tpu_torch.render import wavefront as wf
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
    for k in ("samples_per_pixel", "max_bounces", "shading_mode", "debug_texture_mode",
              "use_mipmaps", "light_sampling", "view_mode"):
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


def test_power_light_sampling_matches_mrt_tpu():
    """light_sampling="power" on config 3 (four lights of unequal power)."""
    rj = config3_renderer(size=48, spp=2, bounces=3)
    rj.light_sampling = "power"
    rj.draw()
    rp = port_like(rj)
    assert rp.light_sampling == "power"
    compare_frames(rj, rp, 3)


def test_tps_view_matches_mrt_tpu(monkeypatch):
    """The third-person view on config 3: per-lane rays equal to mrt_tpu's
    in every frame but for the one documented lane (module docstring)."""
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
    rj = config3_renderer(size=48, spp=2, bounces=3)
    rj.view_mode = "tps"
    rj.draw()
    rp = port_like(rj)
    assert rp.view_mode == "tps"
    for f in range(3):
        if f:
            rj.draw()
        ap, aj = rp.draw().numpy(), np.asarray(rj.accum)
        extra = lane_rays["p"][-1] - lane_rays["j"][-1]
        lanes = np.nonzero(extra)[0].tolist()
        assert lanes == ([409] if f == 2 else []) and extra[lanes].tolist() == [1] * len(lanes), (
            f"frame {f}: lanes {lanes}, rays {extra[lanes].tolist()}")
        assert int(rp.last_rays_traced) == int(rj.last_rays_traced) + len(lanes)
        assert rel_rmse(ap, aj) < 1e-2, f"frame {f}: {rel_rmse(ap, aj)}"
    assert np.abs(rp.output_image().astype(int) - rj.output_image().astype(int)).max() <= 1
