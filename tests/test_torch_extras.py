"""The wavefront's extras against live mrt_tpu: the seven debug views and
mipmapped texture sampling (the atlas's mip chain, ``sample_trilinear`` and
the ray-cone LOD in a render), on the config-3 scene of
tests/golden_scenes.py (a textured floor with a normal map, glass, an
emissive sphere, four light types).

Tolerances: a debug view's accumulation within 1e-5 relative RMSE of
mrt_tpu and rays equal every frame (a debug view colours the first hit and
retires the lane, so only the camera rays' hits enter it). mrt_tpu's motion
view (mode 7) does not trace: it selects a (P,2) motion with a (P,) sample
condition (mrt_tpu/render/wavefront.py:684-685), which does not broadcast.
So the port's motion view is held, frame by frame and within 1e-5, to the
colour mrt_tpu's own buffers give it: the first hit's motion and depth and
the share of samples that hit, all from mrt_tpu's roughness view (mode 3,
the same first hits; roughness is 1 on every hit of this scene). The
atlas's mip rects, levels and texels bit-equal; ``sample_trilinear`` within
1e-6 absolute; a config-3 render with mipmaps within 1e-2 relative RMSE (the
bar tests/test_golden.py uses), rays equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mrt_tpu.engine.renderer as jrenderer
from golden_scenes import config3_renderer
from mrt_tpu.assets import texture as jtex
from mrt_tpu_torch.assets import texture as tex
from mrt_tpu_torch.core import types as T
from mrt_tpu_torch.render import wavefront as wf
from test_torch_render import port_like, rel_rmse
from test_torch_scene_bvh import _bits_equal, one_torch_thread  # noqa: F401

SIZE = 48


def _draw_both(rj, rp, frames, tol, between=None):
    """``frames`` frames on both (JAX's first already drawn): rays equal,
    accumulation within ``tol`` relative RMSE."""
    for f in range(frames):
        if f:
            if between is not None:
                between(f)
            rj.draw()
        ap = rp.draw().numpy()
        aj = np.asarray(rj.accum)
        assert int(rp.last_rays_traced) == int(rj.last_rays_traced), f"frame {f}"
        assert np.isfinite(ap).all()
        assert rel_rmse(ap, aj) < tol, f"frame {f}: {rel_rmse(ap, aj)}"


def _close(a, b, tol):
    """Within ``tol`` relative RMSE, or equal (a view that is black in both)."""
    return np.array_equal(a, b) or rel_rmse(a, b) < tol


def _motion_colour(mp):
    """The motion view's colour of (P,2) motion in pixels."""
    scaled = np.clip(mp * 0.05, -1.0, 1.0)
    mag = np.clip(np.sqrt(mp[:, 0] * mp[:, 0] + mp[:, 1] * mp[:, 1]) * 0.1, 0.0, 1.0)
    return np.stack([scaled[:, 0] * 0.5 + 0.5, scaled[:, 1] * 0.5 + 0.5, mag], -1)


@pytest.mark.parametrize("mode", range(T.DEBUG_MODE_BASECOLOR, T.DEBUG_MODE_MOTION + 1))
def test_debug_view_matches_mrt_tpu(mode, monkeypatch):
    """Each debug view over 3 frames in which the emissive sphere moves
    sideways (so the motion view shows motion): equal to mrt_tpu within 1e-5 (mode 7: to
    what mrt_tpu's buffers give, see the module docstring)."""
    motion_view = mode == T.DEBUG_MODE_MOTION
    rj = config3_renderer(size=SIZE, spp=2, bounces=3)
    rj.debug_texture_mode = T.DEBUG_MODE_ROUGHNESS if motion_view else mode
    jout, pout = [], []
    trace_j, trace_p = jrenderer._trace_all_tiles_frame, wf.trace_frame

    def flat(out):  # a frame's colour, motion and depth, one row per pixel
        return [np.asarray(x).reshape(SIZE * SIZE, -1) for x in (out.color, out.motion, out.depth)]

    def keep_j(*a, **k):
        out, rays = trace_j(*a, **k)
        jout.append(flat(out))
        return out, rays

    def keep_p(*a, **k):
        out = trace_p(*a, **k)
        pout.append(flat(out))
        return out

    monkeypatch.setattr(jrenderer, "_trace_all_tiles_frame", keep_j)
    monkeypatch.setattr(wf, "trace_frame", keep_p)
    rj.draw()
    rp = port_like(rj)
    rp.debug_texture_mode = mode

    def move(f):
        for s in (rj.scene, rp.scene):
            s.move_model(2, right=0.1 * f)

    if not motion_view:
        for f in range(3):
            if f:
                move(f)
                rj.draw()
            ap, aj = rp.draw().numpy(), np.asarray(rj.accum)
            assert int(rp.last_rays_traced) == int(rj.last_rays_traced), f"frame {f}"
            assert np.isfinite(ap).all() and _close(ap, aj, 1e-5), f"frame {f}"
        return
    prev = np.zeros((SIZE * SIZE, 2), np.float32)
    for f in range(3):
        if f:
            move(f)
            rj.draw()
        rp.draw()
        assert int(rp.last_rays_traced) == int(rj.last_rays_traced) == SIZE * SIZE * 2
        (hit_share, jmot, jdepth), (pcol, pmot, _) = jout[-1], pout[-1]
        want = _motion_colour(np.where(jdepth < 1e8, jmot, prev)) * hit_share[:, :1]
        assert _close(pmot, jmot, 1e-5) and _close(pcol, want, 1e-5), f"frame {f}"
        prev = jmot
    assert float(rp.motion.abs().max()) > 0.5  # the sphere moves


def _jax_and_port_atlases():
    """One atlas per package from the same seeded maps: square, odd-sized
    and 1-pixel-wide images, a resource with no maps, an sRGB base colour."""
    rng = np.random.default_rng(3)
    maps = [{jtex.MAP_BASECOLOR: rng.random((16, 16, 3)).astype(np.float32),
             jtex.MAP_NORMAL: rng.random((8, 8, 3)).astype(np.float32)},
            {},
            {jtex.MAP_ROUGHNESS: rng.random((13, 7)).astype(np.float32),
             jtex.MAP_EMISSION: rng.random((5, 1, 3)).astype(np.float32)}]
    jb, pb = jtex.AtlasBuilder(), tex.AtlasBuilder()
    for m in maps:
        assert jb.add_resource(m) == pb.add_resource(m)
    return jb.build(), pb.build()


def test_mip_rects_equal_jax():
    ja, pa = _jax_and_port_atlases()
    for f in ("texels", "rects", "has_map", "mip_rects", "n_levels", "packed", "packed_rects"):
        assert _bits_equal(getattr(ja, f), getattr(pa, f).numpy()), f
    assert int(pa.n_levels[0, tex.MAP_BASECOLOR]) == 5  # 16 -> 8 -> 4 -> 2 -> 1


def test_sample_trilinear_matches_jax():
    """Seeded uv (inside and outside [0, 1]) and LODs (below 0 and past the
    last level) over every resource and map: within 1e-6 of JAX's."""
    ja, pa = _jax_and_port_atlases()
    rng = np.random.default_rng(11)
    n = 4096
    res = rng.integers(0, 3, n).astype(np.int32)
    uv = rng.uniform(-1.5, 2.5, (n, 2)).astype(np.float32)
    lod = rng.uniform(-8.0, 4.0, n).astype(np.float32)
    for mt in range(tex.N_MAP_TYPES):
        j = np.asarray(jtex.sample_trilinear(ja, jnp.asarray(res), mt, jnp.asarray(uv),
                                             jnp.asarray(lod)))
        p = tex.sample_trilinear(pa, torch.as_tensor(res), mt, torch.as_tensor(uv),
                                 torch.as_tensor(lod)).numpy()
        np.testing.assert_allclose(p, j, rtol=0, atol=1e-6, err_msg=f"map {mt}")
        jb = np.asarray(jtex.sample_bilinear(ja, jnp.asarray(res), mt, jnp.asarray(uv)))
        pbl = tex.sample_bilinear(pa, torch.as_tensor(res), mt, torch.as_tensor(uv)).numpy()
        np.testing.assert_allclose(pbl, jb, rtol=0, atol=1e-6, err_msg=f"map {mt}")


def test_config3_mipmaps_matches_mrt_tpu():
    rj = config3_renderer(size=SIZE, spp=2, bounces=3)
    rj.use_mipmaps = True
    rj.draw()
    rp = port_like(rj)
    assert rp.use_mipmaps
    _draw_both(rj, rp, 3, 1e-2)
