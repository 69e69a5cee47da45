"""The HDR loader and the procedural sky against mrt_tpu/assets/hdr.py, and
the environment light they feed, against live mrt_tpu.

Tolerances: ``load_hdr`` (flat and run-length scanlines, written here) and
``procedural_sky`` bit-equal to JAX's; the config-2 scene (sphere and floor
under the sky, tests/test_golden.py) at 48x48, 2 spp, 3 bounces, 3 frames
within 1e-2 relative RMSE of mrt_tpu (the bar tests/test_golden.py uses),
rays equal every frame, in PBR and legacy shading.
"""

import numpy as np
import pytest

from mrt_tpu import UPSCALER_OFF as J_OFF
from mrt_tpu import Renderer as JRenderer
from mrt_tpu.assets import hdr as jhdr
from mrt_tpu.engine.scene import Model as JModel
from mrt_tpu.engine.scene import Scene as JScene
from mrt_tpu_torch import convert
from mrt_tpu_torch.assets import hdr
from mrt_tpu_torch.core import types as T
from test_torch_render import port_like, rel_rmse
from test_torch_scene_bvh import _bits_equal, one_torch_thread  # noqa: F401


def _rle_channel(values: np.ndarray) -> bytes:
    """One channel of an adaptive-RLE scanline: runs of 3 or more equal
    bytes as (128 + n, value), the rest as literals (n, bytes...)."""
    out, x, n = bytearray(), 0, len(values)
    while x < n:
        run = 1
        while x + run < n and run < 127 and values[x + run] == values[x]:
            run += 1
        if run >= 3:
            out += bytes([128 + run, values[x]])
            x += run
            continue
        start = x
        while x < n and x - start < 128 and not (
                x + 2 < n and values[x] == values[x + 1] == values[x + 2]):
            x += 1
        out += bytes([x - start]) + bytes(values[start:x])
    return bytes(out)


def _write_hdr(path, rgbe: np.ndarray, rle: bool):
    h, w = rgbe.shape[:2]
    data = bytearray(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode())
    for y in range(h):
        if not rle:
            data += rgbe[y].tobytes()
            continue
        data += bytes([2, 2, w >> 8, w & 0xFF])
        for c in range(4):
            data += _rle_channel(rgbe[y, :, c])
    path.write_bytes(bytes(data))


@pytest.mark.parametrize("rle", [False, True], ids=["flat", "rle"])
def test_load_hdr_matches_jax(tmp_path, rle):
    """A seeded RGBE image with runs (a constant band) and an exponent-0
    texel; flat scanlines need a width below 8, so that case is 6 wide."""
    rng = np.random.default_rng(5)
    w = 40 if rle else 6
    rgbe = rng.integers(0, 256, (7, w, 4)).astype(np.uint8)
    rgbe[:, :, 3] = rng.integers(120, 140, (7, w))
    rgbe[2, 5:30 if rle else 6] = (200, 100, 50, 130)
    rgbe[4, 1, 3] = 0
    p = tmp_path / "probe.hdr"
    _write_hdr(p, rgbe, rle)
    got, want = hdr.load_hdr(str(p)), jhdr.load_hdr(str(p))
    assert got is not None and got.shape == (7, w, 3) and got.dtype == np.float32
    assert _bits_equal(want, got)
    assert float(got[4, 1].max()) == 0.0
    bad = tmp_path / "bad.hdr"
    bad.write_bytes(b"P6\n1 1\n255\n\0\0\0")
    assert hdr.load_hdr(str(bad)) is None and jhdr.load_hdr(str(bad)) is None


def test_procedural_sky_matches_jax():
    assert _bits_equal(jhdr.procedural_sky(), hdr.procedural_sky())
    kw = dict(zenith=(0.1, 0.2, 0.9), sun_dir=(-0.3, 0.2, 0.9), sun_sharpness=200.0)
    assert _bits_equal(jhdr.procedural_sky(32, 64, **kw), hdr.procedural_sky(32, 64, **kw))


@pytest.mark.parametrize("shading", [T.SHADING_MODE_PBR, T.SHADING_MODE_LEGACY], ids=["pbr", "legacy"])
def test_environment_light_matches_mrt_tpu(shading):
    """Config 2 (tests/test_golden.py): sphere and floor under the sky at
    half intensity; the port's scene takes the sky from the port's own
    ``procedural_sky``."""
    js = JScene(width=48, height=48)
    js.models = [JModel("sphere", position=[0.0, 0.5, 0.0], scale=0.5),
                 JModel("plane", position=[0, 0, 0], scale=10)]
    js.set_environment(jhdr.procedural_sky(32, 64), intensity=0.5)
    rj = JRenderer(js, output_width=48, output_height=48, seed=1234)
    rj.upscaler_mode = J_OFF
    rj.samples_per_pixel = 2
    rj.max_bounces = 3
    rj.shading_mode = shading
    rj.use_motion_adaptive_sampling = False
    rj.draw()
    ps = convert.scene(js)
    ps.set_environment(hdr.procedural_sky(32, 64), intensity=0.5)
    rp = port_like(rj, scene=ps)
    assert rp.statics.has_environment and rp.shading_mode == shading
    for f in range(3):
        if f:
            rj.draw()
        ap, aj = rp.draw().numpy(), np.asarray(rj.accum)
        assert int(rp.last_rays_traced) == int(rj.last_rays_traced), f"frame {f}"
        assert rel_rmse(ap, aj) < 1e-2, f"frame {f}: {rel_rmse(ap, aj)}"
