"""The documented entry points ``python -m mrt_tpu_torch.smoke`` and
``python -m mrt_tpu_torch.demo`` on the CPU against live mrt_tpu, at 32x32.

- The smoke (``scripts/smoke_render.py``'s sphere and plane, upscaler off,
  1 spp, 1 bounce, motion-adaptive sampling off): its five draws through
  ``smoke.main`` against the JAX ``Renderer`` on the same scene with the
  same settings: each accumulation within 1 % relative RMSE (the bar of
  tests/test_golden.py), rays equal per frame; the PNG it writes decodes
  (PIL and ``read_png``) to the image it returns.
- The demo at 2 steps (``scripts/render_demo.py``'s loop: orbit(3.0, 0.6),
  then 3 draws of 1/60 s at the Renderer's defaults but 2 spp and 2
  bounces): each of its six draws through ``demo.main`` against the JAX
  ``Renderer`` driven the same way on the JAX app scene without the
  train/treefir OBJs (the JAX script's own scene needs them, and they are
  absent; it also imports ``imageio``), the robot stand-in swinging; within
  1 %, rays equal. Its GIF decodes to 2 frames of 32x32, each pixel within
  ``GIF_QUANT_ERROR`` of the step's image; the final PNG equals the last.
  An ``.mp4`` output raises before anything renders.
- ``write_gif`` on seeded random frames: PIL and ``read_gif`` decode the
  same frames, within ``GIF_QUANT_ERROR``, with the delay and the loop;
  ``read_gif`` refuses a GIF of another writer (PIL's).

Both entry points build their own ``Renderer``; the tests hand it the JAX
renderer's pixel offsets (a subclass patched into the module) and record
each draw's accumulation and rays.
"""

import numpy as np
import pytest
from PIL import Image

from mrt_tpu import UPSCALER_OFF as J_OFF
from mrt_tpu import Renderer as JRenderer
from mrt_tpu.engine.appscene import _attach_swing_rig as j_attach
from mrt_tpu.engine.scene import Model as JModel
from mrt_tpu.engine.scene import ModelMaterialOverride as JOverride
from mrt_tpu.engine.scene import Scene as JScene
from mrt_tpu.engine.scene import SkinData as JSkinData
from mrt_tpu_torch import demo, smoke
from mrt_tpu_torch.engine.renderer import Renderer
from mrt_tpu_torch.utils.image import GIF_QUANT_ERROR, read_gif, read_png, write_gif
from test_torch_render import rel_rmse
from test_torch_scene_bvh import jax_sah, one_torch_thread  # noqa: F401

SIZE = 32


def recording(monkeypatch, module, offsets):
    """Patch ``module.Renderer`` with a subclass that takes ``offsets`` and
    records (accumulation, rays) after each draw; returns the record."""
    log = []

    class Recording(Renderer):
        def __init__(self, *a, **k):
            super().__init__(*a, offsets=offsets, **k)

        def draw(self, delta_time=None):
            out = super().draw(delta_time)
            log.append((self.accum.numpy().copy(), int(self.last_rays_traced)))
            return out

    monkeypatch.setattr(module, "Renderer", Recording)
    return log


def compare(jax_log, port_log):
    assert len(port_log) == len(jax_log)
    for f, ((aj, rays_j), (ap, rays_p)) in enumerate(zip(jax_log, port_log)):
        assert np.isfinite(ap).all() and ap.max() > 0, f"draw {f}"
        assert rel_rmse(ap, aj) < 1e-2, f"draw {f}: {rel_rmse(ap, aj)}"
        assert rays_p == rays_j, f"draw {f}"


def test_smoke_matches_mrt_tpu(tmp_path, monkeypatch):
    s = JScene(width=SIZE, height=SIZE)
    s.models = [JModel("sphere", position=[0.0, 1.0, 0.0], scale=1.0),
                JModel("plane", position=[0, 0, 0], scale=10)]
    with jax_sah():
        rj = JRenderer(s, output_width=SIZE, output_height=SIZE)
    rj.upscaler_mode = J_OFF
    rj.samples_per_pixel = 1
    rj.max_bounces = 1
    rj.use_motion_adaptive_sampling = False
    jax_log = []
    for _ in range(5):
        rj.draw()
        jax_log.append((np.asarray(rj.accum), int(rj.last_rays_traced)))

    port_log = recording(monkeypatch, smoke, np.asarray(rj.offsets))
    out = tmp_path / "smoke.png"
    r, img = smoke.main(["--cpu", "--size", str(SIZE), "--out", str(out)])
    compare(jax_log, port_log)
    assert r.device.type == "cpu" and img.shape == (SIZE, SIZE, 3) and img.dtype == np.uint8
    assert np.array_equal(np.asarray(Image.open(out).convert("RGB")), img)
    assert np.array_equal(read_png(str(out)), img)


def _jax_app_scene() -> JScene:
    """The JAX app scene without the train/treefir OBJs: the robot stand-in
    as ``mrt_tpu/engine/appscene.py`` rigs it, then the static models."""
    s = JScene(width=SIZE, height=SIZE)
    robot = JModel("robot", position=[-0.5, 0.0, 1.0], rotation=[0, 0, 0], scale=0.01)
    ji, jw, rest = robot.mesh._skin_stub
    robot.scale = 1.0
    robot.skin = JSkinData(joint_indices=ji, joint_weights=jw, rest_joints=rest)
    j_attach(robot)
    s.models = [
        robot,
        JModel("dragon", position=[0.3, 0.38, 2.5], rotation=[0, np.pi / 2 * 1.2, 0], scale=1.2,
               material_override=JOverride.glass()),
        JModel("plane", position=[0, 0, 0], scale=10),
        JModel("sphere", position=[-1.9, 0.0, 0.3], scale=1),
        JModel("sphere", position=[2.9, 0.0, -0.5], scale=2),
        JModel("plane-back", position=[0, 0, -1.5], scale=10),
    ]
    return s


def test_demo_matches_mrt_tpu(tmp_path, monkeypatch):
    with jax_sah():
        rj = JRenderer(_jax_app_scene(), output_width=SIZE, output_height=SIZE)
    rj.samples_per_pixel = 2
    rj.max_bounces = 2
    jax_log = []
    for _ in range(2):
        rj.orbit(3.0, 0.6)
        for _ in range(3):
            rj.draw(1 / 60)
            jax_log.append((np.asarray(rj.accum), int(rj.last_rays_traced)))

    port_log = recording(monkeypatch, demo, np.asarray(rj.offsets))
    gif = tmp_path / "demo.gif"
    r, images = demo.main(["--cpu", "--size", str(SIZE), "--frames", "2", "--no-asset-models",
                           "--out", str(gif)])
    compare(jax_log, port_log)
    assert [m.name for m in r.scene.models][:2] == ["robot", "dragon"]
    assert (r.upscaler_mode, r.render_scale) == ("spatial", 0.67)
    assert r.use_motion_adaptive_sampling and r.use_motion_adaptive_accumulation
    assert len(images) == 2 and all(im.shape == (SIZE, SIZE, 3) for im in images)
    with Image.open(gif) as g:
        assert (g.n_frames, g.size) == (2, (SIZE, SIZE))
        for k in range(2):
            g.seek(k)
            diff = np.asarray(g.convert("RGB")).astype(int) - images[k]
            assert np.abs(diff).max() <= GIF_QUANT_ERROR, k
    assert np.array_equal(read_png(str(tmp_path / "demo_final.png")), images[-1])


def test_demo_refuses_mp4(tmp_path):
    with pytest.raises(ValueError, match="MP4 needs imageio"):
        demo.main(["--cpu", "--size", "8", "--frames", "1", "--out", str(tmp_path / "demo.mp4")])
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("shape", [(3, 37, 53), (2, 300, 7)])
def test_gif_decodes(tmp_path, shape):
    n, h, w = shape
    rng = np.random.default_rng(n * h + w)
    frames = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]
    frames[0][: h // 2] = rng.integers(0, 256, (h // 2, w, 1), dtype=np.uint8)  # greys
    path = str(tmp_path / "t.gif")
    write_gif(path, frames, duration=1 / 30, loop=0)
    ours, delays = read_gif(path)
    assert ours.shape == (n, h, w, 3) and delays == [0.03] * n
    with Image.open(path) as g:
        assert (g.n_frames, g.info["loop"], g.info["duration"]) == (n, 0, 30)
        for k in range(n):
            g.seek(k)
            pil = np.asarray(g.convert("RGB"))
            assert np.array_equal(pil, ours[k]), k
            assert np.abs(pil.astype(int) - frames[k]).max() <= GIF_QUANT_ERROR, k
    # a GIF of another writer (PIL: a table-using LZW stream) is refused, not misread
    Image.fromarray(frames[0]).save(tmp_path / "pil.gif")
    with pytest.raises(ValueError, match="write_gif does not write"):
        read_gif(str(tmp_path / "pil.gif"))
