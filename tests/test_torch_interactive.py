"""The port's REPL driver (``python -m mrt_tpu_torch.interactive``) against
the JAX package's ``scripts/interactive.py``.

Each command of the JAX REPL's test script goes through the port's
``run_commands`` on a small procedural scene (the robot stand-in, a floor,
a sphere; 24x24) and through the same renderer calls on mrt_tpu's renderer
(the branch of ``scripts/interactive.py:main`` for that command, then a
draw): after each, both renderers hold the same controls (camera, settings,
render size, frame index) and their scenes the same model transforms and
lights; ``instancing 0`` switches both to the flat BVH. The driver itself runs
in a subprocess on the CPU over the app scene without its OBJ models and
keeps the JAX REPL's accumulation-restart sequence.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mrt_tpu.core import types as JT
from mrt_tpu_torch import interactive
from test_torch_animated import _configure, _models
from test_torch_scene_bvh import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = """\
orbit 2 1
zoom -0.5
preset isometric
spp 1
bounces 1
scale 0.5
upscaler spatial
shading legacy
shading pbr
debug 1
debug 0
light 2.0
mode tps
w
q
a
mode world
accum 0.8
frames 2
stream 4
priming on
instancing 0
upscaler off
"""

CONTROLS = ("frame_index", "camera_azimuth", "camera_elevation", "camera_distance",
            "camera_fov_degrees", "samples_per_pixel", "max_bounces", "render_scale",
            "accumulation_weight", "upscaler_mode", "shading_mode", "debug_texture_mode",
            "view_mode", "traversal_stream", "hit_priming", "two_level", "render_width",
            "render_height")


def _jax_command(r, cmd, args):
    """scripts/interactive.py's branch for ``cmd`` on mrt_tpu's renderer,
    then its frame (draws as many frames)."""
    scene = r.scene
    shading = {"pbr": JT.SHADING_MODE_PBR, "legacy": JT.SHADING_MODE_LEGACY}
    n = 1
    if cmd == "orbit":
        r.orbit(float(args[0]), float(args[1]))
    elif cmd == "zoom":
        r.zoom(float(args[0]))
    elif cmd == "preset":
        r.apply_view_preset(args[0])
    elif cmd in ("w", "s"):
        scene.move_model(r.player_model_index, forward=0.1 if cmd == "w" else -0.1)
    elif cmd in ("a", "d"):
        scene.move_model(r.player_model_index, right=-0.1 if cmd == "a" else 0.1)
    elif cmd in ("q", "e"):
        scene.rotate_model(r.player_model_index, 0.1 if cmd == "q" else -0.1)
    elif cmd == "spp":
        r.samples_per_pixel = int(args[0])
    elif cmd == "bounces":
        r.max_bounces = max(1, min(5, int(args[0])))
    elif cmd == "scale":
        r.render_scale = float(args[0])
    elif cmd == "accum":
        r.accumulation_weight = float(np.clip(float(args[0]), 0, 0.95))
    elif cmd == "upscaler":
        r.upscaler_mode = args[0]
    elif cmd == "shading":
        r.shading_mode = shading[args[0]]
    elif cmd == "debug":
        r.debug_texture_mode = int(args[0])
    elif cmd == "light":
        scene.set_light_intensity(float(np.clip(float(args[0]), 0, 50)))
    elif cmd == "mode":
        r.view_mode = args[0]
    elif cmd == "frames":
        n = int(args[0])
    elif cmd == "stream":
        r.traversal_stream = int(args[0])
    elif cmd == "priming":
        r.hit_priming = args[0] in ("1", "on", "true")
    elif cmd == "instancing":
        r.two_level = args[0] in ("1", "on", "true")
    else:
        raise AssertionError(cmd)
    for _ in range(n):
        r.draw()
    r.output_image()


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same_controls(rj, rp, line):
    for name in CONTROLS:
        assert getattr(rp, name) == getattr(rj, name), (line, name)
    for mj, mp in zip(rj.scene.models, rp.scene.models):
        for f in ("position", "rotation", "scale"):
            assert np.array_equal(np.asarray(getattr(mp, f)), np.asarray(getattr(mj, f))), (line, f)
    assert np.array_equal(_host(rp.scene.lights.color), _host(rj.scene.lights.color)), line


def test_each_command_leaves_the_same_state(tmp_path, capsys):
    from mrt_tpu_torch import UPSCALER_OFF, Renderer, Scene

    scene = Scene(24, 24)
    scene.models = _models("port", robot=True)
    rp = Renderer(scene, 24, 24, device="cpu")
    _configure(rp, UPSCALER_OFF, robot=True)
    rj = _jax_renderer_like(24)
    out = str(tmp_path / "frame.png")
    for line in SCRIPT.splitlines():
        cmd, args = line.split()[0], line.split()[1:]
        interactive.run_commands(rp, [line], out)
        printed = capsys.readouterr().out
        _jax_command(rj, cmd, args)
        if cmd == "instancing":
            assert type(rp.bvh).__name__ == type(rj.bvh).__name__ == "WideBVH"
        assert printed.splitlines()[-1] == f"frame {rp.frame_index} -> {out}", (line, printed)
        _assert_same_controls(rj, rp, line)
    assert os.path.getsize(out) > 0


def _jax_renderer_like(size):
    from mrt_tpu import Renderer as JRenderer
    from mrt_tpu import UPSCALER_OFF as J_OFF
    from mrt_tpu.engine.scene import Scene as JScene

    s = JScene(size, size)
    s.models = _models("jax", robot=True)
    r = JRenderer(s, size, size)
    _configure(r, J_OFF, robot=True)
    return r


def test_repl_prints_and_survives_bad_input(tmp_path, capsys):
    from mrt_tpu_torch import UPSCALER_OFF, Renderer, Scene

    scene = Scene(16, 16)
    scene.models = _models("port", robot=False)
    r = Renderer(scene, 16, 16, device="cpu")
    _configure(r, UPSCALER_OFF, robot=False)
    out, saved = str(tmp_path / "f.png"), str(tmp_path / "saved.png")
    interactive.run_commands(r, ["", "bogus 1", "spp x", "shading nope", "loop 2 1.0", "stats",
                                 f"save {saved}", "quit", "frames 5"], out)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"frame 1 -> {out}"
    assert lines[1] == "unknown command: bogus"
    assert lines[2].startswith("error:") and lines[3].startswith("error:")
    assert lines[4].startswith("loop 2 frames in ") and lines[4].endswith(" fps")
    assert "mrays_per_s" in lines[5] and lines[6] == f"saved {saved}"
    assert len(lines) == 7 and r.frame_index == 1  # quit stopped before "frames 5"
    from PIL import Image

    assert np.asarray(Image.open(saved)).shape == (16, 16, 3)


ORBIT_SCRIPT = """\
frames 2
orbit 2 1
frames 2
zoom -0.3
quit
"""


@pytest.mark.parametrize("script", ["control", "orbit"])
def test_repl_subprocess(script, tmp_path):
    """``python -m mrt_tpu_torch.interactive --device cpu`` over the app scene
    without its OBJ models: the JAX REPL test's scripts run to their end;
    orbit and zoom restart the accumulation (frames 1, 3, 1, 3, 1)."""
    out = tmp_path / "frame.png"
    text = (SCRIPT + f"loop 2 1.0\nstats\nsave {out}\nquit\n") if script == "control" else ORBIT_SCRIPT
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, "-m", "mrt_tpu_torch.interactive", "--device", "cpu", "--size",
                        "32",
                        "--no-asset-models", "--out", str(out)],
                       input=text, capture_output=True, text=True, cwd=REPO, timeout=600, env=env)
    assert p.returncode == 0, p.stderr[-800:]
    assert out.exists() and out.stat().st_size > 0
    seq = [int(l.split()[1]) for l in p.stdout.splitlines() if l.startswith("frame ")]
    if script == "orbit":
        assert seq == [1, 3, 1, 3, 1], seq
    else:
        assert "fps" in p.stdout and "mrays_per_s" in p.stdout and f"saved {out}" in p.stdout
