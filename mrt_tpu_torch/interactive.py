"""Interactive terminal driver — counterpart of ``scripts/interactive.py``
(the GameViewController analog, GameViewController.swift:70-341): the same
runtime controls on the port's ``Renderer``, over the same app scene, driven
by a REPL. Frames stream to a PNG (and, with --ansi, to a truecolor
terminal preview).

    python -m mrt_tpu_torch.interactive [--device cpu] [--size N] [--out PATH]
                                        [--ansi] [--no-asset-models]

It runs on the card unless ``--device cpu`` is given.
``--no-asset-models`` leaves the train and treefir OBJs out of the app
scene, as ``make_app_scene(asset_models=False)`` does, where they are not
installed.

Controls (one command per line; an empty line draws one more frame):
  orbit DX DY     pan-equivalent orbit (sensitivity 0.005, Renderer.swift:1330)
  zoom D          magnify-equivalent zoom
  preset NAME     front|back|left|right|top|bottom|isometric|free
  w/a/s/d         move player model (TPS), q/e rotate (GameViewController:345-372)
  spp N           samples per pixel {1,2,4,8,16}
  bounces N       max bounces 1-5
  scale F         render scale {0.34,0.5,0.67,0.75,1.0}
  accum F         accumulation weight 0-0.95
  upscaler M      off|spatial|temporal|denoised
  shading M       pbr|legacy
  debug N         0-7 debug texture mode
  light F         light intensity 0-50
  mode M          world|tps
  frames N        draw N frames
  loop N [DX]     N frames back to back, orbiting DX each, with an FPS readout
  save PATH       write current image
  stats           print frame stats
  instancing B    two-level BVH on/off (off: the flat single-level BVH, rebuilt)
  stream N        traversal stream window (kept, changes no result)
  priming B       hit priming on/off (kept, changes no result)
  quit
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

from .core import types as T
from .utils.image import write_png

SHADING = {"pbr": T.SHADING_MODE_PBR, "legacy": T.SHADING_MODE_LEGACY}


def show_ansi(img, cols=48):
    """Truecolor half-block terminal preview: two image rows per text row
    via the upper-half-block glyph."""
    h, w = img.shape[:2]
    step = max(1, w // cols)
    small = img[:: 2 * step, ::step]
    lower = img[step :: 2 * step, ::step]
    lines = []
    for y in range(min(small.shape[0], lower.shape[0])):
        row = []
        for x in range(small.shape[1]):
            tr, tg, tb = (int(v) for v in small[y, x])
            br, bg, bb = (int(v) for v in lower[y, x])
            row.append(f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m▀")
        lines.append("".join(row) + "\x1b[0m")
    print("\n".join(lines))


def _flag(arg: str) -> bool:
    return arg in ("1", "on", "true")


def apply_command(r, cmd: str, args: list) -> bool:
    """Apply one state-changing command to renderer ``r`` (and its scene).
    Returns False for a command it does not know."""
    scene = r.scene
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
        r.shading_mode = SHADING[args[0]]
    elif cmd == "debug":
        r.debug_texture_mode = int(args[0])
    elif cmd == "light":
        scene.set_light_intensity(float(np.clip(float(args[0]), 0, 50)))
    elif cmd == "mode":
        r.view_mode = args[0]
    elif cmd == "instancing":
        r.two_level = _flag(args[0])
    elif cmd == "stream":
        r.traversal_stream = int(args[0])
    elif cmd == "priming":
        r.hit_priming = _flag(args[0])
    else:
        return False
    return True


def run_commands(r, lines, out: str, ansi: bool = False) -> None:
    """Drive renderer ``r`` with REPL command ``lines`` until ``quit`` or
    their end. A state-changing command, like an empty line, draws one frame
    and writes the image to ``out``; ``frames``, ``loop``, ``save`` and
    ``stats`` do their own output. An error in a command is printed and the
    loop goes on."""

    def frame(n=1):
        for _ in range(n):
            r.draw()
        img = r.output_image()
        write_png(out, img)
        if ansi:
            show_ansi(img)
        print(f"frame {r.frame_index} -> {out}", flush=True)

    for line in lines:
        parts = line.strip().split()
        if not parts:
            frame()
            continue
        cmd, args = parts[0].lower(), parts[1:]
        try:
            if cmd == "quit":
                break
            elif cmd == "frames":
                frame(int(args[0]))
            elif cmd == "loop":
                n = int(args[0]) if args else 30
                dx = float(args[1]) if len(args) > 1 else 2.0
                t0 = time.perf_counter()
                for _ in range(n):
                    r.orbit(dx, 0.0)
                    r.draw()
                img = r.output_image()
                dt = time.perf_counter() - t0
                write_png(out, img)
                if ansi:
                    show_ansi(img)
                print(f"loop {n} frames in {dt:.2f}s = {n / dt:.2f} fps", flush=True)
            elif cmd == "save":
                write_png(args[0], r.output_image())
                print("saved", args[0], flush=True)
            elif cmd == "stats":
                print(r.stats.report(), flush=True)
            elif apply_command(r, cmd, args):
                frame()
            else:
                print("unknown command:", cmd, flush=True)
        except Exception as e:  # keep the loop alive on bad input
            print("error:", e, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: the card, cuda)")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "mrt_frame.png"))
    ap.add_argument("--ansi", action="store_true")
    ap.add_argument("--no-asset-models", dest="asset_models", action="store_false")
    args = ap.parse_args(argv)

    from .engine.appscene import make_app_scene
    from .engine.renderer import Renderer

    scene = make_app_scene(width=args.size, height=args.size, asset_models=args.asset_models)
    r = Renderer(scene, output_width=args.size, output_height=args.size, device=args.device)
    run_commands(r, [""], args.out, args.ansi)  # the first frame
    run_commands(r, sys.stdin, args.out, args.ansi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
