"""Offline demo — counterpart of ``scripts/render_demo.py`` (the reference's
``movies/demo.mp4``): orbits the app scene while the robot animates, and
writes an animated GIF and a final still.

    python -m mrt_tpu_torch.demo [--cpu | --device DEV] [--size N] [--frames N]
                                 [--out PATH.gif] [--no-asset-models]

It runs on the card unless ``--cpu`` (or ``--device cpu``) is given, and
raises where there is none. Each of ``--frames`` steps orbits the camera
and draws 3 frames of 1/60 s at the Renderer's defaults (spatial upscaler
from a 0.67-scale render, motion-adaptive accumulation and sampling)
except 2 spp and 2 bounces, as the JAX script sets them; every 10 steps it
prints ``stats.report()``. The GIF (1/30 s a frame, looping) and
``<stem>_final.png`` are written by the port's own NumPy writers; MP4
needs ``imageio``, which the port does not use. ``--no-asset-models``
leaves the train and treefir OBJs out of the scene, where they are not
installed.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

from .engine.appscene import make_app_scene
from .engine.renderer import Renderer
from .utils.image import write_gif, write_png


def main(argv=None):
    """Render and write the demo; returns (renderer, the steps' images)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_const", const="cpu", dest="device",
                    help="run on the CPU")
    ap.add_argument("--device", default=None, help="torch device (default: the card, cuda)")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--frames", type=int, default=90)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "demo.gif"))
    ap.add_argument("--no-asset-models", dest="asset_models", action="store_false")
    args = ap.parse_args(argv)
    if not args.out.lower().endswith(".gif"):
        raise ValueError(f"demo: --out {args.out}: only a .gif is written; MP4 needs imageio, "
                         "which the port does not use")

    size = args.size
    scene = make_app_scene(width=size, height=size, asset_models=args.asset_models)
    r = Renderer(scene, output_width=size, output_height=size, device=args.device)
    r.samples_per_pixel = 2
    r.max_bounces = 2
    print(f"rendering {r.render_width}x{r.render_height}, presented at {size}x{size} "
          f"({r.upscaler_mode} upscaler) on {r.device}")

    images = []
    for i in range(args.frames):
        r.orbit(3.0, 0.6)  # slow sweep; resets accumulation each step
        # a few accumulation frames per camera position to tame noise
        for _ in range(3):
            r.draw(1 / 60)
        images.append(r.output_image())
        if (i + 1) % 10 == 0:
            print(f"{i + 1}/{args.frames} frames, stats={r.stats.report()}")

    t0 = time.perf_counter()
    write_gif(args.out, images, duration=1 / 30, loop=0)
    print(f"gif: {len(images)} frames encoded in {time.perf_counter() - t0:.2f}s")
    write_png(args.out.rsplit(".", 1)[0] + "_final.png", images[-1])
    print("wrote", args.out)
    return r, images


if __name__ == "__main__":
    main()
