"""Smoke render — counterpart of ``scripts/smoke_render.py``: a sphere over a
plane (BASELINE config 1's shape), one first frame, then 4 steady frames,
written as one PNG.

    python -m mrt_tpu_torch.smoke [--cpu | --device DEV] [--size N] [--out PATH]

It runs on the card unless ``--cpu`` (or ``--device cpu``) is given, and
raises where there is none. Upscaler off, 1 spp, 1 bounce, motion-adaptive
sampling off, as the JAX script sets them.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

from .engine.renderer import UPSCALER_OFF, Renderer
from .engine.scene import Model, Scene
from .utils.image import write_png


def main(argv=None):
    """Render and write the smoke image; returns (renderer, image)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_const", const="cpu", dest="device",
                    help="run on the CPU")
    ap.add_argument("--device", default=None, help="torch device (default: the card, cuda)")
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "smoke.png"))
    args = ap.parse_args(argv)

    size = args.size
    scene = Scene(width=size, height=size)
    scene.models = [
        Model("sphere", position=[0.0, 1.0, 0.0], scale=1.0),
        Model("plane", position=[0, 0, 0], scale=10),
    ]
    r = Renderer(scene, output_width=size, output_height=size, device=args.device)
    r.upscaler_mode = UPSCALER_OFF
    r.samples_per_pixel = 1
    r.max_bounces = 1
    r.use_motion_adaptive_sampling = False

    t0 = time.time()
    r.draw()
    img = r.output_image()
    print(f"first frame (incl. the kernels' build on first use): {time.time() - t0:.1f}s")
    t0 = time.time()
    n = 4
    for _ in range(n):
        r.draw()
    img = r.output_image()
    dt = (time.time() - t0) / n
    nonzero = np.count_nonzero(img.sum(-1)) / img.shape[0] / img.shape[1]
    print(f"steady frame: {dt * 1e3:.1f} ms, mean={img.mean():.1f}, nonzero={nonzero:.2%}")
    write_png(args.out, img)
    print("wrote", args.out)
    return r, img


if __name__ == "__main__":
    main()
