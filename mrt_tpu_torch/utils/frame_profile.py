"""Where a frame's time goes: the main path's runs and a profile of one frame.

    python -m mrt_tpu_torch.utils.frame_profile [--out build/frame_profile.txt]

Run A is the flagship frame of ``bench.py`` without the train/treefir OBJs
(1920x1080); run B is the same scene with the 1.31M-triangle dragon at
1024x576. Both render 2 spp, 4 bounces, upscaler and motion-adaptive
sampling off. Run C is the animated app frame: run A's scene plus the
swing-rigged robot stand-in, with motion-adaptive sampling on (up to 2
extra samples), each frame one 60 Hz animation step. Run E is the
reference's interactive configuration (config 5): run C's scene rendered at
1920x1080 (render scale 0.5), 1 spp, 2 bounces, and presented at
3840x2160 through the temporal upscaler; each of its frames is a draw and a
present. Run F is run A's frame with the wavefront's extras on: the floor
textured with a 2048x2048 base-colour checker and a 1024x1024 normal map
(NumPy arrays made from a seed), mipmapped sampling, and the two spheres
masked as light geometry (seen by camera rays, skipped by shadow and bounce
rays), so K2 runs its masked variant. Run G is run B's frame with the
dragon replaced by two distinct blob(subdivisions=9) meshes (seeds 7 and 8,
5,242,880 triangles each): its table has more than 2^20 - 1 rows, so K2
runs its float-sort variant. ``chip_smoke.py`` drives the same runs (run E
in all three presenter modes).

For each run, after two warm-up frames, ``frame_walls`` times FRAMES
unprofiled frames between ``torch.cuda.synchronize()`` calls (every run's
before any profiler session); then ``profile_frame`` times one
``Renderer.prepare`` and one frame under ``torch.profiler``. The device's busy time is the sum of the
device events of the profiled frame (kernels, copies, fills; one stream, so
they do not overlap); the idle share is 1 - busy / the median unprofiled
frame wall, because the profiler slows the host that issues the ops but not
the kernels. ``idle_share_profiled`` is the same share against the profiled
frame's own wall. One JSON line per run goes to stdout; the profiler's
tables go to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

FRAMES = 4  # unprofiled frames timed per run

RUNS = {
    "A": dict(scene="flagship without train/treefir", width=1920, height=1080,
              dragon_subdivisions=None),
    "B": dict(scene="dragon_1m (blob subdivisions=8) without train/treefir", width=1024,
              height=576, dragon_subdivisions=8),
    "C": dict(scene="flagship without train/treefir, with the swing-rigged robot stand-in",
              width=1920, height=1080, dragon_subdivisions=None, robot=True, motion_adaptive=True),
    "E": dict(scene="run C's scene, 1920x1080 render presented at 3840x2160 (config 5)",
              width=3840, height=2160, dragon_subdivisions=None, robot=True, motion_adaptive=True,
              upscaler="temporal", render_scale=0.5, spp=1, bounces=2),
    "F": dict(scene="flagship without train/treefir, floor with a 2048^2 checker and a 1024^2 "
                    "normal map, mipmaps on, the spheres masked as light geometry",
              width=1920, height=1080, dragon_subdivisions=None, floor_maps=True, mipmaps=True,
              light_masked_spheres=True),
    "G": dict(scene="dragon_1m's scene with two blob(subdivisions=9) dragons (seeds 7, 8)",
              width=1024, height=576, dragon_subdivisions=9, second_dragon_seed=8),
}


def configure(r, motion_adaptive: bool = False, upscaler: str = "off", render_scale: float = 1.0,
              spp: int = 2, bounces: int = 4, mipmaps: bool = False):
    """The main path's settings: 2 spp, 4 bounces, upscaler off,
    motion-adaptive sampling off unless asked for (then the Renderer's
    default of at most 2 extra samples), mipmaps off; run E passes its
    upscaler, render scale, 1 spp and 2 bounces, run F mipmaps."""
    r.upscaler_mode = upscaler
    r.render_scale = render_scale
    r.samples_per_pixel = spp
    r.max_bounces = bounces
    r.use_motion_adaptive_sampling = motion_adaptive
    r.use_mipmaps = mipmaps


def floor_maps(seed: int = 0, base: int = 2048, normal: int = 1024):
    """Run F's floor maps from ``seed``: a (base, base, 3) checker of 16x16
    squares in two random colours and a (normal, normal, 3) tangent-space
    normal map of random slopes over 32-texel blocks."""
    rng = np.random.default_rng(seed)
    colours = rng.uniform(0.1, 0.9, (2, 3)).astype(np.float32)
    cell = np.arange(base) * 16 // base
    checker = colours[np.add.outer(cell, cell) % 2]
    slopes = rng.uniform(-0.35, 0.35, (normal // 32, normal // 32, 2)).astype(np.float32)
    xy = np.repeat(np.repeat(slopes, 32, axis=0), 32, axis=1)
    nmap = np.concatenate([xy * 0.5 + 0.5, np.ones((normal, normal, 1), np.float32)], axis=-1)
    return checker, nmap


def _extras(scene, run: dict, seed: int):
    """Run F's floor maps and light-masked spheres, run G's second dragon."""
    from ..assets import procedural
    from ..assets.obj import MaterialDef
    from ..core import types as T
    from ..engine.scene import Model, ModelMaterialOverride

    models = scene.models
    if run.get("floor_maps"):
        checker, nmap = floor_maps(seed)
        floor = next(m for m in models if m.name == "plane")
        floor.mesh = procedural.plane(material=MaterialDef(
            name="floor", map_base_color=checker, map_normal=nmap))
    if run.get("light_masked_spheres"):
        for m in models:
            if m.name == "sphere":
                m.geometry_mask = T.GEOMETRY_MASK_LIGHT
    if run.get("second_dragon_seed") is not None:
        dragon = next(m for m in models if m.name == "dragon")
        mesh = procedural.blob(subdivisions=run["dragon_subdivisions"], radius=0.28,
                               seed=run["second_dragon_seed"],
                               material=MaterialDef(name="Dragon", base_color=(1.0, 0.0, 0.0),
                                                    specular=(0.2, 0.2, 0.2)))
        models.insert(models.index(dragon) + 1, Model(
            "dragon2", position=[-0.45, 0.38, 2.2], rotation=dragon.rotation, scale=dragon.scale,
            material_override=ModelMaterialOverride.glass(), mesh=mesh))


def make_renderer(tag: str, device, seed: int = 0):
    """Scene, BVH and renderer of run ``tag`` with the main path's settings
    (the scene sized as the render)."""
    from ..engine.appscene import make_app_scene
    from ..engine.renderer import Renderer

    run = RUNS[tag]
    scale = run.get("render_scale", 1.0)
    scene = make_app_scene(round(run["width"] * scale), round(run["height"] * scale),
                           include_robot=run.get("robot", False), asset_models=False,
                           dragon_subdivisions=run["dragon_subdivisions"])
    _extras(scene, run, seed)
    r = Renderer(scene, run["width"], run["height"], seed=seed, device=device)
    configure(r, run.get("motion_adaptive", False),
              **{k: run[k] for k in ("upscaler", "render_scale", "spp", "bounces", "mipmaps")
                 if k in run})
    return r


def frame(r, delta_time=None):
    """One frame: a draw, and a present where the renderer upscales."""
    from ..engine.renderer import UPSCALER_OFF

    r.draw(delta_time)
    if r.upscaler_mode != UPSCALER_OFF:
        r.present_device()


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def frame_walls(r, frames: int = FRAMES) -> list[float]:
    """Wall seconds of ``frames`` frames of ``r`` after two warm-ups."""
    for _ in range(2):
        frame(r)
    _sync(r.device)
    walls = []
    for _ in range(frames):
        t0 = time.perf_counter()
        frame(r)
        _sync(r.device)
        walls.append(time.perf_counter() - t0)
    return walls


def profile_frame(r, table_out=None, walls=None) -> dict:
    """Profile one frame of renderer ``r`` (see the module docstring);
    ``walls`` are its unprofiled frame walls, timed here when None."""
    from torch.profiler import ProfilerActivity, profile

    from ..kernels import traverse2

    dev = r.device
    if walls is None:
        walls = frame_walls(r)
    t0 = time.perf_counter()
    r.prepare()
    _sync(dev)
    prepare_s = time.perf_counter() - t0

    activities = [ProfilerActivity.CPU]
    if torch.device(dev).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    launches0 = traverse2.launches
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        frame(r)
        _sync(dev)
        wall = time.perf_counter() - t0
    dev_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev_events) / 1e6
    trav = sum(e.time_range.elapsed_us() for e in dev_events if "traverse2" in e.name) / 1e6
    gather = sum(e.time_range.elapsed_us() for e in dev_events
                 if "gather" in e.name or "index" in e.name) / 1e6
    median = statistics.median(walls)
    line = dict(frame_wall_s=walls, frame_wall_median_s=median, frame_wall_profiled_s=wall,
                prepare_s=prepare_s, device_busy_s=busy, device_events=len(dev_events),
                traverse2_s=trav, traverse2_launches=traverse2.launches - launches0,
                gather_s=gather, idle_share=1.0 - busy / median,
                idle_share_profiled=1.0 - busy / wall, rays=int(r.last_rays_traced))
    if table_out is not None:
        ka = prof.key_averages()
        key = "self_device_time_total" if dev_events else "self_cpu_time_total"
        table_out.write(ka.table(sort_by=key, row_limit=40) + "\n")
        table_out.write(ka.table(sort_by="count", row_limit=25) + "\n")
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("build", "frame_profile.txt"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("frame_profile: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    # every run's unprofiled frames first: frames after a profiler session
    # ran slower on the host (PERF.md, Findings)
    renderers = {tag: make_renderer(tag, torch.device("cuda:0")) for tag in RUNS}
    walls = {tag: frame_walls(r) for tag, r in renderers.items()}
    with open(args.out, "w") as out:
        for tag, r in renderers.items():
            out.write(f"=== run {tag}: {RUNS[tag]['scene']} {r.render_width}x{r.render_height}\n")
            line = dict(run=tag, **profile_frame(r, out, walls[tag]), card=card)
            out.write(json.dumps(line) + "\n")
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
