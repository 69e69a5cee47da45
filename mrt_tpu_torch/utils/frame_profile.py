"""Where a frame's time goes: the main path's runs and a profile of one frame.

    python -m mrt_tpu_torch.utils.frame_profile [--out build/frame_profile.txt] [--runs F,N] [--k7]

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
rays), so K2 runs its masked variant; run N is run F at the Renderer's
default ``use_mipmaps=False``, so its maps are sampled from the packed
atlas. Run G is run B's frame with the
dragon replaced by two distinct blob(subdivisions=9) meshes (seeds 7 and 8,
5,242,880 triangles each): its table has more than 2^20 - 1 rows, so K2
runs its float-sort variant. Run H is run C's frame with the robot read
from disk: ``character()``, a 66,049-vertex, 64-joint skinned cylinder with
the swing rig, written in centimetres as a USD crate ``robot.usdz`` (with
its USDA text and GLB twins, ``write_character``) into a temporary
directory that ``MRT_ASSET_PATH`` names while the app scene is built, so
the robot resolves from the file and keeps the reference's 0.01 scale.
Run J is run C's frame on the flat single-level BVH (``two_level=False``):
the whole table is refit from the posed world-space triangles every frame
and kernel K3 traverses it. ``chip_smoke.py`` drives the same runs (run E
in all three presenter modes).

For each run, after two warm-up frames, ``frame_walls`` times FRAMES
unprofiled frames between ``torch.cuda.synchronize()`` calls (every run's
before any profiler session); then ``profile_frame`` times one
``Renderer.prepare``, then profiles one prepare (its device time and
events, and those of its refit kernels K4 and K5, ``prepare_profiled``) and
one frame under ``torch.profiler``. The device's busy time is the sum of the
device events of the profiled frame (kernels, copies, fills; one stream, so
they do not overlap); the idle share is 1 - busy / the median unprofiled
frame wall, because the profiler slows the host that issues the ops but not
the kernels. ``idle_share_profiled`` is the same share against the profiled
frame's own wall; ``stage_s`` the device seconds of the wavefront's stage
kernels K6-K8 in the profiled frame (``stage_launches`` their launches). One JSON line per run goes to stdout; the profiler's
tables go to ``--out``. ``--runs`` profiles only the runs it names.
With ``--k7`` a first line gives K7's ``-Xptxas -v`` figures and blocks an
SM (``k7_resources``), and each run's line K7 over one more frame
(``k7_frame``: the first launch's profiler ms and bound, the frame's
bound).

The imports are absolute, so the file runs as a script from any checkout
of the repository with that checkout's package first on the path
(``utils/k2_compare.py`` times other trees so).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
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
    "N": dict(scene="run F's scene (2048^2 checker, 1024^2 normal map, light-masked spheres) at "
                    "the Renderer's default use_mipmaps=False: the packed atlas",
              width=1920, height=1080, dragon_subdivisions=None, floor_maps=True,
              light_masked_spheres=True),
    "G": dict(scene="dragon_1m's scene with two blob(subdivisions=9) dragons (seeds 7, 8)",
              width=1024, height=576, dragon_subdivisions=9, second_dragon_seed=8),
    "H": dict(scene="run C's scene with the robot read from robot.usdz (a USD crate): a "
                    "66,049-vertex, 64-joint skinned character authored in centimetres",
              width=1920, height=1080, dragon_subdivisions=None, robot=True, motion_adaptive=True,
              robot_asset=True),
    "J": dict(scene="run C's scene on the flat single-level BVH (two_level=False)",
              width=1920, height=1080, dragon_subdivisions=None, robot=True, motion_adaptive=True,
              flat=True),
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
    from mrt_tpu_torch.assets import procedural
    from mrt_tpu_torch.assets.obj import MaterialDef
    from mrt_tpu_torch.core import types as T
    from mrt_tpu_torch.engine.scene import Model, ModelMaterialOverride

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


def character(segments: int = 256, n_joints: int = 64):
    """Phase D's and run H's character, in metres: a skinned cylinder of
    ``segments`` x ``segments`` quads (66,049 vertices and 131,072
    triangles at 256) and ``n_joints`` joints with the swing rig (a game
    character's size; the app's robot stand-in has 425 vertices and 4
    joints). Returns (mesh, SkinData)."""
    from mrt_tpu_torch.assets import procedural
    from mrt_tpu_torch.engine.appscene import _attach_swing_rig
    from mrt_tpu_torch.engine.scene import Model, SkinData

    mesh, ji, jw, rest = procedural.skinned_cylinder(segments_h=segments, segments_r=segments,
                                                     n_joints=n_joints)
    m = Model("character", mesh=mesh)
    m.skin = SkinData(joint_indices=ji, joint_weights=jw, rest_joints=rest)
    _attach_swing_rig(m)
    return mesh, m.skin


def write_character(directory, mesh=None, skin=None) -> dict:
    """Write the character (``character()`` unless given) in centimetres to
    ``directory``: ``robot.usdz`` (a crate layer), ``robot_text.usdz`` (a
    USDA layer) and ``robot.glb``. Returns the paths by format."""
    from mrt_tpu_torch.assets import rigexport

    if mesh is None:
        mesh, skin = character()
    return rigexport.write_rig(directory, "robot", mesh, skin, unit=100.0)


@contextlib.contextmanager
def robot_asset(directory):
    """Inside this block the model "robot" resolves from ``directory``
    (first on MRT_ASSET_PATH), loaded afresh: the name cache is cleared on
    entry and on exit."""
    from mrt_tpu_torch.engine import scene as scene_mod

    old = os.environ.get("MRT_ASSET_PATH")
    os.environ["MRT_ASSET_PATH"] = os.pathsep.join([str(directory)] + ([old] if old else []))
    scene_mod._MESH_CACHE.pop("robot", None)
    try:
        yield
    finally:
        scene_mod._MESH_CACHE.pop("robot", None)
        if old is None:
            del os.environ["MRT_ASSET_PATH"]
        else:
            os.environ["MRT_ASSET_PATH"] = old


def make_scene(tag: str, seed: int = 0, asset_dir=None):
    """Run ``tag``'s scene (sized as its render; see ``make_renderer``)."""
    from mrt_tpu_torch.engine.appscene import make_app_scene

    run = RUNS[tag]
    scale = run.get("render_scale", 1.0)
    with contextlib.ExitStack() as stack:
        if run.get("robot_asset"):
            if asset_dir is None:
                asset_dir = stack.enter_context(tempfile.TemporaryDirectory())
                write_character(asset_dir)
            stack.enter_context(robot_asset(asset_dir))
        scene = make_app_scene(round(run["width"] * scale), round(run["height"] * scale),
                               include_robot=run.get("robot", False), asset_models=False,
                               dragon_subdivisions=run["dragon_subdivisions"])
    _extras(scene, run, seed)
    return scene


def make_renderer(tag: str, device, seed: int = 0, asset_dir=None):
    """Scene, BVH and renderer of run ``tag`` with the main path's settings
    (the scene sized as the render). Run H's robot loads from
    ``asset_dir`` (``write_character``'s files), else from the files
    written into a temporary directory here."""
    from mrt_tpu_torch.engine.renderer import Renderer

    run = RUNS[tag]
    r = Renderer(make_scene(tag, seed, asset_dir), run["width"], run["height"], seed=seed,
                 device=device)
    if run.get("flat"):
        r.two_level = False
    configure(r, run.get("motion_adaptive", False),
              **{k: run[k] for k in ("upscaler", "render_scale", "spp", "bounces", "mipmaps")
                 if k in run})
    return r


def frame(r, delta_time=None):
    """One frame: a draw, and a present where the renderer upscales."""
    from mrt_tpu_torch.engine.renderer import UPSCALER_OFF

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

    from mrt_tpu_torch.kernels import refit, traverse2
    from mrt_tpu_torch.kernels import wavefront as W

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
    def traversals():  # K2 and K3 launches so far
        return traverse2.launches + traverse2.flat_launches

    def refits():  # K4 and K5 launches so far
        return dict(refit.rows_launches, tlas=refit.tlas_launches)

    def device_events(prof):
        return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]

    def named_s(events, name):
        return sum(e.time_range.elapsed_us() for e in events if name in e.name) / 1e6

    # the prepare stage alone: its refit's launch (refit_rows: K4, with K5
    # in its last block on a two-level BVH) among its device events
    refits0 = refits()
    with profile(activities=activities) as prof:
        r.prepare()
        _sync(dev)
    prep_events = device_events(prof)
    prepare = dict(device_s=sum(e.time_range.elapsed_us() for e in prep_events) / 1e6,
                   device_events=len(prep_events), refit_rows_s=named_s(prep_events, "refit_rows"),
                   refit_launches={k: n - refits0[k] for k, n in refits().items()})

    launches0 = traversals()
    stages0 = dict(W.launches)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        frame(r)
        _sync(dev)
        wall = time.perf_counter() - t0
    dev_events = device_events(prof)
    busy = sum(e.time_range.elapsed_us() for e in dev_events) / 1e6
    trav = named_s(dev_events, "traverse2")
    gather = sum(e.time_range.elapsed_us() for e in dev_events
                 if "gather" in e.name or "index" in e.name) / 1e6
    median = statistics.median(walls)
    line = dict(frame_wall_s=walls, frame_wall_median_s=median, frame_wall_profiled_s=wall,
                prepare_s=prepare_s, prepare_profiled=prepare, device_busy_s=busy,
                device_events=len(dev_events), traverse2_s=trav,
                traverse2_launches=traversals() - launches0,
                gather_s=gather,
                stage_s={s: named_s(dev_events, s) for s in W.STAGES},
                stage_launches={s: W.launches[s] - stages0[s] for s in W.STAGES},
                idle_share=1.0 - busy / median,
                idle_share_profiled=1.0 - busy / wall, rays=int(r.last_rays_traced))
    if table_out is not None:
        ka = prof.key_averages()
        key = "self_device_time_total" if dev_events else "self_cpu_time_total"
        table_out.write(ka.table(sort_by=key, row_limit=40) + "\n")
        table_out.write(ka.table(sort_by="count", row_limit=25) + "\n")
    return line


def k7_frame(r, reps: int = 5) -> dict:
    """K7 over one more frame of renderer ``r`` on the card: its
    instantiation, its launches, the frame's bound (``bounds.k7_listed`` of
    each launch's ``bounds.k7_work``, from the plain step run on copies of
    the launch's inputs, summed) and the first launch (every lane listed):
    its device ms by torch.profiler (the mean of ``reps`` launches, each on
    fresh copies of the state and the Wave), its bound and its lanes."""
    from mrt_tpu_torch.dist.route_check import _device_events
    from mrt_tpu_torch.kernels import traverse2
    from mrt_tpu_torch.kernels import wavefront as W
    from mrt_tpu_torch.utils import bounds

    orig = W.shade_hit
    out = dict(variant=W.K7_VARIANTS[W.k7_variant(r.settings(), r.statics)], launches=0,
               bound_ms=0.0)

    def shade_hit(fr, st, hits, sidx, wv, rows=None):
        st_in, wv_in = W.clone_state(st), W.clone_wave(wv)
        n_listed = st.active.shape[0] if wv.steps == 0 else int(W.listed(wv).numel())
        if "first" not in out:
            ev = [e for e in _device_events(lambda: orig(fr, W.clone_state(st_in), hits, sidx,
                                                         W.clone_wave(wv_in), rows), reps)
                  if "shade_hit" in e.name] if st.active.is_cuda else []
            out["first"] = dict(profiler_ms=sum(e.time_range.elapsed_us() for e in ev) / 1e3 / reps
                                if ev else None, events=len(ev), lanes=n_listed)
        res = orig(fr, st, hits, sidx, wv, rows)
        hits_t = traverse2.hits_of(hits, fr.tri_base)
        _, wv_p, _ = W.shade_hit_listed_plain(fr, W.clone_state(st_in), hits_t, sidx,
                                              wv_in._replace(buf=None), rows)
        work = bounds.k7_work(fr, st_in, hits_t, wv_p.shadow, n_listed=n_listed,
                              pending=wv_in.shadow, occluded=wv_in.occluded, rows=rows)
        b_ms, b_by = bounds.k7_listed(work)
        if out["launches"] == 0:
            out["first"].update(bound_ms=b_ms, bound_by=b_by)
        out["launches"] += 1
        out["bound_ms"] += b_ms
        return res

    W.shade_hit = shade_hit
    try:
        frame(r)
        _sync(r.device)
    finally:
        W.shade_hit = orig
    return out


def k7_resources() -> dict:
    """K7's ``-Xptxas -v`` figures by mangled name (registers, stack, spills,
    static shared memory) with the blocks of 256 threads an SM holds
    (``bounds.blocks_per_sm``), from a build in this process."""
    from mrt_tpu_torch.kernels import build
    from mrt_tpu_torch.utils import bounds

    build.build()
    return {name: dict(r, blocks_per_sm=bounds.blocks_per_sm(r["registers"], 256, r.get("smem", 0)))
            for name, r in build.ptxas.items() if "shade_hit" in name}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("build", "frame_profile.txt"))
    ap.add_argument("--runs", default=",".join(RUNS),
                    help="the runs to profile, comma-separated (default: every run of RUNS)")
    ap.add_argument("--k7", action="store_true",
                    help="also K7's resources and, per run, k7_frame (the first launch's "
                         "profiler ms and the frame's bound)")
    args = ap.parse_args(argv)
    tags = [t for t in args.runs.split(",") if t]
    unknown = sorted(set(tags) - set(RUNS))
    if unknown:
        ap.error(f"unknown runs {unknown}: the runs are {list(RUNS)}")
    if not torch.cuda.is_available():
        print("frame_profile: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    # every run's unprofiled frames first: frames after a profiler session
    # ran slower on the host (PERF.md, Findings)
    if args.k7:
        print(json.dumps(dict(k7_resources=k7_resources(), card=card)), flush=True)
    renderers = {tag: make_renderer(tag, torch.device("cuda:0")) for tag in tags}
    walls = {tag: frame_walls(r) for tag, r in renderers.items()}
    with open(args.out, "w") as out:
        for tag, r in renderers.items():
            out.write(f"=== run {tag}: {RUNS[tag]['scene']} {r.render_width}x{r.render_height}\n")
            line = dict(run=tag, **profile_frame(r, out, walls[tag]), card=card)
            if args.k7:
                line["k7"] = k7_frame(r)
            out.write(json.dumps(line) + "\n")
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
