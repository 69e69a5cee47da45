"""Run one cell of the H100 benchmark of mrt_tpu_torch once.

    python bench_h100/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, its traffic and its per-layer metrics are
found by name from ``BENCHMARK.json`` at the root of the checkout:
``configs/<config>.json`` (the scene), ``traffic/<traffic>.json`` (the
viewer's settings and what each frame does) and ``metrics/<metric>.py``
(one reader per per-layer metric, ``read(trace) -> float | None``). A new
cell, configuration or metric is a new file and a new entry there.

A run builds the port's renderer from the seed's inputs (the Halton
offsets, the animation's start time), draws the traffic's warm-up frames
(set-up ends with them; the first ``prefix_frames`` are kept at some of
the check's pixels), pins its thread to the CPU that spins fastest and
turns the garbage collector off (``steady_host``), then draws frames for
``--seconds``: per frame the traffic's orbit, ``Renderer.draw`` and its
present, and a CUDA event recorded after them, read once the window has
closed, as is each frame's ray count. With ``--trace 1`` it then profiles
``profile_frames`` more frames and reads the per-layer metrics from that
profile. Last it frees the renderer and judges the window's last frame and
the kept first frames against the reference (``check.py``,
``reference/``). Its last line on standard output is one
JSON object; the numbers compared, each beside its limit, are the last
lines on standard error and the result's last key, ``checks``.

``--control 1`` adds the control's readings, the reference computed in
bfloat16 in the program's place, from which the limits were set; the
benchmark's own runs leave it off.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent  # the checkout's root, which holds the port's package
for _p in (ROOT, HERE):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

# top-level modules that may not be loaded in a run: JAX and the JAX package
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "mrt_tpu")
# the port's switches read from the environment when it is imported or a
# scene resolves its assets: a run uses its defaults and procedural assets
PORT_ENVIRONMENT = ("MRT_ASSET_PATH", "MRT_SBVH", "MRT_ENABLE_AO")
# torch.profiler: recordings tried before a trace is given up, and the idle
# time around the recorded frames (the profiler drops the device events of
# recordings without it in an ageing process), doubled at each retry
PROFILE_ATTEMPTS = 3
PROFILE_PAD_S = 0.25


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_files(bench: dict, workload: str, root: Path = ROOT) -> dict:
    """The cell's entry, configuration, traffic and per-layer metrics, found
    by name under the checkout ``root``: {"cell", "config", "traffic",
    "metrics": {name: (entry, reader)}, "end_to_end": [entries]}."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the cells are {sorted(cells)}")
    cell = cells[workload]
    base = root / bench["paths"][0]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(root / cfg_entry["file"]) as f:
        config = json.load(f)
    with open(base / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    metrics = {m["name"]: (m, load_reader(base / "metrics" / f"{m['name']}.py"))
               for m in bench["per_layer"] if workload in m.get("workloads", [workload])}
    return dict(cell=cell, config=config, traffic=traffic, metrics=metrics, end_to_end=e2e)


def load_reader(path: Path):
    """The ``read`` function of the per-layer reader at ``path``."""
    spec = importlib.util.spec_from_file_location(f"bench_metric_{path.stem.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN_MODULES, compared whole."""
    return sorted({n for n in sys.modules if n.split(".")[0] in FORBIDDEN_MODULES})


def seed_inputs(seed: int, height: int, width: int):
    """What the seed makes, handed to the program and the reference alike:
    the (height, width) int32 Halton offsets, the animation's start time in
    the robot's 2 s swing clip, and a generator for the check's pixels."""
    import numpy as np
    import torch

    from reference import halton

    offsets = halton.make_pixel_offsets(torch.Generator().manual_seed(seed), height, width)
    rng = np.random.default_rng(seed)
    return offsets, float(rng.uniform(0.0, 2.0)), rng


def window_metrics(stamps_ms: list[float], rays: int) -> dict:
    """End-to-end numbers of a window from its frames' completion times
    (ms from the window's start, in order) and all their rays: the rate is
    every ray over the whole window, the p95 over every frame's interval.
    ``intervals_ms`` gives the intervals' quartiles and ``halves_fps`` the
    frame rate of each half of the window, to tell drift from noise."""
    window_s = stamps_ms[-1] / 1e3
    intervals = [b - a for a, b in zip([0.0] + stamps_ms[:-1], stamps_ms)]
    n = len(intervals)
    p95 = statistics.quantiles(intervals, n=20, method="inclusive")[18] if n > 1 else intervals[0]
    half = n // 2
    halves = ([half / (stamps_ms[half - 1] / 1e3),
               (n - half) / ((stamps_ms[-1] - stamps_ms[half - 1]) / 1e3)] if half else [])
    quartiles = statistics.quantiles(intervals, n=4) if n > 1 else intervals
    return dict(mrays_per_s=rays / window_s / 1e6, frame_ms_p95=p95, fps=n / window_s,
                window_s=window_s, frames=n, intervals_ms=quartiles, halves_fps=halves)


def build_program(config: dict, traffic: dict, seed: int, device):
    """The port's renderer for the cell, made from the seed's inputs."""
    from mrt_tpu_torch.engine.appscene import make_app_scene
    from mrt_tpu_torch.engine.renderer import Renderer

    from reference.frame import render_size

    h, w = render_size(traffic)
    offsets, start_time, rng = seed_inputs(seed, h, w)
    scene = make_app_scene(w, h, include_robot=config["include_robot"],
                           dragon_subdivisions=config["dragon_subdivisions"],
                           asset_models=config["asset_models"])
    for m in scene.models:
        if m.skin is not None:
            m.skin.current_time = start_time
    r = Renderer(scene, traffic["width"], traffic["height"], seed=seed, device=device,
                 offsets=offsets.numpy())
    r.upscaler_mode = traffic["upscaler"]
    r.render_scale = traffic["render_scale"]
    r.samples_per_pixel = traffic["samples_per_pixel"]
    r.max_bounces = traffic["max_bounces"]
    r.use_motion_adaptive_sampling = config["motion_adaptive_sampling"]
    return r, offsets, start_time, rng


def make_step(r, traffic: dict):
    """One frame of the traffic: its orbit, the draw and its present;
    returns the presented image, or None where the traffic does not
    present."""
    dx, dy = traffic["orbit"]
    dt = traffic["delta_time"]
    orbit = dx != 0 or dy != 0

    def step():
        if orbit:
            r.orbit(dx, dy)
        r.draw(dt)
        return r.present_device() if traffic["present"] else None

    return step


def at_pixels(r, pixels):
    """The renderer's frame state (accumulation, depth, motion, samples) at
    the flat render pixels ``pixels``: the reference's ``Expected`` with no
    rays and no present."""
    from reference.frame import Expected

    pix = pixels.to(r.accum.device)
    return Expected(r.accum.reshape(-1, 3)[pix], r.depth.reshape(-1)[pix],
                    r.motion.reshape(-1, 2)[pix], r.last_samples.reshape(-1)[pix], None, None)


def steady_host(spin_s: float = 0.02, trials: int = 3):
    """Set the host up for the window: the calling thread pinned to the CPU
    of its affinity set that runs a short spin fastest (the frame loop is
    host-bound in some cells, and the machine's CPUs run at different speeds
    under its other load), and the garbage collector frozen and off.
    Returns (the function that undoes both, {cpu: spins a second})."""
    import gc

    cpus = sorted(os.sched_getaffinity(0))
    rates = {}
    for cpu in cpus:
        os.sched_setaffinity(0, {cpu})
        best = 0.0
        for _ in range(trials):
            n, t0 = 0, time.perf_counter()
            while (t := time.perf_counter()) - t0 < spin_s:
                n += 1
            best = max(best, n / (t - t0))
        rates[cpu] = best
    os.sched_setaffinity(0, {max(rates, key=rates.get)})
    gc.collect()
    gc.freeze()
    gc.disable()

    def undo():
        gc.enable()
        gc.unfreeze()
        os.sched_setaffinity(0, cpus)

    return undo, rates


def measure(r, step, seconds: float, sync, event):
    """Frames for ``seconds``: each frame's completion event and rays, and
    the program's state around the last frame (``reference.frame.Program``
    without its ray count). ``sync()`` waits for the device; ``event()``
    records a timing event on its stream."""
    from reference.frame import Program

    sync()
    start = event()
    stamps, rays = [], []
    t0 = time.perf_counter()
    while True:
        prev_accum, prev_motion = r.accum, r.motion
        image = step()
        stamps.append(event())
        rays.append(r.last_rays_traced)
        last = Program(prev_accum, prev_motion, r.accum, r.depth, r.motion, r.last_samples,
                       None, image)
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    return start, stamps, rays, last


def profile(r, step, traffic: dict, sync) -> dict:
    """``profile_frames`` frames under torch.profiler (after a recorded
    warm-up of two): their device events, host events, wall, and the port's
    launch counters over them. A recording whose K2 events fall short of the
    K2 launches counted is taken again with more idle time around it."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile, schedule

    from mrt_tpu_torch.kernels import presenter, refit, traverse2
    from mrt_tpu_torch.kernels import wavefront as W

    def counters():
        return dict(traverse2=traverse2.launches, traverse2_flat=traverse2.flat_launches,
                    **{f"wavefront.{k}": v for k, v in W.launches.items()},
                    **{f"refit.{k}": v for k, v in refit.rows_launches.items()},
                    refit_tlas=refit.tlas_launches,
                    **{f"presenter.{k}": v for k, v in presenter.launches.items()})

    n = traffic["profile_frames"]
    pad = PROFILE_PAD_S
    for attempt in range(PROFILE_ATTEMPTS):
        got = []
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with tprofile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1),
                      on_trace_ready=lambda p: got.append(p.events())) as prof:
            for _ in range(2):
                step()
            sync()
            prof.step()
            time.sleep(pad)
            c0 = counters()
            t0 = time.perf_counter()
            for _ in range(n):
                step()
            sync()
            wall = time.perf_counter() - t0
            c1 = counters()
            time.sleep(pad)
            prof.step()
        cuda = torch.autograd.DeviceType.CUDA
        # the profiler's own step annotations are no device work
        evs = [e for e in got[0] if not e.name.startswith("ProfilerStep")
               and not getattr(e, "is_user_annotation", False)] if got else []
        events = [(e.name, e.time_range.start, e.time_range.elapsed_us())
                  for e in evs if e.device_type == cuda]
        host = [(e.name, e.time_range.start, e.time_range.elapsed_us())
                for e in evs if e.device_type != cuda]
        mark = {k: c1[k] - c0[k] for k in c1}
        k2 = sum(1 for name, _, _ in events if "traverse2_kernel" in name)
        if events and k2 >= mark["traverse2"] + mark["traverse2_flat"]:
            return dict(events=events, host=host, frames=n, wall_s=wall, counters=mark,
                        attempts=attempt + 1)
        print(json.dumps(dict(profiler_dropout=attempt + 1, device_events=len(events),
                              traverse2_events=k2, traverse2_launches=mark["traverse2"],
                              pad_s=pad)), file=sys.stderr, flush=True)
        pad *= 2
    raise RuntimeError("torch.profiler lost the device events of every recording")


def breakdown(trace: dict) -> dict:
    """The ten device operations that took most time (by name, summed) and
    the ten largest sums of idle device time by what the host was doing
    (the host operation that spans most of each gap), in seconds over the
    profiled frames."""
    ops: dict = {}
    for name, _, d in trace["events"]:
        ops[name] = ops.get(name, 0.0) + d / 1e6
    spans = sorted((s, s + d) for _, s, d in trace["events"])
    host = sorted(trace["host"], key=lambda h: h[1])
    starts = [h[1] for h in host]
    gaps: dict = {}
    end = spans[0][1] if spans else 0.0
    for s, e in spans[1:]:
        if s > end:
            g0, g1 = end, s
            # the host operation that covers most of the gap, among those
            # no longer than 4 gaps and 50 us (not one that spans many gaps)
            longest = 4 * (g1 - g0) + 50
            best, best_cov = "host (no operation recorded)", 0.0
            for name, hs, hd in host[bisect.bisect_left(starts, g0 - longest):
                                     bisect.bisect_right(starts, g1)]:
                cov = min(g1, hs + hd) - max(g0, hs)
                if cov > best_cov and hd <= longest:
                    best, best_cov = name, cov
            gaps[best] = gaps.get(best, 0.0) + (g1 - g0) / 1e6
        end = max(end, e)

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return dict(device_ops=top(ops), idle_gaps=top(gaps))


class DeviceClock:
    """Completion stamps on a device's stream: CUDA events on the card,
    the host's clock after a synchronisation elsewhere (the CPU tests)."""

    def __init__(self, torch, device):
        self.torch, self.device = torch, device
        self.cuda = device.type == "cuda"

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize(self.device)

    def event(self):
        if not self.cuda:
            return time.perf_counter()
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def elapsed_ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def run_cell(files: dict, seed: int, seconds: float, trace: bool, device,
             control: bool = False) -> tuple[dict, dict]:
    """One run of a cell (``cell_files``) on ``device``: (the result line,
    details of the check for standard error)."""
    import torch

    import tracelib

    cell, config, traffic = files["cell"], files["config"], files["traffic"]
    clock = DeviceClock(torch, device)
    r, offsets, start_time, rng = build_program(config, traffic, seed, device)
    h, w = offsets.shape  # the render size
    pixels = torch.as_tensor(rng.choice(h * w, size=min(traffic["check_pixels"], h * w),
                                        replace=False))
    prefix_pixels = pixels[:traffic["prefix_pixels"]]
    step = make_step(r, traffic)
    prefix = []  # the first frames at the prefix pixels, for the check
    for k in range(traffic["warmup_frames"]):
        step()
        if k < traffic["prefix_frames"]:
            prefix.append(at_pixels(r, prefix_pixels))
    clock.sync()
    setup_s = time.perf_counter() - T_START

    undo_host, cpu_rates = steady_host()
    start, evs, rays, last = measure(r, step, seconds, clock.sync, clock.event)
    stamps = [clock.elapsed_ms(start, ev) for ev in evs]
    total_rays = int(torch.stack(rays).sum().item())
    win = window_metrics(stamps, total_rays)
    frame = traffic["warmup_frames"] + win["frames"] - 1  # the compared frame's number
    program = last._replace(rays=int(rays[-1].item()))

    result = dict(correct=False, attempted=win["frames"], failed=0, metrics={},
                  device=dict(platform="gpu" if clock.cuda else device.type,
                              kind=torch.cuda.get_device_name(device) if clock.cuda else "cpu",
                              count=cell["chips"]))
    if trace:
        tr = profile(r, step, traffic, clock.sync)
        tr.update(frame_wall_s=win["window_s"] / win["frames"], traffic=traffic, config=config,
                  cell=cell)
        for name, (entry, read) in files["metrics"].items():
            value = read(tr)
            if value is not None:
                result["metrics"][name] = dict(value=value, unit=entry["unit"])
        result["device"].update(busy_s=tracelib.busy_seconds(tr["events"]),
                                window_s=tr["wall_s"])
        result["breakdown"] = breakdown(tr)
    else:
        values = dict(win, setup_s=setup_s)
        for entry in files["end_to_end"]:
            result["metrics"][entry["name"]] = dict(value=values[entry["name"]],
                                                    unit=entry["unit"])
    undo_host()
    result["device"]["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                             if clock.cuda else 0)

    # the check, once the renderer is freed: the window's last frame from
    # the program's state before it, and the first frames from none
    import check
    from reference.frame import Reference, expected_frame

    del r, step
    if clock.cuda:
        torch.cuda.empty_cache()
    limits = dict(check.LIMITS, **traffic.get("limits", {}))
    t_check = time.perf_counter()
    stages = {}
    ref = Reference(config, traffic, start_time, offsets, device)
    expected = expected_frame(ref, frame, pixels, program, seconds=stages)
    got, rays_per_pixel = check.at_pixels(program, pixels, device)
    numbers = check.compare(got, rays_per_pixel, expected, traffic["present"])
    t_prefix = time.perf_counter()
    expected_prefix = ref.prefix(len(prefix), prefix_pixels)
    numbers.update(check.compare_prefix(prefix, expected_prefix))
    stages["prefix"] = time.perf_counter() - t_prefix
    ok, table = check.verdict(numbers, limits)
    detail = dict(parts=numbers["parts"], check_s=time.perf_counter() - t_check, check=stages,
                  frame=frame, pixels=int(pixels.numel()), setup_s=setup_s, window=win,
                  cpu_rates=cpu_rates)
    if control:
        ctl_ref = Reference(config, traffic, start_time, offsets, device, precision="bf16")
        ctl = expected_frame(ctl_ref, frame, pixels, program)
        detail["control"] = check.compare(ctl, ctl.rays.double().mean().item(), expected,
                                          traffic["present"])
        detail["control"].update(check.compare_prefix(ctl_ref.prefix(len(prefix), prefix_pixels),
                                                      expected_prefix))
    result["correct"] = ok
    result["failed"] = 0 if ok else 1
    result["checks"] = table
    return result, detail


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for name in PORT_ENVIRONMENT:
        os.environ.pop(name, None)
    files = cell_files(load_benchmark(), args.workload)

    import torch

    chips = files["cell"]["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"{args.workload}: needs {chips} CUDA device(s), {have} available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result, detail = run_cell(files, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda:0"), bool(args.control))
    found = forbidden_loaded()
    if found:
        print(f"{args.workload}: modules of JAX or the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    print(json.dumps(dict(check_detail=detail)), file=sys.stderr)
    for name, (v, lim) in result["checks"].items():
        print(f"check {name}: {v!r} (limit {lim!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
