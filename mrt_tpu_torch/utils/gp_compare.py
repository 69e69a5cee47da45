"""K13 (``gp_rows``), K14 (``banded_taps``), K15 and K16, the gp=2 frame and
K7's textured lane-row forms in this tree against another, on one card in
one call.

    python -m mrt_tpu_torch.utils.gp_compare build/parent [--only k7rows]

The other tree is a checkout of the repository, such as the parent commit
unpacked under ``build/`` with ``git archive HEAD~ | tar -x -C build/parent``.
This file runs itself (``--measure``) from each tree in a process of its
own, with that tree's package and ``chip_smoke.py`` first on the path, so
that each tree builds and runs its own kernels:

- ``kernels`` (the other tree, then this one): K13 and K14 on seeded inputs
  at run B's 589,824 lanes, a shard of half of run B's 1,318,916 triangles
  and the textured gp scene's packed atlas (whole, and the first of two
  bands), at the live shares of ``SHARES`` (a sample's steps at run B),
  each call's device ms by torch.profiler (the mean of ``REPS`` calls).
  A tree whose K13 and K14 take every lane (no live-lane count) runs them
  over every lane whatever the share; this tree's over the live lanes. A
  tree with the live-lane hit combine (``kernels.wavefront.gp_combine``)
  also times K13's step form (its scan and its gather), K15 and K16 (each
  in both forms) over the same shares; a tree without it (the full-width
  ``combine_hits_across``) has none of them.
- ``frames`` (the other tree, this, this, the other): a gp=2 world over
  gloo on this one card (``dist.launch``), 3 frames each of run B's scene
  and of the textured gp scene (``chip_smoke.gp_textured_scene``, banded):
  each frame's wall between syncs, their median after the first, rays, and
  the collectives the frames' traces issued (every ``dist.all_reduce``
  inside ``render.wavefront.trace_pixels``: calls, elements, bytes; per
  step over K7's launches, sample 0's motion-row psum included), whichever
  combine the tree runs. The two ranks share the card: not a multi-GPU
  figure.

- ``k7rows`` (the other tree, this, this, the other): K7's textured
  lane-row instantiations ``rows_maps``, ``rows_maps_mips`` and
  ``rows_maps_taps`` at gp=1 in one process on the textured gp scene (the
  whole atlas, with and without mipmaps, and banded): per instantiation
  its launches' device ms over a warm frame and its first launch's (every
  lane listed) by torch.profiler, and the tree's registers for them.

One JSON line per measurement and tree (``KERNELS``/``FRAMES``/``K7ROWS``),
then the card's name and power limit. ``--only NAME`` (repeatable) runs
only the measurements it names.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
P = 589_824  # run B's lanes
SHARES = (1.0, 0.736, 0.318, 0.03, 0.002)
REPS = 10


def _prof_ms(torch, fn, names) -> float | None:
    """Device ms of one call of ``fn``: torch.profiler's events whose names
    hold one of ``names``, over ``REPS`` calls recorded after a warm-up
    cycle with idle time around each (None where none was recorded)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    rec = []
    with profile(activities=[ProfilerActivity.CUDA], schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: rec.append(p.events())) as prof:
        for _ in range(2):
            time.sleep(0.05)
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.05)
            prof.step()
    ev = [e for e in (rec[0] if rec else []) if e.device_type == torch.autograd.DeviceType.CUDA
          and any(n in e.name for n in names)]
    return sum(e.time_range.elapsed_us() for e in ev) / 1e3 / REPS if ev else None


def measure_kernels(tree: str) -> None:
    import numpy as np
    import torch

    import chip_smoke as cs
    from mrt_tpu_torch.assets import texture as tex
    from mrt_tpu_torch.kernels import build
    from mrt_tpu_torch.kernels import wavefront as W
    from mrt_tpu_torch.render import wavefront as wf

    build.build()
    live_only = "n_live" in inspect.signature(W.gp_rows).parameters
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(0)
    n_global, n_local = 1_318_916, 659_458
    g2l = np.full(n_global, -1, np.int32)
    g2l[rng.permutation(n_global)[:n_local]] = np.arange(n_local, dtype=np.int32)

    def rand(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=dev)

    geom = wf.Geometry(None, None, None, None, None, None, rand(n_local, 16), rand(n_local, 18),
                       None, g2l=torch.as_tensor(g2l, device=dev))
    ids = torch.as_tensor(rng.integers(-1, n_global, P).astype(np.int32), device=dev)
    rows = []
    for share in SHARES:
        live = torch.as_tensor(rng.random(P) < share, device=dev)
        n = int(live.sum())
        for motion in (False, True):
            args = (geom, ids, live, True, motion) + ((n,) if live_only else ())
            rows.append(dict(kernel="K13", share=share, live=n, motion=motion,
                             ms=_prof_ms(torch, lambda a=args: W.gp_rows(*a), ("gp_rows",))))
    sd, _ = cs.gp_textured_scene().compile(dev)
    n_res = sd.atlas.packed_rects.shape[0]
    u = torch.as_tensor(rng.random(P).astype(np.float32) * 0.5, device=dev)
    v = torch.as_tensor(rng.random(P).astype(np.float32) * 0.5, device=dev)
    for share in SHARES:
        lane_of = np.flatnonzero(rng.random(P) < share).astype(np.int32)
        n = lane_of.size if live_only else P
        srow = rng.standard_normal((n, 16)).astype(np.float32)
        srow[:, 9:15] = rng.random((n, 6)) * 3 - 1
        srow[:, 15] = rng.integers(0, n_res, n)
        s_t = torch.as_tensor(srow, device=dev)
        extra = (torch.as_tensor(lane_of, device=dev),) if live_only else ()
        for bands in (1, 2):
            args = (tex.atlas_band(sd.atlas, bands, 0), s_t, u, v) + extra
            rows.append(dict(kernel="K14", share=share, rows=n, bands=bands,
                             ms=_prof_ms(torch, lambda a=args: W.banded_taps(*a),
                                         ("banded_taps",))))
    if hasattr(W, "gp_combine"):
        rows += _combine_kernels(torch, np, rng, W, geom, n_global, dev)
    print("KERNELS", json.dumps(dict(tree=tree, live_only=live_only, rows=rows)), flush=True)


def _combine_kernels(torch, np, rng, W, geom, n_global: int, dev) -> list:
    """K13's step form (scan, gather), K15 and K16 in both forms at each
    share of ``SHARES``, rank 0 of gp=2 (seeded hits: t from a small set,
    a third of the lanes missed), device ms a call by the profiler."""
    from mrt_tpu_torch.dist import comm

    axis = comm.Axis("gp", 2, 0, None)
    geom = geom._replace(axis=axis)
    t = torch.as_tensor(rng.choice(np.float32([1.0, 2.0, np.inf]), P), device=dev)
    tri = torch.where(torch.isinf(t), -1, torch.as_tensor(
        rng.integers(0, n_global, P).astype(np.int32), device=dev)).to(torch.int32)
    u = torch.as_tensor(rng.random(P).astype(np.float32), device=dev)
    v = torch.as_tensor(rng.random(P).astype(np.float32), device=dev)
    occluded = torch.as_tensor(rng.random(P) < 0.5, device=dev)
    rows = []
    for share in SHARES:
        live = torch.as_tensor(rng.random(P) < share, device=dev)
        n = int(live.sum())
        pos, lane_of = W.gp_scan(live, n)
        keys = W.gp_hit_keys(t, tri, lane_of, axis)
        out = W.gp_gather(geom, t, tri, u, v, keys, lane_of, True, False)
        payload = out[16 * n:].view(torch.int32).view(n, W.PAYLOAD_COLS)
        occ = W.gp_occluded_rows(occluded, lane_of)
        rec = [x.clone() for x in (t, tri, u, v)]
        calls = {
            "K13 scan": (lambda: W.gp_scan(live, n, pos=pos, lane_of=lane_of), ("gp_rows",)),
            "K13 gather": (lambda: W.gp_gather(geom, t, tri, u, v, keys, lane_of, True, False,
                                               out=out), ("gp_gather",)),
            "K15 keys": (lambda: W.gp_hit_keys(t, tri, lane_of, axis, out=keys),
                         ("gp_hit_keys",)),
            "K15 occluded": (lambda: W.gp_occluded_rows(occluded, lane_of, out=occ),
                             ("gp_hit_keys",)),
            "K16 hits": (lambda: W.gp_lane_unpack(keys, payload, lane_of, *rec),
                         ("gp_lane_unpack",)),
            "K16 occluded": (lambda: W.gp_occluded_lanes(occ, lane_of, occluded.clone()),
                             ("gp_lane_unpack",))}
        for name, (fn, names) in calls.items():
            rows.append(dict(kernel=name, share=share, live=n, ms=_prof_ms(torch, fn, names)))
    return rows


def counted_drive(*args, **kwargs) -> dict:
    """Rank side: ``dist.launch.drive`` with every ``dist.all_reduce`` that
    ``render.wavefront.trace_pixels`` issues counted (``collectives``:
    calls, elements, bytes over the drawn frames), in any tree."""
    import torch.distributed as dist

    from mrt_tpu_torch.dist import launch as L
    from mrt_tpu_torch.render import wavefront as wf

    rec = dict(calls=0, elements=0, bytes=0)
    inside = []
    orig_reduce, orig_trace = dist.all_reduce, wf.trace_pixels

    def all_reduce(x, *a, **k):
        if inside:
            rec["calls"] += 1
            rec["elements"] += x.numel()
            rec["bytes"] += x.numel() * x.element_size()
        return orig_reduce(x, *a, **k)

    def trace_pixels(*a, **k):
        inside.append(True)
        try:
            return orig_trace(*a, **k)
        finally:
            inside.pop()

    dist.all_reduce, wf.trace_pixels = all_reduce, trace_pixels
    try:
        out = L.drive(*args, **kwargs)
    finally:
        dist.all_reduce, wf.trace_pixels = orig_reduce, orig_trace
    out["collectives"] = rec
    return out


def _frames_line(job: dict) -> dict:
    steps = job["launches"]["shade_hit"]
    c = job["collectives"]
    return dict(walls=job["walls"], median_after_first=statistics.median(job["walls"][1:]),
                rays=job["rays"], steps=steps, collectives=c,
                per_step=dict(calls=c["calls"] / steps, bytes=c["bytes"] / steps) if steps else None)


def measure_frames(tree: str) -> None:
    import torch

    import chip_smoke as cs
    from mrt_tpu_torch.dist import launch as L
    from mrt_tpu_torch.utils import frame_profile as FP

    dev = torch.device("cuda:0")
    b = FP.RUNS["B"]
    jobs = []
    for make, banded in ((lambda: FP.make_scene("B"), False), (cs.gp_textured_scene, True)):
        settings, offsets = gp_job_settings(make(), b["width"], b["height"], dev)
        jobs.append((counted_drive, ("gp", make(), settings, {"gp": 2}, 3),
                     dict(offsets=offsets, banded=banded)))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = L.launch(L.run_jobs, 2, jobs, backend="gloo")
    print("FRAMES", json.dumps(dict(tree=tree, launch_s=time.perf_counter() - t0,
                                    b=_frames_line(res[0][0]),
                                    textured=_frames_line(res[0][1]))), flush=True)


def k7_rows_frame(r, reps: int = 5) -> dict:
    """K7's lane-row form in two frames of the gp renderer ``r``: over the
    first, each launch's device ms by torch.profiler (the kernel's events in
    the frame, summed and counted); over the second, the first launch (every
    lane of the step listed) on fresh copies of its inputs, the mean of
    ``reps`` launches; the instantiation. On the CPU (no profiler) only the
    launches and the instantiation."""
    import torch

    from mrt_tpu_torch.dist.route_check import _device_events
    from mrt_tpu_torch.kernels import wavefront as W

    cuda = r.device.type == "cuda"
    name = "shade_hit_rows_kernel"
    out = dict(frame_ms=None, launches=None, first_ms=None, variant=None)
    if cuda:
        ev = [e for e in _device_events(r.draw) if name in e.name]
        out.update(frame_ms=sum(e.time_range.elapsed_us() for e in ev) / 1e3 if ev else None,
                   launches=len(ev))
    orig = W.shade_hit

    def shade_hit(fr, st, hits, sidx, wv, rows=None):
        if out["variant"] is None:
            out["variant"] = W.K7_VARIANTS[W.k7_variant(fr.settings, fr.statics,
                                                        fr.scene.atlas.band_lo is not None)]
            if cuda:
                st0, wv0 = W.clone_state(st), W.clone_wave(wv)
                ev = [e for e in _device_events(lambda: orig(fr, W.clone_state(st0), hits, sidx,
                                                             W.clone_wave(wv0), rows), reps)
                      if name in e.name]
                out["first_ms"] = (sum(e.time_range.elapsed_us() for e in ev) / 1e3 / reps
                                   if ev else None)
        if not cuda:
            out["launches"] = (out["launches"] or 0) + 1
        return orig(fr, st, hits, sidx, wv, rows)

    W.shade_hit = shade_hit
    try:
        r.draw()
    finally:
        W.shade_hit = orig
    if cuda:
        torch.cuda.synchronize()
    return out


def gp_job_settings(scene, width: int, height: int, device):
    """A gp job's settings for ``scene`` (the main path's, the flat BVH) and
    its offsets, from a single-device renderer of it."""
    from mrt_tpu_torch import Renderer
    from mrt_tpu_torch.utils import frame_profile as FP

    rt = Renderer(scene, width, height, device=device)
    FP.configure(rt)
    rt.two_level = False
    rt._allocate_state()
    return rt.settings(), rt.offsets.cpu().numpy()


def k7_rows_jobs(textured) -> dict:
    """{K7's textured lane-row instantiation: (settings, banded)} from the
    textured settings: the whole atlas without and with mipmaps, and the
    banded atlas (K14's taps)."""
    import dataclasses

    return {"rows_maps": (textured, False),
            "rows_maps_mips": (dataclasses.replace(textured, use_mipmaps=True), False),
            "rows_maps_taps": (textured, True)}


def measure_k7rows(tree: str) -> None:
    """K7's textured lane-row instantiations (``k7_rows_jobs``) at gp=1 in
    this process (a world of one rank), each on the textured gp scene
    (``k7_rows_frame`` after two warm-up frames), and their registers."""
    import torch

    import chip_smoke as cs
    from mrt_tpu_torch.dist.geometry import GeometryShardedRenderer
    from mrt_tpu_torch.kernels import build
    from mrt_tpu_torch.utils import frame_profile as FP

    dev = torch.device("cuda:0")
    build.build()
    b = FP.RUNS["B"]
    textured, offsets = gp_job_settings(cs.gp_textured_scene(), b["width"], b["height"], dev)
    rows = []
    for v, (settings, banded) in k7_rows_jobs(textured).items():
        r = GeometryShardedRenderer(cs.gp_textured_scene(), settings, banded=banded,
                                    offsets=offsets, device=dev)
        for _ in range(2):
            r.draw()
        torch.cuda.synchronize()
        line = dict(job=v, **k7_rows_frame(r))
        if line["variant"] != v:
            raise AssertionError(f"the {v} job ran K7's {line['variant']}")
        rows.append(line)
        del r
        torch.cuda.empty_cache()
    regs = {n: x for n, x in build.ptxas.items() if "shade_hit_rows_kernel" in n}
    print("K7ROWS", json.dumps(dict(tree=tree, rows=rows, ptxas=regs)), flush=True)


MEASURES = ("kernels", "frames", "k7rows")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", nargs="?", help="the other tree's root")
    ap.add_argument("--measure", choices=MEASURES, help=argparse.SUPPRESS)
    ap.add_argument("--only", choices=MEASURES, action="append",
                    help="run only these measurements (default: all)")
    a = ap.parse_args(argv)
    if a.measure:
        tree = os.getcwd()
        here = os.path.dirname(os.path.abspath(__file__))
        sys.path[:] = [tree] + [p for p in sys.path if os.path.abspath(p or ".") != here]
        {"kernels": measure_kernels, "frames": measure_frames,
         "k7rows": measure_k7rows}[a.measure](tree)
        return 0
    if a.other is None:
        ap.error("name the other tree")
    other = os.path.abspath(a.other)
    me = os.path.abspath(__file__)
    bad = 0
    for what, order in (("kernels", (other, HERE)), ("frames", (other, HERE, HERE, other)),
                        ("k7rows", (other, HERE, HERE, other))):
        if a.only and what not in a.only:
            continue
        for cwd in order:
            r = subprocess.run([sys.executable, me, "--measure", what], cwd=cwd,
                               capture_output=True, text=True)
            for line in r.stdout.splitlines():
                if line.startswith(("KERNELS", "FRAMES", "K7ROWS")):
                    print(line, flush=True)
            if r.returncode:
                bad += 1
                print(f"{what} in {cwd}: exit {r.returncode}\n{r.stderr[-3000:]}", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps(dict(card=card)), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
