#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mrt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
never prints its last line):
  1. device: requires CUDA; prints the card's name and power limit and
     turns TF32 off;
  2. build: compiles the CUDA kernels from mrt_tpu_torch/csrc;
  3. kernels against their plain PyTorch versions on the card: Halton
     (bit-equal to the CPU) and K2 two-level traversal on 2^20 random
     mixed rays, on the same rays with every lane dead and with one live
     lane at the end of the wavefront (the edges of K2's live-lane
     compaction): hit-equal, t/u/v bit-equal, pops equal per lane;
  4. the port's main path at full width: the flagship scene without the
     train/treefir OBJs at 1920x1080, 2 spp, 4 bounces, upscaler off,
     motion-adaptive sampling off (run A), and the 1.31M-triangle dragon at
     1024x576 (run B), both defined in mrt_tpu_torch/utils/frame_profile.py.
     Before each run is driven, K1 present (uint8-equal) and every K2
     launch of one of its frames (hit-equal, t/u/v bit-equal, pops equal)
     are held against their plain versions at that run's shapes and timed,
     with K2's bound per launch from the plain version's visits. Then the run
     is driven with each kernel's launch counter set to 0 and checked to
     rise. After both runs were driven, under torch.profiler: K1's device
     time, warm and after a 64 MB write (cold), and K2's device time over
     one more steady frame (warm L2);
  5. a small frame traced on the card against the same frame traced on the
     CPU through the plain versions.
The line before the last is {"kernels": [...]}, with each kernel's bound
(mrt_tpu_torch/utils/bounds.py); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, name: str, reps: int, flush=None) -> float:
    """Mean device time in ms of the kernels whose name holds ``name`` (one
    per call of ``fn``), from torch.profiler over ``reps`` calls; ``flush``
    (if given) runs before each call, outside the sum."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
    if len(ev) < reps // 2:  # the profiler may drop the first few of a session
        raise AssertionError(f"the profiler saw {len(ev)} '{name}' kernels in {reps} calls")
    return sum(e.time_range.elapsed_us() for e in ev) / 1e3 / len(ev)


def check_halton(torch, H):
    """GPU Halton == CPU Halton bit for bit over every base, on and next to
    quotient boundaries, dense low and random high indices."""
    import numpy as np

    rng = np.random.default_rng(7)
    idx, dims = [], []
    for d in range(100):
        b = int(H.PRIMES[d])
        ks = np.unique(rng.integers(1, (1 << 24) // b, size=64))
        i = np.unique(np.concatenate([ks * b - 1, ks * b, ks * b + 1, np.arange(0, 4096, 97),
                                      rng.integers(1 << 20, 1 << 24, size=64)]))
        i = i[(i >= 0) & (i < (1 << 24))]
        idx.append(i)
        dims.append(np.full(i.shape, d))
    i = torch.as_tensor(np.concatenate(idx).astype(np.int32))
    d = torch.as_tensor(np.concatenate(dims).astype(np.int64))
    cpu = H.halton(i, d)
    gpu = H.halton(i.cuda(), d.cuda()).cpu()
    bases = torch.as_tensor(H.PRIMES)[d.clamp(2, 99)]
    cpu_s = H.halton_base(i, bases, H.STEP_MAX_DIGITS)
    gpu_s = H.halton_base(i.cuda(), bases.cuda(), H.STEP_MAX_DIGITS).cpu()
    bad = int((cpu.view(torch.int32) != gpu.view(torch.int32)).sum()
              + (cpu_s.view(torch.int32) != gpu_s.view(torch.int32)).sum())
    log(f"halton: {i.numel()} indices x 2 digit budgets, GPU vs CPU bit mismatches: {bad}")
    if bad:
        raise AssertionError("GPU Halton differs from the CPU Halton")


def k2_mismatches(torch, kout, pout):
    """Per-field mismatch counts of a K2 result against its plain version
    (tri, inst, found, pops equal; t, u, v equal in their bits), and the
    largest |t| difference over hits."""
    bad = {f: int((getattr(kout, f) != getattr(pout, f)).sum())
           for f in ("tri", "inst", "found", "pops")}
    for f in ("t", "u", "v"):
        bad[f] = int((getattr(kout, f).view(torch.int32) != getattr(pout, f).view(torch.int32)).sum())
    hit = pout.tri >= 0
    err = float((kout.t[hit] - pout.t[hit]).abs().max()) if bool(hit.any()) else 0.0
    return bad, err


def check_path_kernels(torch, tag, r, present, traverse2, bounds):
    """Hold K1 and K2 against their plain versions at the shapes run ``tag``
    gives them, before the run is driven. K1: the edge-case values at the
    render size, and the frame's own accumulation through present_device;
    its time from CUDA events over 50 calls (its device times come later,
    from profile_run). K2: every launch of one frame of the path
    (camera, bounce and shadow batches), each held against the plain
    version on the same inputs right after it ran, with its bound from the
    work of the plain version's visits. Raises on any mismatch; returns the
    kernels' numbers."""
    h, w = r.render_height, r.render_width
    plain1 = present.tonemap_quantize_plain
    x_cpu = present.edge_case_inputs(h, w)
    x = x_cpu.to(r.device)
    k1, p1 = present.tonemap_quantize(x), plain1(x)
    k1_bad = int((k1 != p1).sum()) + int((k1.cpu() != plain1(x_cpu)).sum())
    k1_err = int((k1.int() - p1.int()).abs().max())
    k1_ms = cuda_ms(lambda: present.tonemap_quantize(x), 50)
    k1_plain_ms = cuda_ms(lambda: plain1(x), 50)

    orig = traverse2.traverse
    k2 = dict(launches=0, rays=0, max_abs_err=0.0, frame_ms=0.0, frame_plain_ms=0.0,
              frame_bound_ms=0.0, bound_by={"operations": 0, "bytes": 0}, work={})
    first = []

    def checked(*args):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        kout = orig(*args)
        ev[1].record()
        pout = traverse2.traverse_plain(*args)
        ev[2].record()
        torch.cuda.synchronize()
        bad, err = k2_mismatches(torch, kout, pout)
        if any(bad.values()):
            raise AssertionError(f"K2 disagrees with its plain version (run {tag}, launch "
                                 f"{k2['launches']}, {kout.t.numel()} rays): {bad}")
        n_live = int(args[9].sum())
        work = bounds.k2_work(args[0], args[1], args[2], pout.visits)
        b_ms, b_by = bounds.k2(work, kout.t.numel(), n_live)
        k2["launches"] += 1
        k2["rays"] += n_live
        k2["max_abs_err"] = max(k2["max_abs_err"], err)
        k2["frame_ms"] += ev[0].elapsed_time(ev[1])
        k2["frame_plain_ms"] += ev[1].elapsed_time(ev[2])
        k2["frame_bound_ms"] += b_ms
        k2["bound_by"][b_by] += 1
        for key, val in work.items():
            k2["work"][key] = k2["work"].get(key, 0) + val
        if not first:
            first.append(args)
        return kout

    traverse2.traverse = checked
    try:
        r.draw()
    finally:
        traverse2.traverse = orig
    img = r.present_device()
    k1_bad += int((img != plain1(r.accum.contiguous())).sum())
    log(f"K1 present run {tag} ({h},{w},3): {x.numel()} edge values (zeros, tiny, huge, exact .5 "
        f"landings, random) and the frame's accumulation, kernel vs plain mismatches {k1_bad}; "
        f"kernel {k1_ms:.4f} ms (CUDA events over 50 calls), plain {k1_plain_ms:.4f} ms")
    if k1_bad:
        raise AssertionError(f"K1 disagrees with its plain version (run {tag})")
    if not k2["launches"]:
        raise AssertionError(f"run {tag}: the checked frame launched no traversal")
    cam = first[0]
    k2["ms"] = cuda_ms(lambda: orig(*cam), 10)
    k2["plain_ms"] = cuda_ms(lambda: traverse2.traverse_plain(*cam), 1)
    k2["bound_ms"], k2["bound_by_cam"] = bounds.k2(
        bounds.k2_work(cam[0], cam[1], cam[2], traverse2.traverse_plain(*cam).visits),
        cam[5].shape[0], int(cam[9].sum()))
    log(f"K2 traverse run {tag}: one frame's {k2['launches']} launches, {k2['rays']} live rays, "
        f"0 mismatches in tri, inst, occluded, pops and the bits of t, u, v; kernel "
        f"{k2['frame_ms']:.3f} ms (CUDA events, cold L2), plain {k2['frame_plain_ms']:.3f} ms, "
        f"bound {k2['frame_bound_ms']:.3f} ms per frame (launches bound by {k2['bound_by']}); "
        f"work summed over launches {k2['work']}; camera rays ({cam[5].shape[0]}): kernel {k2['ms']:.3f} ms, "
        f"plain {k2['plain_ms']:.3f} ms, bound {k2['bound_ms']:.4f} ms ({k2['bound_by_cam']})")
    return dict(k1_err=k1_err, k1_ms=k1_ms, k1_plain_ms=k1_plain_ms, k2=k2, k1_input=x)


def profile_run(torch, FP, tag, r, present, bounds, check, walls):
    """After the runs were driven, so that no profiler session precedes their
    timed frames: K1's device time at the render size from the profiler,
    warm and after a 64 MB write (cold), and K2's device time over one more
    steady frame (warm L2), its idle share taken against the median of the
    driven frames' walls (``walls``). Adds them to ``check``; returns the frame's
    profile line."""
    x = check.pop("k1_input")
    scratch = torch.empty(16 << 20, dtype=torch.float32, device=r.device)  # 64 MB > the 50 MB L2
    check["k1_warm"] = device_ms(torch, lambda: present.tonemap_quantize(x), "present_kernel", 20)
    check["k1_cold"] = device_ms(torch, lambda: present.tonemap_quantize(x), "present_kernel", 20,
                                 flush=lambda: scratch.fill_(1.0))
    del scratch, x
    check["k1_bound_ms"], check["k1_bound_by"] = bounds.k1((r.render_height, r.render_width, 3))
    log(f"K1 present run {tag}: device time {check['k1_warm']:.4f} ms warm, {check['k1_cold']:.4f} ms "
        f"cold (profiler); bound {check['k1_bound_ms']:.4f} ms ({check['k1_bound_by']})")
    line = FP.profile_frame(r, walls=walls)
    if not line["traverse2_launches"] or line["traverse2_s"] <= 0.0:
        raise AssertionError(f"{tag}: the profiled frame shows no K2 device time")
    return line


def main() -> int:
    import torch

    # --- 1. device -------------------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run needs an NVIDIA GPU "
              "and does not fall back to the CPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    from mrt_tpu_torch import Model, Renderer, Scene
    from mrt_tpu_torch.core import halton as H
    from mrt_tpu_torch.kernels import build, present, traverse2
    from mrt_tpu_torch.utils import bounds
    from mrt_tpu_torch.utils import frame_profile as FP

    t_start = time.perf_counter()
    card = card_line()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    card_name, power_limit = (s.strip() for s in card.split(",", 1))

    # --- 2. build ---------------------------------------------------------------------
    secs = build.build(verbose=True)
    build.load()
    log(f"build: {sorted(p.name for p in build.CSRC.glob('*.cu'))} -> "
        f"{build.LIB.relative_to(ROOT)} in {secs:.1f} s")

    # --- 3. kernels against their plain versions ----------------------------------------
    check_halton(torch, H)

    def make(tag):
        t0 = time.perf_counter()
        r = FP.make_renderer(tag, dev)
        log(f"run {tag} scene compile + BVH build: {time.perf_counter() - t0:.1f} s, "
            f"{r.statics.n_triangles} triangles, table {tuple(r.bvh.table.shape)}, "
            f"stack {r.bvh.stack_size}")
        return r

    ra = make("A")
    bvh = ra.bvh
    g = torch.Generator(device=dev).manual_seed(1)
    n = 1 << 20
    table = bvh.table
    lo = table[0, 0:24].reshape(3, 8).amin(dim=1)
    hi = table[0, 24:48].reshape(3, 8).amax(dim=1)
    org = lo + (hi - lo) * torch.rand((n, 3), generator=g, device=dev)
    dirs = torch.randn((n, 3), generator=g, device=dev)
    dirs = dirs / dirs.norm(dim=1, keepdim=True)
    shadow = torch.rand(n, generator=g, device=dev) < 0.5
    tmax = torch.where(shadow, 0.1 + 8.0 * torch.rand(n, generator=g, device=dev),
                       torch.full((n,), float("inf"), device=dev))
    active = torch.rand(n, generator=g, device=dev) < 0.95
    args = (table, bvh.n_internal, bvh.n_leaf, bvh.tlas_n, bvh.stack_size, org, dirs, tmax,
            shadow, active)
    k2, p2 = traverse2.traverse(*args), traverse2.traverse_plain(*args)
    bad, k2_rand_err = k2_mismatches(torch, k2, p2)
    k2_rand_ms = cuda_ms(lambda: traverse2.traverse(*args), 10)
    rand_bound = bounds.k2(bounds.k2_work(table, bvh.n_internal, bvh.n_leaf, p2.visits), n,
                           int(active.sum()))
    log(f"K2 traverse, {n} random mixed rays over the run A table: {int((p2.tri >= 0).sum())} hits, "
        f"{int((p2.found & shadow).sum())} occluded, {int(p2.pops.sum())} pops; mismatches {bad}; "
        f"kernel {k2_rand_ms:.3f} ms, bound {rand_bound[0]:.4f} ms ({rand_bound[1]})")
    if any(bad.values()):
        raise AssertionError("K2 disagrees with its plain version (random mixed rays)")
    # the compaction's edges: every lane dead; one live lane, the wavefront's
    # last; and at 2^20 - 1 lanes, where the compaction's last block is
    # partial, the last lane alone and the random mask
    last = torch.zeros(n, dtype=torch.bool, device=dev)
    last[-1] = True
    m = n - 1
    last_m = torch.zeros(m, dtype=torch.bool, device=dev)
    last_m[-1] = True
    edges = (("all lanes dead", n, torch.zeros_like(active)), ("one live lane, the last", n, last),
             ("one live lane, the last", m, last_m), ("the random mask", m, active[:m]))
    for what, lanes, act in edges:
        eargs = args[:5] + tuple(x[:lanes] for x in args[5:9]) + (act,)
        bad, _ = k2_mismatches(torch, traverse2.traverse(*eargs), traverse2.traverse_plain(*eargs))
        log(f"K2 traverse, {lanes} lanes, {what}: mismatches {bad}")
        if any(bad.values()):
            raise AssertionError(f"K2 disagrees with its plain version ({lanes} lanes, {what})")

    # --- 4. main path: each run's kernels checked at its shapes, then driven ---------------
    def drive(tag, r, timed):
        present.launches = 0
        traverse2.launches = 0
        r.draw()  # warm-up
        torch.cuda.synchronize()
        rays, walls = 0, []
        for _ in range(timed):
            t0 = time.perf_counter()
            r.draw()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            rays += int(r.last_rays_traced)
        seconds = sum(walls)
        img = r.output_image()
        torch.cuda.synchronize()
        counts = {"present": present.launches, "traverse2": traverse2.launches}
        h, w = r.render_height, r.render_width
        if img.shape != (h, w, 3) or img.dtype != np.uint8:
            raise AssertionError(f"{tag}: image {img.shape} {img.dtype}")
        acc = r.accum
        if not bool(torch.isfinite(acc).all()) or float(acc.max()) <= 0.0:
            raise AssertionError(f"{tag}: accumulation is not finite or is all black")
        if rays <= 0:
            raise AssertionError(f"{tag}: no rays traced")
        if min(counts.values()) < 1:
            raise AssertionError(f"{tag}: a kernel of the path never launched: {counts}")
        line = dict(run=tag, scene=FP.RUNS[tag]["scene"], resolution=[w, h], spp=2, bounces=4,
                    triangles=r.statics.n_triangles, table_bytes=r.bvh.table.numel() * 4,
                    frames=timed, total_rays=rays, seconds=seconds, frame_walls=walls,
                    mrays_per_s=rays / seconds / 1e6, launches=counts,
                    accum_mean=float(acc.mean()), image_mean=float(img.mean()),
                    card=card_name, power_limit=power_limit)
        log(json.dumps(line))
        return counts, walls

    def profile(tag, r):
        line = profile_run(torch, FP, tag, r, present, bounds, checks[tag], walls[tag])
        log(json.dumps(dict(run=tag, profile=line, card=card_name, power_limit=power_limit)))
        return line

    checks, counts, walls = {}, {}, {}
    checks["A"] = check_path_kernels(torch, "A", ra, present, traverse2, bounds)
    counts["A"], walls["A"] = drive("A", ra, 3)
    del bvh, table, args, k2, p2, eargs, last, last_m, edges
    torch.cuda.empty_cache()
    rb = make("B")
    checks["B"] = check_path_kernels(torch, "B", rb, present, traverse2, bounds)
    counts["B"], walls["B"] = drive("B", rb, 2)
    # the profiler last: a process's frames after a profiler session ran
    # slower on the host in this script's runs (PERF.md, Findings)
    profiles = {"A": profile("A", ra), "B": profile("B", rb)}
    del ra, rb

    # --- 5. a small frame on the card against the CPU plain path -------------------------------
    def small(device):
        s = Scene(48, 48)
        s.models = [Model("sphere", position=[0, 0.5, 0], scale=0.5), Model("plane", scale=10)]
        r = Renderer(s, 48, 48, seed=3, device=device)
        FP.configure(r)
        r.max_bounces = 3
        for _ in range(2):
            r.draw()
        return r.accum.cpu(), int(r.last_rays_traced)

    acc_g, rays_g = small(dev)
    acc_c, rays_c = small("cpu")
    rel = float(((acc_g - acc_c) ** 2).mean().sqrt() / (acc_c ** 2).mean().sqrt())
    log(f"small frame 48x48: card vs CPU relative RMSE {rel:.3e} (limit 1e-2), "
        f"rays {rays_g} vs {rays_c}")
    if not rel < 1e-2 or rays_g <= 0 or abs(rays_g - rays_c) > 0.01 * rays_c:
        raise AssertionError("the card's frame disagrees with the CPU reference")

    # launches: both runs' main-path counts. K1: ms is its profiler device
    # time after a 64 MB write (as a frame leaves the L2) at run A's shape.
    # K2: ms, plain_ms and bound_ms are for run A's camera rays; per run, the
    # warm profiler time of one frame, the cold CUDA-event time of the
    # checked frame, its bound and its work by row type.
    a = checks["A"]
    kernels = [
        dict(name="K1 present tonemap_quantize", route="cuda",
             source="mrt_tpu_torch/csrc/present.cu", replaces="mrt_tpu/kernels/present.py:52",
             launches=counts["A"]["present"] + counts["B"]["present"],
             launches_by_run={t: counts[t]["present"] for t in counts},
             max_abs_err=max(c["k1_err"] for c in checks.values()), ms=a["k1_cold"],
             plain_ms=a["k1_plain_ms"], bound_ms=a["k1_bound_ms"], bound_by=a["k1_bound_by"],
             library_ms=None,
             by_run={t: dict(ms_cold=c["k1_cold"], ms_warm=c["k1_warm"], ms_events=c["k1_ms"],
                             plain_ms=c["k1_plain_ms"], bound_ms=c["k1_bound_ms"])
                     for t, c in checks.items()}),
        dict(name="K2 two-level traversal", route="cuda",
             source="mrt_tpu_torch/csrc/traverse2.cu", replaces="mrt_tpu/bvh/twolevel.py:593",
             launches=counts["A"]["traverse2"] + counts["B"]["traverse2"],
             launches_by_run={t: counts[t]["traverse2"] for t in counts},
             max_abs_err=max([k2_rand_err] + [c["k2"]["max_abs_err"] for c in checks.values()]),
             ms=a["k2"]["ms"], plain_ms=a["k2"]["plain_ms"], bound_ms=a["k2"]["bound_ms"],
             bound_by=a["k2"]["bound_by_cam"], library_ms=None,
             by_run={t: dict(frame_ms_profiler_warm=profiles[t]["traverse2_s"] * 1e3,
                             frame_launches_profiler=profiles[t]["traverse2_launches"],
                             frame_ms_events_cold=c["k2"]["frame_ms"],
                             frame_plain_ms=c["k2"]["frame_plain_ms"],
                             frame_bound_ms=c["k2"]["frame_bound_ms"],
                             launches_bound_by=c["k2"]["bound_by"],
                             pops_by_type={k: c["k2"]["work"][f"pops_{k}"]
                                           for k in ("internal", "leaf", "instance")},
                             work=c["k2"]["work"], live_rays=c["k2"]["rays"],
                             device_busy_s=profiles[t]["device_busy_s"])
                     for t, c in checks.items()}),
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
