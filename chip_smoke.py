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
     compaction): hit-equal, t/u/v bit-equal, pops equal per lane. Each of
     K2's three instantiations on the path so: the packed one over run A's
     table here, and the float-sort one on the same rays over that table
     padded past 2^20 - 1 rows (the sort's own cost); the masked one over
     run F's table with a random ray mask per ray and the float-sort one
     over run G's table (more than 2^20 - 1 rows) each as soon as its run
     is built (6b);
  4. the port's main path at full width: the flagship scene without the
     train/treefir OBJs at 1920x1080, 2 spp, 4 bounces, upscaler off,
     motion-adaptive sampling off (run A), the 1.31M-triangle dragon at
     1024x576 (run B), and the animated app frame: run A's scene plus the
     swing-rigged robot stand-in, motion-adaptive sampling on (run C), all
     defined in mrt_tpu_torch/utils/frame_profile.py; every frame is
     drawn with draw(1/60), one 60 Hz animation step. Before each run is
     driven, K1 present (uint8-equal) and every K2 launch of one of its
     frames (hit-equal, t/u/v bit-equal, pops equal) are held against their
     plain versions at that run's shapes and timed, with K2's bound per
     launch from the plain version's visits. Then the run is driven with
     each kernel's launch counter set to 0 and checked to rise. Run C also
     prints the seconds of its prepare stage (skinning, world transform,
     refit) per animated frame, the share of pixels that earned 1 and 2
     extra samples, and its largest motion vector (> 0.5 px: the robot
     moves); the whole-table copy of each run's refit is timed;
  5. phase D, skinning and refit at character scale: one skinned cylinder
     of 66,049 vertices, 131,072 triangles and 64 joints with the swing rig
     over a floor at 1024x576 with run C's settings, 2 frames driven.
     Checks: the card's LBS against a float64 NumPy LBS within 1e-5 of the
     rig's extent; the card's refit bit-equal to the CPU's on the same
     posed vertices in the skinned BLAS rows, the other rows within 1e-6;
  6. run E, the presenter chain: run C's scene rendered at 1920x1080
     (render scale 0.5), 1 spp, 2 bounces, motion-adaptive sampling on, and
     presented at 3840x2160 through the spatial (Lanczos-3), temporal and
     SVGF-lite denoised upscalers in turn on one renderer. Per mode, with
     the launch counters set to 0: a warm-up frame, 3 orbit frames
     (orbit(0.02, 0), draw(1/30), present_device) and 3 still frames
     (draw(1/60), present_device), each frame's wall between syncs.
     Checks: after an orbit frame the temporal and denoised state is
     bit-equal to a history-free present's, after a still frame the output
     differs from it; the denoiser's G-buffer is finite and its history
     grows; the present of the last frame's buffers and state on the card
     against the same on the CPU (linear output, new history and
     DenoiseState within 1e-5 relative RMSE, uint8 within 1 LSB); K1
     uint8-equal to its plain version on each mode's (2160,3840,3) output;
  6b. runs F and G, each checked and driven as runs A-C are, with each K2
     instantiation's launch count read on its own: run F, the wavefront's
     extras at run A's width (the floor with a 2048x2048 base-colour
     checker and a 1024x1024 normal map made from a seed, mipmapped
     sampling, the two spheres masked as light geometry), launches only the
     masked K2; then one frame of each debug view 1-6 on run F's scene and
     of the motion view (7) on run C's; run G, run B's scene with two
     distinct blob(subdivisions=9) dragons (a table above 2^20 rows; its
     host build seconds printed), launches only the float-sort K2. Runs A-E
     launch only the packed one;
  7. after every run was driven, under torch.profiler: K1's device time,
     warm and after a 64 MB write (cold), K2's device time over one more
     steady frame of runs A-C, F and G (warm L2), the costliest operators
     of a frame of runs A and F, phase D's LBS and refit device time per
     animated frame beside their bounds, and run E's present device time
     and events per mode, its resize products' and denoiser's device time
     and K1's at (2160,3840,3), beside their bounds;
  8. a 48x48 frame traced and presented in every presenter mode on the card
     against the same frames on the CPU through the plain versions (the
     accumulation and the presented output within 1e-2 relative RMSE, the
     G-buffer within 1e-5 on at least 99.9 % of pixels); then a 48x48
     textured scene with a light-masked sphere, on the card against the
     CPU within 1e-2 relative RMSE and rays within 1 %: mipmaps on, each
     debug view 1-7, and the light-masked frame.
The line before the last is {"kernels": [...]}, with each kernel's bound
(mrt_tpu_torch/utils/bounds.py); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
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


def profiled(torch, fn, reps: int, host: bool = False):
    """torch.profiler's (events, key averages) of ``reps`` calls of ``fn``
    (device activity, and the host's if ``host``), recorded in a second
    cycle after a traced warm-up cycle of as many calls: a session's first
    device events can go missing (one saw 5 of 20 kernels)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    out = []
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    fn()
    torch.cuda.synchronize()
    with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: out.append((p.events(), p.key_averages()))) as prof:
        for _ in range(2):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
    if not out:
        raise AssertionError("the profiler recorded no cycle")
    return out[0]


def device_events(torch, events):
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]


def device_ms(torch, fn, name: str, reps: int, flush=None) -> float:
    """Mean device time in ms of the kernels whose name holds ``name`` (one
    per call of ``fn``), from torch.profiler over ``reps`` calls; ``flush``
    (if given) runs before each call, outside the sum. A session that saw
    fewer than half of them is run again, up to three times."""

    def call():
        if flush is not None:
            flush()
        fn()

    for _ in range(3):
        ev = [e for e in device_events(torch, profiled(torch, call, reps)[0]) if name in e.name]
        if len(ev) >= reps // 2:
            return sum(e.time_range.elapsed_us() for e in ev) / 1e3 / len(ev)
    raise AssertionError(f"the profiler saw {len(ev)} '{name}' kernels in {reps} calls")


def device_total_ms(torch, fn, reps: int) -> tuple[float, float]:
    """Mean device time in ms of everything ``fn`` runs on the card
    (kernels, copies, fills) and its device events per call, from
    torch.profiler over ``reps`` calls."""
    ev = device_events(torch, profiled(torch, fn, reps)[0])
    if not ev:
        raise AssertionError("the profiler saw no device events")
    return sum(e.time_range.elapsed_us() for e in ev) / 1e3 / reps, len(ev) / reps


def device_ops(torch, fn, reps: int, top: int = 8) -> dict:
    """The ``top`` operators of ``fn`` by their own device time, in ms per
    call, from torch.profiler (host and device) over ``reps`` calls."""
    averages = profiled(torch, fn, reps, host=True)[1]
    ops = sorted(((a.key, a.self_device_time_total / 1e3 / reps) for a in averages),
                 key=lambda kv: -kv[1])
    return {k: v for k, v in ops[:top] if v > 0}


def lbs_float64(positions, normals, ji, jw, mats):
    """LBS in float64 from the sparse (V,4) weights, as the reference's
    per-vertex loop (tests/test_skinning.py:naive_lbs) computes it:
    weights as authored, a zero-weight vertex on its first joint, normals
    with w = 0."""
    import numpy as np

    w = np.asarray(jw, np.float64).copy()
    w[w.sum(axis=1) < 1e-4] = (1.0, 0.0, 0.0, 0.0)
    blend = np.einsum("vk,vkab->vab", w, np.asarray(mats, np.float64)[ji])
    pos = np.einsum("vab,vb->va", blend[:, :3, :3], positions) + blend[:, :3, 3]
    return pos, np.einsum("vab,vb->va", blend[:, :3, :3], normals)


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


def check_random_rays(torch, tag, bvh, traverse2, bounds, masked: bool = False):
    """K2 on 2^20 random mixed rays (half of them shadow rays with a finite
    tmax, 95 % live) over run ``tag``'s table, each with a random ray mask
    (1, 2 or 3) if ``masked``; then on the same rays with every lane dead,
    with one live lane, the wavefront's last, and at 2^20 - 1 lanes (the
    compaction's last block partial) the last lane alone and the random
    mask. Hit-equal, t/u/v bit-equal and pop-equal to the plain version,
    or it raises. Returns the random batch's numbers."""
    dev = bvh.table.device
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
    rmask = (torch.randint(1, 4, (n,), generator=g, device=dev, dtype=torch.int32)
             if masked else None)
    args = (table, bvh.n_internal, bvh.n_leaf, bvh.tlas_n, bvh.stack_size, org, dirs, tmax,
            shadow, active)
    name = traverse2.variant(table.shape[0], masked)
    k2, p2 = traverse2.traverse(*args, ray_mask=rmask), traverse2.traverse_plain(*args, ray_mask=rmask)
    bad, err = k2_mismatches(torch, k2, p2)
    ms = cuda_ms(lambda: traverse2.traverse(*args, ray_mask=rmask), 10)
    work = bounds.k2_work(table, bvh.n_internal, bvh.n_leaf, p2.visits, masked=masked)
    bound = bounds.k2(work, n, int(active.sum()), masked=masked)
    log(f"K2 traverse ({name}), {n} random mixed rays over the run {tag} table "
        f"({table.shape[0]} rows){' with random ray masks' if masked else ''}: "
        f"{int((p2.tri >= 0).sum())} hits, {int((p2.found & shadow).sum())} occluded, "
        f"{int(p2.pops.sum())} pops; mismatches {bad}; kernel {ms:.3f} ms, "
        f"bound {bound[0]:.4f} ms ({bound[1]})")
    if any(bad.values()):
        raise AssertionError(f"K2 ({name}) disagrees with its plain version (random mixed rays)")
    last = torch.zeros(n, dtype=torch.bool, device=dev)
    last[-1] = True
    m = n - 1
    last_m = torch.zeros(m, dtype=torch.bool, device=dev)
    last_m[-1] = True
    edges = (("all lanes dead", n, torch.zeros_like(active)), ("one live lane, the last", n, last),
             ("one live lane, the last", m, last_m), ("the random mask", m, active[:m]))
    for what, lanes, act in edges:
        eargs = args[:5] + tuple(x[:lanes] for x in args[5:9]) + (act,)
        erm = None if rmask is None else rmask[:lanes]
        bad, _ = k2_mismatches(torch, traverse2.traverse(*eargs, ray_mask=erm),
                               traverse2.traverse_plain(*eargs, ray_mask=erm))
        log(f"K2 traverse ({name}), {lanes} lanes, {what}: mismatches {bad}")
        if any(bad.values()):
            raise AssertionError(f"K2 ({name}) disagrees with its plain version ({lanes} lanes, {what})")
    return dict(variant=name, max_abs_err=err, ms=ms, bound_ms=bound[0], bound_by=bound[1])


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
              frame_bound_ms=0.0, bound_by={"operations": 0, "bytes": 0}, work={}, variants={})
    first = []

    def checked(*args, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        kout = orig(*args, **kw)
        ev[1].record()
        pout = traverse2.traverse_plain(*args, **kw)
        ev[2].record()
        torch.cuda.synchronize()
        masked = kw.get("ray_mask") is not None
        name = traverse2.variant(args[0].shape[0], masked)
        bad, err = k2_mismatches(torch, kout, pout)
        if any(bad.values()):
            raise AssertionError(f"K2 ({name}) disagrees with its plain version (run {tag}, launch "
                                 f"{k2['launches']}, {kout.t.numel()} rays): {bad}")
        n_live = int(args[9].sum())
        work = bounds.k2_work(args[0], args[1], args[2], pout.visits, masked=masked)
        b_ms, b_by = bounds.k2(work, kout.t.numel(), n_live, masked=masked)
        k2["variants"][name] = k2["variants"].get(name, 0) + 1
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
            first.append((args, kw))
        return kout

    traverse2.traverse = checked
    try:
        r.draw(1 / 60)
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
    cam, cam_kw = first[0]
    masked = cam_kw.get("ray_mask") is not None
    k2["ms"] = cuda_ms(lambda: orig(*cam, **cam_kw), 10)
    k2["plain_ms"] = cuda_ms(lambda: traverse2.traverse_plain(*cam, **cam_kw), 1)
    k2["bound_ms"], k2["bound_by_cam"] = bounds.k2(
        bounds.k2_work(cam[0], cam[1], cam[2], traverse2.traverse_plain(*cam, **cam_kw).visits,
                       masked=masked),
        cam[5].shape[0], int(cam[9].sum()), masked=masked)
    log(f"K2 traverse run {tag} ({k2['variants']}): one frame's {k2['launches']} launches, "
        f"{k2['rays']} live rays, "
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


def make_character(dev):
    """Phase D's scene: one skinned cylinder of 66,049 vertices, 131,072
    triangles and 64 joints with the swing rig (a game character's size;
    the app's robot stand-in has 425 vertices and 4 joints) over a floor,
    at 1024x576 with run C's settings. Returns the renderer and its rig."""
    from mrt_tpu_torch import Model, Renderer, Scene
    from mrt_tpu_torch.assets import procedural
    from mrt_tpu_torch.engine.appscene import _attach_swing_rig
    from mrt_tpu_torch.engine.scene import SkinData
    from mrt_tpu_torch.utils import frame_profile as FP

    t0 = time.perf_counter()
    mesh, ji, jw, rest = procedural.skinned_cylinder(segments_h=256, segments_r=256, n_joints=64)
    character = Model("character", mesh=mesh, position=[-0.5, 0.0, 1.0])
    character.skin = SkinData(joint_indices=ji, joint_weights=jw, rest_joints=rest)
    _attach_swing_rig(character)
    scene = Scene(1024, 576)
    scene.models = [character, Model("plane", scale=10)]
    r = Renderer(scene, 1024, 576, seed=0, device=dev)
    FP.configure(r, motion_adaptive=True)
    log(f"phase D scene compile + BVH build: {time.perf_counter() - t0:.1f} s, "
        f"{mesh.positions.shape[0]} vertices, {r.statics.n_triangles} triangles, "
        f"{rest.shape[0]} joints, table {tuple(r.bvh.table.shape)}")
    return r, dict(scene="skinned cylinder 256x256 segments, 64 joints, swing rig, over a floor",
                   joint_indices=ji, joint_weights=jw)


def check_character(torch, r, rig):
    """LBS on the card against float64 NumPy (positions within 1e-5 of the
    rig's extent, unit normals within 1e-5), and the card's refit against
    the CPU's on the same posed vertices: the skinned BLAS rows and root
    boxes bit-equal, the other rows (instance rows hold a torch.linalg.inv)
    within 1e-6."""
    import numpy as np

    from mrt_tpu_torch.bvh import twolevel
    from mrt_tpu_torch.skinning import lbs

    sb, jm = r._skin_bundle[0], r._joint_matrices[0]
    pos, nrm = lbs.skin(sb.weights_dense, jm, sb.rest_positions, sb.rest_normals)
    rest = sb.rest_positions.cpu().numpy()
    want_p, want_n = lbs_float64(rest, sb.rest_normals.cpu().numpy(), rig["joint_indices"],
                                 rig["joint_weights"], jm.cpu().numpy())
    extent = float((rest.max(axis=0) - rest.min(axis=0)).max())
    err_p = float(np.abs(pos.cpu().numpy() - want_p).max())
    err_n = float(np.abs(nrm.cpu().numpy() - want_n).max())
    moved = float(np.abs(want_p - rest).max())
    log(f"phase D LBS on the card vs float64 NumPy: max abs error {err_p:.3e} in positions "
        f"(limit {1e-5 * extent:.3e} = 1e-5 x the rig's extent {extent:.3f}), {err_n:.3e} in "
        f"normals (limit 1e-5); the pose moves vertices up to {moved:.4f}")
    if not (err_p <= 1e-5 * extent and err_n <= 1e-5 and moved > 0.0):
        raise AssertionError("phase D: LBS on the card disagrees with the float64 reference")

    posed, M = r.scene_data.positions_obj, r.scene_data.instance_transform
    gpu = twolevel.refit(r.bvh, posed, M)
    cpu = twolevel.refit(r.bvh.to("cpu"), posed.cpu(), M.cpu())
    gt, ct = gpu.table.cpu(), cpu.table
    skinned = torch.zeros(gt.shape[0], dtype=torch.bool)
    for int_lo, ni, leaf_lo, nl, *_, slot in r.bvh.mesh_meta:
        if slot >= 0:
            skinned[int_lo:int_lo + ni] = True
            skinned[r.bvh.n_internal + leaf_lo:r.bvh.n_internal + leaf_lo + nl] = True
    bits = (gt.view(torch.int32) != ct.view(torch.int32)).any(dim=1)
    bad_skin = int(bits[skinned].sum())
    bad_roots = int((gpu.root_bmin.cpu().view(torch.int32) != cpu.root_bmin.view(torch.int32)).sum()
                    + (gpu.root_bmax.cpu().view(torch.int32) != cpu.root_bmax.view(torch.int32)).sum())
    close = torch.allclose(gt[~skinned], ct[~skinned], rtol=1e-6, atol=1e-6, equal_nan=True)
    log(f"phase D refit on the card vs the CPU on the same posed vertices: {int(skinned.sum())} "
        f"skinned BLAS rows, {bad_skin} differ in their bits, root boxes {bad_roots}; the other "
        f"{int((~skinned).sum())} rows: {int(bits[~skinned].sum())} differ in their bits, "
        f"within 1e-6: {close}")
    if bad_skin or bad_roots or not close:
        raise AssertionError("phase D: the skinned refit on the card disagrees with the CPU")


def profile_prepare(torch, r, bounds):
    """Device time per animated frame of LBS (each skinned model) and of
    the refit (profiler, warm, 20 calls each) and of the whole prepare
    stage; beside them the CUDA-event time of the same calls (which holds
    the host's launch gaps), the bounds and the refit's whole-table copy."""
    from mrt_tpu_torch.bvh import twolevel
    from mrt_tpu_torch.skinning import lbs

    out = dict(lbs_ms=0.0, lbs_events_ms=0.0, lbs_bound_ms=0.0)
    for k, (_, _, count) in enumerate(r.statics.skin_slices):
        sb, jm = r._skin_bundle[k], r._joint_matrices[k]

        def skin():
            return lbs.skin(sb.weights_dense, jm, sb.rest_positions, sb.rest_normals)

        ms, _ = device_total_ms(torch, skin, 20)
        out["lbs_ms"] += ms
        out["lbs_events_ms"] += cuda_ms(skin, 20)
        b_ms, out["lbs_bound_by"] = bounds.lbs(count, jm.shape[0])
        out["lbs_bound_ms"] += b_ms
    posed, M = r.scene_data.positions_obj, r.scene_data.instance_transform

    def refit():
        return twolevel.refit(r.bvh, posed, M)

    out["refit_ms"], out["refit_device_events"] = device_total_ms(torch, refit, 20)
    out["refit_events_ms"] = cuda_ms(refit, 20)
    out["refit_bound_ms"], out["refit_bound_by"] = bounds.refit(r.bvh)
    out["prepare_ms"], out["prepare_device_events"] = device_total_ms(torch, r.prepare, 5)
    return out


E_MODES = ("spatial", "temporal", "denoised")


def bits_equal(torch, a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def rel_rmse(a, b) -> float:
    from mrt_tpu_torch.utils.image import relative_rmse

    return relative_rmse(a.cpu().numpy(), b.cpu().numpy())


def history_free(r, presenter):
    """The renderer's present with no history (as right after a reset), on
    its current buffers; the renderer's own state is left as it was."""
    saved = (r._upscale_history, r._denoise_state)
    r._clear_presenter_history()
    try:
        return presenter.present_linear(r)
    finally:
        object.__setattr__(r, "_upscale_history", saved[0])
        object.__setattr__(r, "_denoise_state", saved[1])


def check_variants(tag, traverse2, want: str):
    """Only K2's ``want`` instantiation launched since the counts were last
    set to 0 (runs A-E: the packed one; F: masked; G: float sort)."""
    rose = {k: n for k, n in traverse2.variant_launches.items() if n}
    if set(rose) != {want}:
        raise AssertionError(f"run {tag}: K2 launched {rose}, expected only its {want} variant")
    return rose


def drive_e(torch, r, mode, present, traverse2, presenter, timed=3):
    """Run E in one presenter mode, with the launch counters set to 0 first:
    a warm-up frame, ``timed`` orbit frames (orbit(0.02, 0), draw(1/30),
    present_device, as the reference's interactive drive) and ``timed``
    still frames (draw(1/60), present_device), each frame's wall between
    syncs. After each frame (untimed, launching neither kernel) the
    history lifecycle: in the stateful modes an orbit frame's new state is
    bit-equal to a history-free present's, a still frame's output differs
    from it. Returns (launch counts, the mode's line)."""
    r.upscaler_mode = mode
    present.launches = 0
    traverse2.reset_launches()
    r.orbit(0.02, 0.0)
    r.draw(1 / 30)
    r.present_device()  # warm-up
    torch.cuda.synchronize()
    walls, rays, history_used = [], 0, []
    for i in range(2 * timed):
        orbit = i < timed
        t0 = time.perf_counter()
        if orbit:
            r.orbit(0.02, 0.0)
            r.draw(1 / 30)
        else:
            r.draw(1 / 60)
        img = r.present_device()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        rays += int(r.last_rays_traced)
        if mode == "spatial":
            continue
        lin_f, hist_f, d_f = history_free(r, presenter)
        same = bits_equal(torch, r._upscale_history, hist_f)
        if mode == "denoised":
            same = same and all(bits_equal(torch, a, b) for a, b in zip(r._denoise_state, d_f))
        history_used.append(not same)
        if same != orbit:
            kind, how = ("orbit", "differs from") if orbit else ("still", "equals")
            raise AssertionError(f"run E {mode}, frame {i} ({kind}): the present {how} a "
                                 "history-free one")
    counts = {"present": present.launches, "traverse2": traverse2.launches}
    if min(counts.values()) < 1:
        raise AssertionError(f"run E {mode}: a kernel of the path never launched: {counts}")
    variants = check_variants(f"E {mode}", traverse2, "packed")
    acc = r.accum
    if not bool(torch.isfinite(acc).all()) or float(acc.max()) <= 0.0:
        raise AssertionError(f"run E {mode}: accumulation is not finite or is all black")
    if img.shape != (r.output_height, r.output_width, 3) or img.dtype != torch.uint8:
        raise AssertionError(f"run E {mode}: image {tuple(img.shape)} {img.dtype}")
    line = dict(run="E", mode=mode, output=[r.output_width, r.output_height],
                resolution=[r.render_width, r.render_height], spp=r.samples_per_pixel,
                bounces=r.max_bounces, upscaler=r.upscaler_mode,
                motion_adaptive=r.use_motion_adaptive_sampling, frames=2 * timed,
                frame_walls_orbit=walls[:timed], frame_walls_still=walls[timed:],
                total_rays=rays, seconds=sum(walls), mrays_per_s=rays / sum(walls) / 1e6,
                launches=counts, k2_variants=variants, history_used=history_used,
                accum_mean=float(acc.mean()),
                image_mean=float(img.float().mean()))
    if mode == "denoised":
        gb = r.gbuffer
        if gb is None or not all(bool(torch.isfinite(v).all()) for v in gb.values()):
            raise AssertionError("run E denoised: no finite G-buffer")
        line["history_length_max"] = float(r._denoise_state.history_length.max())
        if line["history_length_max"] <= 1.0:
            raise AssertionError("run E denoised: the denoiser built no history")
    return counts, line


def check_e_mode(torch, r, present, presenter, T):
    """The renderer's present (its current buffers and state) on the card
    against the same on the CPU: linear output, new history and
    DenoiseState within 1e-5 relative RMSE, uint8 within 1 LSB; and K1
    uint8-equal to its plain version on the card's linear output. Returns
    (numbers, the card's linear output)."""
    from types import SimpleNamespace

    lin_g, hist_g, d_g = presenter.present_linear(r)
    cpu = SimpleNamespace(
        upscaler_mode=r.upscaler_mode, output_height=r.output_height, output_width=r.output_width,
        accumulation_weight=r.accumulation_weight, accum=r.accum.cpu(), depth=r.depth.cpu(),
        motion=r.motion.cpu(),
        gbuffer=None if r.gbuffer is None else {k: v.cpu() for k, v in r.gbuffer.items()},
        _upscale_history=None if r._upscale_history is None else r._upscale_history.cpu(),
        _denoise_state=None if r._denoise_state is None else T.to_device(r._denoise_state, "cpu"))
    t0 = time.perf_counter()
    lin_c, hist_c, d_c = presenter.present_linear(cpu)
    cpu_s = time.perf_counter() - t0
    x = lin_g.contiguous()
    k1 = present.tonemap_quantize(x)
    k1_bad = int((k1 != present.tonemap_quantize_plain(x)).sum())
    lsb = int((k1.cpu().int() - present.tonemap_quantize_plain(lin_c).int()).abs().max())
    errs = dict(linear=rel_rmse(lin_g, lin_c))
    if hist_g is not None:
        errs["history"] = rel_rmse(hist_g, hist_c)
    if d_g is not None:
        errs.update({f"denoise_{f}": rel_rmse(a, b) for f, a, b in zip(d_g._fields, d_g, d_c)})
    out = dict(card_vs_cpu_rel_rmse=errs, card_vs_cpu_lsb=lsb, cpu_present_s=cpu_s,
               k1_shape=list(x.shape), k1_mismatches=k1_bad)
    if k1_bad:
        raise AssertionError(f"run E {r.upscaler_mode}: K1 disagrees with its plain version")
    if lsb > 1 or max(errs.values()) > 1e-5:
        raise AssertionError(f"run E {r.upscaler_mode}: the card's present disagrees with the "
                             f"CPU's: {out}")
    return out, x


def profile_e(torch, FP, r, present, bounds, x4k, walls):
    """Run E under the profiler, after every run's timed frames: per mode,
    one more frame, one frame (draw and present) profiled as runs A-C are
    (its idle share against the median of the mode's still frame walls,
    ``walls``), then the present's device time and events (5 calls) and
    its costliest operators; on the denoised buffers each resize product's
    and the denoiser's device time beside its bound; K1 at the output
    shape, warm and after a 64 MB write (cold), beside its CUDA-event and
    plain times."""
    from mrt_tpu_torch.upscale import denoise, spatial

    h, w, oh, ow = r.render_height, r.render_width, r.output_height, r.output_width
    out = {}
    for mode in E_MODES:
        r.upscaler_mode = mode
        r.draw(1 / 60)
        r.present_device()
        out[f"frame_{mode}"] = FP.profile_frame(r, walls=walls[mode])
        ms, ev = device_total_ms(torch, r.present_device, 5)
        out[f"present_{mode}"] = dict(ms=ms, device_events=ev,
                                      top_ops_ms=device_ops(torch, r.present_device, 3))
    six = torch.cat([r.accum, r.depth[..., None], r.motion], dim=-1)
    dstate, gb = r._denoise_state, r.gbuffer
    for name, fn, reps, bound in (
            ("resize_lanczos3_3ch", lambda: spatial.resize(r.accum, oh, ow, "lanczos3"), 5,
             bounds.resize(h, w, oh, ow, 3)),
            ("resize_bilinear_6ch", lambda: spatial.resize(six, oh, ow, "bilinear"), 5,
             bounds.resize(h, w, oh, ow, 6)),
            ("denoiser", lambda: denoise.svgf_filter(r.accum, gb, r.depth, r.motion, dstate), 3,
             bounds.denoiser(h, w))):
        ms, ev = device_total_ms(torch, fn, reps)
        out[name] = dict(ms=ms, device_events=ev, bound_ms=bound[0], bound_by=bound[1])
    out["present_bounds_ms"] = dict(spatial=bounds.resize(h, w, oh, ow, 3)[0],
                                    temporal=bounds.temporal_chain(h, w, oh, ow)[0],
                                    denoised=bounds.denoised_chain(h, w, oh, ow)[0])
    scratch = torch.empty(16 << 20, dtype=torch.float32, device=r.device)  # 64 MB > the 50 MB L2
    k1 = dict(ms_warm=device_ms(torch, lambda: present.tonemap_quantize(x4k), "present_kernel", 20),
              ms_cold=device_ms(torch, lambda: present.tonemap_quantize(x4k), "present_kernel", 20,
                                flush=lambda: scratch.fill_(1.0)),
              ms_events=cuda_ms(lambda: present.tonemap_quantize(x4k), 50),
              plain_ms=cuda_ms(lambda: present.tonemap_quantize_plain(x4k), 20))
    k1["bound_ms"], k1["bound_by"] = bounds.k1(tuple(x4k.shape))
    del scratch
    return out, k1


def small_frames(device) -> dict:
    """Phase 7's 48x48 sphere and plane, two frames in each presenter mode
    (off at 48x48, the others from a 0.67-scale 32x32 render): per mode the
    accumulation, rays, presented linear output and G-buffer, on the CPU."""
    from mrt_tpu_torch import UPSCALER_OFF, Model, Renderer, Scene
    from mrt_tpu_torch.upscale import presenter
    from mrt_tpu_torch.utils import frame_profile as FP

    s = Scene(48, 48)
    s.models = [Model("sphere", position=[0, 0.5, 0], scale=0.5), Model("plane", scale=10)]
    r = Renderer(s, 48, 48, seed=3, device=device)
    FP.configure(r)
    r.max_bounces = 3
    out = {}
    for mode in (UPSCALER_OFF,) + E_MODES:
        r.upscaler_mode = mode
        r.render_scale = 1.0 if mode == UPSCALER_OFF else 0.67
        for _ in range(2):
            r.draw()
            lin = presenter.present_linear(r)[0]
            r.present_device()
        gb = None if r.gbuffer is None else {k: v.cpu() for k, v in r.gbuffer.items()}
        out[mode] = (r.accum.cpu(), int(r.last_rays_traced), lin.cpu(), gb)
    return out


def check_small_frames(dev):
    """Phase 7: the small frames on the card against the CPU plain path: the
    accumulation and the presented linear output within 1e-2 relative RMSE,
    rays within 1 %, the G-buffer within 1e-5 on at least 99.9 % of pixels."""
    small_g, small_c = small_frames(dev), small_frames("cpu")
    for mode, (acc_g, rays_g, lin_g, gb_g) in small_g.items():
        acc_c, rays_c, lin_c, gb_c = small_c[mode]
        rel, rel_lin = rel_rmse(acc_g, acc_c), rel_rmse(lin_g, lin_c)
        msg = (f"small frame 48x48, {mode}: card vs CPU relative RMSE {rel:.3e} in the "
               f"accumulation, {rel_lin:.3e} in the presented linear output (limit 1e-2), "
               f"rays {rays_g} vs {rays_c}")
        bad = (not (rel < 1e-2 and rel_lin < 1e-2) or rays_g <= 0
               or abs(rays_g - rays_c) > 0.01 * rays_c)
        if gb_g is not None:
            close = {k: float(((gb_g[k] - gb_c[k]).abs() <= 1e-5).reshape(*gb_g[k].shape[:2], -1)
                              .all(dim=-1).float().mean()) for k in gb_g}
            msg += f"; G-buffer pixels within 1e-5 (limit 0.999): {close}"
            bad = bad or min(close.values()) < 0.999
        log(msg)
        if bad:
            raise AssertionError(f"the card's frame disagrees with the CPU reference ({mode})")


def small_extras(device) -> dict:
    """Phase 8's textured 48x48 scene: a sphere masked as light geometry
    over a floor with a 64x64 checker and a 32x32 normal map made from a
    seed. Two frames with the extras off (the light mask only), two with
    mipmaps on, then one frame of each debug view 1-7 (for the motion view
    the sphere moves after a first frame). Per case the accumulation and
    rays, on the CPU."""
    from mrt_tpu_torch import Model, Renderer, Scene
    from mrt_tpu_torch.assets import procedural
    from mrt_tpu_torch.assets.obj import MaterialDef
    from mrt_tpu_torch.core import types as T
    from mrt_tpu_torch.utils import frame_profile as FP

    checker, nmap = FP.floor_maps(seed=5, base=64, normal=32)
    floor = procedural.plane(material=MaterialDef(name="floor", map_base_color=checker,
                                                  map_normal=nmap))
    s = Scene(48, 48)
    s.models = [Model("sphere", position=[0, 0.6, 0], scale=0.4, geometry_mask=T.GEOMETRY_MASK_LIGHT),
                Model("floor", mesh=floor, scale=6)]
    r = Renderer(s, 48, 48, seed=3, device=device)
    FP.configure(r)
    r.max_bounces = 3
    out = {}

    def frames(name, n):
        for _ in range(n):
            r.draw()
        out[name] = (r.accum.cpu(), int(r.last_rays_traced))

    frames("light_masked", 2)
    r.use_mipmaps = True
    frames("mipmaps", 2)
    r.use_mipmaps = False
    for mode in range(T.DEBUG_MODE_BASECOLOR, T.DEBUG_MODE_MOTION + 1):
        r.debug_texture_mode = mode
        if mode == T.DEBUG_MODE_MOTION:
            r.draw()
            r.scene.move_model(0, right=0.1)
        frames(f"debug_{mode}", 1)
    return out


def check_small_extras(dev):
    """Phase 8's extras: the textured frames on the card against the CPU
    plain path, the accumulation within 1e-2 relative RMSE and rays within
    1 %."""
    small_g, small_c = small_extras(dev), small_extras("cpu")
    for case, (acc_g, rays_g) in small_g.items():
        acc_c, rays_c = small_c[case]
        rel = rel_rmse(acc_g, acc_c)
        log(f"small frame 48x48, {case}: card vs CPU relative RMSE {rel:.3e} in the accumulation "
            f"(limit 1e-2), rays {rays_g} vs {rays_c}")
        if not (rel < 1e-2 and rays_g > 0 and abs(rays_g - rays_c) <= 0.01 * rays_c):
            raise AssertionError(f"the card's frame disagrees with the CPU reference ({case})")


def drive_debug(torch, tag, r, mode, present, traverse2, variant, frames=1):
    """``frames`` frames of debug view ``mode`` on run ``tag``'s renderer
    with the launch counters set to 0 first (the last frame's wall between
    syncs): the accumulation finite and, but for the metallic and emission
    views, not all black, K1 and only K2's
    ``variant`` launched; then the beauty view again. Returns its line."""
    from mrt_tpu_torch.core import types as T

    r.debug_texture_mode = mode
    present.launches = 0
    traverse2.reset_launches()
    for _ in range(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.draw(1 / 60)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    img = r.output_image()
    acc = r.accum
    counts = {"present": present.launches, "traverse2": traverse2.launches}
    line = dict(run=tag, debug_mode=mode, frames=frames, frame_wall=wall,
                rays=int(r.last_rays_traced), launches=counts,
                k2_variants=check_variants(f"{tag} debug {mode}", traverse2, variant),
                accum_mean=[float(x) for x in acc.mean(dim=(0, 1))],
                accum_max=[float(x) for x in acc.amax(dim=(0, 1))], image_mean=float(img.mean()))
    # the metallic and emission views are black where no material is
    # metallic or emissive (runs A-C's scene)
    black_ok = mode in (T.DEBUG_MODE_METALLIC, T.DEBUG_MODE_EMISSION)
    if (not bool(torch.isfinite(acc).all()) or (float(acc.max()) <= 0.0 and not black_ok)
            or min(counts.values()) < 1):
        raise AssertionError(f"run {tag}, debug view {mode}: {line}")
    r.debug_texture_mode = 0
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

    from mrt_tpu_torch.core import halton as H
    from mrt_tpu_torch.core import types as T
    from mrt_tpu_torch.kernels import build, present, traverse2
    from mrt_tpu_torch.upscale import presenter
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
    rand = {"A": check_random_rays(torch, "A", ra.bvh, traverse2, bounds)}
    # the float-sort instantiation on the same rays over run A's table padded
    # past 2^20 - 1 rows (rows past its end are never visited): the time the
    # float child sort adds to the same work
    padded = torch.zeros((2 ** 20 + 1, ra.bvh.table.shape[1]), dtype=torch.float32, device=dev)
    padded[: ra.bvh.table.shape[0]] = ra.bvh.table
    rand["A padded"] = check_random_rays(torch, "A (padded past 2^20 rows)",
                                         dataclasses.replace(ra.bvh, table=padded), traverse2, bounds)
    del padded

    # --- 4. main path: each run's kernels checked at its shapes, then driven ---------------
    def drive(tag, r, timed, scene_name, variant="packed"):
        """Warm-up + ``timed`` frames with the launch counters set to 0
        first; per timed frame (after its wall) the largest motion vector and
        the pixels by extra samples earned. Only K2's ``variant`` may
        launch."""
        present.launches = 0
        traverse2.reset_launches()
        r.draw(1 / 60)  # warm-up
        torch.cuda.synchronize()
        rays, walls, motion, extras = 0, [], [], []
        for _ in range(timed):
            t0 = time.perf_counter()
            r.draw(1 / 60)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            rays += int(r.last_rays_traced)
            motion.append(float(torch.linalg.vector_norm(r.motion, dim=-1).max()))
            extras.append(torch.bincount((r.last_samples - r.samples_per_pixel).flatten(),
                                         minlength=3).tolist())
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
        variants = check_variants(tag, traverse2, variant)
        line = dict(run=tag, scene=scene_name, resolution=[w, h], spp=r.samples_per_pixel,
                    bounces=r.max_bounces, upscaler=r.upscaler_mode,
                    motion_adaptive=r.use_motion_adaptive_sampling,
                    triangles=r.statics.n_triangles, table_bytes=r.bvh.table.numel() * 4,
                    frames=timed, total_rays=rays, seconds=seconds, frame_walls=walls,
                    mrays_per_s=rays / seconds / 1e6, launches=counts, k2_variants=variants,
                    mipmaps=r.use_mipmaps, has_masks=r.bvh.has_masks,
                    max_motion_px=motion, pixels_by_extra_samples=extras,
                    accum_mean=float(acc.mean()), image_mean=float(img.mean()),
                    card=card_name, power_limit=power_limit)
        log(json.dumps(line))
        return counts, walls, line

    def profile(tag, r):
        line = profile_run(torch, FP, tag, r, present, bounds, checks[tag], walls[tag])
        log(json.dumps(dict(run=tag, profile=line, card=card_name, power_limit=power_limit)))
        return line

    checks, counts, walls, lines, clone_ms = {}, {}, {}, {}, {}

    def run(tag, r, timed, variant="packed"):
        checks[tag] = check_path_kernels(torch, tag, r, present, traverse2, bounds)
        counts[tag], walls[tag], lines[tag] = drive(tag, r, timed, FP.RUNS[tag]["scene"], variant)
        # refit keeps its input table: it copies the whole table every call
        clone_ms[tag] = cuda_ms(lambda: r.bvh.table.clone(), 20)

    run("A", ra, 3)
    torch.cuda.empty_cache()
    rb = make("B")
    run("B", rb, 2)
    rc = make("C")
    run("C", rc, 3)
    prep = []
    for _ in range(6):
        t0 = time.perf_counter()
        rc.prepare()
        torch.cuda.synchronize()
        prep.append(time.perf_counter() - t0)
    prep = prep[1:]  # the first is a warm-up
    c = lines["C"]
    n_pix = rc.render_width * rc.render_height
    shares = [[n / n_pix for n in e[1:]] for e in c["pixels_by_extra_samples"]]
    log(json.dumps(dict(run="C", mrays_per_s=c["mrays_per_s"], prepare_s=prep,
                        prepare_s_median=sorted(prep)[len(prep) // 2],
                        share_1_extra=[x[0] for x in shares], share_2_extra=[x[1] for x in shares],
                        max_motion_px=max(c["max_motion_px"]), table_clone_ms=clone_ms,
                        card=card_name, power_limit=power_limit)))
    if max(c["max_motion_px"]) <= 0.5:
        raise AssertionError(f"run C: the robot moved at most {max(c['max_motion_px'])} px a frame")

    # --- 5. phase D: skinning and refit at character scale ----------------------------------
    rd, dparts = make_character(dev)
    counts["D"], _, lines["D"] = drive("D", rd, 1, dparts["scene"])
    clone_ms["D"] = cuda_ms(lambda: rd.bvh.table.clone(), 20)
    check_character(torch, rd, dparts)

    # --- 6. run E: the presenter chain, a 1080p render presented at 4K -----------------------
    re_ = make("E")
    e_lines, e_checks = {}, {}
    counts["E"] = {"present": 0, "traverse2": 0}
    for mode in E_MODES:
        c, e_lines[mode] = drive_e(torch, re_, mode, present, traverse2, presenter)
        counts["E"] = {k: n + c[k] for k, n in counts["E"].items()}
        e_checks[mode], x4k = check_e_mode(torch, re_, present, presenter, T)
        e_lines[mode].update(e_checks[mode], card=card_name, power_limit=power_limit)
        log(json.dumps(e_lines[mode]))

    # --- 6b. runs F and G: the masked and the float-sort K2 on the main path ----------------
    from mrt_tpu_torch.assets import texture as tex

    rf = make("F")
    atlas, floor_res = rf.scene_data.atlas, None
    for res in range(atlas.has_map.shape[0]):
        w, h = (int(x) for x in atlas.rects[res, tex.MAP_BASECOLOR, 2:4])
        wn, hn = (int(x) for x in atlas.rects[res, tex.MAP_NORMAL, 2:4])
        if bool(atlas.has_map[res, tex.MAP_BASECOLOR]) and bool(atlas.has_map[res, tex.MAP_NORMAL]):
            floor_res = dict(resource=res, base_color=[w, h], normal=[wn, hn],
                             levels=atlas.n_levels[res].tolist())
    log(f"run F atlas: {tuple(atlas.texels.shape)} texels, floor maps {floor_res}; "
        f"BVH has_masks {rf.bvh.has_masks}, mipmaps {rf.use_mipmaps}")
    if (floor_res is None or floor_res["base_color"] != [2048, 2048]
            or floor_res["normal"] != [1024, 1024] or not rf.bvh.has_masks or not rf.use_mipmaps):
        raise AssertionError("run F: the floor's maps, the light masks or mipmaps are missing")
    rand["F"] = check_random_rays(torch, "F", rf.bvh, traverse2, bounds, masked=True)
    run("F", rf, 3, variant="masked")
    debug_lines = [drive_debug(torch, "F", rf, mode, present, traverse2, "masked")
                   for mode in range(T.DEBUG_MODE_BASECOLOR, T.DEBUG_MODE_EMISSION + 1)]
    debug_lines.append(drive_debug(torch, "C", rc, T.DEBUG_MODE_MOTION, present, traverse2,
                                   "packed", frames=2))
    for line in debug_lines:
        log(json.dumps(dict(line, card=card_name, power_limit=power_limit)))
    if debug_lines[-1]["accum_max"][2] <= 0.0:
        raise AssertionError("run C, motion view: no motion shown (blue, the magnitude, is 0)")
    torch.cuda.empty_cache()

    rg = make("G")
    if rg.bvh.table.shape[0] <= 2 ** 20 - 1:
        raise AssertionError(f"run G: the table has {rg.bvh.table.shape[0]} rows, not more than "
                             "2^20 - 1")
    log(f"run G table: {rg.bvh.table.shape[0]} rows (> 2^20 - 1 = {2 ** 20 - 1}), "
        f"{rg.bvh.table.numel() * 4 / 1e9:.3f} GB")
    rand["G"] = check_random_rays(torch, "G", rg.bvh, traverse2, bounds)
    if rand["G"]["variant"] != "float_sort":
        raise AssertionError(f"run G: K2 took its {rand['G']['variant']} variant")
    run("G", rg, 2, variant="float_sort")

    # --- 7. the profiler last: a process's frames after a profiler session ran
    # slower on the host in this script's runs (PERF.md, Findings)
    profiles = {tag: profile(tag, r) for tag, r in (("A", ra), ("B", rb), ("C", rc), ("F", rf),
                                                    ("G", rg))}
    # where run F's extra device time goes: its costliest operators beside run A's
    log(json.dumps(dict(top_ops_ms={tag: device_ops(torch, lambda r=r: r.draw(1 / 60), 1, top=12)
                                    for tag, r in (("A", ra), ("F", rf))},
                        card=card_name, power_limit=power_limit)))
    for tag, r in (("C", rc), ("D", rd)):
        log(json.dumps(dict(prepare=tag, **profile_prepare(torch, r, bounds),
                            table_clone_ms=clone_ms[tag], card=card_name,
                            power_limit=power_limit)))
    e_profile, e_k1 = profile_e(torch, FP, re_, present, bounds, x4k,
                                {m: e_lines[m]["frame_walls_still"] for m in E_MODES})
    log(json.dumps(dict(run="E", profile=e_profile, k1=e_k1, card=card_name,
                        power_limit=power_limit)))
    del ra, rb, rc, rd, re_, rf, rg, x4k

    # --- 8. a small frame on the card against the CPU plain path -------------------------------
    check_small_frames(dev)
    check_small_extras(dev)

    # launches: every run's main-path counts. K1: ms is its profiler device
    # time after a 64 MB write (as a frame leaves the L2) at run A's shape.
    # K2: ms, plain_ms and bound_ms are for run A's camera rays; per run, the
    # warm profiler time of one frame, the cold CUDA-event time of the
    # checked frame, its bound, its work by row type and the instantiation
    # that ran; per instantiation, its main-path launches and its phase-3
    # check on random rays.
    variant_counts = {t: lines[t]["k2_variants"] for t in lines}
    variant_counts["E"] = {"packed": sum(e_lines[m]["k2_variants"]["packed"] for m in E_MODES)}
    a = checks["A"]
    kernels = [
        dict(name="K1 present tonemap_quantize", route="cuda",
             source="mrt_tpu_torch/csrc/present.cu", replaces="mrt_tpu/kernels/present.py:52",
             launches=sum(c["present"] for c in counts.values()),
             launches_by_run={t: counts[t]["present"] for t in counts},
             max_abs_err=max(c["k1_err"] for c in checks.values()), ms=a["k1_cold"],
             plain_ms=a["k1_plain_ms"], bound_ms=a["k1_bound_ms"], bound_by=a["k1_bound_by"],
             library_ms=None,
             by_run=dict({t: dict(ms_cold=c["k1_cold"], ms_warm=c["k1_warm"], ms_events=c["k1_ms"],
                                  plain_ms=c["k1_plain_ms"], bound_ms=c["k1_bound_ms"])
                          for t, c in checks.items()},
                         E=dict(shape=e_checks["denoised"]["k1_shape"], **e_k1))),
        dict(name="K2 two-level traversal", route="cuda",
             source="mrt_tpu_torch/csrc/traverse2.cu", replaces="mrt_tpu/bvh/twolevel.py:593",
             launches=sum(c["traverse2"] for c in counts.values()),
             launches_by_run={t: counts[t]["traverse2"] for t in counts},
             max_abs_err=max([x["max_abs_err"] for x in rand.values()]
                             + [c["k2"]["max_abs_err"] for c in checks.values()]),
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
                             device_busy_s=profiles[t]["device_busy_s"],
                             variants=lines[t]["k2_variants"])
                     for t, c in checks.items()},
             variants={name: dict(
                 launches=sum(v.get(name, 0) for v in variant_counts.values()),
                 launches_by_run={t: v[name] for t, v in variant_counts.items() if name in v},
                 random_rays=[dict(x, run=t) for t, x in rand.items() if x["variant"] == name])
                 for name in ("packed", "masked", "float_sort")}),
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
