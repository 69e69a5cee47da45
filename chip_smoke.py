#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mrt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
never prints its last line):
  1. device: requires CUDA; prints the card's name and power limit and
     turns TF32 off;
  2. build: compiles the CUDA kernels from mrt_tpu_torch/csrc and counts
     the instructions of one K10 tap in the built library's SASS;
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
     is built (6b). Then K3, the flat traversal, on the same rays: its flat
     instantiation over run A's flat table (made by the user's switch,
     two_level = False) and its float-sort one over that table padded past
     2^20 - 1 rows; then both on the tie scene (utils/tie_scene.py: 2^16
     rays aimed at shared vertices and edges of duplicated and
     edge-sharing triangles, so that slots and children tie on t), its
     flat table and that table padded past 2^20 - 1 rows;
  3c. the wavefront's stages K6-K8 (mrt_tpu_torch/csrc/wavefront.cu)
     against their plain versions on the card: their Halton device function
     (csrc/halton.cuh, through the test entry mrt_halton) bit-equal to the
     CPU's halton_base over check_halton's sweep at 24 and 11 digits; then
     every K6, K7 and K8 launch of one frame of run A held against its plain
     version on the card on the same (cloned) lane state and Wave right
     after it ran, every output field compared in its bits: K7, the listed
     step, against resolve_shadow_plain then shade_hit_plain on the
     traversal's raw record made Hits (every state field and the shadow
     mask on every lane, the shadow rays where both cast one, the live
     count, and its lane list against the plain one: the lanes live or
     holding a shadow ray, none twice), the trailing K8 (once per sample)
     against resolve_shadow_plain: the target is bit-equality, a float
     field that is not bit-equal must stay within STAGE_REL_TOL relative
     (its largest ULP printed), an integer or bool field equal on
     STAGE_INT_SHARE of lanes, a list exactly. K7's first launch is also
     held on the same state with every material glass (the glass-heavy
     state). Then a frame each with power light sampling, with legacy
     shading and with mipmaps (K7's maps_mips instantiation on a scene
     without maps: the ray cone's length only), each stage's time (CUDA
     events) beside its plain version's
     and its bound: K6 and K7 at the frame's first launch, K7 also at its
     first launch with under 5 % of the lanes live, K8 at a sample's end;
     and one whole frame of the kernel route against the plain route
     (trace_frame(..., plain=True)) on the card: bit-equal, or the
     accumulation within 1e-3 relative RMSE and the rays within 1e-4. The
     same for a 512x512 scene with all four light types and an environment
     map made from a seed (lights_env_renderer), uniform and power
     sampled, which the app scene leaves unexercised. Every
     later run on the kernel route (B, C, E denoised for the G-buffer, G,
     H, J, K, G flat) is checked the same way before it is driven, and
     every run's line names its route;
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
     each kernel's launch counter set to 0 and checked to rise (K6-K8's
     on the kernel route; off it they must stay 0). Run C also
     prints the seconds of its prepare stage (skinning, world transform,
     refit) per animated frame, the share of pixels that earned 1 and 2
     extra samples, and its largest motion vector (> 0.5 px: the robot
     moves), and its refit is checked as phase D's (below); the whole-table
     copy of each run's refit is timed. Runs C, E, H launch K4 ``blas``
     with K5 in its last block (one launch, both counted) every animated
     frame, run J K4 ``flat``; their counts are set to 0 and read with the
     others;
  5. phase D, skinning and refit at character scale: one skinned cylinder
     of 66,049 vertices, 131,072 triangles and 64 joints with the swing rig
     over a floor at 1024x576 with run C's settings, 2 frames driven.
     Checks: the card's LBS against a float64 NumPy LBS within 1e-5 of the
     rig's extent; the card's refit (one launch of K4 ``blas`` with K5)
     bit-equal to the plain refit on the card in the whole table and the
     root boxes, and K5's work alone (the same BVH with every group static:
     one block) bit-equal to its plain version; per refit its device events
     by name (the table's copy and the launch, at most 3; any other event,
     a library 3x3 inverse among them, raises), their device ms and the
     CUDA-event ms, the launch's device ms beside its bound, K5's one-block
     launch beside its own, the plain versions' times and K4's registers
     and spills printed; and to the CPU's on the same posed vertices in the
     skinned BLAS rows, the other rows within 1e-6; then one refit with a
     NaN in a real slot of the posed vertices, bit-equal to the plain
     version on the card with the NaN in the root box and the rows above
     it;
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
     the main path's present_device on the same buffers and state
     byte-equal to K1 on the card's linear output, within 1 LSB of the
     CPU's, and the state it hands over bit-equal to the linear chain's;
     each present launches K12's uint8 form once in the spatial mode; K12
     and K11's uint8 form once each in the temporal mode; K9 once, K10
     three times, K12 and K11's uint8 form once each in the denoised mode;
     and no standalone K1 in any mode (the kernel that ends the chain
     tonemaps);
  3p. the presenter kernels (mrt_tpu_torch/csrc/presenter.cu) against their
     plain versions on the card, after run E's denoised mode: on run E's
     last buffers and state, K9 svgf_reproject, K10 atrous_pass at steps 1,
     2 and 4 (the last remodulating; each fed the plain version's previous
     outputs), K12 resize in both forms on the path (Lanczos-3 of the
     colour with the clamp; bilinear of colour, depth and motion as three
     sources, on both chains) and K11 temporal_resolve on both chains'
     resized inputs, each output field compared in its bits, and K12 also
     against the dense torch.mm products over the same weights (within
     RESIZE_DENSE_TOL of the largest value), and K12 at a 64x downscale
     (a tile's inputs staged in chunks); then the same on a synthetic
     1920x1080 frame made from a seed (motion leaving the image, a depth
     jump, zero albedo, history lengths up to 32, K11 at history weights
     0.0 and 0.9 at 3840x2160) and on a synthetic 963x541 frame (no
     multiple of K10's 32x8 and K12's 256x16 tiles: partial tiles, the
     clamped halo, output rows not 16-byte aligned); the whole denoised
     chain through the kernels against the plain chain, and K1's bytes on
     all; the uint8 forms (K12's Lanczos-3 of the colour with the clamp, in
     its strip form and, at a 64x downscale, its tiles; K11's on both
     chains at each weight) byte-equal to K1 on the same f32 kernel's
     output and to tonemap_quantize_plain of the plain version, K11's new
     history bit-equal to its f32 form's. A float field that is not
     bit-equal is
     printed; beyond PRESENTER_REL_TOL relative RMSE it fails the run, as
     does any K1 byte that differs. Each kernel's CUDA-event ms over 5
     calls beside its plain version's and its bound (K10 also beside its
     bound with a tap counted from its SASS, printed after the build; K12
     also beside the dense products' ms and, for the bilinear,
     torch.nn.functional.interpolate's);
  6b. runs F, N and G, each checked and driven as runs A-C are, with each
     K2 instantiation's launch count read on its own: run F, the
     wavefront's extras at run A's width (the floor with a 2048x2048
     base-colour checker and a 1024x1024 normal map made from a seed,
     mipmapped sampling, the two spheres masked as light geometry),
     launches only the masked K2 and only K7's textured, mipmapped
     instantiation (maps_mips); run N, run F at the Renderer's default
     use_mipmaps=False, only the masked K2 and K7's packed-atlas
     instantiation (maps). At F and N every K7 launch of one frame is held
     field by field to its plain version (phase 3c), the kernel route's
     frame bit-equal to the plain route's, and K6-K8 timed at their first
     launches. Then one frame of each debug view 1-6 on run F's scene, of
     the base colour view on run N's and of the motion view (7) on run C's
     (K7's maps_mips_debug, maps_debug and debug instantiations), each
     first held launch by launch and frame by frame, bit-equal, to the
     plain stages, and driven with K6 and its K7 instantiation launched and
     K8 not (a debug view casts no shadow ray); run G, run B's scene with two
     distinct blob(subdivisions=9) dragons (a table above 2^20 rows; its
     host build seconds printed), launches only the float-sort K2; its
     build's refit of every group (K4 ``blas``, K5) is counted and checked
     bit-equal to the plain version on the card, and equal to the built
     table. Runs A-E launch only the packed one;
  6c. run H, a rigged character read from disk, and phase I, a checkpoint
     on the card. Phase D's character (66,049 vertices, 64 joints, the swing
     clip) is written in centimetres, with the port's own writers, as a USDZ
     holding a crate (robot.usdz), a USDZ holding USDA text and a GLB into a
     temporary directory; each file is loaded through the port's loaders
     (seconds printed) and checked against the rig: indices, joint indices
     and weights bit-equal, positions within 1e-6 after the unit change,
     joint matrices within 1e-5 at t = 0, 0.37 and the clip's duration.
     Then run C's frame with MRT_ASSET_PATH naming that directory, so the
     app scene's robot resolves from robot.usdz at the reference's 0.01
     scale: checked and driven as runs A-C are (packed K2 only), its
     prepare seconds, LBS against float64 and the refit against the CPU as
     in phase D, and a 48x48 frame of the same scene on the card against
     the CPU (1e-2 relative RMSE, rays equal). Phase I: run H's renderer
     draws 4 frames and is saved (engine/checkpoint.py); a fresh renderer
     over a fresh load of the file restores it (accumulation, motion, depth
     and offsets bit-equal to the saved state); both draw 2 more frames,
     whose accumulations agree within 1e-6 absolute, with equal rays; save
     and restore seconds and the file's size printed;
  6d. run J, the animated app frame on the flat BVH: run C's scene with
     two_level = False (K3 flat; the whole table refit from the posed
     triangles every frame), checked and driven as runs A-C are, its
     prepare seconds, its refit (K4 ``flat``) bit-equal to the plain
     version on the card and to the CPU's, and a
     48x48 flat frame of the same scene on the card against the CPU (1e-2
     relative RMSE, rays equal), printed beside run C; then phase K, run A's
     scene built under MRT_SBVH=1 (SBVH clip boxes; the build's K4 and K5
     launches counted): the full refit on the card bit-equal to the plain
     version on the card, and against the CPU (BLAS rows and root boxes
     bit-equal, the other rows within 1e-6, equal to the build's table), K2
     checked on a frame's launches and 2 frames driven, printed beside run
     A;
  6e. phase M, the user entry points: python -m mrt_tpu_torch.smoke and
     python -m mrt_tpu_torch.demo, each driven in this process through its
     main(argv) with no device flag (so on the card) at 1024x1024 output:
     the smoke (--size 1024: sphere and plane, upscaler off, 1 spp, 1
     bounce, a first and 4 steady draws, one PNG) and the demo (--size 1024
     --frames 30 --no-asset-models: 30 steps of orbit(3.0, 0.6) and 3
     draws of 1/60 s, 90 draws, at the Renderer's defaults but 2 spp and 2
     bounces: a 686x686 render, spatial upscaler, motion-adaptive
     accumulation and sampling, the robot animating; a GIF and a final
     PNG). Each with every launch count set to 0 just before and read just
     after: K2 (packed only) and K6-K8 must launch, the smoke K1, the demo
     K4 ``blas`` with K5 and K12's uint8 form (its spatial present) and no
     standalone K1, every draw on the kernel
     route (K6 at least once per base sample) and K8 once per sample. The
     PNG and the GIF are read back by the port's own readers
     (mrt_tpu_torch/utils/image.py: the PNG equal to the image, each of the
     GIF's 30 frames within GIF_QUANT_ERROR of its step's image, 1/30 s a
     frame); the images have non-zero pixels and the
     accumulation is finite with rays traced. Printed per entry point:
     first-draw seconds, the steady draws' median wall and Mrays/s,
     stats.report(), the GIF's encoding seconds and, for the demo, one
     profiled draw's device busy time and idle share. Then on each entry
     point's renderer K1 and every K2 launch of a frame, and every K6-K8
     launch of another, are held against their plain versions (as for the
     runs above), and a 48x48 run of each entry point on the card is held
     to the same on the CPU (the last accumulation within 1e-2 relative
     RMSE, rays equal per draw);
  7. after every run was driven, under torch.profiler: K1's device time at
     runs A and B (1920x1080 and 1024x576), warm and after a 64 MB write
     (cold), K2's device time over one more steady frame of runs A-C and
     F-H (warm L2), the costliest operators
     of a frame of runs A and F, phase D's and run H's LBS and refit device
     time per animated frame beside their bounds (the refit's device events
     per call by name, raising on any but the copy and K4's launch with
     K5, and its CUDA-event time), and run E's present device time
     and events per mode (at most 2, 3 and 7) beside the present's bound
     and the f32 chain's with K1, its denoiser's device time, K9's, each
     K10 pass's, K12's (the spatial chain's uint8 form and the bilinear)
     and K11's (its uint8 form) device time per launch and K1's at
     (2160,3840,3), beside their bounds; K3's device
     time over a
     steady frame of run J, its refit's and prepare's device time. A
     profiler session that misses the kernels it was asked for is logged as
     a "profiler_dropout" line (what it saw) and taken again, up to
     PROFILER_ATTEMPTS times in all, each dropout widening the idle time
     around every later session's recorded calls; a timing of a call that
     launches one kernel only then falls back to CUDA events;
  7b. run G flat: run G's renderer switched to the flat BVH (two_level =
     False; a table above 2^20 - 1 rows, K3's float-sort instantiation),
     its rebuild timed (its K4 ``flat`` launch counted), one frame's
     launches checked and one frame driven (after the profiler, so its wall
     runs on a slowed host), its refit checked as run J's on the card;
  7c. phase L, the sharded renderers (mrt_tpu_torch/dist), each rank a
     process of its own on this card (dist.launch.launch; every line names
     its backend; the ranks share one card, so no wall is a multi-GPU
     scaling figure). L1, one rank over nccl: DistributedRenderer (dp=1,
     sp=1) at run A's settings, 3 frames bit-equal to the single-device
     Renderer with equal rays, then GeometryShardedRenderer at gp=1 on run
     B's scene, 2 frames against the flat single device (two_level=False)
     within 1e-5. L2, two ranks over gloo (NCCL refuses two ranks on one
     GPU): dp=2 at run A bit-equal, with K1 on rank 0's gathered image
     uint8-equal to its plain version; sp=2 at run A within 1e-6 of the
     mean of the two sample windows the single device traces; gp=2 at run
     B within 1e-5 of the flat single device (pixels outside counted, rays
     equal or differing only where pixels differ), each rank's table bytes
     beside the single table's, then one more frame in which each rank
     holds every K3 launch on its padded shard table against the plain
     version (hits, t/u/v bits, pops; no padded row visited), and its K4
     ``flat`` refit of that table (every row's bits). L3, four
     ranks over gloo at 48x48: (dp, gp) = (2, 2) with the banded atlas on
     a textured scene, 3 frames within 1e-5 of the flat single device and
     a fourth checked as L2's, save_dist after the second, restore_dist in
     a fresh world and one frame, bit-equal to the uninterrupted third.
     L1 and L2 also drive the textured gp scene (run N's floor maps at
     1024x576, no masks, the banded atlas) at gp=1 and gp=2 within 1e-5
     of its flat single device, and L1 each other lane-row instantiation
     of K7 in a gp=1 job of one frame (GP_VARIANT_JOBS: the whole atlas
     with and without mipmaps, the motion view on run B's scene, the
     normal view whole, mipmapped and banded). Every gp frame takes the kernel route:
     K3, K6, K13 gp_rows (a step's scan, then its gather), K15
     gp_hit_keys and K16 gp_lane_unpack (the hit combine over the step's
     live lanes; over gp=2 also the occlusion's), K7's lane-row form, K8,
     and on the banded textured scenes K14 banded_taps, and nothing of K7
     but its lane-row form; each gp job then draws a checked frame on every
     rank (the kernel route bit-equal to the plain route, each K13 call's
     position map, lane list, rows and payload, each K14 call's taps and
     each K15 and K16 call's keys, occlusion rows or record, over the
     step's live lanes only, and the first K7 step bit-equal to their
     plain versions, both routes' walls and device events, K13-K16's
     CUDA-event ms and their first call's profiler device ms beside their
     bounds, their device ms per call over the profiled kernel-route
     frame, and each step's live share); the gp=2 jobs and L3 record each
     drawn step's collectives (count, elements, bytes; none may reduce a
     whole tensor copy). Walls, rays, Mrays/s and the
     ranks' start-up seconds printed; K1, K2 (packed), K3 (flat), K4
     (flat), K6-K8, K13, K15 and K16 must launch, K14 in L1-L3;
  8. a 48x48 frame traced and presented in every presenter mode on the card
     against the same frames on the CPU through the plain versions (the
     accumulation and the presented output within 1e-2 relative RMSE, the
     G-buffer within 1e-5 on at least 99.9 % of pixels); then a 48x48
     textured scene with a light-masked sphere, on the card against the
     CPU within 1e-2 relative RMSE and rays within 1 %: mipmaps on, each
     debug view 1-7, and the light-masked frame, each on the kernel route
     (K6 and only K7's instantiation for its settings launched).
The line before the last is {"kernels": [...]}: K1, K2's three
instantiations, K3's two (with their registers, shared memory and the
blocks an SM holds), K4's two, K5, K6, K7, K8, K9, K10, K11 (its uint8
form, which ends the temporal and denoised presents; the f32 form's times
beside it), K12's bilinear form and its Lanczos-3 uint8 form (the spatial
present; the f32 form's times beside it) (launches counted
over the main-path runs, the builds of runs G and K and of run G flat,
phase M's entry points and phase L's ranks), then K7 by instantiation
(untextured, maps, maps_mips, maps_debug, maps_mips_debug, debug: its
launches, checks, registers and spills, and its times at the first launch
of the run that takes it), then K7's lane-row form by instantiation (all
eight: each must have launched on the main path and been checked; the
first launch of its checked frame also by the profiler, beside its bound,
and per launch over the profiled frame), K13,
K14, K15 and K16 (timed at the first call of L1's checked gp=1 frames by CUDA
events and by the profiler, and per launch over its profiled frame, with
the live share of each step; their largest difference from the plain
version over every checked launch),
each with its bound
(mrt_tpu_torch/utils/bounds.py); runs A, B, C, E, G, H and J and phase M's
smoke and demo must have launched K6-K8 with only the untextured K7, runs
F and N only their textured one, K8 once per sample (each run's line
prints its K8 launches per frame). The script prints its
total seconds; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
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


# torch.profiler sessions a timing takes before it gives up. On the H100 a
# process's profiler drops the device events of a short session more and
# more often as the process ages (after 50 s of work, every session of five
# 0.17 ms kernels saw none), and keeps them when the recorded cycle idles
# long enough before its first call and after its last (0.25 s sufficed
# to 240 s; mrt_tpu_torch/utils/profiler_probe.py). So each dropout widens
# that idle time, ``profiler_pad_s``, for this session's retry and every
# later session: 0.05 s, then doubled.
PROFILER_ATTEMPTS = 5
profiler_pad_s = 0.0


def widen_profiler_pad() -> None:
    global profiler_pad_s
    profiler_pad_s = min(max(2 * profiler_pad_s, 0.05), 2.0)


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
    device events can go missing (one saw 5 of 20 kernels). The recorded
    cycle idles ``profiler_pad_s`` before its first call and after its last."""
    from torch.profiler import ProfilerActivity, profile, schedule

    out = []
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    fn()
    torch.cuda.synchronize()
    with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: out.append((p.events(), p.key_averages()))) as prof:
        for pad in (0.0, profiler_pad_s):
            time.sleep(pad)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad)
            prof.step()
    if not out:
        raise AssertionError("the profiler recorded no cycle")
    return out[0]


def device_events(torch, events):
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]


def device_ms(torch, fn, name: str, reps: int, flush=None, one_kernel: bool = False) -> float:
    """Mean device time in ms of the kernels whose name holds ``name`` (one
    per call of ``fn``), from torch.profiler over ``reps`` calls; ``flush``
    (if given) runs before each call, outside the sum. A session that saw
    fewer than half of them is run again, up to PROFILER_ATTEMPTS times.
    With ``one_kernel`` (``fn`` launches that kernel and nothing else on
    the card), a profiler that saw too few in every session gives way to
    CUDA events around each call, and a ``profiler_fallback`` line says so."""

    def call():
        if flush is not None:
            flush()
        fn()

    for attempt in range(PROFILER_ATTEMPTS):
        seen = device_events(torch, profiled(torch, call, reps)[0])
        ev = [e for e in seen if name in e.name]
        if len(ev) >= reps // 2:
            return sum(e.time_range.elapsed_us() for e in ev) / 1e3 / len(ev)
        log_dropout(f"'{name}' x{reps}", attempt, len(ev), seen)
    if not one_kernel:
        raise AssertionError(f"the profiler saw {len(ev)} '{name}' kernels in {reps} calls")
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    for start, end in pairs:
        if flush is not None:
            flush()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    ms = sum(start.elapsed_time(end) for start, end in pairs) / reps
    log(json.dumps(dict(profiler_fallback=f"'{name}' x{reps}", cuda_event_ms=ms)))
    return ms


def log_dropout(what: str, attempt: int, n_found: int, seen) -> None:
    """Log a profiler session that missed the kernels it was asked for
    (``seen``: every device event it recorded), so that a dropout stays
    visible in the output whether or not a retry recovers, and widen the
    sessions' idle time."""
    names = sorted({e.name[:60] for e in seen})[:8]
    log(json.dumps(dict(profiler_dropout=what, attempt=attempt + 1, found=n_found,
                        device_events=len(seen), kernels_seen=names, pad_s=profiler_pad_s)))
    widen_profiler_pad()


def device_total_ms(torch, fn, reps: int, least: int = 1) -> tuple[float, float]:
    """Mean device time in ms of everything ``fn`` runs on the card
    (kernels, copies, fills) and its device events per call, from
    torch.profiler over ``reps`` calls. A session that saw fewer than
    ``least`` device events a call is run again, up to PROFILER_ATTEMPTS times."""
    for attempt in range(PROFILER_ATTEMPTS):
        ev = device_events(torch, profiled(torch, fn, reps)[0])
        if len(ev) >= least * reps:
            break
        log_dropout(f"every device event x{reps}", attempt, len(ev), ev)
    if len(ev) < least * reps:
        raise AssertionError(f"the profiler saw {len(ev)} device events in {reps} calls")
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


def traversal(traverse2, bvh, masked: bool = False):
    """The traversal of ``bvh``: (the arguments that describe its table, the
    wrapper's name in kernels/traverse2.py, the plain version, the
    instantiation's name, whether it is K3). K2 for a two-level BVH
    (``masked``: rays carry masks), K3 for a flat one."""
    from mrt_tpu_torch.bvh import kind

    rows = bvh.table.shape[0]
    if kind.is_flat(bvh):
        return ((bvh.table, bvh.n_internal, bvh.stack_size), "traverse_flat",
                traverse2.traverse_flat_plain, traverse2.flat_variant(rows), True)
    return ((bvh.table, bvh.n_internal, bvh.n_leaf, bvh.tlas_n, bvh.stack_size), "traverse",
            traverse2.traverse_plain, traverse2.variant(rows, masked), False)


def work_bound(bounds, head, visits, n_lanes, n_live, masked: bool, flat: bool):
    """(work, bound ms, bound kind) of one traversal call on the table
    ``head`` describes, from the plain version's ``visits``."""
    if flat:
        work = bounds.k3_work(head[0], head[1], visits)
    else:
        work = bounds.k2_work(head[0], head[1], head[2], visits, masked=masked)
    return (work,) + bounds.k2(work, n_lanes, n_live, masked=masked, flat=flat)


def check_random_rays(torch, tag, bvh, traverse2, bounds, masked: bool = False, rays=None):
    """K2 (a two-level BVH) or K3 (a flat one) on 2^20 random mixed rays
    (half of them shadow rays with a finite tmax, 95 % live) over run
    ``tag``'s table, each with a random ray mask (1, 2 or 3) if ``masked``,
    or on ``rays`` (origin, direction, tmax, shadow, active) where given;
    then on the same rays with every lane dead, with one live lane, the
    wavefront's last, and at one lane fewer (the compaction's last block
    partial) the last lane alone and the random mask. Hit-equal, t/u/v
    bit-equal and pop-equal to the plain version, or it raises. Returns the
    batch's numbers."""
    dev = bvh.table.device
    g = torch.Generator(device=dev).manual_seed(1)
    table = bvh.table
    if rays is None:
        from mrt_tpu_torch.utils.k3_profile import random_rays

        rays = random_rays(torch, table, generator=g)
    org, dirs, tmax, shadow, active = rays
    n = org.shape[0]
    rmask = (torch.randint(1, 4, (n,), generator=g, device=dev, dtype=torch.int32)
             if masked else None)
    head, kname, plain, name, flat = traversal(traverse2, bvh, masked)
    kw = {} if rmask is None else {"ray_mask": rmask}
    args = head + (org, dirs, tmax, shadow, active)
    kern = getattr(traverse2, kname)
    k2, p2 = kern(*args, **kw), plain(*args, **kw)
    bad, err = k2_mismatches(torch, k2, p2)
    ms = cuda_ms(lambda: kern(*args, **kw), 10)
    _, b_ms, b_by = work_bound(bounds, head, p2.visits, n, int(active.sum()), masked, flat)
    log(f"{'K3' if flat else 'K2'} {kname} ({name}), {n} mixed rays over the run {tag} "
        f"table ({table.shape[0]} rows){' with random ray masks' if masked else ''}: "
        f"{int((p2.tri >= 0).sum())} hits, {int((p2.found & shadow).sum())} occluded, "
        f"{int(p2.pops.sum())} pops; mismatches {bad}; kernel {ms:.3f} ms, "
        f"bound {b_ms:.4f} ms ({b_by})")
    if any(bad.values()):
        raise AssertionError(f"{kname} ({name}) disagrees with its plain version (random mixed rays)")
    last = torch.zeros(n, dtype=torch.bool, device=dev)
    last[-1] = True
    m = n - 1
    last_m = torch.zeros(m, dtype=torch.bool, device=dev)
    last_m[-1] = True
    edges = (("all lanes dead", n, torch.zeros_like(active)), ("one live lane, the last", n, last),
             ("one live lane, the last", m, last_m), ("the random mask", m, active[:m]))
    nh = len(head)
    for what, lanes, act in edges:
        eargs = args[:nh] + tuple(x[:lanes] for x in args[nh:nh + 4]) + (act,)
        ekw = {} if rmask is None else {"ray_mask": rmask[:lanes]}
        bad, _ = k2_mismatches(torch, kern(*eargs, **ekw), plain(*eargs, **ekw))
        log(f"{kname} ({name}), {lanes} lanes, {what}: mismatches {bad}")
        if any(bad.values()):
            raise AssertionError(f"{kname} ({name}) disagrees with its plain version ({lanes} "
                                 f"lanes, {what})")
    return dict(variant=name, max_abs_err=err, ms=ms, bound_ms=b_ms, bound_by=b_by)


def check_path_kernels(torch, tag, r, present, traverse2, bounds):
    """Hold K1 and the traversal kernel (K2 on a two-level BVH, K3 on a
    flat one) against their plain versions at the shapes run ``tag`` gives
    them, before the run is driven. K1: the edge-case values at the render
    size, and the frame's present (its accumulation, or the upscaled output
    where the renderer upscales) through present_device; its
    time from CUDA events over 50 calls (its device times come later, from
    profile_run). The traversal: every launch of one frame of the path
    (camera, bounce and shadow batches), each held against the plain
    version on the same inputs right after it ran, with its bound from the
    work of the plain version's visits. Raises on any mismatch; returns the
    kernels' numbers (the traversal's under "k2" or "k3")."""
    h, w = r.render_height, r.render_width
    plain1 = present.tonemap_quantize_plain
    x_cpu = present.edge_case_inputs(h, w)
    x = x_cpu.to(r.device)
    k1, p1 = present.tonemap_quantize(x), plain1(x)
    k1_bad = int((k1 != p1).sum()) + int((k1.cpu() != plain1(x_cpu)).sum())
    k1_err = int((k1.int() - p1.int()).abs().max())
    k1_ms = cuda_ms(lambda: present.tonemap_quantize(x), 50)
    k1_plain_ms = cuda_ms(lambda: plain1(x), 50)

    head0, kname, plain, _, flat = traversal(traverse2, r.bvh)
    nh = len(head0)  # the table's arguments before the rays'
    key = "k3" if flat else "k2"
    orig = getattr(traverse2, kname)
    k2 = dict(launches=0, rays=0, max_abs_err=0.0, frame_ms=0.0, frame_plain_ms=0.0,
              frame_bound_ms=0.0, bound_by={"operations": 0, "bytes": 0}, work={}, variants={})
    first = []

    def checked(*args, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        kout = orig(*args, **kw)
        ev[1].record()
        pout = plain(*args, **kw)
        ev[2].record()
        torch.cuda.synchronize()
        masked = kw.get("ray_mask") is not None
        rows = args[0].shape[0]
        name = traverse2.flat_variant(rows) if flat else traverse2.variant(rows, masked)
        bad, err = k2_mismatches(torch, kout, pout)
        if any(bad.values()):
            raise AssertionError(f"{kname} ({name}) disagrees with its plain version (run {tag}, "
                                 f"launch {k2['launches']}, {kout.t.numel()} rays): {bad}")
        n_live = int(args[nh + 4].sum())
        work, b_ms, b_by = work_bound(bounds, args[:nh], pout.visits, kout.t.numel(), n_live,
                                      masked, flat)
        k2["variants"][name] = k2["variants"].get(name, 0) + 1
        k2["launches"] += 1
        k2["rays"] += n_live
        k2["max_abs_err"] = max(k2["max_abs_err"], err)
        k2["frame_ms"] += ev[0].elapsed_time(ev[1])
        k2["frame_plain_ms"] += ev[1].elapsed_time(ev[2])
        k2["frame_bound_ms"] += b_ms
        k2["bound_by"][b_by] += 1
        for k, val in work.items():
            k2["work"][k] = k2["work"].get(k, 0) + val
        if not first:
            # copies: K7 updates the lane state (rays, active) in place later
            first.append((args[:nh] + tuple(x.clone() if torch.is_tensor(x) else x
                                            for x in args[nh:]),
                          {k: v.clone() if torch.is_tensor(v) else v for k, v in kw.items()}))
        return kout

    setattr(traverse2, kname, checked)
    try:
        r.draw(1 / 60)
    finally:
        setattr(traverse2, kname, orig)
    from mrt_tpu_torch.upscale import presenter

    lin = presenter.present_linear(r)[0]  # the accumulation itself where nothing upscales
    img = r.present_device()
    k1_bad += int((img != plain1(lin.contiguous())).sum())
    log(f"K1 present run {tag} ({h},{w},3): {x.numel()} edge values (zeros, tiny, huge, exact .5 "
        f"landings, random) and the frame's present {tuple(img.shape)}, kernel vs plain "
        f"mismatches {k1_bad}; "
        f"kernel {k1_ms:.4f} ms (CUDA events over 50 calls), plain {k1_plain_ms:.4f} ms")
    if k1_bad:
        raise AssertionError(f"K1 disagrees with its plain version (run {tag})")
    if not k2["launches"]:
        raise AssertionError(f"run {tag}: the checked frame launched no traversal")
    cam, cam_kw = first[0]
    masked = cam_kw.get("ray_mask") is not None
    k2["ms"] = cuda_ms(lambda: orig(*cam, **cam_kw), 10)
    k2["plain_ms"] = cuda_ms(lambda: plain(*cam, **cam_kw), 1)
    _, k2["bound_ms"], k2["bound_by_cam"] = work_bound(
        bounds, cam[:nh], plain(*cam, **cam_kw).visits, cam[nh].shape[0],
        int(cam[nh + 4].sum()), masked, flat)
    log(f"{key.upper()} {kname} run {tag} ({k2['variants']}): one frame's {k2['launches']} "
        f"launches, {k2['rays']} live rays, "
        f"0 mismatches in tri, inst, occluded, pops and the bits of t, u, v; kernel "
        f"{k2['frame_ms']:.3f} ms (CUDA events, cold L2), plain {k2['frame_plain_ms']:.3f} ms, "
        f"bound {k2['frame_bound_ms']:.3f} ms per frame (launches bound by {k2['bound_by']}); "
        f"work summed over launches {k2['work']}; camera rays ({cam[nh].shape[0]}): kernel "
        f"{k2['ms']:.3f} ms, plain {k2['plain_ms']:.3f} ms, bound {k2['bound_ms']:.4f} ms "
        f"({k2['bound_by_cam']})")
    return {"k1_err": k1_err, "k1_ms": k1_ms, "k1_plain_ms": k1_plain_ms, key: k2, "k1_input": x}


# phase 3c: a float output of K6-K8 that is not bit-equal to its plain
# version must stay within this relative error (per lane, against the lane's
# largest component), and an integer or bool output equal on this share of
# lanes
STAGE_REL_TOL = 1e-5
STAGE_INT_SHARE = 0.9999


def ordered_bits(torch, x):
    """f32 bits as int64 in the order of the values (so a difference is a
    distance in units in the last place)."""
    i = x.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(i < 0, -(i & 0x7FFFFFFF), i)


def field_diff(torch, k, p, lanes=None) -> dict:
    """Kernel output ``k`` against plain ``p`` (over ``lanes`` if given):
    lanes differing, and for f32 the largest ULP and relative error."""
    if lanes is not None:
        k, p = k[lanes], p[lanes]
    if k.dtype != torch.float32:
        bad = (k != p) if k.ndim == 1 else (k != p).any(dim=-1)
        return dict(lanes=int(k.shape[0]), differing=int(bad.sum()))
    cols = int(torch.tensor(k.shape[1:]).prod()) if k.ndim > 1 else 1
    kk, pp = k.reshape(k.shape[0], cols), p.reshape(p.shape[0], cols)
    bad = (kk.view(torch.int32) != pp.view(torch.int32)).any(dim=1)
    out = dict(lanes=int(k.shape[0]), differing=int(bad.sum()), max_ulp=0, max_rel=0.0,
               max_abs=0.0)
    if out["differing"]:
        kb, pb = kk[bad], pp[bad]
        out["max_ulp"] = int((ordered_bits(torch, kb) - ordered_bits(torch, pb)).abs().max())
        both_nan = torch.isnan(kb) & torch.isnan(pb)
        err = torch.where(both_nan, 0.0, (kb - pb).abs()).nan_to_num(float("inf"))
        scale = pb.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
        out["max_rel"] = float((err / scale).max())
        out["max_abs"] = float(err.max())
    return out


def field_ok(d: dict) -> bool:
    if "max_ulp" in d:
        return d["max_rel"] <= STAGE_REL_TOL
    return d["differing"] <= (1.0 - STAGE_INT_SHARE) * max(d["lanes"], 1)


def merge_fields(acc: dict, new: dict):
    for name, d in new.items():
        a = acc.setdefault(name, dict(lanes=0, differing=0))
        a["lanes"] += d["lanes"]
        a["differing"] += d["differing"]
        if "max_ulp" in d:
            for m in ("max_ulp", "max_rel", "max_abs"):
                a[m] = max(a.get(m, 0), d[m])


def state_diff(torch, W, k, p) -> dict:
    """Every LaneState field of the kernel's state ``k`` against the plain
    version's ``p``."""
    return {f: field_diff(torch, getattr(k, f), getattr(p, f).contiguous())
            for f in W.LaneState._fields if getattr(p, f) is not None}


def shadow_diff(torch, k, p) -> dict:
    """The shadow rays: the mask on every lane, the rays where both cast one."""
    both = k.need & p.need
    out = {"need": field_diff(torch, k.need, p.need)}
    for f in ("origin", "direction", "distance", "contrib"):
        out[f"shadow.{f}"] = field_diff(torch, getattr(k, f), getattr(p, f), both)
    return out


# the card's name and power limit, set in main and put on every phase-3c line
CARD: dict = {}


def check_stages(torch, tag, r, W, traverse2, bounds, glass_heavy: bool = False) -> dict:
    """Phase 3c at run ``tag``: every launch of K6, K7 and K8 in one frame
    of ``r`` held against its plain version on the card on the same inputs
    (the state and the Wave cloned first: the kernels update them in place),
    right after it ran; the frame goes on with the kernel's outputs. K7 (the
    listed step) against ``resolve_shadow_plain`` then ``shade_hit_plain``
    (``shade_hit_listed_plain``, on ``traverse2.hits_of`` of the raw
    record): every state field and ``need`` on every lane, the shadow rays
    where both cast one, the live count, and its list against the plain
    one (``active | need``: the same lanes, none twice). The trailing K8
    against ``resolve_shadow_plain``. Every field's lanes differing, largest
    ULP and relative error are summed per stage; each launch's CUDA-event
    time beside the plain version's and its bound (bounds.k6, k7_listed,
    k8). With ``glass_heavy``, K7's first launch is also held on the
    same state with every material glass (ior 1.5, opacity 0.5). Raises if
    a list differs or a field is outside STAGE_REL_TOL / STAGE_INT_SHARE;
    returns the stages' numbers and the inputs of K7's first launch, of its
    first late launch (under 5 % of the lanes live) and of the first K8
    (for timing)."""
    orig = {s: getattr(W, s) for s in W.STAGES}
    res = {s: dict(launches=0, fields={}, frame_ms=0.0, frame_plain_ms=0.0, frame_bound_ms=0.0,
                   bound_by={"bytes": 0, "operations": 0}) for s in W.STAGES}
    res["shade_hit"]["work"] = {}
    lists = dict(checked=0, lanes=0)
    first = {}
    extra = {}
    where = {"sidx": 0, "iter": 0}

    def timed(fk, fp):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        ok = fk()
        ev[1].record()
        op = fp()
        ev[2].record()
        torch.cuda.synchronize()
        return ok, op, ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])

    def account(stage, fields, ms, pms, bound):
        r_ = res[stage]
        r_["launches"] += 1
        merge_fields(r_["fields"], fields)
        r_["frame_ms"] += ms
        r_["frame_plain_ms"] += pms
        r_["frame_bound_ms"] += bound[0]
        r_["bound_by"][bound[1]] += 1
        bad = {f: d for f, d in fields.items() if not field_ok(d)}
        if bad:
            raise AssertionError(f"phase 3c run {tag}: {stage} (sample {where['sidx']}, "
                                 f"iteration {where['iter']}) disagrees with its plain version "
                                 f"on the card: {bad}")

    def c_sample_start(fr, sidx, total, prev=None):
        where.update(sidx=sidx, iter=0)
        st_k, st_p, ms, pms = timed(lambda: orig["sample_start"](fr, sidx, total, prev),
                                    lambda: W.sample_start_plain(fr, sidx, total, prev))
        account("sample_start", state_diff(torch, W, st_k, st_p), ms, pms,
                bounds.k6(fr.pixel_x.shape[0]))
        first.setdefault("sample_start", (fr, sidx, total.clone(), prev))
        return st_k

    def plain_step(fr, st, hits, sidx, wv):
        return W.shade_hit_listed_plain(fr, W.clone_state(st), traverse2.hits_of(hits, fr.tri_base),
                                        sidx, wv._replace(buf=None))

    def step_fields(st_k, wv_k, live_k, st_p, wv_p, live_p) -> dict:
        fields = state_diff(torch, W, st_k, st_p)
        if (wv_k.shadow is None) != (wv_p.shadow is None):
            raise AssertionError(f"phase 3c run {tag}: K7 cast shadow rays "
                                 f"{wv_k.shadow is not None}, its plain version "
                                 f"{wv_p.shadow is not None} (a debug view casts none)")
        if wv_p.shadow is not None:
            fields.update(shadow_diff(torch, wv_k.shadow, wv_p.shadow))
        fields["live"] = dict(lanes=1, differing=int(int(live_k) != int(live_p)))
        lk = W.listed(wv_k)
        lp = torch.nonzero(wv_p.keep).squeeze(1).to(torch.int32)
        if lk.numel() != lp.numel() or not torch.equal(lk.sort().values, lp):
            raise AssertionError(f"phase 3c run {tag}: K7's list (sample {where['sidx']}, "
                                 f"iteration {where['iter']}) holds {lk.numel()} lanes, "
                                 f"{int(lk.unique().numel())} distinct; the lanes live or with a "
                                 f"shadow ray are {lp.numel()}")
        lists["checked"] += 1
        lists["lanes"] += lp.numel()
        return fields

    def c_shade_hit(fr, st, hits, sidx, wv, rows=None):  # a single-device frame's: no rows
        if rows is not None:
            raise ValueError("check_stages holds single-device frames")
        st_in, wv_in = W.clone_state(st), W.clone_wave(wv)
        P = st.active.shape[0]
        n_listed = P if wv.steps == 0 else int(W.listed(wv).numel())
        (st_k, wv_k, live_k), (st_p, wv_p, live_p), ms, pms = timed(
            lambda: orig["shade_hit"](fr, st, hits, sidx, wv),
            lambda: plain_step(fr, st_in, hits, sidx, wv_in))
        fields = step_fields(st_k, wv_k, live_k, st_p, wv_p, live_p)
        work = bounds.k7_work(fr, st_in, traverse2.hits_of(hits, fr.tri_base), wv_p.shadow,
                              n_listed=n_listed, pending=wv_in.shadow, occluded=wv_in.occluded)
        for k_, v in work.items():
            res["shade_hit"]["work"][k_] = res["shade_hit"]["work"].get(k_, 0) + v
        account("shade_hit", fields, ms, pms, bounds.k7_listed(work))
        if "shade_hit" not in first:
            first["shade_hit"] = (fr, st_in, hits, sidx, wv_in, work)
            if glass_heavy:
                glassy = fr.geom.mat_rows.clone()
                glassy[:, 10] = 1.5
                glassy[:, 11] = 0.5
                fr_g = fr._replace(geom=fr.geom._replace(mat_rows=glassy))
                gk = orig["shade_hit"](fr_g, W.clone_state(st_in), hits, sidx, W.clone_wave(wv_in))
                gp = plain_step(fr_g, st_in, hits, sidx, wv_in)
                gf = step_fields(*gk, *gp)
                gwork = bounds.k7_work(fr_g, st_in, traverse2.hits_of(hits, fr.tri_base),
                                       gp[1].shadow)
                extra["glass_heavy"] = dict(work=gwork, not_bit_equal={
                    f: d for f, d in gf.items() if d["differing"]})
                bad = {f: d for f, d in gf.items() if not field_ok(d)}
                if bad or gwork["glass"] < gwork["hit"] // 2:
                    raise AssertionError(f"phase 3c run {tag}: the glass-heavy K7 state "
                                         f"disagrees or holds few glass hits: {gwork} {bad}")
        elif "shade_hit_late" not in first and wv_in.steps > 0 and work["live"] < 0.05 * P:
            first["shade_hit_late"] = (fr, st_in, hits, sidx, wv_in, work)
        where["iter"] += 1
        return st_k, wv_k, live_k

    def c_resolve(st, wv):
        if wv.shadow is None:  # a debug view: no shadow ray pending, K8 does not launch
            return orig["resolve_shadow"](st, wv)
        st_in = st._replace(accumulated=st.accumulated.clone())
        n_listed = int(W.listed(wv).numel())
        st_k, st_p, ms, pms = timed(lambda: orig["resolve_shadow"](st, wv),
                                    lambda: W.resolve_shadow_listed_plain(st_in, wv))
        n_add = int((wv.shadow.need & ~wv.occluded).sum())
        account("resolve_shadow",
                {"accumulated": field_diff(torch, st_k.accumulated, st_p.accumulated)}, ms, pms,
                bounds.k8(n_listed, n_add))
        first.setdefault("resolve_shadow", (st_in._replace(accumulated=st_in.accumulated.clone()),
                                            W.clone_wave(wv), n_listed, n_add))
        return st_k

    for s, f in (("sample_start", c_sample_start), ("shade_hit", c_shade_hit),
                 ("resolve_shadow", c_resolve)):
        setattr(W, s, f)
    try:
        r.draw(1 / 60)
    finally:
        for s, f in orig.items():
            setattr(W, s, f)
    torch.cuda.synchronize()
    debug = r.debug_texture_mode != 0
    # a debug view retires every lane at its first hit: one K7 step a
    # sample, no shadow ray and no K8
    k8_want = 0 if debug else res["sample_start"]["launches"]
    if min(res[s]["launches"] for s in W.STAGES if s != "resolve_shadow" or not debug) < 1:
        raise AssertionError(f"phase 3c run {tag}: a stage never launched: "
                             f"{ {s: res[s]['launches'] for s in W.STAGES} }")
    if res["resolve_shadow"]["launches"] != k8_want:
        raise AssertionError(f"phase 3c run {tag}: K8 launched {res['resolve_shadow']['launches']} "
                             f"times for {res['sample_start']['launches']} samples")
    not_bit_equal = {s: {f: d for f, d in res[s]["fields"].items() if d["differing"]}
                     for s in W.STAGES}
    log(json.dumps(dict(phase="3c", run=tag, route="kernel",
                        k7_variant=W.K7_VARIANTS[W.k7_variant(r.settings(), r.statics)],
                        launches={s: res[s]["launches"] for s in W.STAGES},
                        not_bit_equal=not_bit_equal, glass_heavy=extra.get("glass_heavy"),
                        lists_checked=lists,
                        frame_ms={s: res[s]["frame_ms"] for s in W.STAGES},
                        frame_plain_ms={s: res[s]["frame_plain_ms"] for s in W.STAGES},
                        frame_bound_ms={s: res[s]["frame_bound_ms"] for s in W.STAGES},
                        k7_work=res["shade_hit"]["work"], **CARD)))
    return dict(stages=res, first=first, not_bit_equal=not_bit_equal, extra=extra, lists=lists,
                variant=W.K7_VARIANTS[W.k7_variant(r.settings(), r.statics)])


def time_stages(torch, W, traverse2, bounds, first, reps: int = 5) -> dict:
    """K6, K7 and K8's time from CUDA events over ``reps`` launches (each K7
    launch on its own copy of the state and the Wave), beside the plain
    version's and the bound: K6 and K7 at a frame's first launch (the whole
    wavefront live), K7 also at its first late launch (under 5 % of the
    lanes live; ``shade_hit_late``), K8 at its first launch (a sample's
    end). K7's first launch also by torch.profiler (``profiler_ms``, the
    card's time without the wrapper's host work; None where every session
    dropped it) and its bound's share of that."""
    out = {}
    fr, sidx, total, prev = first["sample_start"]
    out["sample_start"] = dict(ms=cuda_ms(lambda: W.sample_start(fr, sidx, total, prev), reps),
                               plain_ms=cuda_ms(lambda: W.sample_start_plain(fr, sidx, total,
                                                                             prev), reps))
    out["sample_start"]["bound_ms"], out["sample_start"]["bound_by"] = bounds.k6(
        fr.pixel_x.shape[0])
    for key in ("shade_hit", "shade_hit_late"):
        if key not in first:
            out[key] = None
            continue
        fr, st, hits, sidx, wv, work = first[key]
        copies = [(W.clone_state(st), W.clone_wave(wv)) for _ in range(reps)]
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for c, w in copies:
            W.shade_hit(fr, c, hits, sidx, w)
        end.record()
        torch.cuda.synchronize()
        del copies
        out[key] = dict(ms=start.elapsed_time(end) / reps, step=wv.steps, work=work,
                        plain_ms=cuda_ms(lambda: W.shade_hit_listed_plain(
                            fr, st, traverse2.hits_of(hits, fr.tri_base), sidx,
                            wv._replace(buf=None)), 2))
        out[key]["bound_ms"], out[key]["bound_by"] = bounds.k7_listed(work)
        if key == "shade_hit":  # the card's own time of the launch, without the wrapper's host work
            try:
                p_ms = device_ms(torch, lambda: W.shade_hit(fr, W.clone_state(st), hits, sidx,
                                                            W.clone_wave(wv)), "shade_hit", reps)
            except AssertionError as e:  # the profiler dropped the launches in every session
                log(json.dumps(dict(profiler_dropout="K7's first launch", error=str(e))))
                p_ms = None
            out[key]["profiler_ms"] = p_ms
            out[key]["bound_share_profiler"] = out[key]["bound_ms"] / p_ms if p_ms else None
    if "resolve_shadow" not in first:  # a debug view: K8 never launched
        return out
    st, wv, n_listed, n_add = first["resolve_shadow"]
    out["resolve_shadow"] = dict(
        ms=cuda_ms(lambda: W.resolve_shadow(st, wv), reps),
        plain_ms=cuda_ms(lambda: W.resolve_shadow_listed_plain(st, wv), reps),
        listed=n_listed, added=n_add)
    out["resolve_shadow"]["bound_ms"], out["resolve_shadow"]["bound_by"] = bounds.k8(
        n_listed, n_add)
    return out


def check_route_frame(torch, tag, r, W, wf, strict: bool = False) -> dict:
    """One frame of run ``tag`` on the kernel route against the plain route
    on the card, on the same inputs (``trace_frame`` run twice, the second
    time with ``plain=True``); the frame goes on with the
    kernel route's outputs. The accumulation, rays, samples, depth, motion
    and the G-buffer bit-equal, or (unless ``strict``) the accumulation
    within 1e-3 relative RMSE and the rays within 1e-4 relative. Raises
    otherwise."""
    orig_tf = wf.trace_frame
    out = {}

    def both(*a, **k):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        ok = orig_tf(*a, **k)
        ev[1].record()
        op = orig_tf(*a, plain=True, **k)
        ev[2].record()
        torch.cuda.synchronize()
        out["kernel_route_ms"] = ev[0].elapsed_time(ev[1])
        out["plain_route_ms"] = ev[1].elapsed_time(ev[2])
        fields = {}
        for f in ok._fields:
            a, b = getattr(ok, f), getattr(op, f)
            if a is None:
                continue
            fields[f] = field_diff(torch, a.reshape(-1, *a.shape[2:]), b.reshape(-1, *b.shape[2:]))
        out["fields"] = fields
        out["color_rel_rmse"] = rel_rmse(ok.color, op.color)
        rk, rp = int(ok.rays_traced.sum()), int(op.rays_traced.sum())
        out["rays"] = [rk, rp]
        out["rays_rel"] = abs(rk - rp) / max(rp, 1)
        return ok

    wf.trace_frame = both
    try:
        r.draw(1 / 60)
    finally:
        wf.trace_frame = orig_tf
    out["bit_equal"] = not any(d["differing"] for d in out["fields"].values())
    log(json.dumps(dict(phase="3c", run=tag, frame="kernel route vs plain route on the card",
                        **out, **CARD)))
    if not out["bit_equal"] and (strict or out["color_rel_rmse"] > 1e-3
                                 or out["rays_rel"] > 1e-4):
        raise AssertionError(f"run {tag}: the kernel route's frame disagrees with the plain "
                             f"route's: {out}")
    return out


def lights_env_renderer(dev, size: int = 512):
    """Phase 3c's scene for K7's environment and light-type code, which the
    runs' app scene (an area and a spot light, no environment) leaves
    unexercised: a glass, a red and an emissive sphere over a floor (the CPU
    tests' config 3 without its texture maps), the default area and spot
    lights plus a point and a sun light, and a 64x128 equirect environment
    made from a seed; size x size, 2 spp, 4 bounces."""
    import numpy as np

    from mrt_tpu_torch import Model, Renderer, Scene
    from mrt_tpu_torch.assets import procedural
    from mrt_tpu_torch.assets.obj import MaterialDef
    from mrt_tpu_torch.core import types as T
    from mrt_tpu_torch.engine.scene import ModelMaterialOverride
    from mrt_tpu_torch.utils import frame_profile as FP

    s = Scene(size, size)
    s.models = [
        Model("glass", mesh=procedural.uv_sphere(12, 24), position=[0.0, 0.6, 1.2], scale=0.5,
              material_override=ModelMaterialOverride.glass()),
        Model("red", mesh=procedural.uv_sphere(12, 24), position=[-0.1, 0.5, -0.6], scale=0.5,
              material_override=ModelMaterialOverride(base_color=(0.75, 0.12, 0.1))),
        Model("glow", mesh=procedural.uv_sphere(12, 24, material=MaterialDef(
            name="glow", base_color=(0.1, 0.1, 0.1), emission=(0.4, 1.2, 0.5))),
            position=[0.9, 0.25, 0.2], scale=0.22),
        Model("floor", mesh=procedural.plane(), position=[0, 0, 0], scale=10),
    ]
    s.lights = T.concat_lights(s.lights,
                               T.point_light(position=(1.5, 2.5, 1.0), color=(2.0, 1.8, 1.4)),
                               T.sun_light(direction=(-0.3, -1.0, -0.2), color=(0.25, 0.25, 0.3)))
    rng = np.random.default_rng(5)
    s.set_environment(rng.uniform(0.0, 2.0, (64, 128, 3)).astype(np.float32), intensity=0.8)
    r = Renderer(s, size, size, seed=3, device=dev)
    FP.configure(r)
    r.draw()
    return r


def check_halton_kernel(torch, H, W):
    """K6's and K7's Halton device function (csrc/halton.cuh, through the
    test entry mrt_halton) bit-equal to halton_base on the CPU over
    check_halton's sweep, at 24 and 11 digits (the per-step bases are
    primes[2:])."""
    import numpy as np

    rng = np.random.default_rng(7)
    idx, bases = [], []
    for d in range(100):
        b = int(H.PRIMES[d])
        ks = np.unique(rng.integers(1, (1 << 24) // b, size=64))
        i = np.unique(np.concatenate([ks * b - 1, ks * b, ks * b + 1, np.arange(0, 4096, 97),
                                      rng.integers(1 << 20, 1 << 24, size=64)]))
        i = i[(i >= 0) & (i < (1 << 24))]
        idx.append(i)
        bases.append(np.full(i.shape, b))
    i = torch.as_tensor(np.concatenate(idx).astype(np.int32))
    b = torch.as_tensor(np.concatenate(bases).astype(np.int32))
    step = b >= 5
    bad = {}
    for digits, sel in ((24, torch.ones_like(step)), (11, step)):
        cpu = H.halton_base(i[sel], b[sel], digits)
        gpu = W.halton(i[sel].cuda(), b[sel].cuda(), digits).cpu()
        bad[digits] = int((cpu.view(torch.int32) != gpu.view(torch.int32)).sum())
    log(f"halton through K6/K7's device function (csrc/halton.cuh): {i.numel()} indices at 24 "
        f"digits, {int(step.sum())} at 11, bit mismatches against the CPU {bad}")
    if any(bad.values()):
        raise AssertionError("K6/K7's Halton differs from the CPU Halton")


def profile_run(torch, FP, tag, r, present, bounds, check, walls, k1: bool = False):
    """After the runs were driven, so that no profiler session precedes their
    timed frames: with ``k1``, K1's device time at the render size from the
    profiler, warm and after a 64 MB write (cold); and K2's (or K3's) device
    time over one more steady frame (warm L2), its idle share taken against
    the median of the driven frames' walls (``walls``); a session that saw
    no traversal kernel is run again on the next frame, up to three times.
    Adds them to ``check``; returns the frame's profile line."""
    x = check.pop("k1_input")
    check["k1_bound_ms"], check["k1_bound_by"] = bounds.k1((r.render_height, r.render_width, 3))
    if k1:
        scratch = torch.empty(16 << 20, dtype=torch.float32, device=r.device)  # 64 MB > the 50 MB L2
        check["k1_warm"] = device_ms(torch, lambda: present.tonemap_quantize(x), "present_kernel", 20,
                                     one_kernel=True)
        check["k1_cold"] = device_ms(torch, lambda: present.tonemap_quantize(x), "present_kernel", 20,
                                     flush=lambda: scratch.fill_(1.0), one_kernel=True)
        del scratch
        log(f"K1 present run {tag}: device time {check['k1_warm']:.4f} ms warm, "
            f"{check['k1_cold']:.4f} ms cold (profiler); bound {check['k1_bound_ms']:.4f} ms "
            f"({check['k1_bound_by']})")
    del x
    for attempt in range(3):
        line = FP.profile_frame(r, walls=walls)
        if line["traverse2_launches"] and line["traverse2_s"] > 0.0:
            return line
        log(json.dumps(dict(profiler_dropout=f"run {tag} frame", attempt=attempt + 1,
                            traversal_launches=line["traverse2_launches"],
                            device_events=line["device_events"])))
    raise AssertionError(f"{tag}: the profiled frames show no traversal device time")


def make_character(dev):
    """Phase D's scene: the character of frame_profile.character (66,049
    vertices, 131,072 triangles, 64 joints, the swing rig) over a floor,
    at 1024x576 with run C's settings. Returns the renderer and its rig."""
    from mrt_tpu_torch import Model, Renderer, Scene
    from mrt_tpu_torch.utils import frame_profile as FP

    t0 = time.perf_counter()
    mesh, skin = FP.character()
    scene = Scene(1024, 576)
    scene.models = [Model("character", mesh=mesh, position=[-0.5, 0.0, 1.0], skin=skin),
                    Model("plane", scale=10)]
    r = Renderer(scene, 1024, 576, seed=0, device=dev)
    FP.configure(r, motion_adaptive=True)
    log(f"phase D scene compile + BVH build: {time.perf_counter() - t0:.1f} s, "
        f"{mesh.positions.shape[0]} vertices, {r.statics.n_triangles} triangles, "
        f"{skin.rest_joints.shape[0]} joints, table {tuple(r.bvh.table.shape)}")
    return r, dict(scene="skinned cylinder 256x256 segments, 64 joints, swing rig, over a floor",
                   joint_indices=skin.joint_indices, joint_weights=skin.joint_weights)


def check_rig_files(paths, mesh, skin) -> dict:
    """Run H's load checks: each file written by frame_profile.write_character
    (centimetres) loaded through the port's loader, timed, and held to the
    rig in metres: triangle indices, joint indices and weights bit-equal,
    positions within 1e-6 after the unit change, joint matrices within
    1e-5 at t = 0, 0.37 and the clip's duration. Raises on a mismatch;
    returns per format its load seconds, bytes and errors."""
    import numpy as np

    from mrt_tpu_torch.assets import gltf, usd
    from mrt_tpu_torch.skinning import animation as anim

    d = np.diag([100.0, 100.0, 100.0, 1.0])
    out = {}
    for fmt, path in paths.items():
        t0 = time.perf_counter()
        m, si = (gltf.load_gltf if fmt == "glb" else usd.load_usd)(path)
        load_s = time.perf_counter() - t0
        equal = dict(indices=np.array_equal(m.submeshes[0].indices, mesh.submeshes[0].indices),
                     joint_indices=np.array_equal(si["joint_indices"], skin.joint_indices),
                     joint_weights=np.array_equal(si["joint_weights"], skin.joint_weights))
        pos_err = float(np.abs(m.positions.astype(np.float64) * 0.01 - mesh.positions).max())
        mat_err = max(float(np.abs(np.linalg.inv(d) @ anim.compute_joint_matrices(
            si["skeleton"], si["animation"], t) @ d - anim.compute_joint_matrices(
                skin.skeleton, skin.animation, t)).max())
            for t in (0.0, 0.37, skin.animation.duration))
        out[fmt] = dict(load_s=load_s, bytes=path.stat().st_size, equal=equal,
                        position_err=pos_err, joint_matrix_err=mat_err)
        log(f"run H load {fmt} ({path.name}, {out[fmt]['bytes']} bytes): {load_s:.2f} s; "
            f"bit-equal {equal}; positions within {pos_err:.2e} (limit 1e-6), joint matrices "
            f"within {mat_err:.2e} (limit 1e-5)")
        if not all(equal.values()) or pos_err > 1e-6 or mat_err > 1e-5:
            raise AssertionError(f"run H: the {fmt} file does not load back to the rig")
    return out


def check_small_h(dev, asset_dir):
    """Run H's scene at 48x48 (the robot from the crate) on the card against
    the CPU: two frames with run C's settings, the accumulation within 1e-2
    relative RMSE and rays equal per frame."""
    from mrt_tpu_torch import Renderer, make_app_scene
    from mrt_tpu_torch.utils import frame_profile as FP

    res = []
    for device in (dev, "cpu"):
        with FP.robot_asset(asset_dir):
            scene = make_app_scene(48, 48, include_robot=True, asset_models=False)
        r = Renderer(scene, 48, 48, seed=3, device=device)
        FP.configure(r, motion_adaptive=True)
        rays = []
        for _ in range(2):
            r.draw(1 / 60)
            rays.append(int(r.last_rays_traced))
        res.append((r.accum.cpu(), rays))
    (acc_g, rays_g), (acc_c, rays_c) = res
    rel = rel_rmse(acc_g, acc_c)
    log(f"small frame 48x48, run H's scene: card vs CPU relative RMSE {rel:.3e} in the "
        f"accumulation (limit 1e-2), rays {rays_g} vs {rays_c}")
    if not (rel < 1e-2 and rays_g == rays_c and min(rays_g) > 0):
        raise AssertionError("run H's 48x48 frame on the card disagrees with the CPU")
    return dict(rel_rmse=rel, rays_card=rays_g, rays_cpu=rays_c)


def checkpoint_phase(torch, FP, checkpoint, r, asset_dir, dev, path) -> dict:
    """Phase I: ``r`` (run H) draws 4 frames and is saved to ``path``; a
    fresh renderer over a fresh load of the file (another seed, so other
    offsets until the restore) restores it: accumulation, motion, depth and
    offsets bit-equal to the saved state, the same frame index; both draw 2
    more frames, their accumulations within 1e-6 absolute and their rays
    equal. Raises otherwise; returns the numbers."""
    for _ in range(4):
        r.draw(1 / 60)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save(r, path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    r2 = FP.make_renderer("H", dev, seed=1, asset_dir=asset_dir)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    checkpoint.restore(r2, path)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    state = ("accum", "motion", "depth", "offsets")
    restored = {k: bool(torch.equal(getattr(r, k).view(torch.int32), getattr(r2, k).view(torch.int32)))
                for k in state}
    restored["frame_index"] = r2.frame_index == r.frame_index
    errs, rays = [], []
    for _ in range(2):
        r.draw(1 / 60)
        r2.draw(1 / 60)
        errs.append(float((r.accum - r2.accum).abs().max()))
        rays.append((int(r.last_rays_traced), int(r2.last_rays_traced)))
    line = dict(phase="I", save_s=save_s, restore_s=restore_s, fresh_renderer_s=build_s,
                file_bytes=os.path.getsize(path), restored_bit_equal=restored,
                resumed_max_abs_err=errs, rays=rays, frame_index=r2.frame_index)
    log(json.dumps(line))
    if not all(restored.values()) or max(errs) > 1e-6 or any(a != b for a, b in rays):
        raise AssertionError(f"phase I: the resumed renderer does not follow the saved one: {line}")
    return line


REFIT_KEYS = ("refit_blas", "refit_flat", "refit_tlas")


def refit_counts(refit) -> dict:
    """K4's (by instantiation) and K5's launches since their counts were
    last set to 0."""
    return {"refit_blas": refit.rows_launches["blas"], "refit_flat": refit.rows_launches["flat"],
            "refit_tlas": refit.tlas_launches}


def build_counts(tag, refit, need) -> dict:
    """The launch counts of a BVH build (its refit: K4 and K5 since their
    counts were set to 0; no frame, so no K1, K2 or K3); raises when a
    kernel of ``need`` never launched."""
    c = {"present": 0, "traverse2": 0, "traverse_flat": 0, **refit_counts(refit)}
    if min(c[k] for k in need) < 1:
        raise AssertionError(f"{tag}: a refit kernel of the build never launched: {c}")
    log(f"{tag}: launches {json.dumps(c)}")
    return c


def max_abs_err(torch, a, b) -> float:
    """The largest |a - b| over the entries whose bits differ (inf where
    one is NaN); 0.0 when every bit agrees."""
    if a.numel() == 0:
        return 0.0
    same = a.contiguous().view(torch.int32) == b.contiguous().view(torch.int32)
    d = (a - b).abs().nan_to_num(nan=float("inf"))
    return float(torch.where(same, torch.zeros_like(d), d).max())


def rows_differing(torch, a, b) -> int:
    """Rows of ``a`` whose bits differ from ``b``'s (NaN compared by bits)."""
    if a.shape != b.shape:
        raise AssertionError(f"shapes differ: {tuple(a.shape)} against {tuple(b.shape)}")
    return int((a.contiguous().view(torch.int32) != b.contiguous().view(torch.int32))
               .reshape(a.shape[0], -1).any(dim=1).sum())


def device_names(torch, fn, reps: int, name: str) -> tuple[float, float, dict]:
    """(device ms per call, device events per call, {kernel name: [events,
    ms] per call}) of ``fn`` from torch.profiler over ``reps`` calls, each
    of which launches one kernel whose name holds ``name``: a session that
    saw fewer of them is logged and taken again, up to PROFILER_ATTEMPTS times."""
    for attempt in range(PROFILER_ATTEMPTS):
        ev = device_events(torch, profiled(torch, fn, reps)[0])
        found = sum(name in e.name for e in ev)
        if found == reps:
            break
        log_dropout(f"'{name}' x{reps}", attempt, found, ev)
    else:
        raise AssertionError(f"the profiler saw {found} '{name}' kernels in {reps} calls")
    names = {}
    for e in ev:
        n = names.setdefault(e.name[:80], [0.0, 0.0])
        n[0] += 1 / reps
        n[1] += e.time_range.elapsed_us() / 1e3 / reps
    return sum(e.time_range.elapsed_us() for e in ev) / 1e3 / reps, len(ev) / reps, names


def as_static(b):
    """The two-level BVH ``b`` with every mesh group static: a refit of it
    rewrites no BLAS, so its launch is one block that runs K5's work alone
    (as a moved static scene's refit)."""
    meta = b.refit_meta
    none = meta.skin_leaves[:0]
    return b._replace(mesh_meta=tuple(tuple(m[:8]) + (-1,) for m in b.mesh_meta),
                      refit_meta=dataclasses.replace(
                          meta, group_skinned=meta.group_skinned * 0, skin_leaves=none,
                          skin_unreached=none))


def refit_resources() -> dict:
    """K4's instantiations' registers, stack and spills as ``-Xptxas -v``
    printed them in this process's build (K5 runs inside ``blas``)."""
    from mrt_tpu_torch.kernels import build

    return {("blas" if "ILb1E" in k else "flat"): v for k, v in build.ptxas.items()
            if "refit_rows_kernel" in k}


def check_refit_events(tag, names: dict, events: float) -> None:
    """A two-level refit on the card is the table's copy and one launch of
    K4 with K5 (at most 3 device events): raise on a library call (the 3x3
    inverse is K5's own) or any other kernel."""
    other = [n for n in names if "refit_rows" not in n and "memcpy" not in n.lower()]
    if other or events > 3:
        raise AssertionError(f"{tag}: a two-level refit ran {events} device events, "
                             f"unexpected: {other} (all: {names})")


def check_twolevel_refit(torch, refit, bounds, tag, b, pos, M, group_indices=None,
                         timed: bool = True, time_k5: bool = False) -> dict:
    """One two-level refit (one launch: K4 ``blas``, K5 in its last block)
    held against the plain version on the same CUDA tensors: the whole
    table and the root boxes bit for bit (NaN by its bits); the same for
    K5's work alone (``as_static``: one block). ``timed``: per refit the
    device events by name and their ms (profiler, warm, 10 calls; raises
    on any but the copy and the launch), the CUDA-event ms, K4's launch
    beside the bound of its work and K5's (``bounds.refit``), the plain
    versions' CUDA-event ms, K5's bound and K4's registers and spills;
    ``time_k5``: also K5's one-block launch (profiler, warm, 30 calls: a
    longer profiler run, as short ones lost their device events). Raises on a
    difference; returns the numbers."""
    kt, kmin, kmax = refit.twolevel(b, pos, M, group_indices)
    pt, pmin, pmax = refit.twolevel_plain(b, pos, M, group_indices)
    bs = as_static(b)
    st, smin, smax = refit.twolevel(bs, pos, M)
    sp = refit.twolevel_plain(bs, pos, M)
    out = dict(rows=kt.shape[0], rows_differing=rows_differing(torch, kt, pt),
               roots_differing=rows_differing(torch, kmin, pmin) + rows_differing(torch, kmax, pmax),
               k5_alone_rows_differing=(rows_differing(torch, st, sp[0])
                                        + rows_differing(torch, smin, sp[1])
                                        + rows_differing(torch, smax, sp[2])),
               max_abs_err=max(max_abs_err(torch, kt, pt), max_abs_err(torch, kmin, pmin),
                               max_abs_err(torch, kmax, pmax), max_abs_err(torch, st, sp[0])),
               groups_refit=len(b.mesh_meta) if group_indices is not None else
               sum(m[8] >= 0 for m in b.mesh_meta),
               nan_rows=int(torch.isnan(kt[:, :48]).any(dim=1).sum()),
               nan_roots=int(torch.isnan(kmin).any(dim=1).sum()))
    del st, smin, smax, sp
    if timed:
        all_groups = group_indices is not None

        def call():
            return refit.twolevel(b, pos, M, group_indices)

        ms, events, names = device_names(torch, call, 10, "refit_rows")
        check_refit_events(tag, names, events)
        table, rbmin, rbmax = pt.clone(), pmin.clone(), pmax.clone()
        out.update(
            device_ms=ms, device_events=events, events_by_name=names,
            events_ms=cuda_ms(call, 20),
            k4_ms=sum(v[1] for n, v in names.items() if "refit_rows" in n),
            k4_plain_ms=cuda_ms(lambda: refit.blas_plain(table, rbmin, rbmax, b, pos, group_indices), 3),
            k5_plain_ms=cuda_ms(lambda: refit.tlas_plain(table, rbmin, rbmax, b, M), 3),
            resources=refit_resources()["blas"])
        out["k4_bound_ms"], out["k4_bound_by"] = bounds.refit(b, all_groups)
        out["k4_share"] = out["k4_bound_ms"] / out["k4_ms"]
        out["k5_bound_ms"], out["k5_bound_by"] = bounds.tlas_refit(b)
        if time_k5:
            out["k5_ms"] = device_ms(torch, lambda: refit.twolevel(bs, pos, M), "refit_rows", 30)
    log(f"K4 refit_rows (blas) with K5 refit_tlas, {tag}: {json.dumps(out)}")
    if out["rows_differing"] or out["roots_differing"] or out["k5_alone_rows_differing"]:
        raise AssertionError(f"{tag}: K4/K5 disagree with the plain refit on the card: {out}")
    return out


def check_character(torch, r, rig, refit, bounds, tag="phase D", time_k5=False):
    """The first skinned model of phase D (or of ``tag``): LBS on the card
    against float64 NumPy (positions within 1e-5 of the rig's extent, unit
    normals within 1e-5); the card's refit (K4 ``blas`` and K5) against the
    plain version on the card, the whole table and the root boxes bit for
    bit (``check_twolevel_refit``), and against the CPU's on the same posed
    vertices: the skinned BLAS rows and root boxes bit-equal, the other
    rows within 1e-6 (their bits differing printed: the instance rows' 3x3
    inverse is the same sequence of f32 operations on both). Each plain
    version's host time is printed. Returns the kernel check's numbers."""
    import numpy as np

    from mrt_tpu_torch.bvh import twolevel
    from mrt_tpu_torch.skinning import lbs

    sb, jm = r._skin_bundle[0], r._joint_matrices[0]
    pos, nrm = lbs.skin(sb.weights_dense, jm, sb.rest_positions, sb.rest_normals)
    rest, rest_n, jm_host = (x.cpu().numpy() for x in (sb.rest_positions, sb.rest_normals, jm))
    t0 = time.perf_counter()
    want_p, want_n = lbs_float64(rest, rest_n, rig["joint_indices"], rig["joint_weights"], jm_host)
    plain_lbs_ms = (time.perf_counter() - t0) * 1e3
    extent = float((rest.max(axis=0) - rest.min(axis=0)).max())
    err_p = float(np.abs(pos.cpu().numpy() - want_p).max())
    err_n = float(np.abs(nrm.cpu().numpy() - want_n).max())
    moved = float(np.abs(want_p - rest).max())
    log(f"{tag} LBS on the card vs float64 NumPy: max abs error {err_p:.3e} in positions "
        f"(limit {1e-5 * extent:.3e} = 1e-5 x the rig's extent {extent:.3f}), {err_n:.3e} in "
        f"normals (limit 1e-5); the pose moves vertices up to {moved:.4f}; float64 NumPy LBS "
        f"{plain_lbs_ms:.1f} ms on the host")
    if not (err_p <= 1e-5 * extent and err_n <= 1e-5 and moved > 0.0):
        raise AssertionError(f"{tag}: LBS on the card disagrees with the float64 reference")

    posed, M = r.scene_data.positions_obj, r.scene_data.instance_transform
    kernels = check_twolevel_refit(torch, refit, bounds, tag, r.bvh, posed, M, time_k5=time_k5)
    gpu = twolevel.refit(r.bvh, posed, M)
    bvh_c, posed_c, M_c = r.bvh.to("cpu"), posed.cpu(), M.cpu()
    t0 = time.perf_counter()
    cpu = twolevel.refit(bvh_c, posed_c, M_c)
    plain_refit_ms = (time.perf_counter() - t0) * 1e3
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
    log(f"{tag} refit on the card vs the CPU on the same posed vertices: {int(skinned.sum())} "
        f"skinned BLAS rows, {bad_skin} differ in their bits, root boxes {bad_roots}; the other "
        f"{int((~skinned).sum())} rows: {int(bits[~skinned].sum())} differ in their bits, "
        f"within 1e-6: {close}; the CPU's refit {plain_refit_ms:.1f} ms on the host")
    if bad_skin or bad_roots or not close:
        raise AssertionError(f"{tag}: the skinned refit on the card disagrees with the CPU")
    return dict(kernels, cpu_refit_ms=plain_refit_ms)


def check_refit_nan(torch, r, refit, bounds, tag="phase D"):
    """One refit of ``r``'s two-level BVH with a NaN in a real slot of its
    first skinned model's posed vertices (a y coordinate): K4 and K5
    against the plain version on the card, bit for bit, the NaN carried up
    to the group's root box and the TLAS as the plain version carries it."""
    posed = r.scene_data.positions_obj.clone()
    _, start, count = r.statics.skin_slices[0]
    posed[start + count // 3, 1] = float("nan")
    out = check_twolevel_refit(torch, refit, bounds, f"{tag} with a NaN vertex", r.bvh, posed,
                               r.scene_data.instance_transform, timed=False)
    if not (out["nan_roots"] and out["nan_rows"]):
        raise AssertionError(f"{tag}: the NaN vertex reached no root box or internal row: {out}")
    return out


def profile_prepare(torch, r, bounds):
    """Device time per animated frame of LBS (each skinned model) and of
    the refit (profiler, warm, 20 calls each: its device events per call by
    name, the copy and K4's launch with K5; raises on any other) and of the
    whole prepare stage; beside them the CUDA-event time of the same calls
    (which holds the host's launch gaps), the bounds and the refit's
    whole-table copy."""
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

    out["refit_ms"], out["refit_device_events"], names = device_names(torch, refit, 20, "refit_rows")
    check_refit_events("the prepare's refit", names, out["refit_device_events"])
    out["refit_events_by_name"] = names
    out["refit_k4_k5_ms"] = sum(v[1] for k, v in names.items() if "refit_rows" in k)
    out["refit_events_ms"] = cuda_ms(refit, 20)
    out["refit_bound_ms"], out["refit_bound_by"] = bounds.refit(r.bvh)
    out["prepare_ms"], out["prepare_device_events"] = device_total_ms(torch, r.prepare, 5)
    return out


E_MODES = ("spatial", "temporal", "denoised")
# the kernels a run-E present launches: spatial K12's uint8 form; temporal
# K12 and K11's uint8 form; denoised K9, K10 three times, K12 and K11's
# uint8 form; no standalone K1 (its profile may show one device event
# more, no more)
PRESENT_KERNELS = dict(spatial=1, temporal=2, denoised=6)


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


def stage_counts(W) -> dict:
    """K6-K8's launch counts and K7's by instantiation (``k7 <variant>``)."""
    return {**W.launches, **{f"k7 {k}": n for k, n in W.variant_launches.items()}}


def check_variants(tag, traverse2, want: str):
    """Only K2's ``want`` instantiation launched since the counts were last
    set to 0 (runs A-E: the packed one; F: masked; G: float sort)."""
    rose = {k: n for k, n in traverse2.variant_launches.items() if n}
    if set(rose) != {want}:
        raise AssertionError(f"run {tag}: K2 launched {rose}, expected only its {want} variant")
    return rose


def drive_e(torch, r, mode, present, traverse2, presenter, refit, timed=3):
    """Run E in one presenter mode, with the launch counters set to 0 first:
    a warm-up frame, ``timed`` orbit frames (orbit(0.02, 0), draw(1/30),
    present_device, as the reference's interactive drive) and ``timed``
    still frames (draw(1/60), present_device), each frame's wall between
    syncs. After each frame (untimed, launching neither kernel) the
    history lifecycle: in the stateful modes an orbit frame's new state is
    bit-equal to a history-free present's, a still frame's output differs
    from it. Returns (launch counts, the mode's line)."""
    from mrt_tpu_torch.kernels import presenter as PK
    from mrt_tpu_torch.kernels import wavefront as W

    r.upscaler_mode = mode
    present.launches = 0
    traverse2.reset_launches()
    refit.reset_launches()
    W.reset_launches()
    PK.reset_launches()
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
        main_path = dict(PK.launches)  # the lifecycle check's presents are not the main path's
        lin_f, hist_f, d_f = history_free(r, presenter)
        PK.launches.update(main_path)
        same = bits_equal(torch, r._upscale_history, hist_f)
        if mode == "denoised":
            same = same and all(bits_equal(torch, a, b) for a, b in zip(r._denoise_state, d_f))
        history_used.append(not same)
        if same != orbit:
            kind, how = ("orbit", "differs from") if orbit else ("still", "equals")
            raise AssertionError(f"run E {mode}, frame {i} ({kind}): the present {how} a "
                                 "history-free one")
    counts = {"present": present.launches, "traverse2": traverse2.launches, **refit_counts(refit),
              **stage_counts(W), **PK.launches}
    if min(counts[k] for k in ("traverse2", "refit_blas", "refit_tlas") + W.STAGES) < 1:
        raise AssertionError(f"run E {mode}: a kernel of the path never launched: {counts}")
    presents = 1 + 2 * timed
    # per present: spatial K12's uint8 form; temporal K12, K11's uint8 form;
    # denoised K9, K10 x 3, K12, K11's uint8 form; the kernel that ends the
    # chain tonemaps, so no present launches K1 itself
    want = dict(spatial=dict(resize_u8=presents),
                temporal=dict(resize=presents, temporal_resolve_u8=presents),
                denoised=dict(svgf_reproject=presents, atrous_pass=3 * presents, resize=presents,
                              temporal_resolve_u8=presents))[mode]
    if PK.launches != {k: want.get(k, 0) for k in PK.KERNELS} or counts["present"]:
        raise AssertionError(f"run E {mode}: K9-K12 launched {PK.launches} and K1 "
                             f"{counts['present']} times in {presents} presents, expected {want} "
                             "and no K1")
    variants = check_variants(f"E {mode}", traverse2, "packed")
    acc = r.accum
    if not bool(torch.isfinite(acc).all()) or float(acc.max()) <= 0.0:
        raise AssertionError(f"run E {mode}: accumulation is not finite or is all black")
    if img.shape != (r.output_height, r.output_width, 3) or img.dtype != torch.uint8:
        raise AssertionError(f"run E {mode}: image {tuple(img.shape)} {img.dtype}")
    line = dict(run="E", mode=mode, route="kernel",
                output=[r.output_width, r.output_height],
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
    uint8-equal to its plain version on the card's linear output. Then the
    main path's own present, ``r.present_device()`` (the chain's uint8
    form): byte-equal to K1 on the card's linear output, within 1 LSB of the
    CPU's, and the state it hands the renderer bit-equal to the linear
    chain's (the renderer's state is put back after). Returns (numbers, the
    card's linear output)."""
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
    want_c = present.tonemap_quantize_plain(lin_c).int()
    lsb = int((k1.cpu().int() - want_c).abs().max())
    saved = (r._upscale_history, r._denoise_state)
    try:
        img = r.present_device()
        hist_ok = hist_g is None or bits_equal(torch, r._upscale_history, hist_g)
        d_ok = d_g is None or all(bits_equal(torch, a, b) for a, b in zip(r._denoise_state, d_g))
        fused = dict(vs_k1=int((img != k1).sum()), lsb=int((img.cpu().int() - want_c).abs().max()),
                     state_bit_equal=hist_ok and d_ok)
    finally:
        object.__setattr__(r, "_upscale_history", saved[0])
        object.__setattr__(r, "_denoise_state", saved[1])
    errs = dict(linear=rel_rmse(lin_g, lin_c))
    if hist_g is not None:
        errs["history"] = rel_rmse(hist_g, hist_c)
    if d_g is not None:
        errs.update({f"denoise_{f}": rel_rmse(a, b) for f, a, b in zip(d_g._fields, d_g, d_c)})
    out = dict(card_vs_cpu_rel_rmse=errs, card_vs_cpu_lsb=lsb, cpu_present_s=cpu_s,
               k1_shape=list(x.shape), k1_mismatches=k1_bad, present_device=fused)
    if k1_bad:
        raise AssertionError(f"run E {r.upscaler_mode}: K1 disagrees with its plain version")
    if fused["vs_k1"] or fused["lsb"] > 1 or not fused["state_bit_equal"]:
        raise AssertionError(f"run E {r.upscaler_mode}: present_device disagrees with K1 on the "
                             f"linear chain or with the CPU, or hands over another state: {fused}")
    if lsb > 1 or max(errs.values()) > 1e-5:
        raise AssertionError(f"run E {r.upscaler_mode}: the card's present disagrees with the "
                             f"CPU's: {out}")
    return out, x


# phase 3p: a float output of K9-K12 that is not bit-equal to its plain
# version is printed, and fails the run beyond this relative RMSE
PRESENTER_REL_TOL = 1e-5
# and K12 against the dense torch.mm products over the same weights (the
# products add in another order): the largest difference over the largest
# value
RESIZE_DENSE_TOL = 1e-5


def presenter_fields(torch, names, k, p) -> dict:
    """Each output of a presenter kernel against its plain version: elements
    differing and, where some do, the largest ULP, the largest absolute
    error and the relative RMSE."""
    out = {}
    for name, a, b in zip(names, k, p):
        b = b.contiguous()
        bad = a.view(torch.int32) != b.view(torch.int32)
        d = dict(elements=a.numel(), differing=int(bad.sum()))
        if d["differing"]:
            d["max_ulp"] = int((ordered_bits(torch, a[bad]) - ordered_bits(torch, b[bad]))
                               .abs().max())
            d["max_abs"] = float((a[bad] - b[bad]).abs().nan_to_num(float("inf")).max())
            d["rel_rmse"] = rel_rmse(a, b)
        out[name] = d
    return out


def synthetic_presenter_inputs(torch, dev, h=1080, w=1920, seed=0) -> dict:
    """A denoised frame at (h, w) made from ``seed`` that reaches the
    presenter kernels' edges: a tenth of the pixels with zero albedo, a
    depth jump (a block at 3x the depth, and the state's depth 40 % off on
    another), a band of motion that leaves the image (up to 2w px) beside
    motion within 2 px, history lengths 0-32 (a quarter at 32), and an
    output-size history of (2h, 2w)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    n = torch.randn((h, w, 3), generator=g, device=dev)
    n[..., 1] += 3.0
    n = n / n.norm(dim=-1, keepdim=True)
    depth = 1.0 + 0.01 * rand(h, w)
    depth[h // 4:h // 2, w // 4:w // 2] = 3.0
    motion = (rand(h, w, 2) - 0.5) * 4.0
    motion[h // 2:h // 2 + h // 8] = (rand(h // 8, w, 2) - 0.5) * 4.0 * w
    gb = dict(diffuse_albedo=rand(h, w, 3) * 0.8 * (rand(h, w, 1) > 0.1),
              specular_albedo=rand(h, w, 3) * 0.1 * (rand(h, w, 1) > 0.5),
              normal=n * 0.5 + 0.5)
    s_depth = depth.clone()
    s_depth[h // 8:h // 4] *= 1.4
    lengths = torch.floor(rand(h, w) * 33.0)
    lengths[: h // 4] = 32.0
    m1 = rand(h, w)
    state = (rand(h, w, 3) * 2.0, m1, m1 * m1 + 0.1 * rand(h, w), lengths, s_depth, n.clone())
    history = torch.cat([rand(2 * h, 2 * w, 3), 1.0 + 0.02 * rand(2 * h, 2 * w, 1)], dim=-1)
    return dict(color=rand(h, w, 3) * 2.0, gb=gb, depth=depth, motion=motion, state=state,
                history=history, weights=(0.0, 0.9), out=(2 * h, 2 * w))


def check_presenter(torch, tag, inp, present, bounds, timed: bool = False,
                    sass_tap: dict | None = None) -> dict:
    """Phase 3p on ``inp`` (run E's buffers or ``synthetic_presenter_inputs``):
    K9, K10 at each step, K12 in both of its forms on the path (the spatial
    chain's Lanczos-3 of the colour with the clamp; the bilinear of colour,
    depth and motion read where they lie, on the temporal chain's colour
    and the denoised chain's) and K11 on both chains (on the resize's plain
    output) at each history weight, each against its plain version on the
    card on the same inputs, K12 also against the dense ``torch.mm``
    products over the same weights (``spatial.resize_dense``, the port's
    resize before K12) within RESIZE_DENSE_TOL of the largest value (the
    path's forms asserted to take the strip form), and at a 64x downscale
    (hundreds of taps, the 32x32 tiles staged in chunks) too; the
    denoised chain through the kernels (``svgf_filter``,
    ``temporal_upscale``) against the plain stages composed; K1's bytes;
    the uint8 forms of K12 (the spatial chain's, in its strip form, and
    the 64x downscale of the colour in the 32x32 tiles) and K11 (both
    chains, each weight) byte for byte against K1 on the same f32 kernel's
    output and against ``tonemap_quantize_plain`` of the plain version,
    K11's new history bit for bit against its f32 form's (under "u8").
    With ``timed``, each kernel's and plain version's CUDA-event ms over 5
    calls and its bound (K10's also the time its instructions would take
    at the peak rate with a tap counted as ``sass_tap[step]``, the built
    kernel's SASS count, where given: a diagnostic, not a bound); K12's
    also the dense products' and, for the bilinear,
    ``torch.nn.functional.interpolate``'s (the same function on an NCHW
    copy, ``library_ms``); the uint8 forms' too. Raises beyond
    PRESENTER_REL_TOL or RESIZE_DENSE_TOL, or on a K1 byte or a uint8
    form's byte or history bit."""
    import torch.nn.functional as F

    from mrt_tpu_torch.kernels import presenter as PK
    from mrt_tpu_torch.upscale import denoise, spatial, temporal

    gb, depth, motion = inp["gb"], inp["depth"], inp["motion"]
    h, w = depth.shape
    dev = depth.device
    oh, ow = inp["out"]
    state = denoise.DenoiseState(*inp["state"])
    ins = (inp["color"], gb["diffuse_albedo"], gb["specular_albedo"], gb["normal"], depth, motion)
    names9 = ("demod", "m1", "m2", "history_length", "normal", "var", "lum")
    out, times, dense = {}, {}, {}

    def timing(key, fk, fp, bound):
        if timed:
            times[key] = dict(ms=cuda_ms(fk, 5), plain_ms=cuda_ms(fp, 5), bound_ms=bound[0],
                              bound_by=bound[1])

    k9 = PK.svgf_reproject(*ins, state)
    p9 = PK.svgf_reproject_plain(*ins, state)
    out["svgf_reproject"] = presenter_fields(torch, names9, k9, p9)
    timing("svgf_reproject", lambda: PK.svgf_reproject(*ins, state),
           lambda: PK.svgf_reproject_plain(*ins, state), bounds.svgf_reproject(h, w))
    demod, _, _, _, normal, var, lum = p9
    filt, fvar, flum = demod, var, lum
    for step in PK.ATROUS_STEPS:
        last = step == PK.ATROUS_STEPS[-1]
        remod = (gb["diffuse_albedo"], gb["specular_albedo"]) if last else ()
        a = (filt, fvar, flum, normal, depth, step, *remod)
        k10, p10 = PK.atrous_pass(*a), PK.atrous_pass_plain(*a)
        key = f"atrous_pass step {step}"
        out[key] = (presenter_fields(torch, ("colour",), (k10,), (p10,)) if last else
                    presenter_fields(torch, ("filtered", "var", "lum"), k10, p10))
        timing(key, lambda: PK.atrous_pass(*a), lambda: PK.atrous_pass_plain(*a),
               bounds.atrous_pass(h, w, last))
        if timed and sass_tap:
            times[key]["sass_count_ms"] = bounds.atrous_pass(h, w, last, sass_tap[step])[0]
        if not last:
            filt, fvar, flum = p10
    denoised = p10

    def check_resize(key, sources, method, clamp, size=(oh, ow), timed=timed, strip=True):
        tables = (spatial.band_table(h, size[0], method, dev),
                  spatial.band_table(w, size[1], method, dev))
        strip_form(PK, sources, tables, f"{tag}: {key}", strip)
        k12, p12 = PK.resize(sources, *tables, clamp), PK.resize_plain(sources, *tables, clamp)
        out[key] = presenter_fields(torch, ("output",), (k12,), (p12,))
        x = torch.cat([t.reshape(h, w, -1) for t in sources], dim=-1)
        ref = spatial.resize_dense(x, *size, method)
        ref = torch.clamp_min(ref, 0.0) if clamp else ref
        dense[key] = float((k12 - ref).abs().max() / ref.abs().max())
        if timed:
            kr, kc = (t.weights.shape[1] for t in tables)
            timing(key, lambda: PK.resize(sources, *tables, clamp),
                   lambda: PK.resize_plain(sources, *tables, clamp),
                   bounds.resize(h, w, *size, x.shape[-1], kr, kc))
            times[key].update(taps=[kr, kc], dense_ms=cuda_ms(
                lambda: spatial.resize_dense(x, *size, method), 5), library_ms=None)
            if method == "bilinear":
                nchw = x.permute(2, 0, 1)[None].contiguous()

                def interp():
                    return F.interpolate(nchw, size=size, mode="bilinear", align_corners=False)

                lib = interp()[0].permute(1, 2, 0)
                times[key].update(library_ms=cuda_ms(interp, 5), library_call=(
                    "torch.nn.functional.interpolate(mode='bilinear', align_corners=False)"),
                    library_max_rel_err=float((lib - k12).abs().max() / k12.abs().max()))
        return p12

    check_resize("resize lanczos3 3ch clamped", (inp["color"],), "lanczos3", True)
    # a 64x downscale off the path: hundreds of taps, a tile's inputs staged
    # in chunks of rows and of columns
    check_resize("resize lanczos3 6ch downscale", (inp["color"], depth, motion), "lanczos3",
                 False, (h // 64 + 1, w // 64 + 1), timed=False, strip=False)
    k1_bad = 0
    for chain, colour in (("temporal", inp["color"]), ("denoised", denoised)):
        up = check_resize(f"resize bilinear 6ch {chain}", (colour, depth, motion), "bilinear",
                          False)
        for hw in inp["weights"]:
            a = (up, inp["history"], hw, ow / w, oh / h)
            k11, p11 = PK.temporal_resolve(*a), PK.temporal_resolve_plain(*a)
            key = f"temporal_resolve {chain} weight {hw}"
            out[key] = presenter_fields(torch, ("output", "history"), k11, p11)
            k1_bad += int((present.tonemap_quantize(k11[0])
                           != present.tonemap_quantize_plain(k11[0])).sum())
        timing(f"temporal_resolve {chain}", lambda: PK.temporal_resolve(*a),
               lambda: PK.temporal_resolve_plain(*a), bounds.temporal_resolve(oh, ow))
    # the denoised chain end to end: the kernels against the plain stages
    hw = inp["weights"][-1]
    den_k, st_k = denoise.svgf_filter(inp["color"], gb, depth, motion, state)
    lin_k, hist_k = temporal.temporal_upscale(den_k, depth, motion, inp["history"], oh, ow, hw)
    bl = (spatial.band_table(h, oh, "bilinear", dev), spatial.band_table(w, ow, "bilinear", dev))
    lin_p, hist_p = PK.temporal_resolve_plain(PK.resize_plain((denoised, depth, motion), *bl),
                                              inp["history"], hw, ow / w, oh / h)
    out["denoised chain"] = presenter_fields(
        torch, ("denoised", "linear", "history", *names9[:5]),
        (den_k, lin_k, hist_k, *st_k[:4], st_k.normal), (denoised, lin_p, hist_p, *p9[:5]))
    k1_chain = int((present.tonemap_quantize(lin_k.contiguous())
                    != present.tonemap_quantize_plain(lin_p)).sum())

    # the uint8 forms, which end the upscaled presents
    u8 = {}

    def check_u8(key, k8, kf, pf):
        """K12's or K11's uint8 output ``k8`` against K1 on the f32 form's
        output ``kf`` and K1's plain version of the plain version's ``pf``."""
        u8[key] = d = dict(values=k8.numel())
        for ref, q in (("k1", present.tonemap_quantize(kf.contiguous())),
                       ("plain", present.tonemap_quantize_plain(pf))):
            d[f"vs_{ref}"] = int((k8 != q).sum())
            d[f"vs_{ref}_max_abs"] = int((k8.int() - q.int()).abs().max())

    for key, size, strip in (("resize_u8 lanczos3 3ch clamped", (oh, ow), True),
                             ("resize_u8 lanczos3 3ch downscale", (h // 64 + 1, w // 64 + 1),
                              False)):
        src = (inp["color"],)
        tables = (spatial.band_table(h, size[0], "lanczos3", dev),
                  spatial.band_table(w, size[1], "lanczos3", dev))
        strip_form(PK, src, tables, f"{tag}: {key}", strip)
        check_u8(key, PK.resize(src, *tables, True, True), PK.resize(src, *tables, True),
                 PK.resize_plain(src, *tables, True))
        if strip:
            timing(key, lambda: PK.resize(src, *tables, True, True),
                   lambda: present.tonemap_quantize_plain(PK.resize_plain(src, *tables, True)),
                   bounds.resize(h, w, *size, 3, *(t.weights.shape[1] for t in tables), True))
    for chain, colour in (("temporal", inp["color"]), ("denoised", denoised)):
        up = PK.resize_plain((colour, depth, motion), *bl)
        for hw in inp["weights"]:
            a = (up, inp["history"], hw, ow / w, oh / h)
            key = f"temporal_resolve_u8 {chain} weight {hw}"
            (k8, hist8), (kf, histf) = PK.temporal_resolve(*a, quantize=True), PK.temporal_resolve(*a)
            check_u8(key, k8, kf, PK.temporal_resolve_plain(*a)[0])
            u8[key]["history_differing"] = int((hist8.view(torch.int32)
                                                != histf.view(torch.int32)).sum())
        timing(f"temporal_resolve_u8 {chain}", lambda: PK.temporal_resolve(*a, quantize=True),
               lambda: present.tonemap_quantize_plain(PK.temporal_resolve_plain(*a)[0]),
               bounds.temporal_resolve(oh, ow, True))
    u8_bad = {k: d for k, d in u8.items()
              if d["vs_k1"] or d["vs_plain"] or d.get("history_differing")}
    not_bit_equal = {k: {f: d for f, d in v.items() if d["differing"]} for k, v in out.items()}
    not_bit_equal = {k: v for k, v in not_bit_equal.items() if v}
    worst = max([d["rel_rmse"] for v in not_bit_equal.values() for d in v.values()] + [0.0])
    line = dict(phase="3p", run=tag, render=[w, h], output=[ow, oh], fields=out,
                not_bit_equal=not_bit_equal, max_rel_rmse=worst, k1_mismatches=k1_bad,
                k1_chain_mismatches=k1_chain, resize_vs_dense=dense, u8=u8, times=times, **CARD)
    log(json.dumps(line))
    if (worst > PRESENTER_REL_TOL or k1_bad or k1_chain or u8_bad
            or not max(dense.values()) <= RESIZE_DENSE_TOL):
        raise AssertionError(f"phase 3p run {tag}: a presenter kernel disagrees with its plain "
                             f"version: {not_bit_equal}, K1 {k1_bad}/{k1_chain} bytes, a uint8 "
                             f"form {u8_bad}, or K12 with the dense products: {dense}")
    return line


def atrous_zero_share(torch, a) -> dict:
    """Of a K10 pass's taps (``a``: its arguments), the shares whose luma
    and depth differences from the centre are exactly 0 (edges clamped):
    the taps that skip a division and an ``expf`` (atrous_falloff)."""
    from mrt_tpu_torch.kernels import presenter as PK

    _, _, lum, _, depth, step = a[:6]
    pad = 2 * step
    h, w = lum.shape
    out = {}
    for name, x in (("lum", lum), ("depth", depth)):
        xp = PK.edge_pad(x, pad)
        zero = sum(float((xp[pad + (i - 2) * step:][:h, pad + (j - 2) * step:][:, :w] == x)
                         .float().mean()) for i in range(5) for j in range(5))
        out[name] = zero / 25
    return out


def profile_e(torch, FP, r, present, bounds, x4k, walls, sass_tap):
    """Run E under the profiler, after every run's timed frames: per mode,
    one more frame, one frame (draw and present) profiled as runs A-C are
    (its idle share against the median of the mode's still frame walls,
    ``walls``), then the present's device time and events (5 calls) and
    its costliest operators (a session that saw fewer device events than
    PRESENT_KERNELS is taken again; more than one beyond them raises); on the
    denoised buffers the denoiser's device time beside its bound, and K9's,
    each K10 pass's (with the share of its taps whose differences are
    exactly 0, and the time at peak of its SASS count, ``sass_tap``),
    K12's (the spatial chain's uint8 form and the bilinear) and K11's (its
    uint8 form) per launch beside theirs, as the presents launch them; each present's bound
    (``bounds.present``) beside the f32 chain's with K1 that it replaced;
    K1 at the output shape, warm and after a 64 MB write (cold), beside its
    CUDA-event and plain times."""
    from mrt_tpu_torch.kernels import presenter as PK
    from mrt_tpu_torch.upscale import denoise, spatial

    h, w, oh, ow = r.render_height, r.render_width, r.output_height, r.output_width
    out = {}
    for mode in E_MODES:
        r.upscaler_mode = mode
        r.draw(1 / 60)
        r.present_device()
        out[f"frame_{mode}"] = FP.profile_frame(r, walls=walls[mode])
        ms, ev = device_total_ms(torch, r.present_device, 5, least=PRESENT_KERNELS[mode])
        out[f"present_{mode}"] = dict(ms=ms, device_events=ev,
                                      top_ops_ms=device_ops(torch, r.present_device, 3))
        if ev > PRESENT_KERNELS[mode] + 1:
            raise AssertionError(f"run E {mode}: a present took {ev} device events, more than "
                                 f"{PRESENT_KERNELS[mode] + 1}: {out[f'present_{mode}']}")
    dstate, gb = r._denoise_state, r.gbuffer
    ms, ev = device_total_ms(
        torch, lambda: denoise.svgf_filter(r.accum, gb, r.depth, r.motion, dstate), 5)
    bound = bounds.denoiser(h, w)
    out["denoiser"] = dict(ms=ms, device_events=ev, bound_ms=bound[0], bound_by=bound[1])
    # K9, each K10 pass, K12 and K11 per launch, on the denoised buffers
    ins = tuple(t.contiguous() for t in (r.accum, gb["diffuse_albedo"], gb["specular_albedo"],
                                           gb["normal"], r.depth, r.motion))
    demod, _, _, _, normal, var, lum = PK.svgf_reproject(*ins, dstate)
    ms = device_ms(torch, lambda: PK.svgf_reproject(*ins, dstate), "svgf_reproject", 5,
                   one_kernel=True)
    out["k9_svgf_reproject"] = dict(ms=ms, bound=bounds.svgf_reproject(h, w))
    filt, fvar, flum = demod, var, lum
    for step in PK.ATROUS_STEPS:
        last = step == PK.ATROUS_STEPS[-1]
        a = (filt, fvar, flum, normal, ins[4], step, *((ins[1], ins[2]) if last else ()))
        ms = device_ms(torch, lambda: PK.atrous_pass(*a), "atrous_pass", 5, one_kernel=True)
        out[f"k10_atrous_pass_step_{step}"] = dict(ms=ms, bound=bounds.atrous_pass(h, w, last),
                                                   sass_count=bounds.atrous_pass(
                                                       h, w, last, sass_tap[step]),
                                                   zero_share=atrous_zero_share(torch, a))
        if not last:
            filt, fvar, flum = PK.atrous_pass(*a)
    # each launch as the presents make it: the spatial chain's Lanczos-3 and
    # K11 in their uint8 forms
    for key, sources, method, clamp, q in (
            ("k12_resize_lanczos3_3ch_u8", (ins[0],), "lanczos3", True, True),
            ("k12_resize_bilinear_6ch", (ins[0], ins[4], ins[5]), "bilinear", False, False)):
        tables = (spatial.band_table(h, oh, method, r.device),
                  spatial.band_table(w, ow, method, r.device))
        strip_form(PK, sources, tables, key)
        ms = device_ms(torch, lambda: PK.resize(sources, *tables, clamp, q),
                       "resize_strip_u8_kernel" if q else "resize_strip_kernel", 5,
                       one_kernel=True)
        channels = sum(t.shape[2] if t.dim() == 3 else 1 for t in sources)
        out[key] = dict(ms=ms, bound=bounds.resize(h, w, oh, ow, channels,
                                                   tables[0].weights.shape[1],
                                                   tables[1].weights.shape[1], q))
    up = spatial.resize((ins[0], ins[4], ins[5]), oh, ow, "bilinear")
    hist = r._upscale_history
    ms = device_ms(torch, lambda: PK.temporal_resolve(up, hist, 0.9, ow / w, oh / h, True),
                   "temporal_resolve_u8", 5, one_kernel=True)
    out["k11_temporal_resolve_u8"] = dict(ms=ms, bound=bounds.temporal_resolve(oh, ow, True))
    out["present_bounds_ms"] = {mode: dict(present=bounds.present(mode, h, w, oh, ow)[0],
                                           f32_chain_and_k1=bounds.present(mode, h, w, oh, ow,
                                                                           fused=False)[0])
                                for mode in E_MODES}
    scratch = torch.empty(16 << 20, dtype=torch.float32, device=r.device)  # 64 MB > the 50 MB L2
    k1 = dict(ms_warm=device_ms(torch, lambda: present.tonemap_quantize(x4k), "present_kernel", 20,
                                one_kernel=True),
              ms_cold=device_ms(torch, lambda: present.tonemap_quantize(x4k), "present_kernel", 20,
                                flush=lambda: scratch.fill_(1.0), one_kernel=True),
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
    the sphere moves after a first frame). Per case the accumulation, rays,
    and the K6-K8 and K7 instantiation launches of its frames."""
    from mrt_tpu_torch import Model, Renderer, Scene
    from mrt_tpu_torch.assets import procedural
    from mrt_tpu_torch.assets.obj import MaterialDef
    from mrt_tpu_torch.core import types as T
    from mrt_tpu_torch.kernels import wavefront as W
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
        W.reset_launches()
        for _ in range(n):
            r.draw()
        out[name] = (r.accum.cpu(), int(r.last_rays_traced),
                     dict(stage_counts(W),
                          k7_variant=W.K7_VARIANTS[W.k7_variant(r.settings(), r.statics)]))

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
    """Phase 8's extras: the textured frames on the card, each on the kernel
    route (K6 and K7's instantiation for its settings launched, only it),
    against the CPU plain path, the accumulation within 1e-2 relative RMSE
    and rays within 1 %."""
    small_g, small_c = small_extras(dev), small_extras("cpu")
    for case, (acc_g, rays_g, k) in small_g.items():
        acc_c, rays_c, _ = small_c[case]
        rel = rel_rmse(acc_g, acc_c)
        log(f"small frame 48x48, {case}: card vs CPU relative RMSE {rel:.3e} in the accumulation "
            f"(limit 1e-2), rays {rays_g} vs {rays_c}; K7 {k['k7_variant']} launched "
            f"{k['k7 ' + k['k7_variant']]} of {k['shade_hit']}, K6 {k['sample_start']}")
        if not (rel < 1e-2 and rays_g > 0 and abs(rays_g - rays_c) <= 0.01 * rays_c):
            raise AssertionError(f"the card's frame disagrees with the CPU reference ({case})")
        if (k["sample_start"] < 1 or k["shade_hit"] < 1
                or k["k7 " + k["k7_variant"]] != k["shade_hit"]):
            raise AssertionError(f"small frame 48x48, {case}: off the kernel route or another K7 "
                                 f"instantiation launched: {k}")


def drive_debug(torch, tag, r, mode, present, traverse2, variant, frames=1):
    """``frames`` frames of debug view ``mode`` on run ``tag``'s renderer
    with the launch counters set to 0 first (the last frame's wall between
    syncs): the accumulation finite and, but for the metallic and emission
    views, not all black, K1 and only K2's ``variant`` launched, K6 and
    K7's debug instantiation for the scene on the kernel route and no K8 (a
    debug view casts no shadow ray); then the beauty view again. Returns its
    line."""
    from mrt_tpu_torch.core import types as T
    from mrt_tpu_torch.kernels import wavefront as W

    r.debug_texture_mode = mode
    present.launches = 0
    traverse2.reset_launches()
    W.reset_launches()
    for _ in range(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.draw(1 / 60)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    img = r.output_image()
    acc = r.accum
    k7_variant = W.K7_VARIANTS[W.k7_variant(r.settings(), r.statics)]
    counts = {"present": present.launches, "traverse2": traverse2.launches, **stage_counts(W)}
    line = dict(run=tag, debug_mode=mode, frames=frames, frame_wall=wall,
                rays=int(r.last_rays_traced), launches=counts,
                k7_variant=k7_variant,
                k2_variants=check_variants(f"{tag} debug {mode}", traverse2, variant),
                accum_mean=[float(x) for x in acc.mean(dim=(0, 1))],
                accum_max=[float(x) for x in acc.amax(dim=(0, 1))], image_mean=float(img.mean()))
    # the metallic and emission views are black where no material is
    # metallic or emissive (runs A-C's scene)
    black_ok = mode in (T.DEBUG_MODE_METALLIC, T.DEBUG_MODE_EMISSION)
    if (not bool(torch.isfinite(acc).all()) or (float(acc.max()) <= 0.0 and not black_ok)
            or min(counts[k] for k in ("present", "traverse2", "sample_start", "shade_hit")) < 1
            or counts["resolve_shadow"] or not k7_variant.endswith("debug")
            or counts[f"k7 {k7_variant}"] != counts["shade_hit"]):
        raise AssertionError(f"run {tag}, debug view {mode}: {line}")
    r.debug_texture_mode = 0
    return line


def check_flat_refit(torch, r, tag, refit, bounds, cpu: bool = True):
    """Run ``tag``'s flat table refit (this frame's prepare stage, kernel K4
    ``flat``) against its plain version on the card on the same posed
    world-space triangles, every row bit for bit, with K4's device time
    (profiler, warm, 10 calls), the plain version's (CUDA events) and the
    bound; with ``cpu``, also against the CPU's refit. Returns the numbers;
    raises on a difference."""
    from mrt_tpu_torch.bvh import wide

    _, geom, gpu = r.prepare()
    tris = (geom.tri_v0, geom.tri_v1, geom.tri_v2)
    plain = refit.flat_plain(r.bvh, *tris)
    bound_ms, bound_by = bounds.flat_refit(r.bvh)
    out = dict(rows=gpu.n_rows, unreached_rows=int(r.bvh.walkup.unreached.numel()),
               rows_differing_plain=rows_differing(torch, gpu.table, plain),
               max_abs_err=max_abs_err(torch, gpu.table, plain),
               k4_ms=device_ms(torch, lambda: wide.refit(r.bvh, *tris), "refit_rows", 10),
               k4_plain_ms=cuda_ms(lambda: refit.flat_plain(r.bvh, *tris), 3),
               k4_bound_ms=bound_ms, k4_bound_by=bound_by,
               events_ms=cuda_ms(lambda: wide.refit(r.bvh, *tris), 20))
    if cpu:
        t0 = time.perf_counter()
        ct = wide.refit(r.bvh.to("cpu"), *(t.cpu() for t in tris)).table
        out["cpu_refit_ms"] = (time.perf_counter() - t0) * 1e3
        out["rows_differing_cpu"] = rows_differing(torch, gpu.table.cpu(), ct)
    log(f"K4 refit_rows (flat), run {tag}, on the same posed triangles: {json.dumps(out)}")
    if out["rows_differing_plain"] or out.get("rows_differing_cpu"):
        raise AssertionError(f"run {tag}: the flat refit on the card disagrees: {out}")
    return out


def check_small_flat(dev):
    """Run J's scene at 48x48 (the app scene with the robot, run C's
    settings, two_level=False) on the card against the CPU: two frames, the
    accumulation within 1e-2 relative RMSE and rays equal per frame."""
    from mrt_tpu_torch import Renderer, make_app_scene
    from mrt_tpu_torch.bvh import wide
    from mrt_tpu_torch.utils import frame_profile as FP

    res = []
    for device in (dev, "cpu"):
        scene = make_app_scene(48, 48, include_robot=True, asset_models=False)
        r = Renderer(scene, 48, 48, seed=3, device=device)
        r.two_level = False
        FP.configure(r, motion_adaptive=True)
        if not isinstance(r.bvh, wide.WideBVH):
            raise AssertionError("run J's 48x48 renderer holds no flat BVH")
        rays = []
        for _ in range(2):
            r.draw(1 / 60)
            rays.append(int(r.last_rays_traced))
        res.append((r.accum.cpu(), rays))
    (acc_g, rays_g), (acc_c, rays_c) = res
    rel = rel_rmse(acc_g, acc_c)
    log(f"small frame 48x48, run J's scene (flat BVH): card vs CPU relative RMSE {rel:.3e} in "
        f"the accumulation (limit 1e-2), rays {rays_g} vs {rays_c}")
    if not (rel < 1e-2 and rays_g == rays_c and min(rays_g) > 0):
        raise AssertionError("run J's 48x48 flat frame on the card disagrees with the CPU")
    return dict(rel_rmse=rel, rays_card=rays_g, rays_cpu=rays_c)


def group_indices(torch, r, device):
    """One (Tm,3) local index tensor per mesh group of ``r``'s two-level BVH
    (the mesh of the group's first instance), as its build refits them."""
    import numpy as np

    first = {}
    for i, g in enumerate(r.bvh.inst_mesh):
        first.setdefault(g, i)
    return tuple(torch.as_tensor(np.concatenate(
        [s.indices.reshape(-1, 3) for s in r.scene.models[first[g]].mesh.submeshes]
    ).astype(np.int32)).to(device) for g in range(len(r.bvh.mesh_meta)))


def check_sbvh_refit(torch, r, refit, bounds):
    """Phase K: the SBVH table's full refit (every BLAS, its leaf boxes
    clamped by the clip boxes): K4 ``blas`` and K5 against the plain
    version on the card, bit for bit, with its device events and times
    (``check_twolevel_refit``); the card against the CPU on the same
    vertices: the BLAS rows and root boxes bit-equal, the TLAS and instance
    rows within 1e-6; the card's refit equal to the build's table; and the clamp
    binding: rows that an unclipped refit writes otherwise. Returns the
    numbers; raises on a difference."""
    from mrt_tpu_torch.bvh import twolevel

    b = r.bvh
    if b.leaf_clip is None:
        raise AssertionError("phase K: MRT_SBVH=1 built no clip boxes")
    pos, M = r.scene_data.positions_obj, r.scene_data.instance_transform
    kernels = check_twolevel_refit(torch, refit, bounds, "phase K (every group, clipped)", b, pos, M,
                                   group_indices(torch, r, pos.device))
    gpu = twolevel.refit(b, pos, M, group_indices=group_indices(torch, r, pos.device))
    t0 = time.perf_counter()
    cpu = twolevel.refit(b.to("cpu"), pos.cpu(), M.cpu(), group_indices=group_indices(torch, r, "cpu"))
    cpu_ms = (time.perf_counter() - t0) * 1e3
    unclipped = twolevel.refit(b._replace(leaf_clip=None), pos, M,
                               group_indices=group_indices(torch, r, pos.device))
    gt, ct = gpu.table.cpu(), cpu.table
    blas = slice(b.tlas_n, b.n_internal + b.n_leaf)
    bits = (gt.view(torch.int32) != ct.view(torch.int32)).any(dim=1)
    bad_blas = int(bits[blas].sum())
    bad_roots = int((gpu.root_bmin.cpu().view(torch.int32) != cpu.root_bmin.view(torch.int32)).sum()
                    + (gpu.root_bmax.cpu().view(torch.int32) != cpu.root_bmax.view(torch.int32)).sum())
    other = torch.ones(gt.shape[0], dtype=torch.bool)
    other[blas] = False
    close = torch.allclose(gt[other], ct[other], rtol=1e-6, atol=1e-6, equal_nan=True)
    same_as_build = bool(torch.equal(gpu.table.view(torch.int32), b.table.view(torch.int32)))
    clamped = int((gpu.table.view(torch.int32) != unclipped.table.view(torch.int32)).any(dim=1).sum())
    clipped_leaves = int(torch.isfinite(b.leaf_clip).all(dim=1).sum())
    out = dict(rows=gt.shape[0], blas_rows=blas.stop - blas.start, blas_rows_differing=bad_blas,
               roots_differing=bad_roots, other_rows_within_1e6=close, kernels=kernels,
               refit_equals_build=same_as_build, leaves_with_clip_boxes=clipped_leaves,
               rows_the_clamp_changes=clamped, cpu_refit_ms=cpu_ms)
    log(f"phase K SBVH refit, card vs CPU: {json.dumps(out)}")
    if bad_blas or bad_roots or not close or not same_as_build or not clamped:
        raise AssertionError(f"phase K: the clipped refit on the card disagrees: {out}")
    return out


def l3_scene(size: int = 48):
    """Phase L3's textured scene: a sphere over a floor with a 64x64
    checker and a 32x32 normal map made from a seed (phase 8's floor), no
    geometry masks (gp has no mask test)."""
    from mrt_tpu_torch import Model, Scene
    from mrt_tpu_torch.assets import procedural
    from mrt_tpu_torch.assets.obj import MaterialDef
    from mrt_tpu_torch.utils import frame_profile as FP

    checker, nmap = FP.floor_maps(seed=5, base=64, normal=32)
    floor = procedural.plane(material=MaterialDef(name="floor", map_base_color=checker,
                                                  map_normal=nmap))
    s = Scene(size, size)
    s.models = [Model("sphere", position=[0, 0.6, 0], scale=0.4), Model("floor", mesh=floor, scale=6)]
    return s


# the kernels of K13's to K16's wrapper calls (a K13 entry: a step's scan
# and gather, or the motion rows), by the names the profiler gives them (a
# name matches the kernels that hold it: K15's and K16's two forms); the
# last of each is launched once a call
GP_PROFILED = {"k13": ("gp_rows_count_kernel", "gp_gather_kernel", "gp_rows_kernel"),
               "k14": ("banded_taps_kernel",), "k15": ("gp_hit_keys",),
               "k16": ("gp_lane_unpack",)}


def per_launch(profile: dict | None, name: str) -> float | None:
    """The device ms per event of kernel ``name`` in a profiled frame
    (``route_check``'s ``kernel_profile``); None where it recorded none."""
    k = ((profile or {}).get("kernels") or {}).get(name) or {}
    return k["ms"] / k["events"] if k.get("events") else None


def launch_summary(launches: list, profile: dict | None = None, names=()) -> dict:
    """K13's, K14's, K15's or K16's checked calls of one frame (``drive``'s
    ``route_check``): their count, the first (sample 0's first step, every
    lane), the largest difference from the plain version over them, the
    sums of the CUDA-event ms, the plain version's and the bound (None
    where a launch has no time: a CPU run), each launch's live share (its
    live lanes over the batch's lanes: the rows it wrote and its psum
    carried), and from the kernel route's profiled frame (``profile``) the
    device ms of the kernels ``names`` over their wrapper calls (None where
    the profiler recorded none)."""
    per_call = None
    kern = (profile or {}).get("kernels") or {}
    if names and all(kern.get(n, {}).get("events") for n in names):
        per_call = sum(kern[n]["ms"] for n in names) / kern[names[-1]]["events"]
    return dict(launches=len(launches), first=launches[0] if launches else None,
                max_abs=max((x["max_abs"] for x in launches), default=0.0),
                live_share=[x["live"] / x["lanes"] for x in launches],
                frame_profiler_ms_per_launch=per_call,
                **{f"frame_{k}": None if any(x[k] is None for x in launches)
                   else sum(x[k] for x in launches) for k in ("ms", "plain_ms", "bound_ms")})


def gp_route_checks(tag, jobs, textured: bool, variant: str | None = None) -> dict:
    """The checked gp frame of each rank of one job (``jobs``: its
    ``drive`` results by rank): the kernel route bit-equal to the plain
    route (every output field, rays equal), the second kernel-route run
    equal to the first, every K13 call (its position map, lane list, rows
    and payload of the step's live lanes), every K15 and K16 call (the hit
    combine's keys and unpack; over more than one gp rank outside a debug
    view also the occlusion's two forms) and the first K7 step (the
    lane-row form; with ``variant`` that instantiation) bit-equal to their
    plain versions, K14 launched exactly on a banded textured frame and
    bit-equal too. One line per rank: both routes' walls and device events
    and ms (torch.profiler; an empty profile is logged as a dropout, not a
    failure), the job's kernel-route frame walls, K13's to K16's calls
    beside their bounds (``launch_summary``: their live shares and profiler
    times too), the K7 step, and with ``drive(record_rows=True)`` the drawn
    frames' collectives per gp step (``collectives_summary``; none may
    copy a whole tensor). Raises on a disagreement. Returns rank 0's line
    by field."""
    lines = []
    for r, job in enumerate(jobs):
        c = job["route_check"]
        line = dict(phase=tag, rank=r, check="gp frame: kernel route against plain route",
                    bit_equal=c["bit_equal"], fields=c["fields"],
                    checked_run_differing=c["checked_run_differing"], rays=c["rays"],
                    frame_walls_kernel_route=job["walls"], kernel_wall_s=c["kernel_wall_s"],
                    plain_wall_s=c["plain_wall_s"], kernel_profile=c.get("kernel_profile"),
                    plain_profile=c.get("plain_profile"),
                    k13=launch_summary(c["k13"], c.get("kernel_profile"), GP_PROFILED["k13"]),
                    k14=launch_summary(c["k14"], c.get("kernel_profile"), GP_PROFILED["k14"]),
                    k15=launch_summary(c["k15"], c.get("kernel_profile"), GP_PROFILED["k15"]),
                    k16=launch_summary(c["k16"], c.get("kernel_profile"), GP_PROFILED["k16"]),
                    k7=dict({k: v for k, v in c["k7"].items() if k != "work"},
                            frame_profiler_ms_per_launch=per_launch(c.get("kernel_profile"),
                                                                    "shade_hit_rows_kernel")),
                    k7_work=c["k7"]["work"],
                    **CARD)
        if "rows_psums" in job:
            from mrt_tpu_torch.dist.launch import collectives_summary

            line["collectives"] = collectives_summary(job["rows_psums"])
        log(json.dumps(line))
        for route in ("kernel_profile", "plain_profile"):
            if not (c.get(route) or {}).get("device_events"):
                log(json.dumps(dict(profiler_dropout=f"phase {tag} rank {r} {route}",
                                    recorded=c.get(route))))
        occluded = c["gp_ranks"] > 1 and not c["k7"]["variant"].endswith("debug")
        ok = (c["bit_equal"] and c["checked_run_differing"] == 0 and c["rays"][0] == c["rays"][1]
              and c["k13"] and not any(x["differing"] for x in c["k13"])
              and bool(c["k14"]) == textured and not any(x["differing"] for x in c["k14"])
              and all({x["form"] for x in c[k]} == ({form, "occluded"} if occluded else {form})
                      and not any(x["differing"] for x in c[k])
                      for k, form in (("k15", "keys"), ("k16", "hits")))
              and c["k7"]["differing"] == 0 and c["k7"]["variant"].startswith("rows")
              and c["k7"]["variant"] == (variant or c["k7"]["variant"])
              and line.get("collectives", {}).get("copying", 0) == 0)
        if not ok:
            raise AssertionError(f"phase {tag} rank {r}: the gp frame's kernel route disagrees "
                                 f"with the plain route or a kernel with its plain version: "
                                 f"{line}")
        lines.append(line)
    return lines[0]


def route_walls(job) -> dict:
    """A gp job's checked frame on rank 0: both routes' walls and device
    events (``drive(check_route=True)``), for the phase's line."""
    c = job["route_check"]
    return dict(route_check_kernel_wall_s=c["kernel_wall_s"],
                route_check_plain_wall_s=c["plain_wall_s"],
                kernel_route_profile=c.get("kernel_profile"),
                plain_route_profile=c.get("plain_profile"))


def gp_textured_scene():
    """Phase L's textured gp scene: run N's (the flagship without
    train/treefir, its floor with a 2048x2048 checker and a 1024x1024 normal
    map from seed 0; no mipmaps) at run B's 1024x576, without run N's
    light-masked spheres (gp has no mask test)."""
    from mrt_tpu_torch.engine.appscene import make_app_scene
    from mrt_tpu_torch.utils import frame_profile as FP

    b = FP.RUNS["B"]
    s = make_app_scene(b["width"], b["height"], include_robot=False, asset_models=False,
                       dragon_subdivisions=None)
    FP._extras(s, dict(floor_maps=True), 0)
    return s


# K7's lane-row instantiations that phase L1 drives in a gp=1 job each, beside
# "rows" (run B's scene) and "rows_maps_taps" (the textured gp scene, banded)
GP_VARIANT_JOBS = ("rows_maps", "rows_maps_mips", "rows_debug", "rows_maps_debug",
                   "rows_maps_mips_debug", "rows_maps_taps_debug")


def gp_variant_settings(untextured, textured) -> dict:
    """{K7 lane-row instantiation: (settings, banded)} of the jobs of
    ``GP_VARIANT_JOBS``, from the untextured (run B's) and the textured gp
    scene's settings: the whole atlas (banded False) with and without
    mipmaps, the motion view untextured, the normal view (the normal map's
    taps and motion rows) on the whole atlas, with mipmaps and banded."""
    from mrt_tpu_torch.core import types as T

    mips = dataclasses.replace(textured, use_mipmaps=True)
    normal = dict(debug_mode=T.DEBUG_MODE_NORMAL)
    out = {"rows_maps": (textured, False), "rows_maps_mips": (mips, False),
           "rows_debug": (dataclasses.replace(untextured, debug_mode=T.DEBUG_MODE_MOTION), False),
           "rows_maps_debug": (dataclasses.replace(textured, **normal), False),
           "rows_maps_mips_debug": (dataclasses.replace(mips, **normal), False),
           "rows_maps_taps_debug": (dataclasses.replace(textured, **normal), True)}
    assert tuple(out) == GP_VARIANT_JOBS
    return out


def reference_frames(torch, r, frames: int) -> dict:
    """``frames`` draws of the single-device renderer ``r`` at its render
    size: each accumulation (NumPy), rays and wall (synchronised)."""
    r._allocate_state()
    out = dict(images=[], rays=[], walls=[], offsets=r.offsets.cpu().numpy(),
               settings=r.settings(), table_bytes=r.bvh.table.numel() * 4)
    for _ in range(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.draw()
        torch.cuda.synchronize()
        out["walls"].append(time.perf_counter() - t0)
        out["images"].append(r.accum.cpu().numpy())
        out["rays"].append(int(r.last_rays_traced))
    return out


def phase_l(torch, FP, dev, lines, card_name, power_limit) -> dict:
    """Phase L: the sharded renderers (mrt_tpu_torch/dist), each rank a
    process of its own on this one card (dist.launch.launch). L1: a world
    of one rank over nccl: DistributedRenderer (dp=1, sp=1) at run A's
    settings, 3 frames bit-equal to the single-device Renderer with equal
    rays; GeometryShardedRenderer at gp=1 on run B's scene, 2 frames within
    1e-5 of the flat single-device renderer. L2: two ranks over gloo (NCCL
    refuses two ranks on one GPU): dp=2 at run A (bit-equal, K1 on rank
    0's gathered image uint8-equal to its plain version), sp=2 at run A
    (within 1e-6 of the mean of the two sample windows the single device
    traces), gp=2 at run B (within 1e-5 of the flat single device; pixels
    outside counted, rays equal or differing only with such pixels; each
    rank's table bytes; then one frame with each K3 launch of every rank
    held against the plain version on its padded shard table). L3: four
    ranks over gloo at 48x48, (dp, gp) = (2, 2) with the banded atlas on
    ``l3_scene`` (3 frames within 1e-5 of the flat single device, a
    fourth checked as L2's), save_dist after frame 2, restore_dist in a
    fresh world and one frame, bit-equal to the uninterrupted third. The
    gp frames take the kernel route (K6, K3, K13, K7's lane-row form, K8;
    with the banded atlas and maps K14), and L1 and L2 also drive the
    textured gp scene (``gp_textured_scene``, banded) at gp=1 and gp=2
    within 1e-5 of its flat single device; L1 drives each other lane-row
    instantiation of K7 in a gp=1 job of one frame (``GP_VARIANT_JOBS``,
    ``gp_variant_settings``). After its frames every gp job
    draws one checked frame (``drive(check_route=True)``): on each rank the
    kernel route bit-equal to the plain route, each K13 and K14 launch and
    the first K7 step bit-equal to their plain versions, both routes' walls
    and device events (``gp_route_checks``). The ranks share one card, so
    no wall here is a multi-GPU scaling figure. Returns each sub-phase's
    launch counts, summed over its ranks, and the gp route checks by job."""
    import numpy as np

    from mrt_tpu_torch import Renderer
    from mrt_tpu_torch.core import types as T
    from mrt_tpu_torch.dist import launch as L
    from mrt_tpu_torch.kernels import wavefront as W
    from mrt_tpu_torch.render import wavefront as wf

    t_phase = time.perf_counter()
    note = "ranks share one card: not a multi-GPU scaling figure"
    counts = {}

    def launches(tag, results):
        c = {"present": 0, "traverse2": 0, "traverse_flat": 0, "variants": {}, "k7": {}}
        c.update(dict.fromkeys(REFIT_KEYS + W.STAGES + W.GP_STAGES, 0))
        for rank in results:
            for job in rank:
                for k in ("present", "traverse2", "traverse_flat") + REFIT_KEYS + W.STAGES \
                        + W.GP_STAGES:
                    c[k] += job["launches"][k]
                for key in ("variants", "k7"):
                    for k, n in job["launches"][key].items():
                        c[key][k] = c[key].get(k, 0) + n
        counts[tag] = c
        return c

    gp_checks = {}

    def gp_job(tag, ranks, job, variant: str, checked: bool = True):
        """A gp job's main-path launches on each rank (K6, K7's lane-row
        instantiation ``variant`` and nothing else of K7, K13, K15, K16;
        K8 but in a debug view; K14 exactly where ``variant`` has the
        per-lane taps) and its checked frame (``gp_route_checks``)."""
        textured, debug = "taps" in variant, variant.endswith("debug")
        for r, rank in enumerate(ranks):
            c = rank[job]["launches"]
            if (min(c["sample_start"], c["gp_rows"], c["gp_hit_keys"], c["gp_lane_unpack"],
                    c["shade_hit"]) < 1
                    or c["k7"].get(variant, 0) != c["shade_hit"]
                    or (c["resolve_shadow"] > 0) == debug or (c["banded_taps"] > 0) != textured):
                raise AssertionError(f"phase {tag} rank {r}: a gp kernel of the path never "
                                     f"launched, or another ran: {c}")
        if checked:
            gp_checks[tag] = gp_route_checks(tag, [rank[job] for rank in ranks], textured, variant)
            return gp_checks[tag]
        return None

    def frame_line(job, ref, tol):
        """The rank-0 frames of ``job`` against the reference frames."""
        errs = [float(np.abs(a - b).max()) for a, b in zip(job["images"], ref["images"])]
        outside = [int((np.abs(a - b) > tol).any(axis=-1).sum())
                   for a, b in zip(job["images"], ref["images"])]
        differing = [int((a != b).any(axis=-1).sum()) for a, b in zip(job["images"], ref["images"])]
        return dict(backend=job["backend"], setup_s=job["setup_s"], frames=len(job["images"]),
                    frame_walls=job["walls"],
                    rays=job["rays"], rays_single=ref["rays"][: len(job["rays"])],
                    mrays_per_s=sum(job["rays"]) / sum(job["walls"]) / 1e6, max_abs_err=errs,
                    tolerance=tol, pixels_outside=outside, pixels_differing=differing,
                    bit_equal=not any(differing))

    def flat_checks(tag, ranks, job):
        """Each rank's check of one frame's K3 launches and its K4 ``flat``
        refit on its padded shard table against traverse_flat_plain and
        flat_plain (``drive(check_flat=True)``); raises on a mismatch, on a
        rank that launched no K3 or K4, on a lane that reached a padded row,
        and when no rank's table is padded."""
        checks = [rank[job]["flat_check"] for rank in ranks]
        for r, c in enumerate(checks):
            log(f"K3 traverse_flat phase {tag} rank {r}: one frame's {c['launches']} launches, "
                f"{c['lanes']} lanes, on the shard table of {c['rows']} rows ({c['padded_rows']} "
                f"padded, depth {c['depth']}, stack {c['stack_size']}) against the plain version: "
                f"mismatches {c['mismatches']}, largest |t| difference {c['max_abs_err']}, "
                f"padded rows visited {c['padded_visits']}; K4 refit_rows (flat) on it: "
                f"{json.dumps(c['refit'])}")
        if (any(c["launches"] < 1 or any(c["mismatches"].values()) or c["padded_visits"]
                or c["refit"]["launches"] < 1 or c["refit"]["rows_differing"] for c in checks)
                or not any(c["padded_rows"] for c in checks)):
            raise AssertionError(f"phase {tag}: K3 or K4 on a padded shard table disagrees with "
                                 f"its plain version: {checks}")
        return checks

    # single-device references: run A (two-level) and run B (flat)
    ra = FP.make_renderer("A", dev)
    ref_a = reference_frames(torch, ra, 3)
    s_a = ref_a["settings"]
    # frame 0's two sample windows, traced by the single device: sp=2's reference
    sd, geom, bvh = ra.prepare()
    uni = T.make_frame_uniforms(camera=ra.current_camera(), frame_index=0)
    zeros = torch.zeros_like(ra.motion)
    wins = [wf.trace_frame(s_a, ra.statics, sd, bvh, geom, uni, ra.offsets, zeros,
                           sample_base=k * s_a.sample_stride) for k in (0, 1)]
    ref_sp = dict(images=[((wins[0].color + wins[1].color) / 2).cpu().numpy()],
                  rays=[sum(int(w.rays_traced.sum(dtype=torch.int64)) for w in wins)])
    del ra, sd, geom, bvh, wins, zeros
    rb = FP.make_renderer("B", dev)
    rb.two_level = False
    ref_b = reference_frames(torch, rb, 2)
    del rb
    # the textured gp scene's flat single device (the packed atlas, whole)
    rt = Renderer(gp_textured_scene(), FP.RUNS["B"]["width"], FP.RUNS["B"]["height"], device=dev)
    FP.configure(rt)
    rt.two_level = False
    ref_t = reference_frames(torch, rt, 2)
    del rt
    torch.cuda.empty_cache()
    scene_a, scene_b, scene_t = FP.make_scene("A"), FP.make_scene("B"), gp_textured_scene()
    log(f"phase L references and scenes: {time.perf_counter() - t_phase:.1f} s")

    # --- L1: one rank over nccl
    t0, st1 = time.perf_counter(), {}
    l1 = L.launch(L.run_jobs, 1, [
        (L.drive, ("dp", scene_a, s_a, {"dp": 1, "sp": 1}, 3), dict(offsets=ref_a["offsets"],
                                                                  present=True)),
        (L.drive, ("gp", scene_b, ref_b["settings"], {"gp": 1}, 2), dict(offsets=ref_b["offsets"],
                                                                         check_route=True)),
        (L.drive, ("gp", scene_t, ref_t["settings"], {"gp": 1}, 2),
         dict(offsets=ref_t["offsets"], banded=True, check_route=True)),
    ] + [(L.drive, ("gp", scene_b if v == "rows_debug" else scene_t, settings, {"gp": 1}, 1),
          dict(offsets=(ref_b if v == "rows_debug" else ref_t)["offsets"], banded=banded,
               check_route=True))
         for v, (settings, banded) in gp_variant_settings(ref_b["settings"],
                                                          ref_t["settings"]).items()],
        stats=st1)  # the launcher's defaults: the card, nccl
    l1_s = time.perf_counter() - t0
    dp1, gp1, gpt1 = l1[0][:3]
    line = dict(phase="L1", world=1, backend="nccl", launch_s=l1_s, rank_times_s=st1["ranks"], note=note,
                card=card_name, power_limit=power_limit,
                dp1=dict(frame_line(dp1, ref_a, 0.0), frame_walls_single=ref_a["walls"],
                         frame_walls_run_a=lines["A"]["frame_walls"],
                         mrays_per_s_run_a=lines["A"]["mrays_per_s"],
                         k1_max_err=dp1["present_max_err"]),
                gp1=dict(frame_line(gp1, ref_b, 1e-5), frame_walls_single_flat=ref_b["walls"],
                         frame_walls_run_b=lines["B"]["frame_walls"],
                         table_bytes=gp1["table_bytes"], table_bytes_single=ref_b["table_bytes"],
                         **route_walls(gp1)),
                gp1_textured=dict(frame_line(gpt1, ref_t, 1e-5),
                                  frame_walls_single_flat=ref_t["walls"], **route_walls(gpt1)),
                launches=launches("L1", l1))
    log(json.dumps(line))
    if not (line["dp1"]["bit_equal"] and dp1["rays"] == ref_a["rays"] and dp1["present_max_err"] == 0
            and max(line["gp1"]["max_abs_err"]) <= 1e-5 and gp1["rays"] == ref_b["rays"]
            and max(line["gp1_textured"]["max_abs_err"]) <= 1e-5
            and gpt1["rays"] == ref_t["rays"]):
        raise AssertionError(f"phase L1: a sharded frame disagrees with the single device: {line}")
    gp_job("L1 gp=1", l1, 1, "rows")
    gp_job("L1 gp=1 textured", l1, 2, "rows_maps_taps")
    for k, v in enumerate(GP_VARIANT_JOBS):
        gp_job(f"L1 gp=1 {v}", l1, 3 + k, v)

    # --- L2: two ranks sharing the card over gloo
    t0, st2 = time.perf_counter(), {}
    l2 = L.launch(L.run_jobs, 2, [
        (L.drive, ("dp", scene_a, s_a, {"dp": 2, "sp": 1}, 2), dict(offsets=ref_a["offsets"],
                                                                  present=True)),
        (L.drive, ("dp", scene_a, s_a, {"dp": 1, "sp": 2}, 1), dict(offsets=ref_a["offsets"])),
        (L.drive, ("gp", scene_b, ref_b["settings"], {"gp": 2}, 2), dict(offsets=ref_b["offsets"],
                                                                         check_flat=True,
                                                                         check_route=True,
                                                                         record_rows=True)),
        (L.drive, ("gp", scene_t, ref_t["settings"], {"gp": 2}, 2),
         dict(offsets=ref_t["offsets"], banded=True, check_route=True, record_rows=True)),
    ], backend="gloo", stats=st2)
    l2_s = time.perf_counter() - t0
    dp2, sp2, gp2, gpt2 = l2[0]
    gp_rays_local = [rank[2]["rays_local"] for rank in l2]
    gpt_rays_local = [rank[3]["rays_local"] for rank in l2]
    line = dict(phase="L2", world=2, backend="gloo", launch_s=l2_s, rank_times_s=st2["ranks"], note=note,
                card=card_name, power_limit=power_limit,
                dp2=dict(frame_line(dp2, ref_a, 0.0), k1_max_err=dp2["present_max_err"]),
                sp2=frame_line(sp2, ref_sp, 1e-6),
                gp2=dict(frame_line(gp2, ref_b, 1e-5), rays_local_by_rank=gp_rays_local,
                         table_bytes_by_rank=[rank[2]["table_bytes"] for rank in l2],
                         table_bytes_single=ref_b["table_bytes"],
                         k3_checked_by_rank=flat_checks("L2 gp=2", l2, 2), **route_walls(gp2)),
                gp2_textured=dict(frame_line(gpt2, ref_t, 1e-5), rays_local_by_rank=gpt_rays_local,
                                  band_rows=[rank[3]["route_check"]["k14"][0]["band_rows"]
                                             for rank in l2],
                                  frame_walls_single_flat=ref_t["walls"], **route_walls(gpt2)),
                launches=launches("L2", l2))
    log(json.dumps(line))
    line_l2 = line
    g = line["gp2"]
    # a lane that parts at a tie between shards may trace other rays: the
    # rays differ only by what such (differing) pixels can trace
    s_b = ref_b["settings"]
    per_pixel = 2 * s_b.sample_stride * (s_b.max_bounces * (s_b.max_bounces + 2) + 2)
    gt = line["gp2_textured"]
    rays_ok = all(abs(a - b) <= n * per_pixel
                  for x in (g, gt)
                  for a, b, n in zip(x["rays"], x["rays_single"], x["pixels_differing"]))
    if not (line["dp2"]["bit_equal"] and dp2["rays"] == ref_a["rays"][:2]
            and dp2["present_max_err"] == 0 and max(line["sp2"]["max_abs_err"]) <= 1e-6
            and sp2["rays"] == ref_sp["rays"] and rays_ok
            and all(x == gp_rays_local[0] for x in gp_rays_local)
            and all(x == gpt_rays_local[0] for x in gpt_rays_local)):
        raise AssertionError(f"phase L2: a sharded frame disagrees with the single device: {line}")
    for name, x in (("gp=2", g), ("gp=2 textured", gt)):
        if max(x["max_abs_err"]) > 1e-5:
            log(f"phase L2 {name}: {x['pixels_outside']} pixels outside 1e-5 of the flat single "
                "device")
            raise AssertionError(f"phase L2 {name}: pixels outside 1e-5 of the flat single device")
    gp_job("L2 gp=2", l2, 2, "rows")
    gp_job("L2 gp=2 textured", l2, 3, "rows_maps_taps")

    # --- L3: four ranks over gloo, (dp, gp) = (2, 2), banded atlas, save and resume
    r3 = Renderer(l3_scene(), 48, 48, seed=3, device=dev)
    FP.configure(r3)
    r3.two_level = False
    ref_3 = reference_frames(torch, r3, 3)
    del r3
    tmp = tempfile.TemporaryDirectory(prefix="mrt_phase_l_")
    path = os.path.join(tmp.name, "l3.npz")
    t0, st3, st3b = time.perf_counter(), {}, {}
    l3 = L.launch(L.run_jobs, 4, [
        (L.drive, ("gp", l3_scene(), ref_3["settings"], {"dp": 2, "gp": 2}, 3),
         dict(offsets=ref_3["offsets"], banded=True, save=(2, path), check_flat=True,
              check_route=True, record_rows=True)),
    ], backend="gloo", stats=st3)
    l3b = L.launch(L.run_jobs, 4, [
        (L.drive, ("gp", l3_scene(), ref_3["settings"], {"dp": 2, "gp": 2}, 1),
         dict(banded=True, restore=path)),
    ], backend="gloo", stats=st3b)
    l3_s = time.perf_counter() - t0
    tmp.cleanup()
    run3, resumed = l3[0][0], l3b[0][0]
    launches("L3", [rank for rank in l3] + [rank for rank in l3b])
    line = dict(phase="L3", world=4, backend="gloo", mesh={"dp": 2, "gp": 2}, banded=True,
                launch_s=l3_s,
                rank_times_s=[st3["ranks"], st3b["ranks"]], note=note, card=card_name,
                power_limit=power_limit,
                dp_gp=dict(frame_line(run3, ref_3, 1e-5),
                           k3_checked_by_rank=flat_checks("L3 dp*gp=2*2", l3, 0)),
                resumed_bit_equal=bool(np.array_equal(resumed["images"][0], run3["images"][2])),
                resumed_rays=resumed["rays"], uninterrupted_rays=run3["rays"][2:],
                launches=counts["L3"])
    log(json.dumps(line))
    if not (max(line["dp_gp"]["max_abs_err"]) <= 1e-5 and line["resumed_bit_equal"]
            and resumed["rays"] == run3["rays"][2:]):
        raise AssertionError(f"phase L3: the sharded frames or the resumed frame disagree: {line}")
    gp_job("L3 dp*gp=2*2", l3, 0, "rows_maps_taps")
    gp_job("L3 resumed", l3b, 0, "rows_maps_taps", checked=False)
    counts["L2"]["gp_refit"] = [c["refit"] for c in line_l2["gp2"]["k3_checked_by_rank"]]
    # every frame takes the kernel route: the gp frames (L1, L2, L3) K6, K7's
    # lane-row form, K8 and K13, with the banded atlas and maps K14
    paths = ("traverse_flat", "refit_flat") + W.STAGES + W.GP_STAGES
    for tag, kernels in (("L1", ("present", "traverse2") + paths),
                         ("L2", ("present", "traverse2") + paths), ("L3", paths)):
        if min(counts[tag][k] for k in kernels) < 1:
            raise AssertionError(f"phase {tag}: a kernel of the path never launched: {counts[tag]}")
    if counts["L1"]["variants"].get("flat", 0) < 1 or counts["L2"]["variants"].get("packed", 0) < 1:
        raise AssertionError(f"phase L: K3 flat or K2 packed missing: {counts}")
    log(f"phase L: {time.perf_counter() - t_phase:.1f} s")
    return counts, gp_checks


def run_entry(torch, module, argv, W):
    """``module.main(argv)`` (``mrt_tpu_torch.smoke`` or ``.demo``, the user
    entry points) in this process, its ``Renderer`` a subclass that times
    each draw between syncs and keeps its rays and its K6 launches, and its
    GIF writer (the demo's) timed. Returns (what main returns, the record)."""
    from mrt_tpu_torch.engine.renderer import Renderer

    rec = dict(walls=[], rays=[], k6=[], gif_s=None)

    class Recorded(Renderer):
        def draw(self, delta_time=None):
            cuda = self.device.type == "cuda"
            if cuda:
                torch.cuda.synchronize()
            k6, t0 = W.launches["sample_start"], time.perf_counter()
            out = super().draw(delta_time)
            if cuda:
                torch.cuda.synchronize()
            rec["walls"].append(time.perf_counter() - t0)
            rec["rays"].append(self.last_rays_traced)
            rec["k6"].append(W.launches["sample_start"] - k6)
            return out

    saved = {"Renderer": module.Renderer}
    if hasattr(module, "write_gif"):
        saved["write_gif"] = module.write_gif

        def timed_gif(*a, **k):
            t0 = time.perf_counter()
            saved["write_gif"](*a, **k)
            rec["gif_s"] = time.perf_counter() - t0

        module.write_gif = timed_gif
    module.Renderer = Recorded
    try:
        out = module.main(argv)
    finally:
        for k, v in saved.items():
            setattr(module, k, v)
    # a copy: the renderer goes on recording its later draws (the checks, the profiler)
    return out, dict(rec, walls=list(rec["walls"]), rays=[int(x) for x in rec["rays"]],
                     k6=list(rec["k6"]))


def strip_form(PK, sources, tables, what: str, strip: bool = True) -> int:
    """The output rows a tile of K12's strip form takes for ``sources``
    resampled by ``tables`` (``PK.resize_strip_rows``). Raises unless the
    shape takes the strip form (the path's two shapes), or with ``strip``
    False the 32x32 tiles: so a K12 time is read under the kernel that ran."""
    kr, kc = (t.weights.shape[1] for t in tables)
    rt = PK.resize_strip_rows(*tables, [1 if s.dim() == 2 else s.shape[2] for s in sources], kr, kc)
    if bool(rt) != strip:
        form = {True: "the strip form", False: "the 32x32 tiles"}
        raise AssertionError(f"{what}: K12 takes {form[bool(rt)]}, expected {form[strip]}")
    return rt


def check_spatial_resize(torch, tag, r) -> dict | None:
    """K12 at the shape renderer ``r``'s spatial present gives it (phase M's
    demo: a 0.67-scale render, whose first indices, tile spans and row
    chunks differ from run E's 2x): the Lanczos-3 of its accumulation with
    the clamp, against the plain version on the same inputs bit for bit
    and the dense products within RESIZE_DENSE_TOL of the largest value;
    CUDA-event ms of both beside its bound, and the strip form's output
    rows a tile; then its uint8 form, the demo's present (``u8``):
    byte-equal to K1 on the f32 form's output and to
    ``tonemap_quantize_plain`` of the plain version's, its CUDA-event ms
    and the strip kernel's torch.profiler device ms (the wrapper's host
    work told apart) beside its bound. None where ``r`` presents through another
    chain or at render size. Raises on a difference, and where the shape
    does not take the strip form."""
    from mrt_tpu_torch.engine import renderer as R
    from mrt_tpu_torch.kernels import presenter as PK
    from mrt_tpu_torch.upscale import spatial
    from mrt_tpu_torch.utils import bounds

    h, w, oh, ow = r.render_height, r.render_width, r.output_height, r.output_width
    if r.upscaler_mode in (R.UPSCALER_TEMPORAL, R.UPSCALER_DENOISED) or (h, w) == (oh, ow):
        return None
    x = r.accum.contiguous()
    tables = (spatial.band_table(h, oh, "lanczos3", x.device),
              spatial.band_table(w, ow, "lanczos3", x.device))
    rt = strip_form(PK, (x,), tables, f"phase {tag}")
    k12, p12 = PK.resize((x,), *tables, True), PK.resize_plain((x,), *tables, True)
    fields = presenter_fields(torch, ("output",), (k12,), (p12,))
    ref = torch.clamp_min(spatial.resize_dense(x, oh, ow, "lanczos3"), 0.0)
    dense = float((k12 - ref).abs().max() / ref.abs().max())
    kr, kc = (t.weights.shape[1] for t in tables)
    bound = bounds.resize(h, w, oh, ow, 3, kr, kc)
    out = dict(render=[w, h], output=[ow, oh], taps=[kr, kc], fields=fields,
               vs_dense=dense, ms=cuda_ms(lambda: PK.resize((x,), *tables, True), 5),
               plain_ms=cuda_ms(lambda: PK.resize_plain((x,), *tables, True), 5),
               bound_ms=bound[0], bound_by=bound[1], strip_rows=rt)
    from mrt_tpu_torch.kernels import present

    k8 = PK.resize((x,), *tables, True, True)
    bound8 = bounds.resize(h, w, oh, ow, 3, kr, kc, True)
    out["u8"] = dict(
        vs_k1=int((k8 != present.tonemap_quantize(k12)).sum()),
        vs_plain=int((k8 != present.tonemap_quantize_plain(p12)).sum()),
        ms=cuda_ms(lambda: PK.resize((x,), *tables, True, True), 5),
        device_ms=device_ms(torch, lambda: PK.resize((x,), *tables, True, True),
                            "resize_strip_u8_kernel", 5, one_kernel=True),
        bound_ms=bound8[0], bound_by=bound8[1])
    log(json.dumps(dict(phase="M", entry=tag, k12_resize_lanczos3=out)))
    if (fields["output"]["differing"] or not dense <= RESIZE_DENSE_TOL or out["u8"]["vs_k1"]
            or out["u8"]["vs_plain"]):
        raise AssertionError(f"phase {tag}: K12 at {h}x{w} -> {oh}x{ow} disagrees with its plain "
                             f"version or the dense products, or its uint8 form with K1: {out}")
    return out


def phase_m(torch, present, traverse2, refit, W, bounds, tmp, checks, stage_checks) -> tuple:
    """Phase M: the user entry points, each in this process through its
    main(argv) with no device flag (so on the card), at 1024x1024 output:
    the smoke (sphere and plane, 1 spp, 1 bounce, upscaler off; a first and
    4 steady draws) and the demo (the app scene without train/treefir, 30
    steps of an orbit and 3 draws of 1/60 s at the Renderer's defaults but
    2 spp and 2 bounces: a 0.67-scale render, spatial upscaler,
    motion-adaptive accumulation and sampling; a GIF and a final PNG).
    With every launch count set to 0 first; after, K1, K2 (packed only) and
    K6-K8 must have launched (the demo: K4 ``blas`` with K5 and K12 too), every
    draw on the kernel route (K6 at least once per base sample), K8 once
    per sample. The files are read back by the port's own readers (the
    PNG equal to the image, each GIF frame within GIF_QUANT_ERROR of its
    step's image); images with non-zero pixels, rays traced. Then, on each
    entry point's renderer, K1 and every K2 launch of a frame and every
    K6-K8 launch of another held against their plain versions (as for the
    runs; into ``checks`` and ``stage_checks``), K12 at the demo's shape
    (``check_spatial_resize``; into its line), one profiled draw of the
    demo (device busy and idle share against its median draw wall), and a
    48x48 run of each entry point on the card against the CPU (the last
    accumulation within 1e-2 relative RMSE, rays equal per draw). Returns
    ({tag: launch counts}, {tag: line})."""
    import statistics

    import numpy as np

    from mrt_tpu_torch import demo, smoke
    from mrt_tpu_torch.utils import image

    png, gif = os.path.join(tmp, "smoke.png"), os.path.join(tmp, "demo.gif")
    entries = {"M smoke": (smoke, ["--size", "1024", "--out", png]),
               "M demo": (demo, ["--size", "1024", "--frames", "30", "--no-asset-models",
                                 "--out", gif])}
    from mrt_tpu_torch.kernels import presenter as PK

    counts, lines, renderers = {}, {}, {}
    for tag, (module, argv) in entries.items():
        present.launches = 0
        traverse2.reset_launches()
        refit.reset_launches()
        W.reset_launches()
        PK.reset_launches()
        t0 = time.perf_counter()
        (r, out), rec = run_entry(torch, module, argv, W)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        c = {"present": present.launches, "traverse2": traverse2.launches,
             "traverse_flat": traverse2.flat_launches, **refit_counts(refit), **stage_counts(W),
             **PK.launches}
        variants = {k: n for k, n in traverse2.variant_launches.items() if n}
        need = ("traverse2",) + W.STAGES
        if tag == "M demo":  # its spatial present: K12's uint8 form with the clamp, no K1
            need += ("refit_blas", "refit_tlas", "resize_u8")
        else:  # the smoke presents at render size: K1
            need += ("present",)
        walls, rays = rec["walls"], rec["rays"]
        if (r.device.type != "cuda" or min(c[k] for k in need) < 1 or set(variants) != {"packed"}
                or c["traverse_flat"] or c["resolve_shadow"] != c["sample_start"]
                or min(rec["k6"]) < r.samples_per_pixel
                or (tag == "M demo" and (c["present"] or c["resize"]))):
            raise AssertionError(f"phase {tag}: a kernel of the path never launched, a draw left "
                                 f"the kernel route or ran off the card: launches {c}, K2 "
                                 f"{variants}, K6 per draw {rec['k6']}, device {r.device}")
        images = out if tag == "M demo" else [out]
        size = (1024, 1024, 3)
        if tag == "M smoke":
            if not np.array_equal(image.read_png(png), out):
                raise AssertionError(f"phase {tag}: the PNG does not read back as the image")
            files = {png: os.path.getsize(png)}
        else:
            frames, delays = image.read_gif(gif)
            final = gif.rsplit(".", 1)[0] + "_final.png"
            gif_err = max(int(abs(f.astype("int16") - im).max()) for f, im in zip(frames, images))
            if (frames.shape != (30,) + size or delays != [0.03] * 30
                    or gif_err > image.GIF_QUANT_ERROR
                    or not np.array_equal(image.read_png(final), images[-1])):
                raise AssertionError(f"phase {tag}: the GIF ({frames.shape}, delays {set(delays)}, "
                                     f"largest error {gif_err}) or the final PNG does not read "
                                     "back as the images")
            files = {gif: os.path.getsize(gif), final: os.path.getsize(final)}
        nonzero = [float((im.sum(-1) > 0).mean()) for im in images]
        if (any(im.shape != size for im in images) or min(nonzero) <= 0.0
                or not bool(torch.isfinite(r.accum).all()) or int(r.last_rays_traced) <= 0
                or min(rays) <= 0):
            raise AssertionError(f"phase {tag}: images {[im.shape for im in images][:2]}, non-zero "
                                 f"shares {nonzero}, rays {rays[:4]}")
        steady = walls[1:]
        line = dict(phase="M", entry=tag, argv=argv, output=[r.output_width, r.output_height],
                    render=[r.render_width, r.render_height], spp=r.samples_per_pixel,
                    bounces=r.max_bounces, upscaler=r.upscaler_mode, render_scale=r.render_scale,
                    motion_adaptive_sampling=r.use_motion_adaptive_sampling,
                    motion_adaptive_accumulation=r.use_motion_adaptive_accumulation,
                    triangles=r.statics.n_triangles, draws=len(walls), main_s=total_s,
                    first_frame_s=walls[0], steady_frame_median_s=statistics.median(steady),
                    frame_walls=walls, mrays_per_s=sum(rays[1:]) / sum(steady) / 1e6,
                    total_rays=sum(rays), launches=c, k2_variants=variants,
                    k6_per_draw=sorted(set(rec["k6"])), stats=r.stats.report(),
                    gif_encode_s=rec["gif_s"], files_bytes=files, nonzero_share=nonzero[-1],
                    image_mean=float(images[-1].mean()), card=CARD["card"],
                    power_limit=CARD["power_limit"])
        if tag == "M demo":
            busy_ms, events = device_total_ms(torch, lambda: r.draw(1 / 60), 1)
            line.update(device_busy_s=busy_ms / 1e3, device_events=events,
                        idle_share=1.0 - busy_ms / 1e3 / line["steady_frame_median_s"])
        counts[tag], lines[tag], renderers[tag] = c, line, r
        log(json.dumps(line))

    # each kernel at the shapes the entry points give it, against its plain version
    for tag, r in renderers.items():
        checks[tag] = check_path_kernels(torch, tag, r, present, traverse2, bounds)
        checks[tag].pop("k1_input")
        stage_checks[tag] = check_stages(torch, tag, r, W, traverse2, bounds)
        stage_checks[tag].pop("first")
        if c_spatial := check_spatial_resize(torch, tag, r):
            lines[tag]["k12"] = c_spatial
    del renderers

    # 48x48: each entry point on the card against the CPU
    small = {}
    for tag, (module, argv) in (("M smoke", (smoke, ["--size", "48"])),
                                ("M demo", (demo, ["--size", "48", "--frames", "1",
                                                   "--no-asset-models"]))):
        res = []
        for device in ("cuda", "cpu"):
            ext = "png" if module is smoke else "gif"
            (r, _), rec = run_entry(torch, module, argv + ["--device", device, "--out",
                                                           os.path.join(tmp, f"s{device}.{ext}")], W)
            res.append((r.accum.cpu(), rec["rays"]))
        (acc_g, rays_g), (acc_c, rays_c) = res
        rel = rel_rmse(acc_g, acc_c)
        small[tag] = dict(rel_rmse=rel, rays_card=rays_g, rays_cpu=rays_c)
        log(f"small frame 48x48, phase {tag}: card vs CPU relative RMSE {rel:.3e} in the last "
            f"accumulation (limit 1e-2), rays per draw {rays_g} vs {rays_c}")
        if not (rel < 1e-2 and rays_g == rays_c and min(rays_g) > 0):
            raise AssertionError(f"phase {tag}: the 48x48 run on the card disagrees with the CPU")
    for tag in lines:
        lines[tag]["small_frame"] = small[tag]
    return counts, lines


def main() -> int:
    import torch

    # --- 1. device -------------------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run needs an NVIDIA GPU "
              "and does not fall back to the CPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    from mrt_tpu_torch.bvh import wide
    from mrt_tpu_torch.core import halton as H
    from mrt_tpu_torch.core import types as T
    from mrt_tpu_torch.kernels import build, present, refit, sass_diff, traverse2
    from mrt_tpu_torch.kernels import presenter as PK
    from mrt_tpu_torch.kernels import wavefront as W
    from mrt_tpu_torch.render import wavefront as wf
    from mrt_tpu_torch.upscale import presenter
    from mrt_tpu_torch.utils import bounds
    from mrt_tpu_torch.utils import frame_profile as FP
    from mrt_tpu_torch.utils import tie_scene

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
    CARD.update(card=card_name, power_limit=power_limit)

    # --- 2. build ---------------------------------------------------------------------
    secs = build.build(verbose=True)
    build.load()
    log(f"build: {sorted(p.name for p in build.CSRC.glob('*.cu'))} -> "
        f"{build.LIB.relative_to(ROOT)} in {secs:.1f} s")
    # K10's tap as its SASS issues it, per step (a diagnostic beside its bound)
    k10_sass = sass_diff.tap_instructions(str(build.LIB))
    if sorted(k10_sass) != sorted(PK.ATROUS_STEPS):
        raise AssertionError(f"K10's SASS: instantiations {sorted(k10_sass)}, expected steps "
                             f"{PK.ATROUS_STEPS}")
    sass_tap = {step: v["per_tap"] for step, v in k10_sass.items()}
    log(json.dumps(dict(k10_sass=k10_sass)))
    # K12's strip form: the instructions of a window slot, per instantiation
    k12_sass = sass_diff.slot_instructions(str(build.LIB))
    if sorted(k12_sass) != ["K2C6", "K6C3"]:
        raise AssertionError(f"K12's SASS: instantiations {sorted(k12_sass)}")
    log(json.dumps(dict(k12_sass=k12_sass)))

    # --- 3. kernels against their plain versions ----------------------------------------
    check_halton(torch, H)

    def make(tag, **kw):
        t0 = time.perf_counter()
        r = FP.make_renderer(tag, dev, **kw)
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
    # K3 on the same rays over run A's flat table (built by the user's switch,
    # two_level = False, and back), then over it padded past 2^20 - 1 rows
    # (its float-sort instantiation)
    ra.two_level = False
    flat_a = ra.bvh
    ra.two_level = True
    log(f"run A flat table {tuple(flat_a.table.shape)}, {flat_a.n_internal} internal rows, "
        f"depth {flat_a.depth}, stack {flat_a.stack_size}")
    rand["A flat"] = check_random_rays(torch, "A (flat)", flat_a, traverse2, bounds)
    padded[: flat_a.table.shape[0]] = flat_a.table
    padded[flat_a.table.shape[0]:] = 0.0
    rand["A flat padded"] = check_random_rays(torch, "A (flat, padded past 2^20 rows)",
                                              dataclasses.replace(flat_a, table=padded), traverse2,
                                              bounds)
    # K3 on the tie scene (utils/tie_scene.py: equal t between a leaf's
    # slots and between children, hits at t = tmax and at t = 0), its flat
    # table and that table padded past 2^20 - 1 rows
    v0, v1, v2, tie_rays = tie_scene.tie_scene(seed=0, count=1 << 16)
    ties = wide.build(v0, v1, v2, method="sah", device=dev)
    tie_rays = tuple(torch.as_tensor(x).to(dev) for x in tie_rays)
    log(f"tie scene: {v0.shape[0]} triangles, flat table {tuple(ties.table.shape)}, "
        f"stack {ties.stack_size}")
    rand["ties"] = check_random_rays(torch, "tie scene", ties, traverse2, bounds, rays=tie_rays)
    padded[: ties.table.shape[0]] = ties.table
    padded[ties.table.shape[0]:] = 0.0
    rand["ties padded"] = check_random_rays(torch, "tie scene (padded past 2^20 rows)",
                                            dataclasses.replace(ties, table=padded), traverse2,
                                            bounds, rays=tie_rays)
    del padded, flat_a, ties, tie_rays

    # --- 3c. K6-K8, the wavefront's stages, against their plain versions on the card ----------
    check_halton_kernel(torch, H, W)
    stage_checks, route_frames = {}, {}
    stage_checks["A"] = check_stages(torch, "A", ra, W, traverse2, bounds, glass_heavy=True)
    stage_times = time_stages(torch, W, traverse2, bounds, stage_checks["A"]["first"])
    log(json.dumps(dict(phase="3c", run="A", stage_times=stage_times, card=card_name,
                        power_limit=power_limit)))
    ra.light_sampling = "power"
    stage_checks["A power"] = check_stages(torch, "A power", ra, W, traverse2, bounds)
    ra.light_sampling = "uniform"
    ra.shading_mode = T.SHADING_MODE_LEGACY
    stage_checks["A legacy"] = check_stages(torch, "A legacy", ra, W, traverse2, bounds)
    ra.shading_mode = T.SHADING_MODE_PBR
    # mipmaps on a scene without maps: K7's maps_mips instantiation, which
    # samples no map and carries the ray cone's length
    ra.use_mipmaps = True
    stage_checks["A mipmaps"] = check_stages(torch, "A mipmaps", ra, W, traverse2, bounds)
    ra.use_mipmaps = False
    route_frames["A"] = check_route_frame(torch, "A", ra, W, wf)
    # the environment and all four light types, uniform and power sampled
    rl = lights_env_renderer(dev)
    lt = sorted(set(rl.scene_data.lights.type.tolist()))
    if not (rl.statics.has_environment and lt == [T.LIGHT_TYPE_SUNLIGHT, T.LIGHT_TYPE_SPOTLIGHT,
                                                  T.LIGHT_TYPE_POINTLIGHT, T.LIGHT_TYPE_AREA]):
        raise AssertionError(f"phase 3c: the lights scene has light types {lt}, environment "
                             f"{rl.statics.has_environment}")
    stage_checks["lights+env"] = check_stages(torch, "lights+env", rl, W, traverse2, bounds)
    rl.light_sampling = "power"
    stage_checks["lights+env power"] = check_stages(torch, "lights+env power", rl, W, traverse2, bounds)
    route_frames["lights+env power"] = check_route_frame(torch, "lights+env power", rl, W, wf)
    env_miss = stage_checks["lights+env"]["stages"]["shade_hit"]["work"]["env_miss"]
    if env_miss < 1:
        raise AssertionError("phase 3c: no lane of the lights scene missed into the environment")
    del rl
    for tag in ("A", "A power", "A legacy", "A mipmaps", "lights+env", "lights+env power"):
        stage_checks[tag].pop("first", None)

    # --- 4. main path: each run's kernels checked at its shapes, then driven ---------------
    def drive(tag, r, timed, scene_name, variant="packed", refits=()):
        """Warm-up + ``timed`` frames with the launch counters set to 0
        first; per timed frame (after its wall) the largest motion vector and
        the pixels by extra samples earned. Only the traversal instantiation
        ``variant`` may launch (K3's names start with "flat"); each refit
        kernel in ``refits`` (REFIT_KEYS) must."""
        present.launches = 0
        traverse2.reset_launches()
        refit.reset_launches()
        W.reset_launches()
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
        counts = {"present": present.launches, "traverse2": traverse2.launches,
                  "traverse_flat": traverse2.flat_launches, **refit_counts(refit),
                  **stage_counts(W)}
        path = ("present", "traverse_flat" if variant.startswith("flat") else "traverse2") + refits
        path += W.STAGES
        # the listed K7 folds K8's add in: K8 runs once per sample, at its end
        if counts["resolve_shadow"] != counts["sample_start"]:
            raise AssertionError(f"{tag}: K8 launched {counts['resolve_shadow']} times for "
                                 f"{counts['sample_start']} samples")
        h, w = r.render_height, r.render_width
        if img.shape != (h, w, 3) or img.dtype != np.uint8:
            raise AssertionError(f"{tag}: image {img.shape} {img.dtype}")
        acc = r.accum
        if not bool(torch.isfinite(acc).all()) or float(acc.max()) <= 0.0:
            raise AssertionError(f"{tag}: accumulation is not finite or is all black")
        if rays <= 0:
            raise AssertionError(f"{tag}: no rays traced")
        if min(counts[k] for k in path) < 1:
            raise AssertionError(f"{tag}: a kernel of the path never launched: {counts}")
        variants = check_variants(tag, traverse2, variant)
        line = dict(run=tag, scene=scene_name, resolution=[w, h], spp=r.samples_per_pixel,
                    bounces=r.max_bounces, upscaler=r.upscaler_mode,
                    motion_adaptive=r.use_motion_adaptive_sampling,
                    triangles=r.statics.n_triangles, table_bytes=r.bvh.table.numel() * 4,
                    route="kernel",
                    frames=timed, total_rays=rays, seconds=seconds, frame_walls=walls,
                    mrays_per_s=rays / seconds / 1e6, launches=counts, k2_variants=variants,
                    k8_launches_per_frame=counts["resolve_shadow"] / (timed + 1),
                    mipmaps=r.use_mipmaps, has_masks=r.bvh.has_masks,
                    max_motion_px=motion, pixels_by_extra_samples=extras,
                    accum_mean=float(acc.mean()), image_mean=float(img.mean()),
                    card=card_name, power_limit=power_limit)
        log(json.dumps(line))
        return counts, walls, line

    def profile(tag, r):
        line = profile_run(torch, FP, tag, r, present, bounds, checks[tag], walls[tag],
                           k1=tag in ("A", "B"))
        log(json.dumps(dict(run=tag, profile=line, card=card_name, power_limit=power_limit)))
        return line

    checks, counts, walls, lines, clone_ms, variant_counts_l = {}, {}, {}, {}, {}, {}
    stage_times_by = {"A": stage_times}  # K6-K8's times at a run's first launches

    def check_route(tag, r, strict=False, timed=False):
        """Phase 3c at run ``tag`` (its K6-K8 launches, then a frame of the
        kernel route against the plain route; with ``strict`` the frame
        bit-equal, with ``timed`` the stages timed at their first launches)."""
        if tag not in stage_checks:
            stage_checks[tag] = check_stages(torch, tag, r, W, traverse2, bounds)
            first = stage_checks[tag].pop("first")
            if timed:
                stage_times_by[tag] = time_stages(torch, W, traverse2, bounds, first)
                log(json.dumps(dict(phase="3c", run=tag, stage_times=stage_times_by[tag],
                                    card=card_name, power_limit=power_limit)))
        if tag not in route_frames:
            route_frames[tag] = check_route_frame(torch, tag, r, W, wf, strict=strict)

    def run(tag, r, timed, variant="packed", scene_name=None, refits=(), strict=False):
        checks[tag] = check_path_kernels(torch, tag, r, present, traverse2, bounds)
        check_route(tag, r, strict, timed=strict)
        counts[tag], walls[tag], lines[tag] = drive(
            tag, r, timed, scene_name or FP.RUNS[tag]["scene"], variant, refits)
        # refit keeps its input table: it copies the whole table every call
        clone_ms[tag] = cuda_ms(lambda: r.bvh.table.clone(), 20)

    run("A", ra, 3)
    torch.cuda.empty_cache()
    rb = make("B")
    run("B", rb, 2)
    rc = make("C")
    def prepare_walls(r):
        """Wall seconds of 5 prepare stages (skinning, world transform,
        refit) after a warm-up, each between syncs."""
        prep = []
        for _ in range(6):
            t0 = time.perf_counter()
            r.prepare()
            torch.cuda.synchronize()
            prep.append(time.perf_counter() - t0)
        return prep[1:]

    skinned = ("refit_blas", "refit_tlas")
    run("C", rc, 3, refits=skinned)
    prep = prepare_walls(rc)
    robot_skin = rc.scene.models[0].skin
    refit_checks = {"C": check_character(torch, rc, dict(joint_indices=robot_skin.joint_indices,
                                                         joint_weights=robot_skin.joint_weights),
                                         refit, bounds, tag="run C")}
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
    counts["D"], _, lines["D"] = drive("D", rd, 1, dparts["scene"], refits=skinned)
    clone_ms["D"] = cuda_ms(lambda: rd.bvh.table.clone(), 20)
    refit_checks["D"] = check_character(torch, rd, dparts, refit, bounds, time_k5=True)
    refit_checks["D NaN"] = check_refit_nan(torch, rd, refit, bounds)

    # --- 6. run E: the presenter chain, a 1080p render presented at 4K -----------------------
    re_ = make("E")
    e_lines, e_checks = {}, {}
    counts["E"] = {"present": 0, "traverse2": 0, **dict.fromkeys(REFIT_KEYS, 0),
                   **dict.fromkeys(stage_counts(W), 0), **dict.fromkeys(PK.KERNELS, 0)}
    for mode in E_MODES:
        c, e_lines[mode] = drive_e(torch, re_, mode, present, traverse2, presenter, refit)
        counts["E"] = {k: n + c[k] for k, n in counts["E"].items()}
        e_checks[mode], x4k = check_e_mode(torch, re_, present, presenter, T)
        e_lines[mode].update(e_checks[mode], card=card_name, power_limit=power_limit)
        log(json.dumps(e_lines[mode]))
    # --- 3p. K9-K12, the presenter kernels, against their plain versions on the card ---------
    t_3p = time.perf_counter()
    presenter_checks = {"E": check_presenter(torch, "E", dict(
        color=re_.accum.contiguous(), gb={k: v.contiguous() for k, v in re_.gbuffer.items()},
        depth=re_.depth.contiguous(), motion=re_.motion.contiguous(),
        state=tuple(re_._denoise_state), history=re_._upscale_history,
        weights=(float(re_.accumulation_weight),),
        out=(re_.output_height, re_.output_width)), present, bounds, timed=True,
        sass_tap=sass_tap)}
    presenter_checks["synthetic"] = check_presenter(
        torch, "synthetic 1920x1080", synthetic_presenter_inputs(torch, dev), present, bounds)
    # no multiple of K10's 32x8 and K12's 256x16 tiles: partial tiles, the clamped halo,
    # K12's output rows not 16-byte aligned
    presenter_checks["synthetic odd"] = check_presenter(
        torch, "synthetic 963x541", synthetic_presenter_inputs(torch, dev, h=541, w=963), present,
        bounds)
    log(f"phase 3p: {time.perf_counter() - t_3p:.1f} s")
    # the G-buffer state (denoised mode): K7 writes it at sample 0's first hit
    if not re_.settings().enable_gbuffer:
        raise AssertionError("run E denoised: no G-buffer")
    stage_checks["E denoised"] = check_stages(torch, "E denoised", re_, W, traverse2, bounds)
    stage_checks["E denoised"].pop("first")
    route_frames["E denoised"] = check_route_frame(torch, "E denoised", re_, W, wf)

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
    run("F", rf, 3, variant="masked", strict=True)
    # run N: run F at the Renderer's default use_mipmaps=False (the packed atlas)
    rn = make("N")
    if rn.use_mipmaps or not any(rn.statics.any_map):
        raise AssertionError("run N: mipmaps on, or the scene has no texture map")
    run("N", rn, 3, variant="masked", strict=True)
    # the debug views: 1-6 on run F's scene (mipmaps), the base colour view on
    # run N's (the packed atlas) and the motion view (7) on run C's; each
    # view's K6-K8 launches and a frame of its kernel route held bit-equal
    # to the plain route first
    debug_lines = []
    for tag, r_, modes, variant in (
            ("F", rf, range(T.DEBUG_MODE_BASECOLOR, T.DEBUG_MODE_EMISSION + 1), "masked"),
            ("N", rn, (T.DEBUG_MODE_BASECOLOR,), "masked"),
            ("C", rc, (T.DEBUG_MODE_MOTION,), "packed")):
        for mode in modes:
            dtag = f"{tag} debug {mode}"
            r_.debug_texture_mode = mode
            try:
                check_route(dtag, r_, strict=True,
                            timed=mode in (T.DEBUG_MODE_BASECOLOR, T.DEBUG_MODE_MOTION))
            finally:
                r_.debug_texture_mode = 0
            line = drive_debug(torch, tag, r_, mode, present, traverse2, variant,
                               frames=2 if mode == T.DEBUG_MODE_MOTION else 1)
            counts[dtag] = line["launches"]
            debug_lines.append(line)
    for line in debug_lines:
        log(json.dumps(dict(line, card=card_name, power_limit=power_limit)))
    if debug_lines[-1]["accum_max"][2] <= 0.0:
        raise AssertionError("run C, motion view: no motion shown (blue, the magnitude, is 0)")
    torch.cuda.empty_cache()

    refit.reset_launches()
    rg = make("G")
    counts["G build"] = build_counts("G build", refit, skinned)
    refit_checks["G build"] = check_twolevel_refit(
        torch, refit, bounds, "run G's build-time refit of every group", rg.bvh,
        rg.scene_data.positions_obj, rg.scene_data.instance_transform,
        group_indices(torch, rg, dev))
    if rows_differing(torch, refit.twolevel(rg.bvh, rg.scene_data.positions_obj,
                                            rg.scene_data.instance_transform,
                                            group_indices(torch, rg, dev))[0], rg.bvh.table):
        raise AssertionError("run G: a refit of every group does not give the build's table")
    if rg.bvh.table.shape[0] <= 2 ** 20 - 1:
        raise AssertionError(f"run G: the table has {rg.bvh.table.shape[0]} rows, not more than "
                             "2^20 - 1")
    log(f"run G table: {rg.bvh.table.shape[0]} rows (> 2^20 - 1 = {2 ** 20 - 1}), "
        f"{rg.bvh.table.numel() * 4 / 1e9:.3f} GB")
    rand["G"] = check_random_rays(torch, "G", rg.bvh, traverse2, bounds)
    if rand["G"]["variant"] != "float_sort":
        raise AssertionError(f"run G: K2 took its {rand['G']['variant']} variant")
    run("G", rg, 2, variant="float_sort")

    # --- 6c. run H: the robot read from disk; phase I: a checkpoint on the card ---------------
    from mrt_tpu_torch.engine import checkpoint

    h_tmp = tempfile.TemporaryDirectory(prefix="mrt_run_h_")
    hdir = h_tmp.name
    t0 = time.perf_counter()
    hmesh, hskin = FP.character()
    hpaths = FP.write_character(hdir, hmesh, hskin)
    write_s = time.perf_counter() - t0
    hloads = check_rig_files(hpaths, hmesh, hskin)
    rh = make("H", asset_dir=hdir)
    robot = rh.scene.models[0]
    if not (robot.name == "robot" and robot.scale == 0.01 and robot.skin is not None
            and robot.mesh.positions.shape[0] == hmesh.positions.shape[0]
            and rh.statics.skin_slices[0][2] == hmesh.positions.shape[0]):
        raise AssertionError("run H: the app scene's robot did not come from robot.usdz")
    run("H", rh, 3, refits=skinned)
    h_prep = prepare_walls(rh)
    if max(lines["H"]["max_motion_px"]) <= 0.5:
        raise AssertionError(f"run H: the robot moved at most {max(lines['H']['max_motion_px'])} px")
    refit_checks["H"] = check_character(torch, rh, dict(joint_indices=hskin.joint_indices,
                                                        joint_weights=hskin.joint_weights),
                                        refit, bounds, tag="run H")
    h_small = check_small_h(dev, hdir)
    log(json.dumps(dict(run="H", character_and_write_s=write_s, loads=hloads,
                        mrays_per_s=lines["H"]["mrays_per_s"], frame_walls=lines["H"]["frame_walls"],
                        frame_walls_c=lines["C"]["frame_walls"], prepare_s=h_prep,
                        prepare_s_median=sorted(h_prep)[len(h_prep) // 2],
                        k2_variants=lines["H"]["k2_variants"], small_frame=h_small,
                        card=card_name, power_limit=power_limit)))
    phase_i = checkpoint_phase(torch, FP, checkpoint, rh, hdir, dev,
                               os.path.join(hdir, "run_h_checkpoint.npz"))
    log(json.dumps(dict(phase_i, card=card_name, power_limit=power_limit)))
    h_tmp.cleanup()

    # --- 6d. run J: the animated app frame on the flat BVH (K3); phase K: SBVH ----------------
    rj = make("J")
    if not isinstance(rj.bvh, wide.WideBVH) or traverse2.flat_variant(rj.bvh.n_rows) != "flat":
        raise AssertionError("run J: the renderer holds no flat table of at most 2^20 - 1 rows")
    run("J", rj, 3, variant="flat", refits=("refit_flat",))
    j_prep = prepare_walls(rj)
    if max(lines["J"]["max_motion_px"]) <= 0.5:
        raise AssertionError(f"run J: the robot moved at most {max(lines['J']['max_motion_px'])} px")
    j_refit = refit_checks["J"] = check_flat_refit(torch, rj, "J", refit, bounds)
    j_small = check_small_flat(dev)
    log(json.dumps(dict(run="J", table_rows=rj.bvh.n_rows, n_internal=rj.bvh.n_internal,
                        depth=rj.bvh.depth, stack=rj.bvh.stack_size,
                        mrays_per_s=lines["J"]["mrays_per_s"], mrays_per_s_c=lines["C"]["mrays_per_s"],
                        frame_walls=lines["J"]["frame_walls"], frame_walls_c=lines["C"]["frame_walls"],
                        prepare_s=j_prep, prepare_s_median=sorted(j_prep)[len(j_prep) // 2],
                        prepare_s_c=prep, k3=checks["J"]["k3"], refit=j_refit,
                        small_frame=j_small, card=card_name, power_limit=power_limit)))

    os.environ["MRT_SBVH"] = "1"
    refit.reset_launches()
    try:
        rk = make("A")
    finally:
        del os.environ["MRT_SBVH"]
    counts["K build"] = build_counts("K build", refit, skinned)
    k_refit = check_sbvh_refit(torch, rk, refit, bounds)
    run("K", rk, 2, scene_name="run A's scene with SBVH spatial splits (MRT_SBVH=1)")
    log(json.dumps(dict(phase="K", table=list(rk.bvh.table.shape), refit=k_refit,
                        frame_walls=lines["K"]["frame_walls"], frame_walls_a=lines["A"]["frame_walls"],
                        mrays_per_s=lines["K"]["mrays_per_s"], mrays_per_s_a=lines["A"]["mrays_per_s"],
                        k2=checks["K"]["k2"], k2_a=checks["A"]["k2"], card=card_name,
                        power_limit=power_limit), default=str))
    del rk
    torch.cuda.empty_cache()

    # --- 6e. phase M: the user entry points, smoke and demo, through their main(argv) ----------
    m_tmp = tempfile.TemporaryDirectory(prefix="mrt_phase_m_")
    t0 = time.perf_counter()
    m_counts, m_lines = phase_m(torch, present, traverse2, refit, W, bounds, m_tmp.name, checks,
                                stage_checks)
    m_tmp.cleanup()
    counts.update(m_counts)
    lines.update(m_lines)
    log(f"phase M: {time.perf_counter() - t0:.1f} s")

    # --- 7. the profiler last: a process's frames after a profiler session ran
    # slower on the host in this script's runs (PERF.md, Findings)
    profiles = {tag: profile(tag, r) for tag, r in (("A", ra), ("B", rb), ("C", rc), ("F", rf),
                                                    ("N", rn), ("G", rg), ("H", rh), ("J", rj))}
    # run F's costliest operators (K7's textured instantiation, the masked K2) beside run A's
    log(json.dumps(dict(top_ops_ms={tag: device_ops(torch, lambda r=r: r.draw(1 / 60), 1, top=12)
                                    for tag, r in (("A", ra), ("F", rf))},
                        card=card_name, power_limit=power_limit)))
    for tag, r in (("C", rc), ("D", rd), ("H", rh)):
        log(json.dumps(dict(prepare=tag, **profile_prepare(torch, r, bounds),
                            table_clone_ms=clone_ms[tag], card=card_name,
                            power_limit=power_limit)))
    # run J's prepare: the whole flat table refit from the posed triangles
    _, jgeom, _ = rj.prepare()
    jtris = (jgeom.tri_v0, jgeom.tri_v1, jgeom.tri_v2)
    j_refit_ms, j_refit_ev, j_names = device_names(torch, lambda: wide.refit(rj.bvh, *jtris), 20,
                                                   "refit_rows")
    j_prep_ms, j_prep_ev = device_total_ms(torch, rj.prepare, 5)
    log(json.dumps(dict(prepare="J", refit_ms=j_refit_ms, refit_device_events=j_refit_ev,
                        refit_events_by_name=j_names,
                        refit_events_ms=cuda_ms(lambda: wide.refit(rj.bvh, *jtris), 20),
                        refit_bound_ms=bounds.flat_refit(rj.bvh)[0],
                        prepare_ms=j_prep_ms, prepare_device_events=j_prep_ev,
                        table_clone_ms=clone_ms["J"], card=card_name, power_limit=power_limit)))
    del jgeom, jtris
    e_profile, e_k1 = profile_e(torch, FP, re_, present, bounds, x4k,
                                {m: e_lines[m]["frame_walls_still"] for m in E_MODES}, sass_tap)
    log(json.dumps(dict(run="E", profile=e_profile, k1=e_k1, card=card_name,
                        power_limit=power_limit)))
    del ra, rb, rc, rd, re_, rf, rn, rh, rj, x4k
    torch.cuda.empty_cache()

    # --- 7b. run G on the flat BVH: a flat table above 2^20 - 1 rows (K3's float sort) ----------
    # after the profiler, so its walls run on a host slowed by it
    t0 = time.perf_counter()
    refit.reset_launches()
    rg.two_level = False
    g_flat_build_s = time.perf_counter() - t0
    counts["G flat rebuild"] = build_counts("G flat rebuild", refit, ("refit_flat",))
    if traverse2.flat_variant(rg.bvh.n_rows) != "flat_float_sort":
        raise AssertionError(f"run G flat: {rg.bvh.n_rows} rows take K3's "
                             f"{traverse2.flat_variant(rg.bvh.n_rows)} instantiation")
    log(f"run G flat: two_level = False rebuilt {tuple(rg.bvh.table.shape)} "
        f"({rg.bvh.table.numel() * 4 / 1e9:.3f} GB, {rg.bvh.n_internal} internal rows, stack "
        f"{rg.bvh.stack_size}) in {g_flat_build_s:.1f} s")
    run("G flat", rg, 1, variant="flat_float_sort",
        scene_name="run G's scene on the flat BVH (two_level=False)")
    refit_checks["G flat"] = check_flat_refit(torch, rg, "G flat", refit, bounds, cpu=False)
    log(json.dumps(dict(run="G flat", build_s=g_flat_build_s, k3=checks["G flat"]["k3"],
                        frame_walls=lines["G flat"]["frame_walls"],
                        frame_walls_g=lines["G"]["frame_walls"],
                        mrays_per_s=lines["G flat"]["mrays_per_s"],
                        mrays_per_s_g=lines["G"]["mrays_per_s"], card=card_name,
                        power_limit=power_limit)))
    del rg
    torch.cuda.empty_cache()

    # --- 7c. phase L: the sharded renderers, each rank a process on this card ---------------------
    l_counts, gp_checks = phase_l(torch, FP, dev, lines, card_name, power_limit)
    for tag, c in l_counts.items():
        counts[tag] = {k: c[k] for k in ("present", "traverse2", "traverse_flat") + REFIT_KEYS
                       + W.STAGES + W.GP_STAGES}
        counts[tag].update({f"k7 {k}": n for k, n in c["k7"].items()})
        if "gp_refit" in c:
            refit_checks["L2 gp=2"] = c["gp_refit"]
        variant_counts_l[tag] = c["variants"]

    # --- 8. a small frame on the card against the CPU plain path -------------------------------
    check_small_frames(dev)
    check_small_extras(dev)

    # launches: every run's main-path counts. K1: ms is its profiler device
    # time after a 64 MB write (as a frame leaves the L2) at run A's shape.
    # K2 and K3, one entry per instantiation: ms, plain_ms and bound_ms are
    # for the camera rays of the run that takes it (K2 packed: run A;
    # masked: F; float sort: G; K3 flat: J; flat float sort: G flat); per
    # run, the warm profiler time of one frame (where profiled), the cold
    # CUDA-event time of the checked frame, its bound and its work by row
    # type; the main-path launches by run and the phase-3 checks on random
    # rays.
    variant_counts = {t: lines[t]["k2_variants"] for t in lines}
    variant_counts["E"] = {"packed": sum(e_lines[m]["k2_variants"]["packed"] for m in E_MODES)}
    variant_counts.update({t: {k: n for k, n in v.items() if n} for t, v in variant_counts_l.items()})
    a = checks["A"]

    # K3's registers, shared memory, stack and spills (-Xptxas -v) with the
    # blocks and warps an SM holds, by instantiation (None for K2's)
    from mrt_tpu_torch.utils.k2_compare import k3_resources

    k3_regs = k3_resources(build.ptxas)
    log(json.dumps(dict(k3_resources=k3_regs)))

    def traversal_entry(name, key, run_tag, kernel, replaces):
        runs = {t: c[key] for t, c in checks.items()
                if key in c and name in lines[t]["k2_variants"]}
        cam = checks[run_tag][key]
        return dict(
            name=f"{kernel} ({name})", route="cuda", source="mrt_tpu_torch/csrc/traverse2.cu",
            replaces=replaces, launches=sum(v.get(name, 0) for v in variant_counts.values()),
            launches_by_run={t: v[name] for t, v in variant_counts.items() if name in v},
            max_abs_err=max([x["max_abs_err"] for x in rand.values() if x["variant"] == name]
                            + [c["max_abs_err"] for c in runs.values()]),
            ms=cam["ms"], plain_ms=cam["plain_ms"], bound_ms=cam["bound_ms"],
            bound_by=cam["bound_by_cam"], library_ms=None, camera_rays_of_run=run_tag,
            registers=k3_regs.get(name),
            by_run={t: dict(frame_ms_profiler_warm=(profiles[t]["traverse2_s"] * 1e3
                                                    if t in profiles else None),
                            frame_launches_profiler=(profiles[t]["traverse2_launches"]
                                                     if t in profiles else None),
                            frame_ms_events_cold=c["frame_ms"], frame_plain_ms=c["frame_plain_ms"],
                            frame_bound_ms=c["frame_bound_ms"], launches_bound_by=c["bound_by"],
                            pops_by_type={k: c["work"][f"pops_{k}"]
                                          for k in ("internal", "leaf", "instance")},
                            work=c["work"], live_rays=c["rays"],
                            device_busy_s=profiles[t]["device_busy_s"] if t in profiles else None)
                    for t, c in runs.items()},
            random_rays=[dict(x, run=t) for t, x in rand.items() if x["variant"] == name])

    k2_src, k3_src = "mrt_tpu/bvh/twolevel.py:593", "mrt_tpu/bvh/wide.py:936"
    kernels = [
        dict(name="K1 present tonemap_quantize", route="cuda",
             source="mrt_tpu_torch/csrc/present.cu", replaces="mrt_tpu/kernels/present.py:52",
             launches=sum(c["present"] for c in counts.values()),
             launches_by_run={t: counts[t]["present"] for t in counts if counts[t]["present"]},
             max_abs_err=max(c["k1_err"] for c in checks.values()), ms=a["k1_cold"],
             plain_ms=a["k1_plain_ms"], bound_ms=a["k1_bound_ms"], bound_by=a["k1_bound_by"],
             library_ms=None,
             by_run=dict({t: dict(ms_cold=c["k1_cold"], ms_warm=c["k1_warm"], ms_events=c["k1_ms"],
                                  plain_ms=c["k1_plain_ms"], bound_ms=c["k1_bound_ms"])
                          for t, c in checks.items() if "k1_cold" in c},
                         E=dict(shape=e_checks["denoised"]["k1_shape"], **e_k1))),
        traversal_entry("packed", "k2", "A", "K2 two-level traversal", k2_src),
        traversal_entry("masked", "k2", "F", "K2 two-level traversal", k2_src),
        traversal_entry("float_sort", "k2", "G", "K2 two-level traversal", k2_src),
        traversal_entry("flat", "k3", "J", "K3 flat traversal", k3_src),
        traversal_entry("flat_float_sort", "k3", "G flat", "K3 flat traversal", k3_src),
    ]
    d, j = refit_checks["D"], refit_checks["J"]

    def refit_entry(name, key, replaces, head, prefix, by_run):
        return dict(
            name=name, route="cuda", source="mrt_tpu_torch/csrc/refit.cu", replaces=replaces,
            launches=sum(c.get(key, 0) for c in counts.values()),
            launches_by_run={t: c[key] for t, c in counts.items() if c.get(key)},
            max_abs_err=max(x.get("max_abs_err", 0.0) for x in by_run.values()),
            ms=head[f"{prefix}_ms"], plain_ms=head[f"{prefix}_plain_ms"],
            bound_ms=head[f"{prefix}_bound_ms"], bound_by=head[f"{prefix}_bound_by"],
            library_ms=None, by_run=by_run)

    twolevel_checks = {t: c for t, c in refit_checks.items() if "roots_differing" in c}
    twolevel_checks["K"] = k_refit["kernels"]
    flat_refits = {t: refit_checks[t] for t in ("J", "G flat")}
    flat_refits.update({f"L2 gp=2 rank {i}": dict(c, max_abs_err=0.0 if not c["rows_differing"]
                                                  else float("inf"))
                        for i, c in enumerate(refit_checks["L2 gp=2"])})
    kernels += [
        refit_entry("K4 refit_rows (blas)", "refit_blas", "mrt_tpu/bvh/twolevel.py:387", d, "k4",
                    twolevel_checks),
        refit_entry("K4 refit_rows (flat)", "refit_flat", "mrt_tpu/bvh/wide.py:358", j, "k4",
                    flat_refits),
        refit_entry("K5 refit_tlas", "refit_tlas", "mrt_tpu/bvh/twolevel.py:460", d, "k5",
                    twolevel_checks),
    ]
    if any(k["launches"] < 1 or k["max_abs_err"] != 0.0 for k in kernels[-3:]):
        raise AssertionError(f"a refit kernel never launched on the main path or disagreed: "
                             f"{kernels[-3:]}")

    # K6-K8: ms, plain_ms and bound_ms at run A's first launch of a frame
    # (sample 0's camera rays, every lane live; K8: a sample's end; phase
    # 3c), K7 also at its first late launch (under 5 % of the lanes live); the phase-3c
    # checks by run (launches held, the fields not bit-equal with their
    # largest ULP and relative error), the checked frames' CUDA-event times
    # beside the plain versions' and the bounds, the kernel route's frames
    # against the plain route's, and the profiled frames' device time
    def stage_entry(name, stage, replaces):
        t = stage_times[stage]
        errs = [d.get("max_abs", 0.0) for c in stage_checks.values()
                for d in c["stages"][stage]["fields"].values()]
        return dict(
            name=name, route="cuda", source="mrt_tpu_torch/csrc/wavefront.cu", replaces=replaces,
            launches=sum(c.get(stage, 0) for c in counts.values()),
            launches_by_run={t_: c[stage] for t_, c in counts.items() if c.get(stage)},
            max_abs_err=max(errs + [0.0]), ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None,
            **({"late_launch": stage_times["shade_hit_late"]} if stage == "shade_hit" else {}),
            checked={run: dict(launches=c["stages"][stage]["launches"],
                               not_bit_equal=c["not_bit_equal"][stage],
                               frame_ms=c["stages"][stage]["frame_ms"],
                               frame_plain_ms=c["stages"][stage]["frame_plain_ms"],
                               frame_bound_ms=c["stages"][stage]["frame_bound_ms"])
                     for run, c in stage_checks.items()},
            profiled_frame_ms={t_: p["stage_s"][stage] * 1e3 for t_, p in profiles.items()})

    kernels += [
        stage_entry("K6 sample_start", "sample_start", "mrt_tpu/render/wavefront.py:290"),
        stage_entry("K7 shade_hit", "shade_hit", "mrt_tpu/render/wavefront.py:372"),
        stage_entry("K8 resolve_shadow", "resolve_shadow", "mrt_tpu/render/wavefront.py:372"),
    ]
    log(json.dumps(dict(route_frames=route_frames, card=card_name, power_limit=power_limit)))
    if any(k["launches"] < 1 for k in kernels[-3:]):
        raise AssertionError(f"a stage kernel never launched on the main path: {kernels[-3:]}")
    # K9-K11: ms, plain_ms and bound_ms from phase 3p on run E's last
    # buffers (K10 at step 1, K11 on the denoised chain), every pass's and
    # chain's times there, the profiler's device ms per launch (profile_e),
    # and the phase-3p fields that are not bit-equal, by run. K11 in its
    # uint8 form (the end of the temporal and denoised presents): its bytes
    # against K1 and the plain version, its history against the f32
    # form's, and the f32 form (off the main path: present_linear) beside it
    def presenter_entry(name, key, timed, replaces, profiled):
        """``key``: the launch count, the first word of the phase-3p fields,
        uint8 checks and times the entry reads."""
        def mine(k):
            return k.split()[0] == key

        fields = [d for c in presenter_checks.values() for k, v in c["fields"].items()
                  if mine(k) for d in v.values()]
        u8s = [d for c in presenter_checks.values() for k, d in c["u8"].items() if mine(k)]
        t = presenter_checks["E"]["times"][timed]
        return dict(
            name=name, route="cuda", source="mrt_tpu_torch/csrc/presenter.cu", replaces=replaces,
            launches=sum(c.get(key, 0) for c in counts.values()),
            launches_by_run={t_: c[key] for t_, c in counts.items() if c.get(key)},
            max_abs_err=max([d.get("max_abs", 0.0) for d in fields]
                            + [d["vs_plain_max_abs"] for d in u8s] + [0.0]),
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=None,
            times={k: v for k, v in presenter_checks["E"]["times"].items() if mine(k)},
            profiled={k: e_profile[k] for k in profiled},
            not_bit_equal={run: {k: v for k, v in c["not_bit_equal"].items() if mine(k)}
                           for run, c in presenter_checks.items()},
            **({"u8_checks": {run: {k: d for k, d in c["u8"].items() if mine(k)}
                              for run, c in presenter_checks.items()}} if u8s else {}))

    k11_f32 = presenter_entry("K11 temporal_resolve (f32)", "temporal_resolve",
                              "temporal_resolve denoised", "mrt_tpu/upscale/temporal.py:65", [])
    kernels += [
        presenter_entry("K9 svgf_reproject", "svgf_reproject", "svgf_reproject",
                        "mrt_tpu/upscale/denoise.py:90", ["k9_svgf_reproject"]),
        dict(presenter_entry("K10 atrous_pass", "atrous_pass", "atrous_pass step 1",
                             "mrt_tpu/upscale/denoise.py:56",
                             [f"k10_atrous_pass_step_{s}" for s in PK.ATROUS_STEPS]),
             sass=k10_sass),
        dict(presenter_entry("K11 temporal_resolve (uint8 out: K1's tonemap and quantize in its "
                             "epilogue)", "temporal_resolve_u8", "temporal_resolve_u8 denoised",
                             "mrt_tpu/upscale/temporal.py:65", ["k11_temporal_resolve_u8"]),
             f32_form={k: v for k, v in k11_f32.items()
                       if k not in ("name", "route", "source", "replaces")}),
    ]
    # K12 by its two forms on the path: the spatial chain's Lanczos-3 in its
    # uint8 form (run E spatial, phase M's demo) and the temporal chains'
    # bilinear (run E temporal and denoised); ms, plain_ms, bound_ms and
    # library_ms from phase 3p on run E's last buffers (the bilinear on the
    # denoised chain), with the dense products' time (the port's resize
    # before K12) and the largest difference from them; the spatial form
    # also checked at phase M's demo shape, its f32 form (off the main path:
    # present_linear) beside it; each form's registers and spills (-Xptxas
    # -v; instantiations of the strip kernel, resize_strip_kernel<K, C0, C1,
    # C2> and resize_strip_u8_kernel<6, 3, 0, 0>)
    if "k12" not in m_lines["M demo"]:
        raise AssertionError("phase M: K12 was not checked at the demo's shape")
    m_k12 = m_lines["M demo"]["k12"]
    k12_entries = {}
    for form, key, timed, runs, count, profiled, kernel, slot in (
            ("lanczos3, 3 channels, clamped", "resize lanczos3", "resize lanczos3 3ch clamped",
             ("E spatial", "M demo"), "resize", None,
             "resize_strip_kernelILi6ELi3ELi0ELi0E", "K6C3"),
            ("bilinear, 6 channels", "resize bilinear", "resize bilinear 6ch denoised",
             ("E temporal", "E denoised"), "resize", "k12_resize_bilinear_6ch",
             "resize_strip_kernelILi2ELi3ELi1ELi2E", "K2C6"),
            ("lanczos3, 3 channels, clamped; uint8 out: K1's tonemap and quantize in its "
             "epilogue", "resize_u8 lanczos3", "resize_u8 lanczos3 3ch clamped",
             ("E spatial", "M demo"), "resize_u8", "k12_resize_lanczos3_3ch_u8",
             "resize_strip_u8_kernelILi6ELi3ELi0ELi0E", None)):
        u8 = count == "resize_u8"
        mode_counts = {f"E {m}": e_lines[m]["launches"][count] for m in E_MODES}
        mode_counts["M demo"] = counts["M demo"][count]
        t = presenter_checks["E"]["times"][timed]
        fields = [d for c in presenter_checks.values() for k, v in c["fields"].items()
                  if k.startswith(key) for d in v.values()]
        u8s = [d for c in presenter_checks.values() for k, d in c["u8"].items()
               if k.startswith(key)]
        at_m = {}
        if "M demo" in runs and not u8:
            fields += list(m_k12["fields"].values())
            at_m = dict(at_m_demo={k: v for k, v in m_k12.items() if k not in ("fields", "u8")},
                        not_bit_equal_m_demo=m_k12["fields"]["output"]["differing"])
        elif u8:
            at_m = dict(at_m_demo=m_k12["u8"])
        regs = {k: v for k, v in build.ptxas.items() if kernel in k}
        if len(regs) != 1:
            raise AssertionError(f"K12 ({form}): -Xptxas -v reported {sorted(regs)}")
        k12_entries[form] = dict(
            name=f"K12 resize ({form})", route="cuda", source="mrt_tpu_torch/csrc/presenter.cu",
            replaces="mrt_tpu/upscale/spatial.py:15" if form.startswith("lanczos3")
            else "mrt_tpu/upscale/temporal.py:91",
            launches=sum(mode_counts[r_] for r_ in runs),
            launches_by_run={r_: mode_counts[r_] for r_ in runs},
            max_abs_err=max([d.get("max_abs", 0.0) for d in fields]
                            + [d["vs_plain_max_abs"] for d in u8s] + [0.0]),
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t.get("library_ms"), taps=t.get("taps"), dense_ms=t.get("dense_ms"),
            **at_m, ptxas=regs, sass=k12_sass[slot] if slot else None,
            library=t.get("library_call"), library_max_rel_err=t.get("library_max_rel_err"),
            times={k: v for k, v in presenter_checks["E"]["times"].items() if k.startswith(key)},
            vs_dense={run: {k: v for k, v in c["resize_vs_dense"].items() if k.startswith(key)}
                      for run, c in presenter_checks.items()},
            profiled=e_profile[profiled] if profiled else None,
            not_bit_equal={run: {k: v for k, v in c["not_bit_equal"].items() if k.startswith(key)}
                           for run, c in presenter_checks.items()},
            u8_checks={run: {k: d for k, d in c["u8"].items() if k.startswith(key)}
                       for run, c in presenter_checks.items()} if u8 else None)
    f32, bil, u8e = k12_entries.values()
    kernels += [dict(u8e, f32_form={k: v for k, v in f32.items()
                                    if k not in ("name", "route", "source", "replaces")}), bil]
    if any(k["launches"] < 1 for k in kernels[-5:]):
        raise AssertionError(f"a presenter kernel never launched on the main path: {kernels[-5:]}")
    # K7 by instantiation: its launches on the main path, the phase-3c checks
    # of the frames that took it, its registers and spills (-Xptxas -v), and
    # ms, plain_ms and bound_ms at the first launch of the run that times it
    # (the untextured one: run A's; the K7 entry above sums them all)
    k7_regs = {}
    for name, res_ in build.ptxas.items():
        if "shade_hit_kernel" in name:
            k7_regs["untextured"] = res_
        elif "shade_hit_tex_kernel" in name:
            bits = [b == "1" for b in re.findall(r"Lb([01])E", name)[:3]]
            v = sum(1 << k for k, b in enumerate(bits) if b)
            k7_regs[W.K7_VARIANTS[v]] = res_
        elif "shade_hit_rows_kernel" in name:  # <MAPS, MIPS, DEBUG, TAPS>: bits 0-2, 4
            bits = [b == "1" for b in re.findall(r"Lb([01])E", name)[:4]]
            v = 8 | sum(1 << (k if k < 3 else 4) for k, b in enumerate(bits) if b)
            k7_regs[W.K7_VARIANTS[v]] = res_
    k7_timed = {"untextured": "A", "maps": "N", "maps_mips": "F", "maps_debug": "N debug 1",
                "maps_mips_debug": "F debug 1", "debug": "C debug 7"}
    k7_replaces = {"untextured": "mrt_tpu/render/wavefront.py:372",
                   "maps": "mrt_tpu/render/wavefront.py:619",
                   "maps_mips": "mrt_tpu/render/wavefront.py:572",
                   "maps_debug": "mrt_tpu/render/wavefront.py:661",
                   "maps_mips_debug": "mrt_tpu/render/wavefront.py:661",
                   "debug": "mrt_tpu/render/wavefront.py:661"}
    for v, tag in k7_timed.items():
        t = stage_times_by[tag]["shade_hit"]
        mine = {run_: c for run_, c in stage_checks.items() if c["variant"] == v}
        errs = [d.get("max_abs", 0.0) for c in mine.values()
                for d in c["stages"]["shade_hit"]["fields"].values()]
        kernels.append(dict(
            name=f"K7 shade_hit ({v})", route="cuda", source="mrt_tpu_torch/csrc/wavefront.cu",
            replaces=k7_replaces[v],
            launches=sum(c.get(f"k7 {v}", 0) for c in counts.values()),
            launches_by_run={t_: c[f"k7 {v}"] for t_, c in counts.items() if c.get(f"k7 {v}")},
            max_abs_err=max(errs + [0.0]), ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None, timed_at=tag,
            profiler_ms=t["profiler_ms"], bound_share_profiler=t["bound_share_profiler"],
            registers=k7_regs.get(v),
            checked={run_: dict(launches=c["stages"]["shade_hit"]["launches"],
                                not_bit_equal=c["not_bit_equal"]["shade_hit"],
                                frame_ms=c["stages"]["shade_hit"]["frame_ms"],
                                frame_plain_ms=c["stages"]["shade_hit"]["frame_plain_ms"],
                                frame_bound_ms=c["stages"]["shade_hit"]["frame_bound_ms"])
                     for run_, c in mine.items()}))
        if kernels[-1]["launches"] < 1 or not mine:
            raise AssertionError(f"K7's {v} instantiation never launched on the main path or was "
                                 f"never checked: {kernels[-1]}")
    # K7's lane-row form by instantiation (phase L's gp frames), K13-K16:
    # launches on the main path, registers and spills, ms, plain_ms
    # and bound_ms at the first launch of the checked frame of a gp=1 job
    # (K7's ms holds its wrapper's host work: its profiler_ms, and the
    # bound's share of it, are the card's)
    # (one rank alone on the card; K13, K15, K16 and "rows" at run B's
    # scene (K15's and K16's hit forms; their occlusion forms run at gp=2
    # and are checked there), K14 and
    # "rows_maps_taps" at the textured gp scene, every other instantiation
    # at its own job; K13-K16 also by the profiler at that launch and
    # per launch over the profiled frame, and each step's live share), the
    # largest difference from the plain version over every checked launch,
    # and the checked frames of every gp job (all bit-equal to the plain
    # versions, or phase L raised)
    k7_rows_replaces = {"rows": "mrt_tpu/render/wavefront.py:527",
                        "rows_maps": "mrt_tpu/render/wavefront.py:619",
                        "rows_maps_mips": "mrt_tpu/render/wavefront.py:572",
                        "rows_maps_taps": "mrt_tpu/render/wavefront.py:607"}
    gp_timed = {"rows": "L1 gp=1", "rows_maps_taps": "L1 gp=1 textured",
                **{v: f"L1 gp=1 {v}" for v in GP_VARIANT_JOBS}}
    for v in (v for v in W.K7_VARIANTS.values() if v.startswith("rows")):
        t = gp_checks[gp_timed[v]]["k7"]
        mine = {t_: g["k7"] for t_, g in gp_checks.items() if g["k7"]["variant"] == v}
        kernels.append(dict(
            name=f"K7 shade_hit ({v})", route="cuda", source="mrt_tpu_torch/csrc/wavefront.cu",
            replaces=k7_rows_replaces.get(v, "mrt_tpu/render/wavefront.py:661"),
            launches=sum(c.get(f"k7 {v}", 0) for c in counts.values()),
            launches_by_run={t_: c[f"k7 {v}"] for t_, c in counts.items() if c.get(f"k7 {v}")},
            max_abs_err=max(c["max_abs"] for c in mine.values()), ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=None, timed_at=gp_timed[v], profiler_ms=t["profiler_ms"],
            bound_share_profiler=(t["bound_ms"] / t["profiler_ms"] if t["profiler_ms"] else None),
            frame_profiler_ms_per_launch=t["frame_profiler_ms_per_launch"],
            registers=k7_regs.get(v), checked=mine))
        if kernels[-1]["launches"] < 1 or t["variant"] != v:
            raise AssertionError(f"K7's {v} instantiation never launched on the main path or was "
                                 f"never checked: {kernels[-1]}")
    for name, stage, tag, replaces, key in (
            ("K13 gp_rows", "gp_rows", "L1 gp=1", "mrt_tpu/render/wavefront.py:76", "k13"),
            ("K14 banded_taps", "banded_taps", "L1 gp=1 textured",
             "mrt_tpu/assets/texture.py:355", "k14"),
            ("K15 gp_hit_keys", "gp_hit_keys", "L1 gp=1", "mrt_tpu/render/wavefront.py:180",
             "k15"),
            ("K16 gp_lane_unpack", "gp_lane_unpack", "L1 gp=1",
             "mrt_tpu/render/wavefront.py:180", "k16")):
        g_t = gp_checks[tag][key]
        t = g_t["first"]
        kernels.append(dict(
            name=name, route="cuda", source="mrt_tpu_torch/csrc/wavefront.cu", replaces=replaces,
            launches=sum(c.get(stage, 0) for c in counts.values()),
            launches_by_run={t_: c[stage] for t_, c in counts.items() if c.get(stage)},
            max_abs_err=max(g[key]["max_abs"] for g in gp_checks.values() if g[key]["launches"]),
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=None, timed_at=tag, profiler_ms=t["profiler_ms"],
            frame_profiler_ms_per_launch=g_t["frame_profiler_ms_per_launch"],
            frame_ms=g_t["frame_ms"], frame_bound_ms=g_t["frame_bound_ms"],
            live_share=g_t["live_share"],
            registers={n_: r_ for n_, r_ in build.ptxas.items()
                       if any(k_ in n_ for k_ in GP_PROFILED[key])} or None,
            checked={t_: g[key] for t_, g in gp_checks.items() if g[key]["launches"]}))
        if kernels[-1]["launches"] < 1:
            raise AssertionError(f"{name} never launched on the main path: {kernels[-1]}")
    for tag in ("A", "B", "C", "E", "G", "H", "J", "M smoke", "M demo"):
        c = counts[tag]
        if min(c[s] for s in W.STAGES) < 1 or c["k7 untextured"] != c["shade_hit"]:
            raise AssertionError(f"run {tag}: off the kernel route, a stage never launched or a "
                                 f"textured K7 launched: {c}")
    for tag, v in (("F", "maps_mips"), ("N", "maps")):
        c = counts[tag]
        if min(c[s] for s in W.STAGES) < 1 or c[f"k7 {v}"] != c["shade_hit"]:
            raise AssertionError(f"run {tag}: K6-K8 or K7's {v} instantiation never launched, or "
                                 f"another K7 did: {c}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
