"""K3's time and what it works on, in one tree: the script that
``utils/k2_compare.py --k3`` runs from each tree it compares.

    cd TREE && python /path/to/mrt_tpu_torch/utils/k3_profile.py --pops OUT.npz

It imports ``mrt_tpu_torch`` from the working directory, so the same script
times any checkout that has K3 (``kernels/traverse2.traverse_flat``): it
builds that tree's kernels into its own ``build/``, prints K3's
resources as ``-Xptxas -v`` gave them (registers, static shared memory,
stack and spills of each instantiation), then one JSON line per case:

  * 2^20 random mixed rays over run A's flat table (``random_rays``: the
    rays ``chip_smoke.py`` checks K3 on), unpadded (``flat``) and padded past
    2^20 - 1 rows (``flat_float_sort``): device ms per call (torch.profiler,
    the mean over 10 calls of the kernels named ``traverse2*``) and
    CUDA-event ms per call (the wrapper's host work inside);
  * run J (``frame_profile.RUNS``; K3 ``flat``), run G's scene on the flat
    BVH (``G flat``, ``flat_float_sort``) and run B's scene at gp=1 in one
    process (``L1 gp=1``, the shard table of phase L's first gp job): K3's
    device ms per frame (torch.profiler, warm: each of FRAMES frames after a
    warm-up) and its launches.

Each case's live lanes' pops (one frame's launches, in lane order) go to
``--pops`` (an ``.npz``: ``{case}/{k}`` per launch k), from which
``k2_compare`` reads ``bounds.simt_share``. Nothing here compares a
kernel with its plain version: ``chip_smoke.py`` does.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

# warm frames timed a case
FRAMES = 3


def random_rays(torch, table, n: int = 1 << 20, generator=None):
    """The 2^20 random mixed rays ``chip_smoke.check_random_rays`` holds K2
    and K3 to over ``table``, from ``generator`` (default: seeded 1 on the
    table's device): origins in the root's box, unit directions, half of
    them shadow rays with a finite tmax, 95 % live."""
    dev = table.device
    g = generator if generator is not None else torch.Generator(device=dev).manual_seed(1)
    lo = table[0, 0:24].reshape(3, 8).amin(dim=1)
    hi = table[0, 24:48].reshape(3, 8).amax(dim=1)
    org = lo + (hi - lo) * torch.rand((n, 3), generator=g, device=dev)
    dirs = torch.randn((n, 3), generator=g, device=dev)
    dirs = dirs / dirs.norm(dim=1, keepdim=True)
    shadow = torch.rand(n, generator=g, device=dev) < 0.5
    tmax = torch.where(shadow, 0.1 + 8.0 * torch.rand(n, generator=g, device=dev),
                       torch.full((n,), float("inf"), device=dev))
    active = torch.rand(n, generator=g, device=dev) < 0.95
    return org, dirs, tmax, shadow, active


def k3_device_ms(fn, reps: int) -> tuple[float | None, int]:
    """(device ms of the ``traverse2*`` kernels over ``reps`` calls of ``fn``
    divided by ``reps``, their events), by ``route_check``'s profiler
    session; (None, 0) where it recorded none."""
    from mrt_tpu_torch.dist.route_check import _device_events

    ev = [e for e in _device_events(fn, reps) if "traverse2" in e.name]
    return (sum(e.time_range.elapsed_us() for e in ev) / 1e3 / reps if ev else None), len(ev)


def events_ms(torch, fn, reps: int) -> float:
    """CUDA-event ms per call over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def recorded(torch, traverse2, fn) -> list:
    """Call ``fn`` with ``traverse2.traverse_flat`` wrapped: each of its
    launches' pops of the live lanes in lane order (int16), on the host."""
    orig, launches = traverse2.traverse_flat, []

    def rec(*args, **kw):
        out = orig(*args, **kw)
        launches.append(out.pops[args[7]].to(torch.int16).cpu())
        return out

    traverse2.traverse_flat = rec
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        traverse2.traverse_flat = orig
    return launches


def frames_case(torch, traverse2, tag: str, draw, pops: dict) -> dict:
    """K3 over FRAMES warm frames of ``draw``: the device ms of each (the
    profiler's session draws twice and times the second), then one more
    frame's launches recorded into ``pops[tag]`` and counted."""
    draw()
    torch.cuda.synchronize()
    per_frame = [k3_device_ms(draw, 1)[0] for _ in range(FRAMES)]
    pops[tag] = recorded(torch, traverse2, draw)
    good = [x for x in per_frame if x is not None]
    return dict(case=tag, frame_ms=per_frame,
                frame_ms_median=statistics.median(good) if good else None,
                launches_per_frame=len(pops[tag]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pops", required=True, help="the .npz the per-lane pops go to")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k3_profile: needs a CUDA device", file=sys.stderr)
        return 2
    from mrt_tpu_torch.kernels import build, traverse2
    from mrt_tpu_torch.utils import frame_profile as FP

    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    secs = build.build()
    build.load()
    res = {k: v for k, v in build.ptxas.items() if "traverse2" in k and "kernel" in k}
    print(json.dumps(dict(case="resources", card=card, build_s=secs, ptxas=res)), flush=True)
    pops: dict = {}

    def emit(line):
        print(json.dumps(dict(line, card=card)), flush=True)

    # random rays over run A's flat table, unpadded and padded past 2^20 - 1 rows
    ra = FP.make_renderer("A", dev)
    ra.two_level = False
    flat_a = ra.bvh
    del ra
    padded = torch.zeros((2 ** 20 + 1, flat_a.table.shape[1]), dtype=torch.float32, device=dev)
    padded[: flat_a.table.shape[0]] = flat_a.table
    rays = random_rays(torch, flat_a.table)
    for tag, table in (("random_rays", flat_a.table), ("random_rays_padded", padded)):
        head = (table, flat_a.n_internal, flat_a.stack_size)

        def call(head=head):
            return traverse2.traverse_flat(*head, *rays)

        ms, n_ev = k3_device_ms(call, 10)
        out = call()
        torch.cuda.synchronize()
        pops[tag] = [out.pops[rays[4]].to(torch.int16).cpu()]
        emit(dict(case=tag, variant=traverse2.flat_variant(table.shape[0]), rows=table.shape[0],
                  lanes=rays[0].shape[0], live=int(rays[4].sum()), device_ms=ms, device_events=n_ev,
                  events_ms=events_ms(torch, call, 10), pops=int(out.pops.sum())))
    del padded, rays, flat_a
    torch.cuda.empty_cache()

    # run J, G flat and L1's gp=1 at run B
    rj = FP.make_renderer("J", dev)
    emit(dict(frames_case(torch, traverse2, "J", lambda: FP.frame(rj, 1 / 60), pops),
              rows=rj.bvh.n_rows, variant=traverse2.flat_variant(rj.bvh.n_rows)))
    del rj
    rg = FP.make_renderer("G", dev)
    t0 = time.perf_counter()
    rg.two_level = False
    emit(dict(frames_case(torch, traverse2, "G flat", lambda: FP.frame(rg), pops),
              rows=rg.bvh.n_rows, variant=traverse2.flat_variant(rg.bvh.n_rows),
              flat_rebuild_s=time.perf_counter() - t0))
    del rg
    torch.cuda.empty_cache()
    from mrt_tpu_torch.dist.geometry import GeometryShardedRenderer

    rb = FP.make_renderer("B", dev)
    rb.two_level = False
    settings = rb.settings()
    del rb
    gp = GeometryShardedRenderer(FP.make_scene("B"), settings, device=dev)
    emit(dict(frames_case(torch, traverse2, "L1 gp=1", gp.draw, pops),
              rows=gp.bvh.n_rows, variant=traverse2.flat_variant(gp.bvh.n_rows)))
    return save(np, args.pops, pops)


def save(np, path: str, pops: dict) -> int:
    """Write each case's launches' pops to ``path``; 0."""
    np.savez_compressed(path, **{f"{tag}/{k}": x.numpy() for tag, launches in pops.items()
                                 for k, x in enumerate(launches)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
