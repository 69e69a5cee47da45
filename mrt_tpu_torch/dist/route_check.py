"""The check of a geometry-sharded (gp) frame on the kernel route against
the plain route, on one rank: ``launch.drive(check_route=True)`` calls
``checked_route_frame`` after its frames, and the tests and
``chip_smoke.py``'s phase L read its result.
"""

from __future__ import annotations

import time

import torch


# K13's three kernels, K14's, K15's and K16's (two forms each, one name)
# and K7's lane-row form (every instantiation), by the names the profiler
# gives them
GP_KERNELS = ("gp_rows_count_kernel", "gp_rows_kernel", "gp_gather_kernel", "banded_taps_kernel",
              "gp_hit_keys", "gp_lane_unpack", "shade_hit_rows_kernel")
# idle seconds around a profiled call: a short session with none can lose
# its device events
PROFILER_PAD_S = 0.05


def _device_events(fn, reps: int = 1) -> list:
    """torch.profiler's device events of ``reps`` calls of ``fn`` on the
    card, recorded in a second cycle after a traced warm-up cycle (a
    session's first device events can go missing), with idle time around
    each cycle's calls."""
    from torch.profiler import ProfilerActivity, profile, schedule

    rec = []
    with profile(activities=[ProfilerActivity.CUDA], schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: rec.append(p.events())) as prof:
        for _ in range(2):
            time.sleep(PROFILER_PAD_S)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILER_PAD_S)
            prof.step()
    return [e for e in (rec[0] if rec else []) if e.device_type == torch.autograd.DeviceType.CUDA]


def _by_kernel(ev: list) -> dict:
    """The events of each of ``GP_KERNELS`` (a name matches the kernels
    that hold it): their count and summed ms."""
    out = {}
    for name in GP_KERNELS:
        mine = [e for e in ev if name in e.name]
        out[name] = dict(events=len(mine), ms=sum(e.time_range.elapsed_us() for e in mine) / 1e3)
    return out


def _profiled_frame(fn) -> dict:
    """torch.profiler's device events of one call of ``fn`` on the card,
    their summed device ms and those of GP_KERNELS among them (``kernels``:
    count and ms by kernel name); an empty record is returned as it is, for
    the caller to report."""
    ev = _device_events(fn)
    return dict(device_events=len(ev), device_ms=sum(e.time_range.elapsed_us() for e in ev) / 1e3,
                kernels=_by_kernel(ev))


def _profiled_ms(fn, reps: int = 5) -> float | None:
    """The device ms of one call of ``fn`` (one wrapper call of K13-K16, or
    of K7's lane-row form) by torch.profiler, the mean over ``reps`` calls
    of the GP_KERNELS' events; None where the profiler recorded none."""
    ev = [e for e in _device_events(fn, reps) if any(n in e.name for n in GP_KERNELS)]
    return sum(e.time_range.elapsed_us() for e in ev) / 1e3 / reps if ev else None


def differing(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements of two tensors of one dtype whose bits differ (float32
    compared as int32); every element of the longer where their shapes or
    dtypes differ."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return max(a.numel(), b.numel())
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a != b).sum())


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest |a - b| over the elements whose bits differ (inf where
    one of them is not finite, and for tensors not float32 that differ);
    0.0 for bit-equal tensors."""
    if a.shape != b.shape:
        return float("inf")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        return 0.0 if differing(a, b) == 0 else float("inf")
    same = a.view(torch.int32) == b.view(torch.int32)
    d = torch.where(same, 0.0, (a - b).abs().nan_to_num(float("inf")))
    return float(d.max()) if d.numel() else 0.0


def checked_route_frame(r) -> dict:
    """Draw one frame of the gp renderer ``r`` with its trace run on both
    routes on the same inputs: the kernel route (its wall), the kernel
    route again with each call of K13 (a step's scan, ``gp_scan``, and
    gather, ``gp_gather``, as one entry; sample 0's motion rows,
    ``gp_rows``), K14 (``banded_taps``), K15 (``gp_hit_keys``,
    ``gp_occluded_rows``) and K16 (``gp_lane_unpack``,
    ``gp_occluded_lanes``, in place: their plain versions on copies)
    held against its plain version on the same inputs right after it ran
    (K13's position map, lane list, rows and payload, K14's taps, K15's
    keys or occlusion rows, the record or occlusion K16 wrote: every
    element's bits and the largest difference, ``max_abs``; the step's
    lanes and live lanes, whose ratio is its live share; the bound,
    ``utils/bounds.py``; CUDA-event ms of both, at the frame's first call
    of each over 5 more calls after it on the same inputs, which hold the
    wrapper's checks, and on the card the first call's device ms by
    torch.profiler over 5 calls, ``profiler_ms``)
    and the frame's first K7 launch (the lane-row form) run on copies of
    its state and Wave and held, every state field, against
    ``shade_hit_listed_plain`` with the same rows (each timed once after a
    warm-up run, beside ``bounds.k7_listed``; on the card also its device
    ms by torch.profiler over 5 calls on fresh copies, ``profiler_ms``),
    and the plain route
    (``trace_frame(..., plain=True)``; its wall); on the card each route
    once more under torch.profiler (device events and device ms of one
    frame; the kernel route's with the GP_KERNELS' device events by
    kernel). The frame goes on with the first kernel route's outputs.
    Returns the elements differing between the routes' outputs per field
    (``fields``, ``bit_equal``) and between the two kernel-route runs, the
    rays of each route, the walls and profiles, the K13-K16 checks by call
    (``k13``...``k16``; K15's and K16's with their ``form``), the K7
    check (``k7``) and the gp axis's ranks (``gp_ranks``)."""
    from ..kernels import traverse2
    from ..kernels import wavefront as W
    from ..render import wavefront as wf
    from ..utils import bounds

    cuda = r.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    res = dict(k13=[], k14=[], k15=[], k16=[], gp_ranks=r.mesh.axis("gp").size)
    orig_tf, orig_rows, orig_taps, orig_k7 = wf.trace_frame, W.gp_rows, W.banded_taps, W.shade_hit
    gp_names = ("gp_scan", "gp_gather", "gp_hit_keys", "gp_occluded_rows", "gp_lane_unpack",
                "gp_occluded_lanes")
    orig = {n: getattr(W, n) for n in gp_names}
    scans = []  # the step's scan, held until its gather

    def timed(fn, *a, reps: int = 1):
        """fn(*a) and its CUDA-event ms (None off the card); with ``reps``
        > 1 the mean over that many more calls after it."""
        if not cuda:
            return fn(*a), None
        y = fn(*a)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        if reps == 1:
            y = fn(*a)
        else:
            for _ in range(reps):
                fn(*a)
        ev[1].record()
        torch.cuda.synchronize()
        return y, ev[0].elapsed_time(ev[1]) / reps

    def checked_rows(geom, ids, live, shade=True, motion=False, n_live=None, out=None, pos=None,
                     lane_of=None, counts=None):
        first = not res["k13"]
        args = (geom, ids, live, shade, motion, n_live, out, pos, lane_of, counts)
        (k, kpos, klane), ms = timed(orig_rows, *args, reps=5 if first else 1)
        (p, ppos, plane), plain_ms = timed(W.gp_rows_plain, geom, ids, live, shade, motion,
                                           reps=5 if first else 1)
        b_ms, b_by = bounds.gp_rows(geom, ids, live, shade, motion)
        map_diff = differing(kpos, ppos) + differing(klane, plane)
        res["k13"].append(dict(
            lanes=ids.shape[0], live=plane.shape[0], shade=shade, motion=motion,
            elements=k.numel(), differing=differing(k, p) + map_diff, map_differing=map_diff,
            max_abs=max_abs(k, p), ms=ms, plain_ms=plain_ms,
            profiler_ms=_profiled_ms(lambda: orig_rows(*args)) if first and cuda else None,
            bound_ms=b_ms, bound_by=b_by))
        return k, kpos, klane

    def checked_scan(live, n_live, pos=None, lane_of=None, counts=None):
        first = not res["k13"]
        args = (live, n_live, pos, lane_of, counts)
        (kpos, klane), ms = timed(orig["gp_scan"], *args, reps=5 if first else 1)
        (ppos, plane), plain_ms = timed(W.gp_scan_plain, live, reps=5 if first else 1)
        scans.append(dict(map_differing=differing(kpos, ppos) + differing(klane, plane), ms=ms,
                          plain_ms=plain_ms, bound=bounds.gp_scan(live),
                          profiler_ms=_profiled_ms(lambda: orig["gp_scan"](*args))
                          if first and cuda else None))
        return kpos, klane

    def checked_gather(geom, t, tri, u, v, keys, lane_of, shade=True, motion=False, out=None):
        scan = scans.pop()
        first = not res["k13"]
        args = (geom, t, tri, u, v, keys, lane_of, shade, motion, out)
        k, ms = timed(orig["gp_gather"], *args, reps=5 if first else 1)
        p, plain_ms = timed(W.gp_gather_plain, *args[:-1], reps=5 if first else 1)
        b_ms, b_by = bounds.gp_gather(geom, t, tri, keys, lane_of, shade, motion)
        prof = None
        if first and cuda:
            prof = _profiled_ms(lambda: orig["gp_gather"](*args))
            prof = None if prof is None or scan["profiler_ms"] is None else prof + scan[
                "profiler_ms"]
        res["k13"].append(dict(
            lanes=t.shape[0], live=lane_of.shape[0], shade=shade, motion=motion,
            elements=k.numel(), differing=differing(k, p) + scan["map_differing"],
            map_differing=scan["map_differing"], max_abs=max_abs(k, p),
            ms=None if ms is None else ms + scan["ms"],
            plain_ms=None if plain_ms is None else plain_ms + scan["plain_ms"],
            profiler_ms=prof, bound_ms=b_ms + scan["bound"][0], bound_by=b_by))
        return k

    def checked_k15(form, fn, plain, bound, *args):
        first = not res["k15"]
        k, ms = timed(fn, *args, reps=5 if first else 1)
        p, plain_ms = timed(plain, *args[:-1], reps=5 if first else 1)
        b_ms, b_by = bound
        res["k15"].append(dict(
            form=form, lanes=args[0].shape[0], live=k.shape[0], differing=differing(k, p),
            max_abs=max_abs(k, p), ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            profiler_ms=_profiled_ms(lambda: fn(*args)) if first and cuda else None))
        return k

    def checked_keys(t, tri, lane_of, axis, out=None):
        return checked_k15("keys", orig["gp_hit_keys"], W.gp_hit_keys_plain,
                           bounds.gp_hit_keys(lane_of.shape[0]), t, tri, lane_of, axis, out)

    def checked_occ_rows(occluded, lane_of, out=None):
        return checked_k15("occluded", orig["gp_occluded_rows"], W.gp_occluded_rows_plain,
                           bounds.gp_occluded_rows(lane_of.shape[0]), occluded, lane_of, out)

    def checked_k16(form, fn, plain, bound, args, targets):
        """K16 writes ``targets`` (the last of ``args``) in place: its plain
        version writes copies of them, made first."""
        first = not res["k16"]
        n_in = len(args) - len(targets)
        copies = [x.clone() for x in targets]
        _, plain_ms = timed(plain, *args[:n_in], *copies, reps=5 if first else 1)
        _, ms = timed(fn, *args, reps=5 if first else 1)
        b_ms, b_by = bound
        res["k16"].append(dict(
            form=form, lanes=targets[0].shape[0], live=args[n_in - 1].shape[0],
            differing=sum(differing(a, b) for a, b in zip(targets, copies)),
            max_abs=max(max_abs(a, b) for a, b in zip(targets, copies)), ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            profiler_ms=_profiled_ms(lambda: fn(*args)) if first and cuda else None))

    def checked_unpack(keys, payload, lane_of, t, tri, u, v):
        checked_k16("hits", orig["gp_lane_unpack"], W.gp_lane_unpack_plain,
                    bounds.gp_lane_unpack(lane_of.shape[0]), (keys, payload, lane_of, t, tri, u, v),
                    (t, tri, u, v))

    def checked_occ_lanes(occ, lane_of, occluded):
        checked_k16("occluded", orig["gp_occluded_lanes"], W.gp_occluded_lanes_plain,
                    bounds.gp_occluded_lanes(lane_of.shape[0]), (occ, lane_of, occluded),
                    (occluded,))

    gp_checks = dict(gp_scan=checked_scan, gp_gather=checked_gather, gp_hit_keys=checked_keys,
                     gp_occluded_rows=checked_occ_rows, gp_lane_unpack=checked_unpack,
                     gp_occluded_lanes=checked_occ_lanes)

    def checked_taps(atlas, srow, u, v, lane_of, out=None):
        first = not res["k14"]
        args = (atlas, srow, u, v, lane_of, out)
        k, ms = timed(orig_taps, *args, reps=5 if first else 1)
        p, plain_ms = timed(W.banded_taps_plain, atlas, srow, u, v, lane_of,
                            reps=5 if first else 1)
        b_ms, b_by = bounds.banded_taps(atlas, srow, u, v, lane_of)
        res["k14"].append(dict(
            lanes=u.shape[0], live=srow.shape[0], band_rows=atlas.packed.shape[0],
            differing=differing(k, p), max_abs=max_abs(k, p), ms=ms, plain_ms=plain_ms,
            profiler_ms=_profiled_ms(lambda: orig_taps(*args)) if first and cuda else None,
            bound_ms=b_ms, bound_by=b_by))
        return k

    def checked_k7(fr, st, hits, sidx, wv, rows=None):
        if rows is not None and "k7" not in res:
            hits_t = traverse2.hits_of(hits, fr.tri_base)
            n_listed = st.active.shape[0] if wv.steps == 0 else int(W.listed(wv).numel())
            # K7 updates its state and Wave in place: a copy for each run
            copies = iter([(W.clone_state(st), W.clone_wave(wv)) for _ in range(2)])

            def kernel_step():
                st_c, wv_c = next(copies)
                return orig_k7(fr, st_c, hits, sidx, wv_c, rows)

            (k, _, _), ms = timed(kernel_step)
            prof_ms = _profiled_ms(lambda: orig_k7(fr, W.clone_state(st), hits, sidx,
                                                   W.clone_wave(wv), rows)) if cuda else None
            (p, wv_p, _), plain_ms = timed(W.shade_hit_listed_plain, fr, W.clone_state(st),
                                           hits_t, sidx, wv._replace(buf=None), rows)
            pairs = [(f, a, b) for f, a, b in zip(W.LaneState._fields, k, p) if a is not None]
            fields = {f: differing(a, b) if a.dtype == torch.float32 else int((a != b).sum())
                      for f, a, b in pairs}
            work = bounds.k7_work(fr, st, hits_t, wv_p.shadow, n_listed, wv.shadow, wv.occluded,
                                  rows=rows)
            b_ms, b_by = bounds.k7_listed(work)
            res["k7"] = dict(variant=W.K7_VARIANTS[W.k7_variant(
                fr.settings, fr.statics, fr.scene.atlas.band_lo is not None)], lanes=n_listed,
                fields=fields, differing=sum(fields.values()),
                max_abs=max([max_abs(a, b) for _, a, b in pairs if a.dtype == torch.float32]
                            + [0.0]),
                ms=ms, plain_ms=plain_ms, profiler_ms=prof_ms, bound_ms=b_ms, bound_by=b_by,
                work=work)
        return orig_k7(fr, st, hits, sidx, wv, rows)

    def walled(*a, **k):
        sync()
        t0 = time.perf_counter()
        y = orig_tf(*a, **k)
        sync()
        return y, time.perf_counter() - t0

    def both(*a, **k):
        ok, res["kernel_wall_s"] = walled(*a, **k)
        W.gp_rows, W.banded_taps, W.shade_hit = checked_rows, checked_taps, checked_k7
        for n in gp_names:
            setattr(W, n, gp_checks[n])
        try:
            oc = orig_tf(*a, **k)
        finally:
            W.gp_rows, W.banded_taps, W.shade_hit = orig_rows, orig_taps, orig_k7
            for n in gp_names:
                setattr(W, n, orig[n])
        if cuda:
            res["kernel_profile"] = _profiled_frame(lambda: orig_tf(*a, **k))
        op, res["plain_wall_s"] = walled(*a, plain=True, **k)
        if cuda:
            res["plain_profile"] = _profiled_frame(lambda: orig_tf(*a, plain=True, **k))
        fields, checked = {}, 0
        for f in ok._fields:
            x, y, z = getattr(ok, f), getattr(op, f), getattr(oc, f)
            if x is None:
                continue
            if x.dtype == torch.float32:
                x, y, z = x.view(torch.int32), y.view(torch.int32), z.view(torch.int32)
            fields[f] = int((x != y).sum())
            checked += int((x != z).sum())
        res.update(fields=fields, bit_equal=not any(fields.values()),
                   checked_run_differing=checked,
                   rays=[int(ok.rays_traced.sum(dtype=torch.int64)),
                         int(op.rays_traced.sum(dtype=torch.int64))])
        return ok

    wf.trace_frame = both
    try:
        r.draw()
    finally:
        wf.trace_frame = orig_tf
    return res
