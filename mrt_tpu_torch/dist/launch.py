"""Start a world of ranks on one host, and drive a sharded renderer on each.

    results = launch(fn, world_size, *args)                  # one rank per card, nccl
    results = launch(fn, world_size, *args, backend="gloo")  # several ranks per card
    results = launch(fn, world_size, *args, device="cpu")    # gloo on the CPU

spawns ``world_size`` processes (``torch.multiprocessing``, the ``spawn``
start method), sets ``torch.distributed`` up in each with a ``file://``
store in a temporary directory (no TCP port to share between concurrent
worlds), runs ``fn(*args)`` and returns each rank's return value, by rank.
``fn`` and its arguments go to the ranks by pickling, so ``fn`` is a
module-level function. The world runs on the card unless the caller asks
for the CPU, as every entry point of the port does: rank r on
``cuda:{r % device_count}``, with the kernels built before the ranks are
spawned so that they only load the library; or on the CPU with one torch
thread each. The backend defaults to nccl on the card and gloo on the CPU.
A world of more ranks than cards needs ``backend="gloo"``: nccl raises
there, and the launcher never switches backends on its own. A mesh built
on a rank (``comm.Mesh``) takes the launcher's device unless it is given
one, and raises if it is given another.

Rank-side functions to launch, for the tests and ``chip_smoke.py``:
``drive`` renders frames with ``DistributedRenderer`` or
``GeometryShardedRenderer`` and returns what they check; ``on_mesh`` calls
functions that take a mesh axis on per-rank inputs (``caught`` returns what
such a call raised); ``run_jobs`` runs several such calls in one world.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
from datetime import timedelta

import torch
import torch.distributed as dist

from ..core.device import resolve as resolve_device
from . import comm


# how long a collective waits for the other ranks before it raises
TIMEOUT_S = 900.0


def launch(fn, world_size: int, *args, backend: str | None = None, device=None,
           stats: dict | None = None) -> list:
    """Run ``fn(*args)`` on ``world_size`` spawned ranks and return their
    results by rank (see the module docstring). ``device``: None for the
    card (raises when there is none), or ``"cpu"``; ``backend``: None for
    nccl on the card and gloo on the CPU. ``stats``, when given, is filled
    with the seconds from the spawn to each rank's start, to its process
    group's readiness and to its end (host clock)."""
    import torch.multiprocessing as mp

    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend runs on CUDA devices only")
    if dev.type == "cuda":
        comm.check_backend(backend, world_size)
        from ..kernels import build

        build.ensure_built()
    with tempfile.TemporaryDirectory(prefix="mrt_dist_") as d:
        # the call goes through a file: a spawned process reads its pipe only
        # after its imports, so large arguments there would start the ranks
        # one after another
        with open(os.path.join(d, "call.pkl"), "wb") as f:
            pickle.dump((fn, args), f)
        t0 = time.time()
        mp.start_processes(_rank_main, args=(world_size, backend, dev.type, d),
                           nprocs=world_size, start_method="spawn", join=True)
        out, times = [], []
        for r in range(world_size):
            with open(os.path.join(d, f"result{r}.pkl"), "rb") as f:
                result, t = pickle.load(f)  # written by this program's ranks
            out.append(result)
            times.append({k: v - t0 for k, v in t.items()})
    if stats is not None:
        stats.update(world=world_size, backend=backend, ranks=times)
    return out


def _rank_main(rank, world_size, backend, device_type, d):
    times = dict(start=time.time())
    with open(os.path.join(d, "call.pkl"), "rb") as f:
        fn, args = pickle.load(f)  # written by the launching process
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(world_size)
    os.environ[comm.RANK_DEVICE_ENV] = device_type
    if device_type == "cpu":
        # ranks share the host's cores: one torch thread each
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(comm.rank_device("cuda"))
    dist.init_process_group(backend, init_method=f"file://{os.path.join(d, 'store')}", rank=rank,
                            world_size=world_size, timeout=timedelta(seconds=TIMEOUT_S))
    times["ready"] = time.time()
    try:
        result = fn(*args)
    finally:
        dist.destroy_process_group()
    times["done"] = time.time()
    tmp = os.path.join(d, f"result{rank}.tmp")
    with open(tmp, "wb") as f:
        pickle.dump((result, times), f)
    os.replace(tmp, os.path.join(d, f"result{rank}.pkl"))


def run_jobs(jobs) -> list:
    """Rank side: ``fn(*args, **kwargs)`` for each ``(fn, args, kwargs)`` of
    ``jobs``, in order; their results."""
    return [fn(*args, **kwargs) for fn, args, kwargs in jobs]


def drive(kind: str, scene, settings, shape: dict, frames: int, *, seed: int = 0, offsets=None,
          banded: bool = True, joints=(), save=None, restore=None, present: bool = False,
          check_flat: bool = False, check_route: bool = False, record_rows: bool = False,
          device=None) -> dict:
    """Rank side: a ``DistributedRenderer`` (``kind`` "dp") or a
    ``GeometryShardedRenderer`` ("gp") over a ``comm.Mesh`` of ``shape`` on
    this rank's device; ``restore`` a checkpoint path to resume from; then
    ``frames`` draws, ``joints[k]`` (when given) set as the joint matrices
    before draw k, and ``save_dist`` to ``save[1]`` after ``save[0]`` draws.
    ``present``: rank 0 runs kernel K1 on the last gathered image and
    compares it with K1's plain version. ``check_flat`` ("gp"): after those
    draws, one more frame in which every rank holds each launch of kernel
    K3 on its shard table against the plain version, and its refit of the
    shard table (kernel K4 ``flat``) too (``_checked_flat_frame``).
    ``check_route`` ("gp"): then one more frame whose trace runs on the
    kernel route and on the plain route, compared bit for bit, with each
    launch of K13 and K14 held against its plain version
    (``route_check.checked_route_frame``). ``record_rows`` ("gp"): each gp
    step of the drawn frames recorded (``rows_psums``: its lanes, live
    lanes, the count ``lane_rows`` was given, its row floats, whether it
    has taps, the elements of each ``comm.psum_`` ``lane_rows`` issued,
    and each collective of the step, ``collectives``: its op, elements,
    bytes and the axis's ranks; ``collectives_summary`` sums them), and the
    frames' collectives outside the steps (``frame_collectives``).

    Returns a dict: ``setup_s`` (the mesh's and the renderer's
    construction, and the restore), ``images`` (each frame's full
    accumulation, rank 0 only), ``rays`` (each frame's total, int64),
    ``rays_local`` ("gp": this rank's own count before the reductions),
    ``walls`` (each draw's seconds, the device synchronised),
    ``prepare_reused`` (whether the frame reused the prepared geometry;
    "dp" only), the kernels' launch counts over the draws and the present
    (K4's and K5's under ``refit_blas``, ``refit_flat``, ``refit_tlas``,
    K6-K8's under their stage names, ``kernels.wavefront.STAGES``),
    with ``present`` the uint8 image and K1's largest difference from its
    plain version, with ``check_flat`` this rank's check (``flat_check``)
    and with ``check_route`` its route check (``route_check``). The launch
    counts also hold K13's and K14's (``gp_rows``, ``banded_taps``) and
    K7's by instantiation (``k7``); they are read before the checked
    frames."""
    from ..engine import checkpoint
    from ..kernels import present as k1
    from ..kernels import refit, traverse2
    from ..kernels import wavefront as W
    from .geometry import GeometryShardedRenderer
    from .sharding import DistributedRenderer

    t0 = time.perf_counter()
    mesh = comm.Mesh(shape, device)
    if kind == "dp":
        r = DistributedRenderer(scene, settings, mesh, seed=seed, offsets=offsets)
    elif kind == "gp":
        r = GeometryShardedRenderer(scene, settings, mesh, banded=banded, seed=seed, offsets=offsets)
    else:
        raise ValueError(f"unknown renderer kind {kind!r}")
    if restore is not None:
        checkpoint.restore_dist(r, restore)
    sync = torch.cuda.synchronize if mesh.device.type == "cuda" else (lambda: None)
    rank0 = mesh.rank == 0
    out = dict(images=[], rays=[], rays_local=[], walls=[], prepare_reused=[], rank=mesh.rank,
               backend=dist.get_backend() if dist.is_initialized() else None,
               device=str(mesh.device), table_bytes=r.bvh.table.numel() * 4,
               setup_s=time.perf_counter() - t0)
    k1.launches = 0
    traverse2.reset_launches()
    refit.reset_launches()
    W.reset_launches()
    unpatch = None
    if record_rows:
        out["rows_psums"], out["frame_collectives"], unpatch = _record_rows(W)
    img = None
    for k in range(frames):
        if k < len(joints) and joints[k] is not None:
            r.set_joint_matrices(joints[k])
        before = getattr(r, "_prepared", None)
        sync()
        t0 = time.perf_counter()
        img = r.draw()
        sync()
        out["walls"].append(time.perf_counter() - t0)
        out["rays"].append(int(r.last_rays_traced))
        out["rays_local"].append(int(r.last_rays_local) if kind == "gp" else None)
        out["prepare_reused"].append(before is not None and getattr(r, "_prepared", None) is before)
        if rank0:
            out["images"].append(img.cpu().numpy())
        if save is not None and k + 1 == save[0]:
            checkpoint.save_dist(r, save[1])
    if present and rank0:
        u8 = k1.tonemap_quantize(img.contiguous())
        plain = k1.tonemap_quantize_plain(img)
        out["present"] = u8.cpu().numpy()
        out["present_max_err"] = int((u8.int() - plain.int()).abs().max())
    if unpatch is not None:
        unpatch()
    sync()
    # the main path's launches: the checked frames below are not counted
    out["launches"] = dict(present=k1.launches, traverse2=traverse2.launches,
                           traverse_flat=traverse2.flat_launches,
                           variants=dict(traverse2.variant_launches),
                           refit_blas=refit.rows_launches["blas"],
                           refit_flat=refit.rows_launches["flat"], refit_tlas=refit.tlas_launches,
                           k7=dict(W.variant_launches), **W.launches)
    if check_flat:
        out["flat_check"] = _checked_flat_frame(r, traverse2)
    if check_route:
        from .route_check import checked_route_frame

        out["route_check"] = checked_route_frame(r)
    return out


# the collectives of dist/comm.py a gp frame can issue: in place (the gp
# step's) and copying (over a whole tensor)
COLLECTIVES = ("psum_", "pmin_", "pmax_", "psum", "pmin", "pmax")


def _record_rows(W):
    """Patch ``W.lane_rows``, ``W.gp_motion_rows``, ``W.resolve_shadow``
    and the collectives of ``comm`` (``COLLECTIVES``) to record each gp
    step (see ``drive``'s ``record_rows``): a step runs from its
    ``lane_rows`` call to the next, or to its sample's end; a collective
    outside a step (sample 0's motion rows) goes to a list of its own.
    Returns the two lists they fill and a function that puts the originals
    back."""
    orig = {n: getattr(comm, n) for n in COLLECTIVES}
    orig_w = {n: getattr(W, n) for n in ("lane_rows", "gp_motion_rows", "resolve_shadow")}
    steps, outside, cur, inside = [], [], [], []

    def recorder(name):
        def collective(x, axis):
            rec = dict(op=name, elements=x.numel(), bytes=x.numel() * x.element_size(),
                       ranks=axis.size)
            (cur[-1]["collectives"] if cur else outside).append(rec)
            if inside and name == "psum_":
                cur[-1]["psums"].append(x.numel())
            return orig[name](x, axis)
        return collective

    def lane_rows(fr, st, hits, wv, n_live):
        cols = 16 + 18 * W.needs_motion_rows(fr.settings, fr.statics)
        taps = W.needs_lane_taps(fr.settings, fr.statics, fr.scene.atlas.band_lo is not None)
        steps.append(dict(lanes=st.active.shape[0], live=int(st.active.sum()), n_live=n_live,
                          cols=cols, taps=taps, psums=[], collectives=[]))
        cur[:] = [steps[-1]]
        inside.append(True)
        try:
            return orig_w["lane_rows"](fr, st, hits, wv, n_live)
        finally:
            inside.pop()

    def ends_step(name):
        def fn(*a, **k):
            cur.clear()
            return orig_w[name](*a, **k)
        return fn

    def unpatch():
        for n, f in orig.items():
            setattr(comm, n, f)
        for n, f in orig_w.items():
            setattr(W, n, f)

    for n in COLLECTIVES:
        setattr(comm, n, recorder(n))
    W.lane_rows = lane_rows
    W.gp_motion_rows, W.resolve_shadow = ends_step("gp_motion_rows"), ends_step("resolve_shadow")
    return steps, outside, unpatch


def collectives_summary(steps: list) -> dict:
    """The collectives of recorded gp steps (``drive(record_rows=True)``'s
    ``rows_psums``) that reduce over more than one rank: per step their
    count, elements and bytes (lists, step by step), the bytes of all of
    them, each step's live share, and ``copying``: the collectives that
    reduce a whole tensor copy (``psum``, ``pmin``, ``pmax``; the
    full-width combine) rather than a step's live-lane buffer in place."""
    real = [[c for c in st["collectives"] if c["ranks"] > 1] for st in steps]
    return dict(steps=len(steps), count=[len(r) for r in real],
                elements=[sum(c["elements"] for c in r) for r in real],
                bytes=[sum(c["bytes"] for c in r) for r in real],
                total_bytes=sum(c["bytes"] for r in real for c in r),
                live_share=[st["live"] / st["lanes"] for st in steps],
                ops=sorted({c["op"] for r in real for c in r}),
                copying=sum(c["op"] in ("psum", "pmin", "pmax") for r in real for c in r))


def _checked_flat_frame(r, traverse2) -> dict:
    """Draw one frame of the gp renderer ``r`` with each K3 launch held
    against ``traverse_flat_plain`` on the same inputs right after it ran:
    the hit triangle, ``found`` and the pops equal, and t, u, v equal in
    their bits. The shard table is padded to the shapes every shard shares
    (internal rows without a child, leaves without a triangle, NaN boxes
    after the refit): the plain version's per-row visits show whether a
    lane reached one. The frame's refit of the shard table is held
    against ``kernels.refit.flat_plain`` on the same triangles and ids,
    every row bit for bit (``refit``: launches, rows differing, the rows no
    leaf reaches, the kernel's CUDA-event ms where it ran on the card and
    its bound). Returns the launches, lanes, mismatches by field, the
    largest |t| difference over hits, and the padded rows and their
    visits."""
    from ..kernels import refit
    from ..utils import bounds

    bvh = r.bvh
    padded = torch.cat([(bvh.node_child < 0).all(dim=1), (bvh.leaf_tri < 0).all(dim=1)])
    fields = ("tri", "found", "pops", "t", "u", "v")
    res = dict(launches=0, lanes=0, mismatches=dict.fromkeys(fields, 0), max_abs_err=0.0,
               rows=bvh.n_rows, n_internal=bvh.n_internal, depth=bvh.depth,
               stack_size=bvh.stack_size, padded_rows=int(padded.sum()), padded_visits=0)
    orig = traverse2.traverse_flat
    orig_refit = refit.flat
    res["refit"] = dict(launches=0, rows=bvh.n_rows, rows_differing=0,
                        unreached_rows=int(bvh.walkup.unreached.numel()), ms=None,
                        bound_ms=bounds.flat_refit(bvh, row_ids=True)[0])

    def checked_refit(wbvh, *args):
        cuda = args[0].device.type == "cuda"
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        table = orig_refit(wbvh, *args)
        if cuda:
            ev[1].record()
            torch.cuda.synchronize()
            res["refit"]["ms"] = ev[0].elapsed_time(ev[1])
        plain = refit.flat_plain(wbvh, *args)
        res["refit"]["rows_differing"] += int(
            (table.view(torch.int32) != plain.view(torch.int32)).any(dim=1).sum())
        res["refit"]["launches"] += 1
        return table

    def checked(*args, **kw):
        kout = orig(*args, **kw)
        pout = traverse2.traverse_flat_plain(*args, **kw)
        bad = res["mismatches"]
        for f in fields:
            a, b = getattr(kout, f), getattr(pout, f)
            if a.dtype == torch.float32:  # t, u, v: equal in their bits
                a, b = a.view(torch.int32), b.view(torch.int32)
            bad[f] += int((a != b).sum())
        hit = pout.tri >= 0
        if bool(hit.any()):
            err = float((kout.t[hit] - pout.t[hit]).abs().max())
            res["max_abs_err"] = max(res["max_abs_err"], err)
        res["padded_visits"] += int(pout.visits[padded, 0].sum())
        res["launches"] += 1
        res["lanes"] += kout.t.numel()
        return kout

    traverse2.traverse_flat = checked
    refit.flat = checked_refit
    try:
        r.draw()
    finally:
        traverse2.traverse_flat = orig
        refit.flat = orig_refit
    return res


def _host(x):
    """Tensors (in tuples, lists and dicts) as NumPy arrays."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_host(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_host(v) for v in x)
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    return x


def caught(fn, *args):
    """Rank side: ``("returned", fn(*args))``, or ``("raised", "ValueError",
    its message)`` where it raised a ValueError (a refused argument): a call
    a test expects to be refused on every rank, without ending the world."""
    try:
        return ("returned", fn(*args))
    except ValueError as e:
        return ("raised", type(e).__name__, str(e))


def on_mesh(shape: dict, calls, device=None) -> dict:
    """Rank side: a ``comm.Mesh`` of ``shape``; for each ``(axis_name, fn,
    args_by_rank)`` of ``calls``, ``fn(*args_by_rank[rank], axis)`` with the
    mesh's axis of that name last (``comm.psum`` with per-rank ``(x,)``
    reduces ``x``). Returns the mesh's rank layout and the results, tensors
    as NumPy arrays."""
    mesh = comm.Mesh(shape, device)
    results = []
    for name, fn, args_by_rank in calls:
        args = [a.to(mesh.device) if isinstance(a, torch.Tensor) else a
                for a in args_by_rank[mesh.rank]]
        results.append(_host(fn(*args, mesh.axis(name))))
    return dict(ranks=mesh.ranks, rank=mesh.rank, results=results)
