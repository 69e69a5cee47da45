"""The port's spans and counters against the device trace, and what they
cost, for PERF.md.

    python3 bench_h100/spancheck.py --workloads <cell>,... --seeds <n>,...
        [--seconds 10] [--cost-seconds 5] [--out spancheck.jsonl]

For each cell and seed it makes one traced run (``run.run_cell``, its check
included, the port's counters cleared first as in a run of its own) and
prints one JSON line: the result line's metrics and ``correct``; over the
profiled frames the share of the idle device time that ``mrt.draw`` and
``mrt.present`` cover (``covered``), the idle by innermost span
(``spanlib.idle_by_span``, ms a profiled frame), the device-to-host copies a
frame (``Memcpy DtoH`` events) beside the counters' ``host_syncs`` a frame
over the same frames, the ``mrt.*`` spans a frame, and the profiled against
the unprofiled frame wall. Then, once a cell, the cost: unprofiled windows
and profiles of ``--cost-seconds`` in turns with the spans as they are and
with ``telemetry.span`` replaced by the no-op (on, off, on, off), and the
host's cost of one span and one count with no profiler (best of 5 loops)
and of one span while a profiler records.
Its look for a card is the caller's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
for _p in (HERE.parent, HERE):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def per_call_us(fn, n: int = 200_000, trials: int = 5) -> float:
    """Best µs a call of ``fn()`` over ``trials`` loops of ``n``, less the
    empty loop's."""
    def loop(f):
        t0 = time.perf_counter()
        for _ in range(n):
            f()
        return (time.perf_counter() - t0) / n * 1e6

    def nothing():
        pass

    return min(loop(fn) for _ in range(trials)) - min(loop(nothing) for _ in range(trials))


def host_costs() -> dict:
    """µs of one span entered and left and of one count with no profiler
    on, and of one span while a profiler records (``span_on_us``)."""
    from torch.profiler import ProfilerActivity, profile

    from mrt_tpu_torch.utils import telemetry as tm

    def one_span():
        with tm.span("mrt.cost"):
            pass

    def one_count():
        tm.count("cost.probe")

    out = dict(span_us=per_call_us(one_span), count_us=per_call_us(one_count))
    tm.counters.pop("cost.probe", None)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        out["span_on_us"] = per_call_us(one_span, n=20_000, trials=3)
    return out


def traced_run(files: dict, seed: int, seconds: float, device) -> dict:
    """One traced run with its profile kept: the result and the spans'
    readings over the profiled frames."""
    import run
    import spanlib
    from mrt_tpu_torch.utils import telemetry as tm

    kept = {}
    profile = run.profile

    def keep(r, step, traffic, sync):
        # the counters at each recording's first profiled frame (after its
        # two warm-up steps), so that they cover the profiled frames alone
        calls, marks = [0], []

        def counted():
            if calls[0] % (traffic["profile_frames"] + 2) == 2:
                marks.append(dict(tm.counters))
            calls[0] += 1
            return step()

        tr = profile(r, counted, traffic, sync)
        c0 = marks[-1]
        kept.update(trace=tr, counters={k: v - c0.get(k, 0) for k, v in tm.counters.items()})
        return tr

    tm.reset()
    run.profile = keep
    try:
        result, detail = run.run_cell(files, seed, seconds, True, device)
    finally:
        run.profile = profile
    tr, c = kept["trace"], kept["counters"]
    n = tr["frames"]
    gaps = spanlib.idle_gaps(tr["events"])
    idle = sum(e - s for s, e in gaps)
    covered = sum(spanlib.overlap_us(gaps, spanlib.intervals(tr, name))
                  for name in ("mrt.draw", "mrt.present"))
    by_span = spanlib.idle_by_span(tr)
    dtoh = sum(1 for name, _, _ in tr["events"] if "Memcpy DtoH" in name)
    return dict(
        workload=files["cell"]["name"], seed=seed, correct=result["correct"],
        metrics={k: v["value"] for k, v in result["metrics"].items()},
        idle_ms_profiled_frame=idle / 1e3 / n, covered=covered / idle if idle else None,
        idle_by_span_ms={k: round(v / 1e3 / n, 4)
                         for k, v in sorted(by_span.items(), key=lambda kv: -kv[1])},
        dtoh_per_frame=dtoh / n, host_syncs_per_profiled_frame=c.get("host_syncs", 0) / n,
        frames_counted=c.get("frames"), loop_steps_per_frame=c.get("loop_steps", 0) / n,
        extra_samples_per_frame=c.get("extra_samples", 0) / n,
        spans_per_frame=sum(1 for name, _, _ in tr["host"] if name.startswith("mrt.")) / n,
        profiled_wall_ms=tr["wall_s"] / n * 1e3, unprofiled_wall_ms=tr["frame_wall_s"] * 1e3,
        setup=detail["setup_s"], breakdown=result.get("breakdown"))


def cost(files: dict, seed: int, seconds: float, device) -> dict:
    """Frame walls with the spans as they are and with them replaced by the
    no-op, unprofiled and profiled, in turns."""
    import torch

    import run
    from mrt_tpu_torch.utils import telemetry as tm

    clock = run.DeviceClock(torch, device)
    r = run.build_program(files["config"], files["traffic"], seed, device)[0]
    step = run.make_step(r, files["traffic"])
    for _ in range(files["traffic"]["warmup_frames"]):
        step()
    clock.sync()
    span = tm.span
    walls = []
    undo, _ = run.steady_host()
    try:
        for mode in ("on", "off", "on", "off"):
            tm.span = span if mode == "on" else (lambda name: tm._OFF)
            start, evs, _, _ = run.measure(r, step, seconds, clock.sync, clock.event)
            tr = run.profile(r, step, files["traffic"], clock.sync)
            walls.append(dict(spans=mode, unprofiled_ms=clock.elapsed_ms(start, evs[-1]) / len(evs),
                              profiled_ms=tr["wall_s"] / tr["frames"] * 1e3))
    finally:
        tm.span = span
        undo()
    return dict(workload=files["cell"]["name"], seed=seed, walls=walls, **host_costs())


def main(argv=None) -> int:
    import torch

    import run

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workloads", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--cost-seconds", type=float, default=5.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    bench = run.load_benchmark()
    seeds = [int(s) for s in args.seeds.split(",")]
    out = open(args.out, "a") if args.out else None

    def emit(line: dict):
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()

    try:
        for cell in args.workloads.split(","):
            files = run.cell_files(bench, cell)
            for s in seeds:
                emit(traced_run(files, s, args.seconds, device))
            emit(cost(files, seeds[0], args.cost_seconds, device))
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
