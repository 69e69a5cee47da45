"""The refit's device time per call in this tree against other trees, on one
card in one call.

    python -m mrt_tpu_torch.utils.refit_compare build/parent [more trees]

Each tree is a checkout of the repository, such as the parent commit
unpacked under ``build/`` with ``git archive HEAD~ | tar -x -C build/parent``.
This file runs itself (``--measure``) from each tree in a process of its
own, in the order others, this, this, others reversed, with that tree's
package and ``chip_smoke.py`` first on the path, so that every tree builds
and runs its own kernels through the same calls: ``bvh.twolevel.refit`` at
phase D's character, run C and run A (no skinned group: the instance and
TLAS rows alone), ``bvh.wide.refit`` at run J, and each renderer's prepare
stage. Per run and tree one JSON line: the refit's device ms and events
per call and the events by name (torch.profiler, warm, 20 calls), its
CUDA-event ms (20 calls, the host's launch gaps included), and the median
wall of 5 prepare stages between syncs; then a summary line with the
means over each tree's two runs.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REPS = 20


def measure(tree: str) -> None:
    """One JSON line per run for the tree at ``tree`` (its package imported)."""
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [tree] + [p for p in sys.path if os.path.abspath(p or ".") != here]
    import time

    import torch

    import chip_smoke as cs
    from mrt_tpu_torch.bvh import twolevel, wide
    from mrt_tpu_torch.kernels import build
    from mrt_tpu_torch.utils import frame_profile as FP

    if not torch.cuda.is_available():
        raise SystemExit("refit_compare measures on a CUDA device; none is available")
    dev = torch.device("cuda:0")
    build.load()
    card = cs.card_line()

    def profile(fn) -> dict:
        ev = cs.device_events(torch, cs.profiled(torch, fn, REPS)[0])
        names: dict = {}
        for e in ev:
            n = names.setdefault(e.name[:80], [0.0, 0.0])
            n[0] += 1 / REPS
            n[1] += e.time_range.elapsed_us() / 1e3 / REPS
        return dict(device_ms=sum(v[1] for v in names.values()), device_events=len(ev) / REPS,
                    events_by_name=names, events_ms=cs.cuda_ms(fn, REPS))

    def prepare_s(r) -> float:
        walls = []
        for _ in range(6):
            t0 = time.perf_counter()
            r.prepare()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return statistics.median(walls[1:])

    rd, _ = cs.make_character(dev)
    runs = [("D", rd)] + [(tag, FP.make_renderer(tag, dev)) for tag in ("C", "J", "A")]
    for tag, r in runs:
        for _ in range(2):
            r.draw(1 / 60)
        torch.cuda.synchronize()
        if tag == "J":
            _, geom, _ = r.prepare()
            tris = (geom.tri_v0, geom.tri_v1, geom.tri_v2)
            line = profile(lambda r=r, tris=tris: wide.refit(r.bvh, *tris))
        else:
            sd = r.scene_data
            line = profile(lambda r=r, sd=sd: twolevel.refit(r.bvh, sd.positions_obj,
                                                             sd.instance_transform))
        line.update(run=tag, table_rows=int(r.bvh.table.shape[0]), prepare_s=prepare_s(r), card=card)
        print(json.dumps(line), flush=True)
        del r
    del runs, rd


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--measure"]:
        measure(os.path.abspath(argv[1]))
        return 0
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="other checkouts to compare with this one")
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds per tree's run")
    args = ap.parse_args(argv)
    others = [os.path.abspath(t) for t in args.trees]
    order = others + [HERE, HERE] + others[::-1]
    keys = ("device_ms", "device_events", "events_ms", "prepare_s")
    got: dict = {}
    for k, tree in enumerate(order):
        name = "this" if tree == HERE else os.path.relpath(tree, HERE)
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", tree], cwd=tree,
                           capture_output=True, text=True, timeout=args.timeout)
        if p.returncode != 0:
            raise RuntimeError(f"refit_compare failed in {tree} (rc {p.returncode}):\n"
                               f"{p.stdout[-4000:]}\n{p.stderr[-4000:]}")
        for line in p.stdout.splitlines():
            if line.startswith('{"device_ms"'):
                row = json.loads(line)
                print(json.dumps(dict(order=k, tree=name, **row)), flush=True)
                got.setdefault(f"{name} run {row['run']}", []).append({x: row[x] for x in keys})
    summary = {t: {x: statistics.fmean(r[x] for r in rows) for x in keys} for t, rows in got.items()}
    print(json.dumps(dict(summary=summary)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
