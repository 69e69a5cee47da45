"""K2's and K3's device time in this tree against other trees, on one card in
one call.

    python -m mrt_tpu_torch.utils.k2_compare build/parent [more trees] [--out build/k2_compare]
        [--runs F,N,A,J] [--k7]
    python -m mrt_tpu_torch.utils.k2_compare build/parent --k3 [--no-frames]

Each tree is a checkout of the repository, such as the parent commit
unpacked under ``build/`` with ``git archive HEAD~ | tar -x -C build/parent``.
The script runs this tree's ``utils/frame_profile.py`` in each tree (its
working directory, its package first on the path) in its own process, in
the order others, this, this, others reversed, so that a drift of the
card's clocks over the call shows as a difference between the two runs of
one tree. Every tree builds its own kernels into its own ``build/``.
``--runs`` and ``--k7`` go to frame_profile (its runs; K7's resources, its
first launch's profiler ms and each frame's bound). One JSON line per run
and tree goes to stdout (the frame_profile line: K2's profiler time over
one warm frame, device busy time, K6-K8's, gathers, idle share, the frame
walls, rays), then a summary line with K2's mean over each tree's two runs
and, under ``k7``, K7's device ms over the warm profiled frame of runs F,
N, A and J per tree (each run's, their mean and spread; with ``--k7`` the
first launch's profiler ms, the frame's bound and its share, and each
tree's K7 resources); the profiler tables go to ``--out``.

With ``--k3`` each run of a tree also runs this tree's ``utils/k3_profile.py``
from that tree (in its own process, after its frame_profile; with
``--no-frames`` instead of it): K3's resources, its device ms on 2^20
random rays over run A's flat table (unpadded: ``flat``; padded past 2^20 -
1 rows: ``flat_float_sort``) and per warm frame at run J, run G on the flat
BVH and run B at gp=1, without adding a run to ``frame_profile.RUNS``. The
K3 summary line gives each tree's mean over its two runs, its registers,
shared memory, stack and spills per instantiation beside the blocks and
warps an SM holds (``bounds.blocks_per_sm``), and each case's SIMT share
at groups of 32, 8 and 4 (``bounds.simt_share`` of the pops one frame's
launches or one random batch gave; equal in every tree, since each tree's
K3 is pop-equal to the plain version: ``pops_equal`` says whether they
were).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
K3_SCRIPT = os.path.join(HERE, "mrt_tpu_torch", "utils", "k3_profile.py")
FP_SCRIPT = os.path.join(HERE, "mrt_tpu_torch", "utils", "frame_profile.py")
# the runs whose K7 the summary line gives: the textured F (maps_mips) and N
# (maps), the untextured A and J
K7_RUNS = ("F", "N", "A", "J")
# K3's kernels (K2's kernel under FLAT) by instantiation, launched in
# blocks of K3_THREADS
K3_KERNELS = {"traverse2_kernelILb0ELb0ELb1E": "flat", "traverse2_kernelILb0ELb1ELb1E": "flat_float_sort"}
K3_THREADS = 128
SIMT_GROUPS = (32, 8, 4)


def profile_tree(tree: str, out_file: str, timeout: float, runs: str | None = None,
                 k7: bool = False) -> list[dict]:
    """The frame_profile lines of one run of ``tree`` (this tree's
    ``utils/frame_profile.py`` with ``tree``'s package first on the path)."""
    env = dict(os.environ, PYTHONPATH=tree)
    cmd = [sys.executable, FP_SCRIPT, "--out", out_file] + (["--runs", runs] if runs else [])
    p = subprocess.run(cmd + (["--k7"] if k7 else []), cwd=tree, env=env, capture_output=True,
                       text=True, timeout=timeout)
    if p.returncode != 0:
        raise RuntimeError(f"frame_profile failed in {tree} (rc {p.returncode}):\n{p.stdout}\n{p.stderr}")
    return [json.loads(line) for line in p.stdout.splitlines() if line.startswith("{")]


def k3_tree(tree: str, pops_file: str, timeout: float) -> list[dict]:
    """The k3_profile lines of one run of ``tree``."""
    env = dict(os.environ, PYTHONPATH=tree)
    p = subprocess.run([sys.executable, K3_SCRIPT, "--pops", pops_file],
                       cwd=tree, env=env, capture_output=True, text=True, timeout=timeout)
    if p.returncode != 0:
        raise RuntimeError(f"k3_profile failed in {tree} (rc {p.returncode}):\n{p.stdout}\n{p.stderr}")
    return [json.loads(line) for line in p.stdout.splitlines() if line.startswith("{")]


def k3_resources(ptxas: dict) -> dict:
    """K3's -Xptxas -v figures by instantiation, with the blocks and warps an
    SM holds at K3_THREADS threads a block."""
    from . import bounds

    out = {}
    for mangled, r in ptxas.items():
        v = next((v for k, v in K3_KERNELS.items() if k in mangled), None)
        if v is not None:
            blocks = bounds.blocks_per_sm(r["registers"], K3_THREADS, r.get("smem", 0))
            out[v] = dict(r, threads=K3_THREADS, blocks_per_sm=blocks,
                          warps_per_sm=blocks * K3_THREADS // 32)
    return out


def k3_shares(pops_file: str) -> dict:
    """Per case of a k3_profile ``--pops`` file (each launch's live lanes'
    pops): its launches, live lanes, pops and ``bounds.simt_share`` at each
    of SIMT_GROUPS over the case's launches together."""
    import numpy as np
    import torch

    from . import bounds

    data = np.load(pops_file)
    cases: dict = {}
    for key in data.files:
        case, k = key.rsplit("/", 1)
        cases.setdefault(case, {})[int(k)] = torch.from_numpy(data[key])
    out = {}
    for case, launches in cases.items():
        steps = {g: [0, 0] for g in SIMT_GROUPS}
        for p in launches.values():
            for g in SIMT_GROUPS:
                w, s = bounds.lane_steps(p, torch.ones(p.shape, dtype=torch.bool), g)
                steps[g][0] += w
                steps[g][1] += s
        out[case] = dict(launches=len(launches), live=sum(p.numel() for p in launches.values()),
                         pops=steps[SIMT_GROUPS[0]][0],
                         simt_share={g: w / s if s else 1.0 for g, (w, s) in steps.items()})
    return out


def k7_summary(runs: dict, resources: dict) -> dict:
    """K7 per run of K7_RUNS and tree: its device ms over each warm profiled
    frame (frame_profile's ``stage_s["shade_hit"]``), their mean and spread
    (largest less smallest), and where frame_profile ran with ``--k7`` the
    first launch's profiler ms, the frame's bound and its share of the
    mean; then each tree's K7 resources (``--k7``)."""
    out = {}
    for run in K7_RUNS:
        for tree, lines in runs.get(run, {}).items():
            ms = [ln["stage_s"]["shade_hit"] * 1e3 for ln in lines]
            row = dict(frame_ms=ms, mean_ms=statistics.fmean(ms), spread_ms=max(ms) - min(ms),
                       launches=lines[0]["stage_launches"]["shade_hit"])
            k = [ln["k7"] for ln in lines if "k7" in ln]
            if k:
                first = [x["first"]["profiler_ms"] for x in k if x["first"]["profiler_ms"]]
                row.update(variant=k[0]["variant"], bound_ms=k[0]["bound_ms"],
                           bound_share=k[0]["bound_ms"] / row["mean_ms"],
                           first_profiler_ms=first, first_bound_ms=k[0]["first"]["bound_ms"])
            out.setdefault(run, {})[tree] = row
    if resources:
        out["resources"] = resources
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="other checkouts to compare with this one")
    ap.add_argument("--out", default=os.path.join("build", "k2_compare"))
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds per frame_profile run")
    ap.add_argument("--k3", action="store_true", help="also run utils/k3_profile.py from each tree")
    ap.add_argument("--no-frames", action="store_true", help="with --k3: no frame_profile runs")
    ap.add_argument("--runs", help="frame_profile's runs, comma-separated (default: all)")
    ap.add_argument("--k7", action="store_true",
                    help="frame_profile --k7: K7's resources, first launch and frame bound")
    args = ap.parse_args(argv)
    others = [os.path.abspath(t) for t in args.trees]
    order = others + [HERE, HERE] + others[::-1]
    os.makedirs(args.out, exist_ok=True)
    times: dict = {}
    k3: dict = {}
    k7_res: dict = {}
    k7_runs: dict = {}
    for k, tree in enumerate(order):
        name = "this" if tree == HERE else os.path.relpath(tree, HERE)
        if not (args.k3 and args.no_frames):
            out_file = os.path.abspath(os.path.join(args.out, f"profile_{k}.txt"))
            for line in profile_tree(tree, out_file, args.timeout, args.runs, args.k7):
                row = dict(order=k, tree=name, **line)
                print(json.dumps(row), flush=True)
                if "k7_resources" in line:
                    k7_res[name] = line["k7_resources"]
                    continue
                times.setdefault((name, line["run"]), []).append(line["traverse2_s"] * 1e3)
                if line["run"] in K7_RUNS:
                    k7_runs.setdefault(line["run"], {}).setdefault(name, []).append(line)
        if args.k3:
            pops_file = os.path.abspath(os.path.join(args.out, f"k3_pops_{k}.npz"))
            mine = k3.setdefault(name, dict(ms={}, resources=None, shares=[]))
            for line in k3_tree(tree, pops_file, args.timeout):
                print(json.dumps(dict(order=k, tree=name, **line)), flush=True)
                if line["case"] == "resources":
                    mine["resources"] = k3_resources(line["ptxas"])
                else:
                    ms = line.get("device_ms", line.get("frame_ms_median"))
                    mine["ms"].setdefault(line["case"], []).append(ms)
            mine["shares"].append(k3_shares(pops_file))
    if times:
        summary = {f"{tree} run {run}": dict(traverse2_ms=ms, mean_ms=statistics.fmean(ms))
                   for (tree, run), ms in times.items()}
        print(json.dumps(dict(summary=summary, k7=k7_summary(k7_runs, k7_res))), flush=True)
    if k3:
        shares = [s for t in k3.values() for s in t["shares"]]
        print(json.dumps(dict(k3_summary={
            tree: dict(resources=t["resources"],
                       ms={c: dict(runs=v, mean=statistics.fmean(x for x in v if x is not None)
                                   if any(x is not None for x in v) else None)
                           for c, v in t["ms"].items()})
            for tree, t in k3.items()}, simt=shares[0],
            pops_equal=all(s == shares[0] for s in shares))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
