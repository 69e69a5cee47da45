"""K2's device time per frame in this tree against other trees, on one card in
one call.

    python -m mrt_tpu_torch.utils.k2_compare build/parent [more trees] [--out build/k2_compare]

Each tree is a checkout of the repository, such as the parent commit
unpacked under ``build/`` with ``git archive HEAD~ | tar -x -C build/parent``.
The script runs ``python -m mrt_tpu_torch.utils.frame_profile`` from each
tree in its own process, in the order others, this, this, others reversed,
so that a drift of the card's clocks over the call shows as a difference
between the two runs of one tree. Every tree builds its own kernels into
its own ``build/``. One JSON line per run and tree goes to stdout (the
frame_profile line: K2's profiler time over one warm frame, device busy
time, gathers, idle share, the frame walls, rays), then a summary line with
K2's mean over each tree's two runs; the profiler tables go to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def profile_tree(tree: str, out_file: str, timeout: float) -> list[dict]:
    """The frame_profile lines of one run of ``tree``."""
    p = subprocess.run([sys.executable, "-m", "mrt_tpu_torch.utils.frame_profile", "--out", out_file],
                       cwd=tree, capture_output=True, text=True, timeout=timeout)
    if p.returncode != 0:
        raise RuntimeError(f"frame_profile failed in {tree} (rc {p.returncode}):\n{p.stdout}\n{p.stderr}")
    return [json.loads(line) for line in p.stdout.splitlines() if line.startswith("{")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="other checkouts to compare with this one")
    ap.add_argument("--out", default=os.path.join("build", "k2_compare"))
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds per frame_profile run")
    args = ap.parse_args(argv)
    others = [os.path.abspath(t) for t in args.trees]
    order = others + [HERE, HERE] + others[::-1]
    os.makedirs(args.out, exist_ok=True)
    times: dict = {}
    for k, tree in enumerate(order):
        name = "this" if tree == HERE else os.path.relpath(tree, HERE)
        out_file = os.path.abspath(os.path.join(args.out, f"profile_{k}.txt"))
        for line in profile_tree(tree, out_file, args.timeout):
            row = dict(order=k, tree=name, **line)
            print(json.dumps(row), flush=True)
            times.setdefault((name, line["run"]), []).append(line["traverse2_s"] * 1e3)
    summary = {f"{tree} run {run}": dict(traverse2_ms=ms, mean_ms=statistics.fmean(ms))
               for (tree, run), ms in times.items()}
    print(json.dumps(dict(summary=summary)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
