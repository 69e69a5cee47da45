"""Faults planted in the port's timed path, for reading the check's upper
limits: each breaks the frames a run draws and must make ``correct`` false.

    python3 bench_h100/faults.py --workload <cell> --seconds <s>
        --faults half_left_out,... --seeds <n>,...

runs the cell once per fault and seed on the card with the fault planted
(``run.run_cell``; its look for a card is the caller's) and prints one JSON
line each with the numbers compared. The CPU tests plant the same faults
(``tests/test_bench_h100_check.py``).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for _p in (HERE.parent, HERE):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

FAULTS = ("unchanged_state", "half_left_out", "answer_altered", "odd_frames_unchanged")


def plant(fault: str):
    """Break the port's timed path: ``unchanged_state``, a draw that leaves
    the renderer's frame state as it was; ``odd_frames_unchanged``, the
    same on every other draw only (the second, the fourth, ...);
    ``half_left_out``, every other pixel of a frame left out (no colour, no
    rays); ``answer_altered``, each pixel's colour 1 % off where the frame
    is traced. Returns the function that mends it."""
    from mrt_tpu_torch.engine.renderer import Renderer
    from mrt_tpu_torch.render import wavefront as wf

    if fault in ("unchanged_state", "odd_frames_unchanged"):
        orig_draw = Renderer.draw
        draws = [0]

        def draw(self, delta_time=None):
            keep = (self.accum, self.depth, self.motion, self.last_samples)
            orig_draw(self, delta_time)
            draws[0] += 1
            if keep[3] is not None and (fault == "unchanged_state" or draws[0] % 2 == 0):
                for name, value in zip(("accum", "depth", "motion", "last_samples"), keep):
                    object.__setattr__(self, name, value)
            return self.accum

        Renderer.draw = draw
        return lambda: setattr(Renderer, "draw", orig_draw)
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; the faults are {FAULTS}")
    orig = wf.trace_frame

    def trace_frame(*a, **kw):
        out = orig(*a, **kw)
        if fault == "half_left_out":
            color, rays = out.color.clone(), out.rays_traced.clone()
            color[1::2] = 0.0
            rays[1::2] = 0
            return out._replace(color=color, rays_traced=rays)
        return out._replace(color=out.color * 1.01)

    wf.trace_frame = trace_frame
    return lambda: setattr(wf, "trace_frame", orig)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--faults", default=",".join(FAULTS))
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    import torch

    import run

    if not torch.cuda.is_available():
        print("faults: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    files = run.cell_files(run.load_benchmark(), args.workload)
    for fault in args.faults.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            mend = plant(fault)
            try:
                result, detail = run.run_cell(files, seed, args.seconds, False,
                                              torch.device("cuda:0"))
            finally:
                mend()
            print(json.dumps(dict(workload=args.workload, fault=fault, seed=seed,
                                  correct=result["correct"], checks=result["checks"],
                                  parts=detail["parts"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
