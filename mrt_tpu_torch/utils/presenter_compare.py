"""K12 ``resize`` in this tree against other trees, on one card in one call.

    python -m mrt_tpu_torch.utils.presenter_compare build/parent [more trees]

Each tree is a checkout of the repository, such as the parent commit
unpacked under ``build/`` with ``git archive HEAD~ | tar -x -C build/parent``.
This file runs itself (``--measure``) from each tree in a process of its
own, in the order others, this, this, others reversed, with that tree's
package and ``chip_smoke.py`` first on the path: each tree builds its
kernels (so ``-Xptxas -v`` reports its resize kernels' registers and
spills) and runs K12 in its two forms on the path: at run E's shapes
(1920x1080 to 3840x2160, on ``chip_smoke.synthetic_presenter_inputs``) the
Lanczos-3 of 3 channels with the clamp and the bilinear of colour, depth
and motion, and at phase M's demo shape (686x686 to 1024x1024, a colour
from a seed) the Lanczos-3 with the clamp. Per run and tree one JSON line:
each form's CUDA-event ms (50 calls, three times; the wrapper's host work
included), its torch.profiler device ms a launch (20 calls, three times;
the kernel alone: ``resize_strip_kernel`` where the tree has the strip
form and the shape takes it, else ``resize_kernel``), and its elements
that differ from the plain version. Where the time a call goes (three
times each):

- ``queued_ms``: CUDA-event ms a call with the 50 calls queued behind a
  sleep kernel, so that the card runs them back to back (launch gaps on
  the card included, the host's time not);
- ``host_us``: host microseconds a call, no synchronisation inside: of
  the wrapper (``wrapper``), of the C launcher with the wrapper's
  arguments (``launcher``: ctypes, the launcher's checks, the launch),
  and of the launcher with no output rows (``checks``: it returns before
  launching).

Then a summary line with each form's means over each tree's runs.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REPS, DEVICE_REPS, HOST_REPS = 50, 20, 200
# ~50 ms at an H100's 1.98 GHz: the host queues REPS calls meanwhile, in
# up to QUEUE_ATTEMPTS tries (a host that stalls past the sleep tries again)
SLEEP_CYCLES, QUEUE_ATTEMPTS = 100_000_000, 3
KEYS = ("ms", "device_ms", "queued_ms")
HOST_KEYS = ("wrapper", "launcher", "checks")
FORMS = ("lanczos3_3ch", "bilinear_6ch", "lanczos3_3ch_m_demo")
M_DEMO = (686, 686, 1024, 1024)


def measure(tree: str) -> None:
    """One JSON line for the tree at ``tree`` (its package imported)."""
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [tree] + [p for p in sys.path if os.path.abspath(p or ".") != here]
    import torch

    import chip_smoke as cs
    from mrt_tpu_torch.kernels import build
    from mrt_tpu_torch.kernels import presenter as PK
    from mrt_tpu_torch.upscale import spatial

    if not torch.cuda.is_available():
        raise SystemExit("presenter_compare measures on a CUDA device; none is available")
    dev = torch.device("cuda:0")
    build.build()
    build.load()
    inp = cs.synthetic_presenter_inputs(torch, dev)
    (h, w), (oh, ow) = inp["depth"].shape, inp["out"]
    g = torch.Generator(device=dev).manual_seed(0)
    demo = torch.rand(M_DEMO[:2] + (3,), generator=g, device=dev) * 2.0 - 0.1
    line = dict(ptxas={k: v for k, v in build.ptxas.items() if "resize_" in k},
                card=cs.card_line())
    for form, sources, method, clamp, size in (
            (FORMS[0], (inp["color"],), "lanczos3", True, (h, w, oh, ow)),
            (FORMS[1], (inp["color"], inp["depth"], inp["motion"]), "bilinear", False,
             (h, w, oh, ow)),
            (FORMS[2], (demo,), "lanczos3", True, M_DEMO)):
        tables = (spatial.band_table(size[0], size[2], method, dev),
                  spatial.band_table(size[1], size[3], method, dev))

        def call():
            return PK.resize(sources, *tables, clamp)

        chans = [1 if s.dim() == 2 else s.shape[2] for s in sources]
        strip = hasattr(PK, "resize_strip_rows") and PK.resize_strip_rows(
            *tables, chans, tables[0].weights.shape[1], tables[1].weights.shape[1])
        kernel = "resize_strip_kernel" if strip else "resize_kernel"
        k, p = call(), PK.resize_plain(sources, *tables, clamp)
        launcher, args = launch_args(PK, call)
        checks = list(args)
        checks[14] = 0  # no output rows: mrt_resize returns before launching
        line[form] = dict(
            kernel=kernel,
            ms=[cs.cuda_ms(call, REPS) for _ in range(3)],
            device_ms=[cs.device_ms(torch, call, kernel, DEVICE_REPS, one_kernel=True)
                       for _ in range(3)],
            queued_ms=[queued_ms(torch, call) for _ in range(3)],
            host_us={k: [host_us(torch, f) for _ in range(3)] for k, f in (
                ("wrapper", call), ("launcher", lambda: launcher(*args)),
                ("checks", lambda: launcher(*checks)))},
            differing=int((k.view(torch.int32) != p.view(torch.int32)).sum()))
    print(json.dumps(line), flush=True)


def launch_args(PK, call):
    """The C launcher and the arguments that ``call``'s wrapper passes it
    (through ``PK._launch``; the output they point to kept alive with the
    launcher), each call of it checked to return 0."""
    seen = []
    real = PK._launch
    PK._launch = lambda name, fn, *args: seen.append((fn, args)) or real(name, fn, *args)
    try:
        out = call()
    finally:
        PK._launch = real
    fn, args = seen[-1]

    def launcher(*a):
        if fn(*a) != 0:
            raise RuntimeError(f"mrt_resize failed (output {tuple(out.shape)})")

    return launcher, args


def queued_ms(torch, fn) -> float:
    """CUDA-event ms a call of ``fn``, REPS calls queued behind a sleep
    kernel so that the card runs them back to back; raises where the host
    took longer to queue them than the sleep lasted in every try."""
    fn()
    torch.cuda.synchronize()
    for _ in range(QUEUE_ATTEMPTS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(SLEEP_CYCLES)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        if host_ms < ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / REPS
    raise RuntimeError(f"queueing {REPS} calls took {host_ms} ms, longer than the sleep")


def host_us(torch, fn) -> float:
    """Host microseconds a call of ``fn`` over HOST_REPS calls, with no
    synchronisation between them (the card queues what they launch)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_REPS):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / HOST_REPS
    torch.cuda.synchronize()
    return us


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
    got: dict = {}
    for k, tree in enumerate(order):
        name = "this" if tree == HERE else os.path.relpath(tree, HERE)
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", tree], cwd=tree,
                           capture_output=True, text=True, timeout=args.timeout)
        if p.returncode != 0:
            raise RuntimeError(f"presenter_compare failed in {tree} (rc {p.returncode}):\n"
                               f"{p.stdout[-4000:]}\n{p.stderr[-4000:]}")
        for line in p.stdout.splitlines():
            if line.startswith('{"ptxas"'):
                row = json.loads(line)
                print(json.dumps(dict(order=k, tree=name, **row)), flush=True)
                got.setdefault(name, []).append(row)
    summary = {t: {f: dict(
        {k: statistics.fmean(x for r in rows for x in r[f][k]) for k in KEYS},
        host_us={k: statistics.fmean(x for r in rows for x in r[f]["host_us"][k])
                 for k in HOST_KEYS}) for f in FORMS} for t, rows in got.items()}
    print(json.dumps(dict(summary=summary)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
