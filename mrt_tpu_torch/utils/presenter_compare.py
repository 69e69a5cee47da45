"""K12 ``resize`` in this tree against other trees, on one card in one call.

    python -m mrt_tpu_torch.utils.presenter_compare build/parent [more trees]

Each tree is a checkout of the repository, such as the parent commit
unpacked under ``build/`` with ``git archive HEAD~ | tar -x -C build/parent``.
This file runs itself (``--measure``) from each tree in a process of its
own, in the order others, this, this, others reversed, with that tree's
package and ``chip_smoke.py`` first on the path: each tree builds its
kernels (so ``-Xptxas -v`` reports its resize kernels' registers and
spills) and runs K12 in its two forms on the path (and the spatial
chain's uint8 form where the tree has it): at run E's shapes
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

With ``--presents``, each tree times whole presents instead: its
``upscale.presenter.present_device`` on a renderer's buffers and state
(``chip_smoke.synthetic_presenter_inputs``) in each mode at run E's
1920x1080 → 3840x2160, and the spatial present at the demo's 686² →
1024², each three times: CUDA-event ms a present (50 presents), the
profiler's device ms and device events a present (20), host µs a present
(no synchronisation inside), and the kernels it launched (the wrappers'
counts over one present). Then the standalone K1 (``tonemap_quantize``)
at run A's (1080,1920,3), run B's (576,1024,3) and the 4K output, its
profiler device ms warm and after a 64 MB write (cold), twice. The
summary line holds each tree's means.
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
# the spatial chain's uint8 form, timed in the trees that have it
FORMS_U8 = ("lanczos3_3ch_u8", "lanczos3_3ch_u8_m_demo")
M_DEMO = (686, 686, 1024, 1024)
# --presents: the presents timed (mode, at the demo's shape) and K1's shapes
PRESENTS = (("spatial", False), ("temporal", False), ("denoised", False), ("spatial", True))
PRESENT_KEYS = ("ms", "device_ms", "device_events", "host_us")
K1_SHAPES = {"A": (1080, 1920, 3), "B": (576, 1024, 3), "4K": (2160, 3840, 3)}


def measure(tree: str) -> None:
    """One JSON line for the tree at ``tree`` (its package imported)."""
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [tree] + [p for p in sys.path if os.path.abspath(p or ".") != here]
    import torch

    import inspect

    import chip_smoke as cs
    from mrt_tpu_torch.kernels import build, present
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
    forms = [(FORMS[0], (inp["color"],), "lanczos3", True, (h, w, oh, ow), False),
             (FORMS[1], (inp["color"], inp["depth"], inp["motion"]), "bilinear", False,
              (h, w, oh, ow), False),
             (FORMS[2], (demo,), "lanczos3", True, M_DEMO, False)]
    if "quantize" in inspect.signature(PK.resize).parameters:
        forms += [(FORMS_U8[0], (inp["color"],), "lanczos3", True, (h, w, oh, ow), True),
                  (FORMS_U8[1], (demo,), "lanczos3", True, M_DEMO, True)]
    for form, sources, method, clamp, size, u8 in forms:
        tables = (spatial.band_table(size[0], size[2], method, dev),
                  spatial.band_table(size[1], size[3], method, dev))

        def call():
            return PK.resize(sources, *tables, clamp, **({"quantize": True} if u8 else {}))

        chans = [1 if s.dim() == 2 else s.shape[2] for s in sources]
        strip = hasattr(PK, "resize_strip_rows") and PK.resize_strip_rows(
            *tables, chans, tables[0].weights.shape[1], tables[1].weights.shape[1])
        kernel = ("resize_strip_u8_kernel" if u8 else "resize_strip_kernel") if strip \
            else "resize_kernel"
        k, p = call(), PK.resize_plain(sources, *tables, clamp)
        if u8:
            k, p = k.int(), present.tonemap_quantize_plain(p).int()
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


def measure_presents(tree: str) -> None:
    """One JSON line of whole presents and K1 for the tree at ``tree`` (its
    package imported; see the module's note on ``--presents``)."""
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [tree] + [p for p in sys.path if os.path.abspath(p or ".") != here]
    from types import SimpleNamespace

    import torch

    import chip_smoke as cs
    from mrt_tpu_torch.kernels import build, present
    from mrt_tpu_torch.kernels import presenter as PK
    from mrt_tpu_torch.upscale import denoise
    from mrt_tpu_torch.upscale import presenter as P

    if not torch.cuda.is_available():
        raise SystemExit("presenter_compare measures on a CUDA device; none is available")
    dev = torch.device("cuda:0")
    build.build()
    build.load()
    inp = cs.synthetic_presenter_inputs(torch, dev)
    (h, w), (oh, ow) = inp["depth"].shape, inp["out"]
    g = torch.Generator(device=dev).manual_seed(0)
    demo = torch.rand(M_DEMO[:2] + (3,), generator=g, device=dev) * 2.0 - 0.1
    line = dict(card=cs.card_line())
    for mode, at_demo in PRESENTS:
        r = SimpleNamespace(
            upscaler_mode=mode, output_height=M_DEMO[2] if at_demo else oh,
            output_width=M_DEMO[3] if at_demo else ow, accumulation_weight=inp["weights"][1],
            accum=demo if at_demo else inp["color"], depth=inp["depth"], motion=inp["motion"],
            gbuffer=inp["gb"], _upscale_history=inp["history"].clone(),
            _denoise_state=denoise.DenoiseState(*inp["state"]))

        def call(r=r):
            return P.present_device(r)

        present.launches = 0
        PK.reset_launches()
        img = call()
        torch.cuda.synchronize()
        launches = dict(present=present.launches, **{k: n for k, n in PK.launches.items() if n})
        line[f"{mode}_m_demo" if at_demo else mode] = dict(
            output=list(img.shape), dtype=str(img.dtype), launches=launches,
            ms=[cs.cuda_ms(call, REPS) for _ in range(3)],
            **dict(zip(("device_ms", "device_events"),
                       zip(*[cs.device_total_ms(torch, call, DEVICE_REPS) for _ in range(3)]))),
            host_us=[host_us(torch, call) for _ in range(3)])
    scratch = torch.empty(16 << 20, dtype=torch.float32, device=dev)  # 64 MB > the 50 MB L2
    line["k1"] = {}
    for tag, shape in K1_SHAPES.items():
        x = torch.rand(shape, generator=g, device=dev) * 4.0

        def k1(x=x):
            return present.tonemap_quantize(x)

        line["k1"][tag] = dict(
            warm=[cs.device_ms(torch, k1, "present_kernel", DEVICE_REPS, one_kernel=True)
                  for _ in range(2)],
            cold=[cs.device_ms(torch, k1, "present_kernel", DEVICE_REPS,
                               flush=lambda: scratch.fill_(1.0), one_kernel=True)
                  for _ in range(2)])
    print(json.dumps(dict(presents=line)), flush=True)


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


def presents_summary(got: dict) -> dict:
    """Per tree, each present's means over the tree's runs and K1's warm and
    cold means by shape and instantiation."""
    out = {}
    for tree, rows in got.items():
        lines = [r["presents"] for r in rows]
        presents = {k: {m: statistics.fmean(x for ln in lines for x in ln[k][m])
                        for m in PRESENT_KEYS}
                    for k, v in lines[0].items() if k not in ("card", "k1")}
        k1 = {k: {m: statistics.fmean(x for ln in lines for x in ln["k1"][k][m])
                  for m in ("warm", "cold")} for k in lines[0]["k1"]}
        out[tree] = dict(presents=presents, k1=k1)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--measure"]:
        (measure_presents if argv[2:] == ["--presents"] else measure)(os.path.abspath(argv[1]))
        return 0
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="other checkouts to compare with this one")
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds per tree's run")
    ap.add_argument("--presents", action="store_true",
                    help="time whole presents and the standalone K1 instead of K12")
    args = ap.parse_args(argv)
    others = [os.path.abspath(t) for t in args.trees]
    order = others + [HERE, HERE] + others[::-1]
    got: dict = {}
    head = '{"presents"' if args.presents else '{"ptxas"'
    for k, tree in enumerate(order):
        name = "this" if tree == HERE else os.path.relpath(tree, HERE)
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", tree]
                           + ["--presents"] * args.presents, cwd=tree,
                           capture_output=True, text=True, timeout=args.timeout)
        if p.returncode != 0:
            raise RuntimeError(f"presenter_compare failed in {tree} (rc {p.returncode}):\n"
                               f"{p.stdout[-4000:]}\n{p.stderr[-4000:]}")
        for line in p.stdout.splitlines():
            if line.startswith(head):
                row = json.loads(line)
                print(json.dumps(dict(order=k, tree=name, **row)), flush=True)
                got.setdefault(name, []).append(row)
    if args.presents:
        print(json.dumps(dict(summary=presents_summary(got))), flush=True)
        return 0
    summary = {t: {f: dict(
        {k: statistics.fmean(x for r in rows for x in r[f][k]) for k in KEYS},
        host_us={k: statistics.fmean(x for r in rows for x in r[f]["host_us"][k])
                 for k in HOST_KEYS}) for f in FORMS + FORMS_U8 if f in rows[0]}
        for t, rows in got.items()}
    print(json.dumps(dict(summary=summary)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
