"""How torch.profiler loses device events in an ageing process, on the card.

    python -m mrt_tpu_torch.utils.profiler_probe [--seconds 240] [--out FILE]

Run from the root of the repository (it uses ``chip_smoke.py``'s helpers).
On a synthetic 1920x1080 denoiser frame it first times five K10 launches
with ``chip_smoke.device_ms`` twice: through the profiler, and with a
profiler made to see nothing, so that the CUDA-event fallback of
``one_kernel=True`` answers. Then, for ``--seconds``, every ~12 s of
unprofiled matmul work, it records two sessions of five K10 launches
(host and device activity), one with no idle time around the launches and
one with 0.25 s before the first and after the sync, and prints per
session how many kernels it saw and the gap between the first launch on
the host and the first kernel on the device. Its last line on stdout is
one JSON object, also written to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

PADS = (0.0, 0.25)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=240.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiler_probe measures on a CUDA device; none is available")

    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    from mrt_tpu_torch.kernels import presenter as PK
    from mrt_tpu_torch.upscale import denoise

    dev = torch.device("cuda")
    inp = cs.synthetic_presenter_inputs(torch, dev)
    gb = inp["gb"]
    ins = (inp["color"], gb["diffuse_albedo"], gb["specular_albedo"], gb["normal"],
           inp["depth"], inp["motion"])
    demod, _, _, _, normal, var, lum = PK.svgf_reproject(*ins, denoise.DenoiseState(*inp["state"]))
    a = (demod, var, lum, normal, ins[4], 1)

    def fn():
        PK.atrous_pass(*a)

    profiled = cs.profiled
    k10_ms = cs.device_ms(torch, fn, "atrous_pass", 5, one_kernel=True)
    cs.profiled = lambda torch, fn, reps, host=False: ([], None)
    try:
        k10_fallback_ms = cs.device_ms(torch, fn, "atrous_pass", 5, one_kernel=True)
    finally:
        cs.profiled = profiled

    m = torch.rand(4096, 4096, device=dev)
    rows, t0 = [], time.time()
    while time.time() - t0 < args.seconds:
        for pad in PADS:
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                time.sleep(pad)
                for _ in range(5):
                    fn()
                torch.cuda.synchronize()
                time.sleep(pad)
            ev = prof.events()
            k = [e for e in ev if e.device_type == torch.autograd.DeviceType.CUDA
                 and "atrous" in e.name]
            launch = [e for e in ev if e.device_type != torch.autograd.DeviceType.CUDA
                      and "LaunchKernel" in e.name]
            gap = (min(e.time_range.start for e in k) - min(e.time_range.start for e in launch)
                   if k and launch else None)
            rows.append(dict(t=round(time.time() - t0, 1), pad_s=pad, found=len(k), gap_us=gap))
        t1 = time.time()
        while time.time() - t1 < 12:  # unprofiled device work between sessions
            for _ in range(50):
                m = (m @ m).clamp_(-1, 1)
            torch.cuda.synchronize()
    line = dict(k10_profiler_ms=k10_ms, k10_cuda_event_fallback_ms=k10_fallback_ms,
                sessions=rows, card=cs.card_line())
    print(json.dumps(line))
    if args.out:
        with open(args.out, "w") as f:
            f.write(json.dumps(line) + "\n")
    return line


if __name__ == "__main__":
    main()
