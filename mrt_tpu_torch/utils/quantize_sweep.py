"""Every float through K1's per-value body (``csrc/present.cuh``), on the host.

    python -m mrt_tpu_torch.utils.quantize_sweep

Builds ``present.cuh`` with the host compiler (``-ffp-contract=off``, as
the card's ``-fmad=false``) and checks, over every float:

- ``tone_div``, the quotient ``quantize`` takes where it decides the byte
  (2^-60 <= c < 2^24), from a reciprocal 0, 1 and 2 ulp either side of
  ``1 / (1 + c)`` (the card's ``rcp.approx`` is within 1): bit-equal to
  the IEEE quotient ``c / (1 + c)``;
- ``quantize`` on all 2^32 bit patterns: the byte of
  ``trunc(clamp(c / (1 + c), 0, 1) * 255 + 0.5)`` with the IEEE division
  (``fmaxf`` taking NaN to 0, as the kernels do).

Prints one JSON line with the values checked and those that differ, and
exits 1 if any differs. About 2.5 min on one CPU core.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"

_SWEEP = r'''
#include <cstdio>
#include <cstring>
#include "present.cuh"
static float bits(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
static unsigned ubits(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }
static unsigned char reference(float c) {
    volatile float d = 1.0f + c;
    float tone = c / d;
    tone = fminf(fmaxf(tone, 0.0f), 1.0f);
    return (unsigned char)(tone * 255.0f + 0.5f);
}
int main() {
    long long div_checked = 0, div_bad = 0, q_checked = 0, q_bad = 0;
    for (unsigned u = ubits(0x1p-60f); u < ubits(0x1p24f); ++u) {
        float c = bits(u);
        volatile float d = 1.0f + c;
        volatile float want = c / d;
        unsigned r = ubits(1.0f / d);
        for (int k = -2; k <= 2; ++k) {
            div_bad += ubits(mrt_tonemap::tone_div(c, d, bits(r + k))) != ubits(want);
            ++div_checked;
        }
    }
    unsigned u = 0;
    do {
        float c = bits(u);
        q_bad += mrt_tonemap::quantize(c) != reference(c);
        ++q_checked;
    } while (++u != 0);
    std::printf("%lld %lld %lld %lld\n", div_checked, div_bad, q_checked, q_bad);
    return 0;
}
'''


def main() -> int:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise SystemExit("quantize_sweep needs a host C++ compiler")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        src, exe = Path(d) / "sweep.cpp", Path(d) / "sweep"
        src.write_text(_SWEEP)
        subprocess.run([cxx, "-O2", "-ffp-contract=off", "-std=c++17", f"-I{CSRC}", str(src), "-o",
                        str(exe)], check=True)
        out = subprocess.run([str(exe)], check=True, capture_output=True, text=True).stdout
    div_checked, div_bad, q_checked, q_bad = (int(x) for x in out.split())
    print(json.dumps(dict(tone_div_checked=div_checked, tone_div_differing=div_bad,
                          quantize_checked=q_checked, quantize_differing=q_bad,
                          seconds=time.perf_counter() - t0)))
    return 1 if div_bad or q_bad else 0


if __name__ == "__main__":
    sys.exit(main())
