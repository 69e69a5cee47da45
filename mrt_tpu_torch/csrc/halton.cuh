// Halton radical inverse, shared by kernels K6 and K7 (wavefront.cu) and
// compiled for the host too (MRT_HD is empty outside nvcc), so a host
// compiler can hold it against core/halton.py on the CPU.
//
// The f32 reciprocal-floor digit loop with the +/-1 remainder fixup, op for
// op as mrt_tpu/core/halton.py:halton_base and the port's
// core/halton.py:halton_base compute it: every product and sum rounds on its
// own (nvcc -fmad=false; a host compiler with -ffp-contract=off), so the
// value is the plain version's bit for bit. The index wraps at 2^24.
#pragma once

#ifdef __CUDACC__
#define MRT_HD __host__ __device__
#else
#define MRT_HD
#endif

#include <math.h>

// Radical inverse of ``i`` in base ``b`` with ``digits`` digits (24 reach
// every index below 2^24 in base 2; the per-step bases are >= 5, and
// 5^11 > 2^24, so 11 do there).
MRT_HD inline float mrt_halton_base(int i, int b, int digits) {
    const float b_f = (float)b;
    const float inv_b = 1.0f / b_f;
    float i_f = (float)(i & ((1 << 24) - 1));
    float f = 1.0f;
    float r = 0.0f;
    for (int d = 0; d < digits; ++d) {
        float q = floorf(i_f * inv_b);
        float rem = i_f - q * b_f;
        if (rem < 0.0f) {
            q = q - 1.0f;
            rem = rem + b_f;
        }
        if (rem >= b_f) {
            q = q + 1.0f;
            rem = rem - b_f;
        }
        f = f * inv_b;
        r = r + f * rem;
        i_f = q;
    }
    return r;
}
