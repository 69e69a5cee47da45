// K9 svgf_reproject, K10 atrous_pass, K11 temporal_resolve: the stateful
// presenter chains (mrt_tpu_torch/kernels/presenter.py holds the wrappers
// and the plain PyTorch versions these repeat bit for bit).
//
// Replace the XLA programs of mrt_tpu/upscale/denoise.py:svgf_filter
// (K9: the demodulation, the reprojection of the DenoiseState and the
// moments, :99-164; K10: _atrous_pass, :56-87, with the next pass's luma and
// the last pass's remodulation folded in) and of
// mrt_tpu/upscale/temporal.py:temporal_upscale after its resize (K11,
// :94-124). In eager PyTorch the denoiser was ~2,300 launches a call and the
// temporal upscaler ~100.
//
// Bound: bytes. Per pixel K9 moves ~40 f32 with a few dozen operations;
// K10 reads 25 taps of 9 f32 (from L1/L2: neighbours share them) and
// evaluates 50 expf; K11 reads 6 + 4 x 4 f32 and writes 7. Design: one
// thread per pixel, every tap through the read-only cache (__ldg), K11's
// history taps as one float4 each; no shared-memory tiling yet.
//
// The per-pixel bodies, and the bit rules they keep, are in presenter.cuh
// (a host compiler builds them too, for the CPU tests).

#include <cuda_runtime.h>

#include "presenter.cuh"

namespace {

using namespace mrt_presenter;

__device__ __forceinline__ long long pixel() {
    return (long long)blockIdx.x * blockDim.x + threadIdx.x;
}

__global__ void __launch_bounds__(256) svgf_reproject_kernel(
    const float* __restrict__ color, const float* __restrict__ diffuse,
    const float* __restrict__ specular, const float* __restrict__ normal_enc,
    const float* __restrict__ depth, const float* __restrict__ motion,
    const float* __restrict__ s_demod, const float* __restrict__ s_m1,
    const float* __restrict__ s_m2, const float* __restrict__ s_len,
    const float* __restrict__ s_depth, const float* __restrict__ s_normal,
    float* __restrict__ o_demod, float* __restrict__ o_m1, float* __restrict__ o_m2,
    float* __restrict__ o_len, float* __restrict__ o_normal, float* __restrict__ o_var,
    float* __restrict__ o_lum, int h, int w) {
    long long p = pixel();
    if (p < (long long)h * w)
        svgf_reproject_px(p, h, w, color, diffuse, specular, normal_enc, depth, motion, s_demod,
                          s_m1, s_m2, s_len, s_depth, s_normal, o_demod, o_m1, o_m2, o_len,
                          o_normal, o_var, o_lum);
}

__global__ void __launch_bounds__(256) atrous_pass_kernel(
    const float* __restrict__ filtered, const float* __restrict__ var,
    const float* __restrict__ lum, const float* __restrict__ normal,
    const float* __restrict__ depth, const float* __restrict__ diffuse,
    const float* __restrict__ specular, float* __restrict__ out, float* __restrict__ out_var,
    float* __restrict__ out_lum, int h, int w, int step) {
    long long p = pixel();
    if (p < (long long)h * w)
        atrous_pass_px(p, h, w, step, filtered, var, lum, normal, depth, diffuse, specular, out,
                       out_var, out_lum);
}

__global__ void __launch_bounds__(256) temporal_resolve_kernel(
    const float* __restrict__ up, const float4* __restrict__ history, float* __restrict__ out,
    float4* __restrict__ new_history, int h, int w, float history_weight, float sx, float sy) {
    long long p = pixel();
    if (p < (long long)h * w)
        temporal_resolve_px(p, h, w, up, history, out, new_history, history_weight, sx, sy);
}

unsigned blocks_for(long long n) { return (unsigned)((n + 255) / 256); }

}  // namespace

extern "C" int mrt_svgf_reproject(const void* color, const void* diffuse, const void* specular,
                                  const void* normal_enc, const void* depth, const void* motion,
                                  const void* s_demod, const void* s_m1, const void* s_m2,
                                  const void* s_len, const void* s_depth, const void* s_normal,
                                  void* o_demod, void* o_m1, void* o_m2, void* o_len,
                                  void* o_normal, void* o_var, void* o_lum, int h, int w,
                                  void* stream) {
    long long n = (long long)h * w;
    if (n <= 0) return 0;
    svgf_reproject_kernel<<<blocks_for(n), 256, 0, (cudaStream_t)stream>>>(
        (const float*)color, (const float*)diffuse, (const float*)specular,
        (const float*)normal_enc, (const float*)depth, (const float*)motion,
        (const float*)s_demod, (const float*)s_m1, (const float*)s_m2, (const float*)s_len,
        (const float*)s_depth, (const float*)s_normal, (float*)o_demod, (float*)o_m1,
        (float*)o_m2, (float*)o_len, (float*)o_normal, (float*)o_var, (float*)o_lum, h, w);
    return (int)cudaGetLastError();
}

extern "C" int mrt_atrous_pass(const void* filtered, const void* var, const void* lum,
                               const void* normal, const void* depth, const void* diffuse,
                               const void* specular, void* out, void* out_var, void* out_lum,
                               int h, int w, int step, void* stream) {
    long long n = (long long)h * w;
    if (n <= 0) return 0;
    atrous_pass_kernel<<<blocks_for(n), 256, 0, (cudaStream_t)stream>>>(
        (const float*)filtered, (const float*)var, (const float*)lum, (const float*)normal,
        (const float*)depth, (const float*)diffuse, (const float*)specular, (float*)out,
        (float*)out_var, (float*)out_lum, h, w, step);
    return (int)cudaGetLastError();
}

extern "C" int mrt_temporal_resolve(const void* up, const void* history, void* out,
                                    void* new_history, int h, int w, float history_weight,
                                    float sx, float sy, void* stream) {
    long long n = (long long)h * w;
    if (n <= 0) return 0;
    temporal_resolve_kernel<<<blocks_for(n), 256, 0, (cudaStream_t)stream>>>(
        (const float*)up, (const float4*)history, (float*)out, (float4*)new_history, h, w,
        history_weight, sx, sy);
    return (int)cudaGetLastError();
}
