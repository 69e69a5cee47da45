// K9 svgf_reproject, K10 atrous_pass, K11 temporal_resolve: the stateful
// presenter chains; K12 resize: the resampling in front of K11 and the
// spatial chain (mrt_tpu_torch/kernels/presenter.py holds the wrappers and
// the plain PyTorch versions these repeat bit for bit).
//
// Replace the XLA programs of mrt_tpu/upscale/denoise.py:svgf_filter
// (K9: the demodulation, the reprojection of the DenoiseState and the
// moments, :99-164; K10: _atrous_pass, :56-87, with the next pass's luma and
// the last pass's remodulation folded in), of
// mrt_tpu/upscale/temporal.py:temporal_upscale after its resize (K11,
// :94-124), and jax.image.resize in mrt_tpu/upscale/spatial.py:15 and
// temporal.py:91-93 (K12). In eager PyTorch the denoiser was ~2,300
// launches a call and the temporal upscaler ~100; the resize was two dense
// (n_in, n_out) products.
//
// Bound: bytes for K9, K11 and K12, operations for K10. Per pixel K9 moves
// ~40 f32 with a few dozen operations; K10 reads 25 taps of 9 f32 and
// evaluates 50 expf and 50 divisions (skipped where a difference is 0);
// K11 reads 6 + 4 x 4 f32 and writes 7; K12 reads each source value once
// and writes each output value once, with at most K taps a value per axis.
// Design: K9 and K11 a thread a pixel, every tap through the read-only
// cache (__ldg), K11's history taps as one float4 each. K10 a block per
// 32x8 output tile: the tile and a 2*step halo staged in shared memory as
// nine planes (the edge clamp applied when staging), the 25 taps read
// from there (one instantiation per step). K12 a block per 32x32 output
// tile, a lane an output column, a warp four rows: the input pixels the
// tile reads staged in shared memory (in chunks of rows and columns where
// they do not fit), the horizontal sums from there into shared memory,
// then the vertical taps from there, the tile's rows stored through shared
// memory, coalesced; compiled for the path's two shapes (3 channels and
// 6x6 taps, 6 channels and 2x2), the loops unrolled, and for any other at
// run time.
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

template <int STEP>
__global__ void __launch_bounds__(256) atrous_pass_kernel(
    const float* __restrict__ filtered, const float* __restrict__ var,
    const float* __restrict__ lum, const float* __restrict__ normal,
    const float* __restrict__ depth, const float* __restrict__ diffuse,
    const float* __restrict__ specular, float* __restrict__ out, float* __restrict__ out_var,
    float* __restrict__ out_lum, int h, int w) {
    using T = AtrousTile<STEP>;
    __shared__ float planes[AP_PLANES * T::N];
    int x0 = blockIdx.x * ATROUS_TW, y0 = blockIdx.y * ATROUS_TH;
    for (int i = threadIdx.x; i < T::N; i += blockDim.x)
        atrous_stage<STEP>(i, x0, y0, h, w, filtered, var, lum, normal, depth, planes);
    __syncthreads();
    int tx = threadIdx.x % ATROUS_TW, ty = threadIdx.x / ATROUS_TW;
    if (x0 + tx < w && y0 + ty < h)
        atrous_tile_px<STEP>(tx, ty, x0, y0, w, planes, diffuse, specular, out, out_var,
                             out_lum);
}

__global__ void __launch_bounds__(256) temporal_resolve_kernel(
    const float* __restrict__ up, const float4* __restrict__ history, float* __restrict__ out,
    float4* __restrict__ new_history, int h, int w, float history_weight, float sx, float sy) {
    long long p = pixel();
    if (p < (long long)h * w)
        temporal_resolve_px(p, h, w, up, history, out, new_history, history_weight, sx, sy);
}

unsigned blocks_for(long long n) { return (unsigned)((n + 255) / 256); }

// K12 over one output tile; C_, KR_, KC_ the channels and the taps of a
// row and of a column where compiled in (the path's two forms), else 0 and
// given at run time
template <int C_, int KR_, int KC_>
__global__ void __launch_bounds__(RESIZE_WARPS * 32) resize_kernel(
    ResizeSrc src, int c_rt, int w, int oh, int ow, const int* __restrict__ row_first,
    const float* __restrict__ row_w, int kr_rt, const int* __restrict__ col_first,
    const float* __restrict__ col_w, int kc_rt, int rows_chunk, int cols_chunk, int clamp,
    float* __restrict__ out) {
    constexpr int ROWS = RESIZE_TH / RESIZE_WARPS;  // output rows a warp takes
    constexpr int NC = C_ ? C_ : RESIZE_MAX_C;  // the channels a thread holds sums for
    const int C = C_ ? C_ : c_rt, kr = KR_ ? KR_ : kr_rt, kc = KC_ ? KC_ : kc_rt;
    extern __shared__ float smem[];
    float* stage = smem;                                     // [rows_chunk][cols_chunk][C]
    float* sums = stage + rows_chunk * cols_chunk * C;      // [rows_chunk][C][RESIZE_TW]
    float* row = sums + rows_chunk * C * RESIZE_TW;         // [RESIZE_WARPS][RESIZE_TW * C]
    // a lane is an output column; warp w takes output rows w, w + RESIZE_WARPS, ...
    int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    int ox0 = blockIdx.x * RESIZE_TW, oy0 = blockIdx.y * RESIZE_TH;
    int ox = ox0 + lane;
    // the input rows and columns the tile reads (first indices rise with the output's)
    int r_lo = __ldg(row_first + oy0);
    int r_hi = __ldg(row_first + min(oy0 + RESIZE_TH, oh) - 1) + kr;
    int c_lo = __ldg(col_first + ox0);
    int c_hi = __ldg(col_first + min(ox0 + RESIZE_TW, ow) - 1) + kc;
    int fc = ox < ow ? __ldg(col_first + ox) : c_lo;
    const float* wc = col_w + (long long)ox * kc;
    float acc[ROWS][NC];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
    for (int r0 = r_lo; r0 < r_hi; r0 += rows_chunk) {
        int nr = min(rows_chunk, r_hi - r0);
        // the horizontal sums of rows r0.. at the tile's columns, over
        // chunks of staged input columns (their taps in increasing index)
        for (int c0 = c_lo; c0 < c_hi; c0 += cols_chunk) {
            int nc = min(cols_chunk, c_hi - c0);
            for (int rr = warp; rr < nr; rr += RESIZE_WARPS)
                for (int cc = lane; cc < nc; cc += 32)
                    resize_stage_px(src, w, r0 + rr, c0 + cc, stage + (rr * nc + cc) * C);
            __syncthreads();
            int k0 = max(c0 - fc, 0), k1 = min(c0 + nc - fc, kc);
            if (ox < ow && k0 < k1) {
                for (int rr = warp; rr < nr; rr += RESIZE_WARPS) {
                    const float* x = stage + (rr * nc + fc + k0 - c0) * C;
                    float* to = sums + rr * C * RESIZE_TW + lane;
                    if (k1 - k0 == kc)  // every tap in this chunk (the path's case)
                        resize_row_px(x, C, wc, 0, kc, to, RESIZE_TW);
                    else
                        resize_row_px(x, C, wc + k0, k0, k1 - k0, to, RESIZE_TW);
                }
            }
            __syncthreads();
        }
        // the vertical taps whose rows are in this chunk, per output row of the warp
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
            int oy = oy0 + warp + i * RESIZE_WARPS;
            if (oy >= oh || ox >= ow) continue;
            int fr = __ldg(row_first + oy);
            const float* wr = row_w + (long long)oy * kr;
            int k0 = max(r0 - fr, 0), k1 = min(r0 + nr - fr, kr);
            const float* v = sums + (fr + k0 - r0) * C * RESIZE_TW + lane;
            if (k1 - k0 == kr) {  // every tap in this chunk (the path's case)
#pragma unroll
                for (int k = 0; k < kr; ++k) {
                    float wt = __ldg(wr + k);
#pragma unroll
                    for (int c = 0; c < NC; ++c)
                        if (c < C)
                            acc[i][c] = resize_tap(acc[i][c], v[(k * C + c) * RESIZE_TW], wt, k);
                }
            } else {
                for (int k = k0; k < k1; ++k) {
                    float wt = __ldg(wr + k);
#pragma unroll
                    for (int c = 0; c < NC; ++c)
                        if (c < C)
                            acc[i][c] = resize_tap(acc[i][c], v[((k - k0) * C + c) * RESIZE_TW],
                                                   wt, k);
                }
            }
        }
        __syncthreads();
    }
    // each of the warp's output rows through shared memory, stored coalesced
    float* buf = row + warp * RESIZE_TW * C;
    int n = min(RESIZE_TW, ow - ox0) * C;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
        int oy = oy0 + warp + i * RESIZE_WARPS;
        if (oy >= oh) break;
        if (ox < ow) {
#pragma unroll
            for (int c = 0; c < NC; ++c)
                if (c < C) buf[lane * C + c] = resize_out(acc[i][c], clamp != 0);
        }
        __syncwarp();
        float* o = out + ((long long)oy * ow + ox0) * C;
        for (int j = lane; j < n; j += 32) o[j] = buf[j];
        __syncwarp();
    }
}

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
    if (h <= 0 || w <= 0) return 0;
    dim3 grid((w + ATROUS_TW - 1) / ATROUS_TW, (h + ATROUS_TH - 1) / ATROUS_TH);
    auto k = step == 1 ? atrous_pass_kernel<1>
             : step == 2 ? atrous_pass_kernel<2>
             : step == 4 ? atrous_pass_kernel<4>
                         : nullptr;
    if (k == nullptr) return (int)cudaErrorInvalidValue;
    k<<<grid, ATROUS_TW * ATROUS_TH, 0, (cudaStream_t)stream>>>(
        (const float*)filtered, (const float*)var, (const float*)lum, (const float*)normal,
        (const float*)depth, (const float*)diffuse, (const float*)specular, (float*)out,
        (float*)out_var, (float*)out_lum, h, w);
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

// K12: sources s0..s2 of c0..c2 channels (an absent one: c = 0) at (h, w),
// resampled to (oh, ow) by the banded tables (per output row: the first
// input row and kr weights; per output column likewise, kc), written to
// the contiguous (oh, ow, c0 + c1 + c2) ``out``; a block stages
// ``rows_chunk`` x ``cols_chunk`` input pixels at once
extern "C" int mrt_resize(const void* s0, const void* s1, const void* s2, int c0, int c1, int c2,
                          int h, int w, const void* row_first, const void* row_w, int kr,
                          const void* col_first, const void* col_w, int kc, int oh, int ow,
                          int rows_chunk, int cols_chunk, int clamp, void* out, void* stream) {
    int C = c0 + c1 + c2;
    size_t smem = ((size_t)rows_chunk * (cols_chunk + RESIZE_TW) + RESIZE_WARPS * RESIZE_TW) *
                  C * sizeof(float);
    if (C < 1 || C > RESIZE_MAX_C || c0 < 1 || c1 < 0 || c2 < 0 || (c1 == 0 && c2 > 0) ||
        rows_chunk < 1 || cols_chunk < 1 || kr < 1 || kc < 1 || h < 1 || w < 1 ||
        smem > 48 * 1024)
        return (int)cudaErrorInvalidValue;
    if (oh <= 0 || ow <= 0) return 0;
    ResizeSrc src = {{(const float*)s0, (const float*)s1, (const float*)s2}, {c0, c1, c2}};
    dim3 grid((ow + RESIZE_TW - 1) / RESIZE_TW, (oh + RESIZE_TH - 1) / RESIZE_TH);
    // the path's two forms compiled for their shapes: the spatial chain's
    // Lanczos-3 upscale of 3 channels, the temporal chain's bilinear of 6
    auto k = C == 3 && kr == 6 && kc == 6   ? resize_kernel<3, 6, 6>
             : C == 6 && kr == 2 && kc == 2 ? resize_kernel<6, 2, 2>
                                            : resize_kernel<0, 0, 0>;
    k<<<grid, RESIZE_WARPS * 32, smem, (cudaStream_t)stream>>>(
        src, C, w, oh, ow, (const int*)row_first, (const float*)row_w, kr,
        (const int*)col_first, (const float*)col_w, kc, rows_chunk, cols_chunk, clamp,
        (float*)out);
    return (int)cudaGetLastError();
}
