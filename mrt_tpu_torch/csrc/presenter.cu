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
// and writes each output value once, with at most K taps a value per axis
// (at run E's 2x upscale of 3 channels the 99.5 MB write is 80 % of its
// bytes, and the taps, unfused under -fmad=false, ~56 f32 instructions an
// output pixel, ~0.015 ms of the card's instruction rate at 4K).
// Design: K9 and K11 a thread a pixel, every tap through the read-only
// cache (__ldg), K11's history taps as one float4 each. K10 a block per
// 32x8 output tile: the tile and a 2*step halo staged in shared memory as
// nine planes (the edge clamp applied when staging), the 25 taps read
// from there (one instantiation per step). K12, for the path's two shapes
// (the spatial chain's Lanczos-3 of 3 channels, 6 taps an axis; the
// temporal chains' bilinear of colour, depth and motion, 2 taps), in its
// strip form: a thread owns one output column of a 256-column tile and
// every one of the tile's 16 output rows, in order. It sums each
// staged input row's width taps once into a window of the last K rows held
// in registers (the loop is unrolled K times so the window's names rotate
// and nothing moves), and when that row is an output row's last tap it
// sums the window's K rows into that output: no intermediate goes through
// shared memory, the column's weights stay in registers for the tile, and
// the height's tap loads are warp-uniform reads of the tile's row table.
// Persistent blocks (as many as the SMs hold) walk the tiles with two
// stage buffers: the next tile's inputs and row table are copied with
// cp.async while this tile computes. Each output row of a warp leaves
// through a double-buffered row in shared memory as float4 stores. So
// the stores (0.031 ms alone at 4K on an H100, near the write's bound)
// overlap the taps, and no barrier separates a tile's phases, which held a
// block-per-tile form with both passes' taps read from shared memory to
// 34 % of its bound. Any other shape (such as a 64x downscale, hundreds of
// taps) takes that form: a block per 32x32 output tile, a lane an output
// column, a warp four rows, the tile's input pixels staged in shared
// memory in chunks of rows and columns where they do not fit, the
// horizontal sums from there into shared memory, then the vertical taps
// from there.
//
// K11 and K12 have uint8 forms for the kernel that ends an upscaled chain
// (temporal_resolve_u8_kernel: the temporal and denoised chains;
// resize_strip_u8_kernel: the spatial chain; resize_u8_kernel: any other
// shape): the epilogue writes K1's byte of each value (present.cuh's
// quantize), so the chain's f32 output never reaches device memory for K1
// to read back (at run E's 4K, 99.5 MB written and read again, 80 % of
// K12's f32 bytes). K12's rows leave as 16-byte stores where a row's
// offset allows it (every row at a width divisible by 16), else 4-byte or
// byte stores. Each f32 form keeps its name and is the same body (a
// template on the output type), so its instructions do not change.
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

// K11's uint8 form, the end of the temporal and denoised chains: K1's
// bytes of the output (3 B a pixel, not 12), the new history as above
__global__ void __launch_bounds__(256) temporal_resolve_u8_kernel(
    const float* __restrict__ up, const float4* __restrict__ history,
    unsigned char* __restrict__ out, float4* __restrict__ new_history, int h, int w,
    float history_weight, float sx, float sy) {
    long long p = pixel();
    if (p < (long long)h * w)
        temporal_resolve_px(p, h, w, up, history, out, new_history, history_weight, sx, sy);
}

unsigned blocks_for(long long n) { return (unsigned)((n + 255) / 256); }

// K12 over one output tile, for any shape the strip form is not compiled
// for: C channels, kr taps a row and kc a column; Out float, or unsigned
// char for K1's bytes of each value (resize_u8_kernel)
template <class Out>
__device__ __forceinline__ void resize_tile(
    ResizeSrc src, int C, int w, int oh, int ow, const int* __restrict__ row_first,
    const float* __restrict__ row_w, int kr, const int* __restrict__ col_first,
    const float* __restrict__ col_w, int kc, int rows_chunk, int cols_chunk, int clamp,
    Out* __restrict__ out) {
    constexpr int ROWS = RESIZE_TH / RESIZE_WARPS;  // output rows a warp takes
    constexpr int NC = RESIZE_MAX_C;                 // the channels a thread holds sums for
    extern __shared__ float smem[];
    float* stage = smem;                                     // [rows_chunk][cols_chunk][C]
    float* sums = stage + rows_chunk * cols_chunk * C;      // [rows_chunk][C][RESIZE_TW]
    // [RESIZE_WARPS][RESIZE_TW * C] of Out
    Out* row = reinterpret_cast<Out*>(sums + rows_chunk * C * RESIZE_TW);
    // a lane is an output column; warp w takes output rows w, w + RESIZE_WARPS, ...
    int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    int ox0 = blockIdx.x * RESIZE_TW, oy0 = blockIdx.y * RESIZE_TH;
    int ox = ox0 + lane;
    // the input rows and columns the tile reads
    ResizeSpan rows = resize_span(row_first, oy0, min(oy0 + RESIZE_TH, oh), kr);
    ResizeSpan cols = resize_span(col_first, ox0, min(ox0 + RESIZE_TW, ow), kc);
    int r_lo = rows.lo, r_hi = rows.hi, c_lo = cols.lo, c_hi = cols.hi;
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
            ResizeSpan taps = resize_chunk_taps(c0, nc, fc, kc);
            int k0 = taps.lo, k1 = taps.hi;
            if (ox < ow && k0 < k1) {
                for (int rr = warp; rr < nr; rr += RESIZE_WARPS) {
                    const float* x = stage + (rr * nc + fc + k0 - c0) * C;
                    resize_row_px(x, C, wc + k0, k0, k1 - k0, sums + rr * C * RESIZE_TW + lane,
                                  RESIZE_TW);
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
            ResizeSpan taps = resize_chunk_taps(r0, nr, fr, kr);
            int k0 = taps.lo, k1 = taps.hi;
            const float* v = sums + (fr + k0 - r0) * C * RESIZE_TW + lane;
            for (int k = k0; k < k1; ++k) {
                float wt = __ldg(wr + k);
#pragma unroll
                for (int c = 0; c < NC; ++c)
                    if (c < C)
                        acc[i][c] = resize_tap(acc[i][c], v[((k - k0) * C + c) * RESIZE_TW], wt, k);
            }
        }
        __syncthreads();
    }
    // each of the warp's output rows through shared memory, stored coalesced
    Out* buf = row + warp * RESIZE_TW * C;
    int n = min(RESIZE_TW, ow - ox0) * C;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
        int oy = oy0 + warp + i * RESIZE_WARPS;
        if (oy >= oh) break;
        if (ox < ow) {
#pragma unroll
            for (int c = 0; c < NC; ++c)
                if (c < C) put(buf + lane * C + c, resize_out(acc[i][c], clamp != 0));
        }
        __syncwarp();
        Out* o = out + ((long long)oy * ow + ox0) * C;
        for (int j = lane; j < n; j += 32) o[j] = buf[j];
        __syncwarp();
    }
}

__global__ void __launch_bounds__(RESIZE_WARPS * 32) resize_kernel(
    ResizeSrc src, int C, int w, int oh, int ow, const int* __restrict__ row_first,
    const float* __restrict__ row_w, int kr, const int* __restrict__ col_first,
    const float* __restrict__ col_w, int kc, int rows_chunk, int cols_chunk, int clamp,
    float* __restrict__ out) {
    resize_tile(src, C, w, oh, ow, row_first, row_w, kr, col_first, col_w, kc, rows_chunk,
                cols_chunk, clamp, out);
}

__global__ void __launch_bounds__(RESIZE_WARPS * 32) resize_u8_kernel(
    ResizeSrc src, int C, int w, int oh, int ow, const int* __restrict__ row_first,
    const float* __restrict__ row_w, int kr, const int* __restrict__ col_first,
    const float* __restrict__ col_w, int kc, int rows_chunk, int cols_chunk, int clamp,
    unsigned char* __restrict__ out) {
    resize_tile(src, C, w, oh, ow, row_first, row_w, kr, col_first, col_w, kc, rows_chunk,
                cols_chunk, clamp, out);
}


// a 4-byte asynchronous copy from global to shared memory (cp.async)
struct AsyncCopy {
    __device__ __forceinline__ void operator()(float* dst, const float* src) const {
        unsigned d = (unsigned)__cvta_generic_to_shared(dst);
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
    }
};

__device__ __forceinline__ void async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every asynchronous copy of this thread but the last committed group's done
__device__ __forceinline__ void async_wait_all_but_last() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// K12's strip form, for the path's two shapes (K taps on both axes, the
// sources' channels C0, C1, C2): persistent blocks walk the tiles
// (resize_strip_tile) with two stage buffers, the next tile's inputs
// copied asynchronously while this tile's outputs are computed
// (resize_strip); each output row of a warp's 32 columns leaves through
// shared memory as float4 stores, or with Out unsigned char (the uint8
// form, resize_strip_u8_kernel) as K1's bytes in 16-byte stores where the
// row allows (store_row). span_r x span_c is the most inputs a tile
// stages (the buffers' size).
template <int K, int C0, int C1, int C2, class Out>
__device__ __forceinline__ void resize_strip_blocks(
    ResizeSrc src, int w, int oh, int ow, const int* __restrict__ row_first,
    const float* __restrict__ row_w, const int* __restrict__ col_first,
    const float* __restrict__ col_w, int rt, int span_r, int span_c, int clamp,
    Out* __restrict__ out) {
    constexpr int C = C0 + C1 + C2;
    extern __shared__ float4 strip_smem[];
    float* smem = reinterpret_cast<float*>(strip_smem);
    int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    // a warp's two output-row buffers (as many floats as values, whatever
    // Out), then the two stage buffers
    Out* rowbuf = reinterpret_cast<Out*>(smem + warp * 2 * 32 * C);
    float* stage = smem + RESIZE_STRIP_WARPS * 2 * 32 * C;
    int stage_floats = span_r * span_c * C + rt * (K + 1);
    int tiles_x = (ow + RESIZE_STRIP_W - 1) / RESIZE_STRIP_W;
    int tiles = tiles_x * ((oh + rt - 1) / rt);
    AsyncCopy copy;
    auto stage_tile = [&](int t, float* planes) {
        ResizeTile T = resize_strip_tile(t, tiles_x, rt, oh, ow, row_first, col_first, K, K);
        if (T.r.hi - T.r.lo > span_r || T.c.hi - T.c.lo > span_c) __trap();
        resize_stage_plane<C0>(src.p[0], w, T, planes + resize_plane_at<C0, C1, C2>(T, 0), warp,
                               RESIZE_STRIP_WARPS, lane, 32, copy);
        resize_stage_plane<C1>(src.p[1], w, T, planes + resize_plane_at<C0, C1, C2>(T, 1), warp,
                               RESIZE_STRIP_WARPS, lane, 32, copy);
        resize_stage_plane<C2>(src.p[2], w, T, planes + resize_plane_at<C0, C1, C2>(T, 2), warp,
                               RESIZE_STRIP_WARPS, lane, 32, copy);
        resize_stage_table<K>(row_first, row_w, T, planes + resize_plane_at<C0, C1, C2>(T, 3),
                              threadIdx.x, RESIZE_STRIP_W, copy);
    };
    int t = blockIdx.x;
    if (t < tiles) stage_tile(t, stage);
    async_commit();
    int parity = 0;
    for (int it = 0; t < tiles; ++it, t += gridDim.x) {
        if (t + (int)gridDim.x < tiles)
            stage_tile(t + gridDim.x, stage + ((it + 1) & 1) * stage_floats);
        async_commit();
        async_wait_all_but_last();
        __syncthreads();
        ResizeTile T = resize_strip_tile(t, tiles_x, rt, oh, ow, row_first, col_first, K, K);
        int n = resize_strip_cols(T, warp) * C;
        Out* row0 = out + (long long)(T.ox0 + 32 * warp) * C;
        resize_strip<K, C0, C1, C2>(
            stage + (it & 1) * stage_floats, T, resize_strip_col(T, threadIdx.x), col_first,
            col_w, [&](int oy, const float* o) {
                Out* buf = rowbuf + parity * 32 * C;
#pragma unroll
                for (int c = 0; c < C; ++c)
                    put(buf + lane * C + c, resize_out(o[c], clamp != 0));
                __syncwarp();
                // a buffer is written again two rows on, after every lane's
                // read of it (each passed the __syncwarp between)
                if (n > 0) store_row(buf, n, row0 + (long long)oy * ow * C, lane);
                parity ^= 1;
            });
        __syncthreads();
    }
}

template <int K, int C0, int C1, int C2>
__global__ void __launch_bounds__(RESIZE_STRIP_W, 2) resize_strip_kernel(
    ResizeSrc src, int w, int oh, int ow, const int* __restrict__ row_first,
    const float* __restrict__ row_w, const int* __restrict__ col_first,
    const float* __restrict__ col_w, int rt, int span_r, int span_c, int clamp,
    float* __restrict__ out) {
    resize_strip_blocks<K, C0, C1, C2>(src, w, oh, ow, row_first, row_w, col_first, col_w, rt,
                                       span_r, span_c, clamp, out);
}

template <int K, int C0, int C1, int C2>
__global__ void __launch_bounds__(RESIZE_STRIP_W, 2) resize_strip_u8_kernel(
    ResizeSrc src, int w, int oh, int ow, const int* __restrict__ row_first,
    const float* __restrict__ row_w, const int* __restrict__ col_first,
    const float* __restrict__ col_w, int rt, int span_r, int span_c, int clamp,
    unsigned char* __restrict__ out) {
    resize_strip_blocks<K, C0, C1, C2>(src, w, oh, ow, row_first, row_w, col_first, col_w, rt,
                                       span_r, span_c, clamp, out);
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

// K11; with ``quantize`` its uint8 form (``out`` (h, w, 3) bytes)
extern "C" int mrt_temporal_resolve(const void* up, const void* history, void* out,
                                    void* new_history, int h, int w, float history_weight,
                                    float sx, float sy, int quantize, void* stream) {
    long long n = (long long)h * w;
    if (n <= 0) return 0;
    auto st = (cudaStream_t)stream;
    if (quantize)
        temporal_resolve_u8_kernel<<<blocks_for(n), 256, 0, st>>>(
            (const float*)up, (const float4*)history, (unsigned char*)out,
            (float4*)new_history, h, w, history_weight, sx, sy);
    else
        temporal_resolve_kernel<<<blocks_for(n), 256, 0, st>>>(
            (const float*)up, (const float4*)history, (float*)out, (float4*)new_history, h, w,
            history_weight, sx, sy);
    return (int)cudaGetLastError();
}

// the most dynamic shared memory a block of K12's strip form may take
constexpr int RESIZE_STRIP_SMEM_MAX = 227 * 1024;

// K12's strip form for Out: resize_strip_kernel (float) or
// resize_strip_u8_kernel (unsigned char)
template <int K, int C0, int C1, int C2>
auto strip_kernel(float*) {
    return resize_strip_kernel<K, C0, C1, C2>;
}
template <int K, int C0, int C1, int C2>
auto strip_kernel(unsigned char*) {
    return resize_strip_u8_kernel<K, C0, C1, C2>;
}

// K12's strip form launched on ``stream``: as many persistent blocks as
// the device's SMs hold at this shared memory (the SM count asked once per
// device, the blocks an SM holds again when the shared memory changes), no
// more than the tiles
template <int K, int C0, int C1, int C2, class Out>
int launch_resize_strip(const ResizeSrc& src, int w, int oh, int ow, const int* row_first,
                        const float* row_w, const int* col_first, const float* col_w, int rt,
                        int span_r, int span_c, int clamp, Out* out, cudaStream_t stream) {
    constexpr int C = C0 + C1 + C2;
    static int sms[64], ready[64], per_sm[64];
    static size_t per_sm_smem[64];
    size_t smem = ((size_t)RESIZE_STRIP_WARPS * 2 * 32 * C +
                   2 * ((size_t)span_r * span_c * C + (size_t)rt * (K + 1))) * sizeof(float);
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= 64 || smem > (size_t)RESIZE_STRIP_SMEM_MAX) return (int)cudaErrorInvalidValue;
    auto k = strip_kernel<K, C0, C1, C2>(out);
    if (!ready[dev]) {
        e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     RESIZE_STRIP_SMEM_MAX);
        if (e != cudaSuccess) return (int)e;
        ready[dev] = 1;
    }
    if (per_sm_smem[dev] != smem) {
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[dev], k, RESIZE_STRIP_W, smem);
        if (e != cudaSuccess) return (int)e;
        per_sm_smem[dev] = smem;
    }
    long long tiles =
        (long long)((ow + RESIZE_STRIP_W - 1) / RESIZE_STRIP_W) * ((oh + rt - 1) / rt);
    long long grid = (long long)(per_sm[dev] > 0 ? per_sm[dev] : 1) * sms[dev];
    k<<<(unsigned)(tiles < grid ? tiles : grid), RESIZE_STRIP_W, smem, stream>>>(
        src, w, oh, ow, row_first, row_w, col_first, col_w, rt, span_r, span_c, clamp, out);
    return (int)cudaGetLastError();
}

// K12: sources s0..s2 of c0..c2 channels (an absent one: c = 0) at (h, w),
// resampled to (oh, ow) by the banded tables (per output row: the first
// input row and kr weights; per output column likewise, kc), written to
// the contiguous (oh, ow, c0 + c1 + c2) ``out``: f32, or with ``quantize``
// K1's bytes of each value (the uint8 form, 3 channels in all). With
// rt > 0 the strip form (only for the path's two shapes: 3 channels of one
// source with 6 taps, or 3 + 1 + 2 channels with 2), tiles of rt output
// rows that stage at most span_r x span_c inputs; else a block a 32x32
// tile that stages ``rows_chunk`` x ``cols_chunk`` input pixels at once
extern "C" int mrt_resize(const void* s0, const void* s1, const void* s2, int c0, int c1, int c2,
                          int h, int w, const void* row_first, const void* row_w, int kr,
                          const void* col_first, const void* col_w, int kc, int oh, int ow,
                          int rows_chunk, int cols_chunk, int rt, int span_r, int span_c,
                          int clamp, int quantize, void* out, void* stream) {
    int C = c0 + c1 + c2;
    if (C < 1 || C > RESIZE_MAX_C || c0 < 1 || c1 < 0 || c2 < 0 || (c1 == 0 && c2 > 0) ||
        kr < 1 || kc < 1 || h < 1 || w < 1 || (quantize && C != 3))
        return (int)cudaErrorInvalidValue;
    if (oh <= 0 || ow <= 0) return 0;
    ResizeSrc src = {{(const float*)s0, (const float*)s1, (const float*)s2}, {c0, c1, c2}};
    auto rf = (const int*)row_first, cf = (const int*)col_first;
    auto rw = (const float*)row_w, cw = (const float*)col_w;
    auto o = (float*)out;
    auto o8 = (unsigned char*)out;
    auto st = (cudaStream_t)stream;
    if (rt > 0) {
        if (span_r < 1 || span_c < 1) return (int)cudaErrorInvalidValue;
        if (c0 == 3 && c1 == 0 && kr == 6 && kc == 6)
            return quantize ? launch_resize_strip<6, 3, 0, 0>(src, w, oh, ow, rf, rw, cf, cw, rt,
                                                              span_r, span_c, clamp, o8, st)
                            : launch_resize_strip<6, 3, 0, 0>(src, w, oh, ow, rf, rw, cf, cw, rt,
                                                              span_r, span_c, clamp, o, st);
        if (c0 == 3 && c1 == 1 && c2 == 2 && kr == 2 && kc == 2)
            return launch_resize_strip<2, 3, 1, 2>(src, w, oh, ow, rf, rw, cf, cw, rt, span_r,
                                                   span_c, clamp, o, st);
        return (int)cudaErrorInvalidValue;
    }
    size_t smem = ((size_t)rows_chunk * (cols_chunk + RESIZE_TW) + RESIZE_WARPS * RESIZE_TW) *
                  C * sizeof(float);
    if (rows_chunk < 1 || cols_chunk < 1 || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    dim3 grid((ow + RESIZE_TW - 1) / RESIZE_TW, (oh + RESIZE_TH - 1) / RESIZE_TH);
    if (quantize)
        resize_u8_kernel<<<grid, RESIZE_WARPS * 32, smem, st>>>(
            src, C, w, oh, ow, rf, rw, kr, cf, cw, kc, rows_chunk, cols_chunk, clamp, o8);
    else
        resize_kernel<<<grid, RESIZE_WARPS * 32, smem, st>>>(
            src, C, w, oh, ow, rf, rw, kr, cf, cw, kc, rows_chunk, cols_chunk, clamp, o);
    return (int)cudaGetLastError();
}
