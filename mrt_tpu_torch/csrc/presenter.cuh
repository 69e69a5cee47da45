// The per-pixel bodies of K9 svgf_reproject, K10 atrous_pass, K11
// temporal_resolve and K12 resize (presenter.cu launches them: K9 and K11
// a thread a pixel, K10 and K12 a block an output tile), compiled for the
// host too (outside nvcc MRT_PX is plain inline and MRT_LDG a plain load),
// so a host compiler can hold them against the plain PyTorch versions on
// the CPU. K11 and K12 write f32, or in their uint8 forms (the kernel that
// ends an upscaled chain) K1's tonemapped byte of each value (put,
// present.cuh's quantize).
//
// Bits: nvcc -fmad=false (a host compiler: -ffp-contract=off). Every step
// is written in the plain version's op order: clamp/clamp_min/clamp_max/
// minimum/maximum keep a NaN as PyTorch's CUDA ops do, `t / python_scalar`
// is a multiply by the f32 reciprocal, `s / t` is reciprocal(t) * s, a
// Python double product of tap weights is rounded once to f32 (the B3
// products are exact), torch.exp is expf, luma and the normal dot products
// add left to right.
#pragma once

#include <math.h>

#include "present.cuh"

#ifdef __CUDACC__
#define MRT_LDG(p) __ldg(p)
#else
#define MRT_LDG(p) (*(p))
struct float4 {
    float x, y, z, w;
};
struct uint4 {
    unsigned int x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) { return float4{x, y, z, w}; }
#endif

namespace mrt_presenter {

MRT_PX int mrt_imin(int a, int b) { return a < b ? a : b; }
MRT_PX int mrt_imax(int a, int b) { return a > b ? a : b; }
MRT_PX int mrt_iclamp(int v, int lo, int hi) { return mrt_imin(mrt_imax(v, lo), hi); }

MRT_PX float clamp_min_t(float v, float lo) {
    return isnan(v) ? v : fmaxf(v, lo);
}
MRT_PX float clamp_max_t(float v, float hi) {
    return isnan(v) ? v : fminf(v, hi);
}
MRT_PX float clamp_t(float v, float lo, float hi) {
    return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
MRT_PX float minimum_t(float a, float b) {
    return a != a ? a : (b != b ? b : fminf(a, b));
}
MRT_PX float maximum_t(float a, float b) {
    return a != a ? a : (b != b ? b : fmaxf(a, b));
}
MRT_PX float luma3(float x0, float x1, float x2) {
    return x0 * 0.2126f + x1 * 0.7152f + x2 * 0.0722f;
}
MRT_PX float dot3(float a0, float a1, float a2, float b0, float b1, float b2) {
    float p0 = a0 * b0, p1 = a1 * b1, p2 = a2 * b2;
    return p0 + p1 + p2;
}

// an output value of K11 or K12: the f32 itself, or in the uint8 forms K1's
// byte of it
MRT_PX void put(float* o, float v) { *o = v; }
MRT_PX void put(unsigned char* o, float v) { *o = mrt_tonemap::quantize(v); }

// bilinear_sample's addressing at (rows, cols) over an (h, w) image: the
// four taps' pixel indices, the blend fractions and the in-bounds test.
struct Bilinear {
    long long p00, p01, p10, p11;
    float fr, fc;
    bool in_bounds;
};

MRT_PX Bilinear bilinear_at(float rows, float cols, int h, int w) {
    Bilinear b;
    float hm = (float)(h - 1), wm = (float)(w - 1);
    b.in_bounds = (rows >= 0.0f) & (rows <= hm) & (cols >= 0.0f) & (cols <= wm);
    float r = clamp_t(rows, 0.0f, hm);
    float c = clamp_t(cols, 0.0f, wm);
    float r0 = floorf(r), c0 = floorf(c);
    b.fr = r - r0;
    b.fc = c - c0;
    // a NaN coordinate has no tap: clamp the index (the plain version fails there)
    int r0i = r0 >= 0.0f ? (int)fminf(r0, hm) : 0;
    int c0i = c0 >= 0.0f ? (int)fminf(c0, wm) : 0;
    int r1i = mrt_imin(r0i + 1, h - 1), c1i = mrt_imin(c0i + 1, w - 1);
    b.p00 = (long long)r0i * w + c0i;
    b.p01 = (long long)r0i * w + c1i;
    b.p10 = (long long)r1i * w + c0i;
    b.p11 = (long long)r1i * w + c1i;
    return b;
}

// top = v00 * (1 - fc) + v01 * fc; bot likewise; top * (1 - fr) + bot * fr
MRT_PX float blend(const Bilinear& b, float v00, float v01, float v10, float v11) {
    float gc = 1.0f - b.fc, gr = 1.0f - b.fr;
    float top = v00 * gc + v01 * b.fc;
    float bot = v10 * gc + v11 * b.fc;
    return top * gr + bot * b.fr;
}

MRT_PX float tap1(const float* __restrict__ f, const Bilinear& b) {
    return blend(b, MRT_LDG(f + b.p00), MRT_LDG(f + b.p01), MRT_LDG(f + b.p10),
                 MRT_LDG(f + b.p11));
}

MRT_PX float tap3(const float* __restrict__ f, const Bilinear& b, int k) {
    return blend(b, MRT_LDG(f + 3 * b.p00 + k), MRT_LDG(f + 3 * b.p01 + k),
                 MRT_LDG(f + 3 * b.p10 + k), MRT_LDG(f + 3 * b.p11 + k));
}

// K9 at pixel p: demodulation, the reprojected state, the moments
MRT_PX void svgf_reproject_px(
    long long p, int h, int w, const float* __restrict__ color, const float* __restrict__ diffuse,
    const float* __restrict__ specular, const float* __restrict__ normal_enc,
    const float* __restrict__ depth, const float* __restrict__ motion,
    const float* __restrict__ s_demod, const float* __restrict__ s_m1,
    const float* __restrict__ s_m2, const float* __restrict__ s_len,
    const float* __restrict__ s_depth, const float* __restrict__ s_normal,
    float* __restrict__ o_demod, float* __restrict__ o_m1, float* __restrict__ o_m2,
    float* __restrict__ o_len, float* __restrict__ o_normal, float* __restrict__ o_var,
    float* __restrict__ o_lum) {
    int row = (int)(p / w), col = (int)(p - (long long)row * w);

    float n[3], demod[3];
    for (int k = 0; k < 3; ++k) {
        float albedo =
            clamp_min_t(MRT_LDG(diffuse + 3 * p + k) + MRT_LDG(specular + 3 * p + k), 1e-3f);
        n[k] = MRT_LDG(normal_enc + 3 * p + k) * 2.0f - 1.0f;
        demod[k] = MRT_LDG(color + 3 * p + k) / albedo;
    }
    float lum = luma3(demod[0], demod[1], demod[2]);
    float z = MRT_LDG(depth + p);

    // display +Y down is -row: the history sits at row + motion.y, col - motion.x
    Bilinear b = bilinear_at((float)row + MRT_LDG(motion + 2 * p + 1),
                             (float)col - MRT_LDG(motion + 2 * p), h, w);
    float pd[3], pn[3];
    for (int k = 0; k < 3; ++k) {
        pd[k] = tap3(s_demod, b, k);
        pn[k] = tap3(s_normal, b, k);
    }
    float pm1 = tap1(s_m1, b), pm2 = tap1(s_m2, b), plen = tap1(s_len, b);
    float pz = tap1(s_depth, b);

    bool depth_ok = fabsf(pz - z) <= 0.1f * clamp_min_t(z, 1e-3f);
    bool normal_ok = dot3(pn[0], pn[1], pn[2], n[0], n[1], n[2]) > 0.8f;
    bool valid = b.in_bounds & depth_ok & normal_ok;

    float hist_len = valid ? clamp_max_t(plen + 1.0f, 32.0f) : 1.0f;
    float inv_len = 1.0f / hist_len;
    float alpha = clamp_min_t(inv_len * 1.0f, 0.2f);
    float di[3];
    for (int k = 0; k < 3; ++k) di[k] = valid ? pd[k] + (demod[k] - pd[k]) * alpha : demod[k];
    float lum2 = lum * lum;
    float m1 = valid ? pm1 + (lum - pm1) * alpha : lum;
    float m2 = valid ? pm2 + (lum2 - pm2) * alpha : lum2;
    float var = clamp_min_t(m2 - m1 * m1, 0.0f);
    // young pixels have unreliable moments: inflate the variance
    var = var * clamp_t(inv_len * 4.0f, 1.0f, 4.0f);

    for (int k = 0; k < 3; ++k) {
        o_demod[3 * p + k] = di[k];
        o_normal[3 * p + k] = n[k];
    }
    o_m1[p] = m1;
    o_m2[p] = m2;
    o_len[p] = hist_len;
    o_var[p] = var;
    o_lum[p] = luma3(di[0], di[1], di[2]);
}

// the B3 spline's taps per axis; their products (wr * wc in double) are
// exact in f32
MRT_PX float mrt_b3(int i) {
    return i == 2 ? 3.0f / 8.0f : (i == 1 || i == 3) ? 1.0f / 4.0f : 1.0f / 16.0f;
}

// K10's tile: ATROUS_TW x ATROUS_TH output pixels (a block), staged with
// a 2*STEP halo on every side, the edge clamp applied when staging
constexpr int ATROUS_TW = 32, ATROUS_TH = 8;
// the staged fields, one plane each: filtered 3, normal 3, var, lum, depth
enum { AP_F0, AP_F1, AP_F2, AP_N0, AP_N1, AP_N2, AP_VAR, AP_LUM, AP_Z, AP_PLANES };

template <int STEP>
struct AtrousTile {
    static constexpr int W = ATROUS_TW + 4 * STEP, H = ATROUS_TH + 4 * STEP, N = W * H;
};

// the centre pixel's terms of K10's weights
struct AtrousCentre {
    float n0, n1, n2, z, l, sigma_l, depth_scale;
};

// K10's running sums over the taps
struct AtrousSums {
    float acc0, acc1, acc2, acc_var, wsum;
};

MRT_PX AtrousCentre atrous_centre(float n0, float n1, float n2, float z, float l, float var) {
    AtrousCentre c;
    c.n0 = n0;
    c.n1 = n1;
    c.n2 = n2;
    c.z = z;
    c.l = l;
    c.sigma_l = sqrtf(clamp_min_t(var, 0.0f)) * 4.0f + 1e-4f;
    c.depth_scale = 0.1f * clamp_min_t(z, 1e-3f);
    return c;
}

// exp(-d / s) of a distance d >= 0. Where d is 0 and s > 0, -0 / s is -0
// and the result exactly 1: taken without the division and the exp. Flat
// image regions have many such taps, and a zero dividend takes the
// division off its fast path (K10 ran slower on rendered frames than on
// random data before this)
MRT_PX float atrous_falloff(float d, float s) {
    if (d == 0.0f && s > 0.0f) return 1.0f;
    return expf(-d / s);
}

// one of K10's 25 taps: ``wij`` the B3 product, then the neighbour's
// filtered colour, normal, variance, luma and depth
MRT_PX void atrous_tap(AtrousSums& s, const AtrousCentre& c, float wij, float f0, float f1,
                       float f2, float m0, float m1, float m2, float qv, float ql, float qz) {
    float nd = dot3(m0, m1, m2, c.n0, c.n1, c.n2);
    float w_n = clamp_t(nd, 0.0f, 1.0f);
    for (int k = 0; k < 5; ++k) w_n = w_n * w_n;
    float w_z = atrous_falloff(fabsf(qz - c.z), c.depth_scale);
    float w_l = atrous_falloff(fabsf(ql - c.l), c.sigma_l);
    float wgt = wij * w_n * w_z * w_l;
    s.acc0 = s.acc0 + f0 * wgt;
    s.acc1 = s.acc1 + f1 * wgt;
    s.acc2 = s.acc2 + f2 * wgt;
    s.acc_var = s.acc_var + qv * wgt * wgt;
    s.wsum = s.wsum + wgt;
}

// stage pixel i (row-major) of the tile whose first output pixel is (x0,
// y0) into ``planes`` (AP_PLANES planes of AtrousTile<STEP>::N): the image
// pixel at the clamped (y0 - 2 STEP + i / W, x0 - 2 STEP + i % W)
template <int STEP>
MRT_PX void atrous_stage(int i, int x0, int y0, int h, int w, const float* __restrict__ filtered,
                         const float* __restrict__ var, const float* __restrict__ lum,
                         const float* __restrict__ normal, const float* __restrict__ depth,
                         float* __restrict__ planes) {
    using T = AtrousTile<STEP>;
    int ty = i / T::W, tx = i - ty * T::W;
    int r = mrt_iclamp(y0 - 2 * STEP + ty, 0, h - 1);
    int c = mrt_iclamp(x0 - 2 * STEP + tx, 0, w - 1);
    long long q = (long long)r * w + c;
    for (int k = 0; k < 3; ++k) {
        planes[(AP_F0 + k) * T::N + i] = MRT_LDG(filtered + 3 * q + k);
        planes[(AP_N0 + k) * T::N + i] = MRT_LDG(normal + 3 * q + k);
    }
    planes[AP_VAR * T::N + i] = MRT_LDG(var + q);
    planes[AP_LUM * T::N + i] = MRT_LDG(lum + q);
    planes[AP_Z * T::N + i] = MRT_LDG(depth + q);
}

// K10 at the tile's pixel (tx, ty), inside the image, from the staged
// planes: one pass at dilation STEP; with ``diffuse`` (the last pass) the
// remodulated colour, else the colour, variance and luma
template <int STEP>
MRT_PX void atrous_tile_px(int tx, int ty, int x0, int y0, int w, const float* planes,
                           const float* __restrict__ diffuse, const float* __restrict__ specular,
                           float* __restrict__ out, float* __restrict__ out_var,
                           float* __restrict__ out_lum) {
    using T = AtrousTile<STEP>;
    const float* at = planes + (ty + 2 * STEP) * T::W + tx + 2 * STEP;  // the centre
    AtrousCentre c = atrous_centre(at[AP_N0 * T::N], at[AP_N1 * T::N], at[AP_N2 * T::N],
                                   at[AP_Z * T::N], at[AP_LUM * T::N], at[AP_VAR * T::N]);
    AtrousSums s = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 5; ++i) {
#pragma unroll
        for (int j = 0; j < 5; ++j) {
            const float* q = at + (i - 2) * STEP * T::W + (j - 2) * STEP;
            atrous_tap(s, c, mrt_b3(i) * mrt_b3(j), q[AP_F0 * T::N], q[AP_F1 * T::N],
                       q[AP_F2 * T::N], q[AP_N0 * T::N], q[AP_N1 * T::N], q[AP_N2 * T::N],
                       q[AP_VAR * T::N], q[AP_LUM * T::N], q[AP_Z * T::N]);
        }
    }
    long long p = (long long)(y0 + ty) * w + x0 + tx;
    float den = clamp_min_t(s.wsum, 1e-6f);
    float o0 = s.acc0 / den, o1 = s.acc1 / den, o2 = s.acc2 / den;
    if (diffuse != nullptr) {  // the last pass: remodulate
        float o[3] = {o0, o1, o2};
        for (int k = 0; k < 3; ++k)
            out[3 * p + k] = o[k] * clamp_min_t(MRT_LDG(diffuse + 3 * p + k) +
                                                    MRT_LDG(specular + 3 * p + k), 1e-3f);
        return;
    }
    out[3 * p] = o0;
    out[3 * p + 1] = o1;
    out[3 * p + 2] = o2;
    out_var[p] = s.acc_var / clamp_min_t(s.wsum * s.wsum, 1e-6f);
    out_lum[p] = luma3(o0, o1, o2);
}

// K11 at output pixel p: the reprojected history, the depth test, the
// 3x3 clamp and the blend; the output as f32 or (Out unsigned char) K1's
// bytes, the new history f32 either way
template <class Out>
MRT_PX void temporal_resolve_px(
    long long p, int h, int w, const float* __restrict__ up, const float4* __restrict__ history,
    Out* __restrict__ out, float4* __restrict__ new_history, float history_weight, float sx,
    float sy) {
    int row = (int)(p / w), col = (int)(p - (long long)row * w);

    const float* u = up + 6 * p;
    float cur[3] = {MRT_LDG(u), MRT_LDG(u + 1), MRT_LDG(u + 2)};
    float dep = MRT_LDG(u + 3);
    float mx = MRT_LDG(u + 4) * sx, my = MRT_LDG(u + 5) * sy;

    Bilinear b = bilinear_at((float)row + my, (float)col - mx, h, w);
    float4 v00 = MRT_LDG(history + b.p00), v01 = MRT_LDG(history + b.p01);
    float4 v10 = MRT_LDG(history + b.p10), v11 = MRT_LDG(history + b.p11);
    float hist[3] = {blend(b, v00.x, v01.x, v10.x, v11.x), blend(b, v00.y, v01.y, v10.y, v11.y),
                     blend(b, v00.z, v01.z, v10.z, v11.z)};
    float hist_depth = blend(b, v00.w, v01.w, v10.w, v11.w);
    bool depth_ok = fabsf(hist_depth - dep) <= 0.1f * clamp_min_t(dep, 1e-3f);

    // 3x3 clamp: the min/max over the rows above, at and below (edges
    // clamped) in each of the three columns, then over the columns
    int rows[3] = {mrt_imax(row - 1, 0), row, mrt_imin(row + 1, h - 1)};
    float nmin[3], nmax[3];
    for (int j = 0; j < 3; ++j) {
        int c = mrt_iclamp(col + j - 1, 0, w - 1);
        for (int k = 0; k < 3; ++k) {
            float a = MRT_LDG(up + 6 * ((long long)rows[0] * w + c) + k);
            float m = MRT_LDG(up + 6 * ((long long)rows[1] * w + c) + k);
            float d = MRT_LDG(up + 6 * ((long long)rows[2] * w + c) + k);
            float rmin = minimum_t(minimum_t(a, m), d);
            float rmax = maximum_t(maximum_t(a, m), d);
            nmin[k] = j == 0 ? rmin : minimum_t(nmin[k], rmin);
            nmax[k] = j == 0 ? rmax : maximum_t(nmax[k], rmax);
        }
    }
    float mag = sqrtf(mx * mx + my * my);
    float weight = history_weight * clamp_t(1.0f - mag * 0.0625f, 0.25f, 1.0f);
    weight = (b.in_bounds & depth_ok) ? weight : 0.0f;
    float o[3];
    for (int k = 0; k < 3; ++k) {
        float hk = minimum_t(maximum_t(hist[k], nmin[k]), nmax[k]);
        o[k] = cur[k] + (hk - cur[k]) * weight;
        put(out + 3 * p + k, o[k]);
    }
    new_history[p] = make_float4(o[0], o[1], o[2], dep);
}

// K12: up to three (h, w, c) sources resampled as one image of their
// channels in order (an absent source has c = 0), at most RESIZE_MAX_C
constexpr int RESIZE_MAX_C = 8;
// K12's tile: RESIZE_TW x RESIZE_TH output pixels (a block of RESIZE_WARPS
// warps, each RESIZE_TH / RESIZE_WARPS of its rows)
constexpr int RESIZE_TW = 32, RESIZE_TH = 32, RESIZE_WARPS = 8;

struct ResizeSrc {
    const float* p[3];
    int c[3];
};

// K12's staging: input pixel (r, col)'s channels, every source's in turn,
// to dst[0..C)
MRT_PX void resize_stage_px(const ResizeSrc& src, int w, int r, int col, float* dst) {
    long long q = (long long)r * w + col;
    int c0 = 0;
#pragma unroll
    for (int s = 0; s < 3; ++s) {
        int cs = src.c[s];
        for (int c = 0; c < cs; ++c) dst[c0 + c] = MRT_LDG(src.p[s] + q * cs + c);
        c0 += cs;
    }
}

// a tap of either axis: v times its weight wt, added in increasing input
// index (tap 0 starts the sum)
MRT_PX float resize_tap(float acc, float v, float wt, int k) {
    float t = v * wt;
    return k == 0 ? t : acc + t;
}

// K12's horizontal pass at one input row and output column, taps k0 to
// k0 + n - 1: x points at tap k0's staged pixel (C channels a pixel), wt
// at its weight; channel c's sum is sums[c * stride] (read unless k0 is 0)
MRT_PX void resize_row_px(const float* x, int C, const float* __restrict__ wt, int k0, int n,
                          float* sums, int stride) {
    for (int c = 0; c < C; ++c) {
        float acc = sums[c * stride];
        for (int k = 0; k < n; ++k) acc = resize_tap(acc, x[k * C + c], MRT_LDG(wt + k), k0 + k);
        sums[c * stride] = acc;
    }
}

// the spatial chain's clamp_min(out, 0), folded in (NaN kept)
MRT_PX float resize_out(float v, bool clamp) { return clamp ? clamp_min_t(v, 0.0f) : v; }

// a warp's row of n floats from shared ``buf`` to ``dst``: as float4s
// where both allow it (16-byte aligned, n a multiple of 4), else floats
MRT_PX void store_row(const float* buf, int n, float* dst, int lane) {
    if (((unsigned long long)dst & 15) == 0 && (n & 3) == 0) {
#pragma unroll 1
        for (int j = lane; j < n / 4; j += 32)
            reinterpret_cast<float4*>(dst)[j] = reinterpret_cast<const float4*>(buf)[j];
    } else {
#pragma unroll 1
        for (int j = lane; j < n; j += 32) dst[j] = buf[j];
    }
}

// a warp's row of n bytes (the uint8 forms) from shared ``buf`` (16-byte
// aligned) to ``dst``: 16-byte stores where dst is 16-byte aligned and n a
// multiple of 16 (a warp's 96 bytes; every row's offset is a multiple of
// 16 at an output width divisible by 16), else 4-byte stores where both
// allow it, else bytes
MRT_PX void store_row(const unsigned char* buf, int n, unsigned char* dst, int lane) {
    unsigned long long a = (unsigned long long)dst;
    if ((a & 15) == 0 && (n & 15) == 0) {
#pragma unroll 1
        for (int j = lane; j < n / 16; j += 32)
            reinterpret_cast<uint4*>(dst)[j] = reinterpret_cast<const uint4*>(buf)[j];
    } else if ((a & 3) == 0 && (n & 3) == 0) {
#pragma unroll 1
        for (int j = lane; j < n / 4; j += 32)
            reinterpret_cast<unsigned int*>(dst)[j] = reinterpret_cast<const unsigned int*>(buf)[j];
    } else {
#pragma unroll 1
        for (int j = lane; j < n; j += 32) dst[j] = buf[j];
    }
}

// The inputs [lo, hi) that outputs [o0, o1) of a banded table read with k
// taps each (first indices rise with the output)
struct ResizeSpan {
    int lo, hi;
};

MRT_PX ResizeSpan resize_span(const int* __restrict__ first, int o0, int o1, int k) {
    return ResizeSpan{MRT_LDG(first + o0), MRT_LDG(first + o1 - 1) + k};
}

// of the k taps from input f, those [k0, k1) that a chunk of n staged
// inputs from input c0 holds (none where k1 <= k0)
MRT_PX ResizeSpan resize_chunk_taps(int c0, int n, int f, int k) {
    return ResizeSpan{mrt_imax(c0 - f, 0), mrt_imin(c0 + n - f, k)};
}

// K12's strip form (the path's two shapes): a block of RESIZE_STRIP_WARPS
// warps takes a tile of RESIZE_STRIP_W output columns (a thread a column)
// by ``rt`` output rows (a thread all of them, in order), and stages the
// tile's input rows and columns whole, each source as a plane of its own.
constexpr int RESIZE_STRIP_WARPS = 8, RESIZE_STRIP_W = 32 * RESIZE_STRIP_WARPS;

struct ResizeTile {
    int ox0, ox1, oy0, oy1;  // its outputs, clipped to the image
    ResizeSpan r, c;         // the input rows and columns it stages
};

// tile t, tiles row-major with ``tiles_x`` a row; partial at the right and
// bottom edges
MRT_PX ResizeTile resize_strip_tile(int t, int tiles_x, int rt, int oh, int ow,
                                    const int* __restrict__ row_first,
                                    const int* __restrict__ col_first, int kr, int kc) {
    ResizeTile T;
    int ty = t / tiles_x, tx = t - ty * tiles_x;
    T.ox0 = tx * RESIZE_STRIP_W;
    T.ox1 = mrt_imin(T.ox0 + RESIZE_STRIP_W, ow);
    T.oy0 = ty * rt;
    T.oy1 = mrt_imin(T.oy0 + rt, oh);
    T.r = resize_span(row_first, T.oy0, T.oy1, kr);
    T.c = resize_span(col_first, T.ox0, T.ox1, kc);
    return T;
}

// the output column that the block's thread ``thread`` owns in tile T; a
// thread past the image's right edge takes the last column (computed, not
// stored), so that every lane of a warp runs every row
MRT_PX int resize_strip_col(const ResizeTile& T, int thread) {
    return mrt_imin(T.ox0 + thread, T.ox1 - 1);
}

// the columns of tile T whose outputs warp ``warp`` stores (0 past the edge)
MRT_PX int resize_strip_cols(const ResizeTile& T, int warp) {
    return mrt_imax(mrt_imin(32, T.ox1 - T.ox0 - 32 * warp), 0);
}

// where tile T's staged data lies in its stage buffer, in floats: source
// s's plane at resize_plane_at(T, s) for s < 3; then (s = 3) the first
// input rows of its output rows, as ints, and the rows' K weights each
template <int C0, int C1, int C2>
MRT_PX int resize_plane_at(const ResizeTile& T, int s) {
    int n = (T.r.hi - T.r.lo) * (T.c.hi - T.c.lo);
    return s == 0 ? 0 : s == 1 ? n * C0 : s == 2 ? n * (C0 + C1) : n * (C0 + C1 + C2);
}

// stage tile T's rows of the height's table (their first input rows and
// their K weights each) at ``table`` (resize_plane_at(T, 3)): items from e0
// by de, each float moved by copy(dst, src)
template <int K, class Copy>
MRT_PX void resize_stage_table(const int* __restrict__ row_first, const float* __restrict__ row_w,
                               const ResizeTile& T, float* table, int e0, int de, Copy copy) {
    int n = T.oy1 - T.oy0;
    for (int e = e0; e < n * (K + 1); e += de) {
        if (e < n)
            copy(table + e, reinterpret_cast<const float*>(row_first + T.oy0 + e));
        else
            copy(table + e, row_w + (long long)T.oy0 * K + e - n);
    }
}

// stage tile T's rows of one source of CS channels (an (h, w, CS) image)
// into its plane: row rr of the tile's inputs at plane + rr * ncols * CS,
// the pixels' channels as they lie in the source; rows from r0 by dr,
// floats of a row from e0 by de (a warp's rows, its lanes' floats), each
// float moved by copy(dst, src)
template <int CS, class Copy>
MRT_PX void resize_stage_plane(const float* __restrict__ src, int w, const ResizeTile& T,
                               float* plane, int r0, int dr, int e0, int de, Copy copy) {
    if (CS == 0) return;
    int n = (T.c.hi - T.c.lo) * CS;
    for (int rr = r0; rr < T.r.hi - T.r.lo; rr += dr) {
        const float* s = src + ((long long)(T.r.lo + rr) * w + T.c.lo) * CS;
        float* d = plane + rr * n;
        for (int e = e0; e < n; e += de) copy(d + e, s + e);
    }
}

// the width's K taps at one staged row of one source: x points at the
// thread's first tap's pixel (CS channels a pixel), wc holds its weights;
// channel c's sum to out[c], tap 0 first
template <int K, int CS>
MRT_PX void resize_row_taps(const float* x, const float* wc, float* out) {
#pragma unroll
    for (int c = 0; c < CS; ++c) {
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < K; ++k) acc = resize_tap(acc, x[k * CS + c], wc[k], k);
        out[c] = acc;
    }
}

// K12's strip form for one thread: output column ``col`` of tile T, every
// output row of the tile in order, from T's stage buffer ``staged`` (the
// C0 + C1 + C2 channels of up to three sources, a plane each, and the
// rows' table; resize_plane_at). The horizontal sums of one staged row at
// a time go into a window of the last K rows, held in registers (the
// unrolled loop rotates the window's names, so nothing moves); when the
// row just summed is an output row's last tap, that output is the sum of
// the window's K rows, tap 0 first, and emit(oy, o) takes its C values
// (the next row's table read before). Every output of the tile takes its
// taps in increasing input index, as resize_plain adds them.
template <int K, int C0, int C1, int C2, class Emit>
MRT_PX void resize_strip(const float* staged, const ResizeTile& T, int col,
                         const int* __restrict__ col_first, const float* __restrict__ col_w,
                         Emit emit) {
    constexpr int C = C0 + C1 + C2;
    int ncols = T.c.hi - T.c.lo, nrows = T.r.hi - T.r.lo, n = T.oy1 - T.oy0;
    float wc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) wc[k] = MRT_LDG(col_w + (long long)col * K + k);
    int p = MRT_LDG(col_first + col) - T.c.lo;
    const float* x0 = staged + resize_plane_at<C0, C1, C2>(T, 0) + p * C0;
    const float* x1 = staged + resize_plane_at<C0, C1, C2>(T, 1) + p * C1;
    const float* x2 = staged + resize_plane_at<C0, C1, C2>(T, 2) + p * C2;
    const int* first = reinterpret_cast<const int*>(staged + resize_plane_at<C0, C1, C2>(T, 3));
    const float* wts = staged + resize_plane_at<C0, C1, C2>(T, 3) + n;
    float v[K][C], wr[K];
    // the next output (i of the tile's rows) and its first tap row,
    // relative to the tile's first input row, and weights
    int i = 0, fr = first[0] - T.r.lo;
#pragma unroll
    for (int k = 0; k < K; ++k) wr[k] = wts[k];
    for (int r = 0; r < nrows; r += K) {
#pragma unroll
        for (int u = 0; u < K; ++u) {
            int q = r + u;  // its sums go to window slot u
            if (q < nrows) {
                resize_row_taps<K, C0>(x0 + q * ncols * C0, wc, v[u]);
                resize_row_taps<K, C1>(x1 + q * ncols * C1, wc, v[u] + C0);
                resize_row_taps<K, C2>(x2 + q * ncols * C2, wc, v[u] + C0 + C1);
            }
            while (fr + K - 1 == q) {  // the same for every thread of the tile
                float o[C] = {};
#pragma unroll
                for (int k = 0; k < K; ++k)
#pragma unroll
                    for (int c = 0; c < C; ++c)
                        o[c] = resize_tap(o[c], v[(u + 1 + k) % K][c], wr[k], k);
                int j = mrt_imin(++i, n - 1);
                fr = i < n ? first[j] - T.r.lo : -K;
#pragma unroll
                for (int k = 0; k < K; ++k) wr[k] = wts[j * K + k];
                emit(T.oy0 + i - 1, o);
            }
        }
    }
}

}  // namespace mrt_presenter
