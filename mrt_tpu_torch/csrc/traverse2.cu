// K2: two-level wide-BVH traversal, one thread per ray.
//
// Replaces mrt_tpu/bvh/twolevel.py:_step2 as looped by _traverse2 for
// closest_hit / any_hit / trace_mixed (leaf test wide.py:_mt_leaf, child
// slabs wide.py:_aabb_children, child order wide.py:_sort_children_packed).
// One kernel serves all three entry points through the per-lane shadow flag:
// a shadow lane stops at its first hit.
//
// Per step a lane pops one entry and reads its 128-float row:
//  * instance row (entry >= n_internal + n_leaf): world-AABB slab test
//    against best_t; on a hit the lane's current ray registers switch to
//    object space through the 3x4 inverse (direction unnormalised, so t stays
//    in world units) and the BLAS root is pushed;
//  * leaf row: 12-wide Moller-Trumbore, keeping the nearest t/tri/inst/u/v
//    (strictly nearer only, first slot on equal t);
//  * internal row: 8 child slab tests (TLAS rows with the WORLD registers),
//    the hit children pushed nearest-first by the packed key
//    [t-bits >> 20 | child id], the same key the JAX package sorts by, so
//    both visit rows in one order and equal-t ties resolve alike.
// Ids decode as bitcast_i32(f) - 2^30.
//
// Bound: latency. Every step is a dependent 512-byte row gather and lanes
// of a warp diverge in row type and path length. This first version stays
// simple: a private stack of stack_size entries in local memory (the
// BVH build's exact worst case, checked by the wrapper against MAX_STACK),
// read-only loads through the texture path (__ldg), no ray sorting. The
// arithmetic is written op for op like the plain PyTorch version
// (kernels/traverse2.py:traverse_plain) and built with -fmad=false, so
// t/u/v are bit-equal to it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define ARITY 8
#define LEAF_K 12
#define ROW 128
#define MAX_STACK 128
#define ID_BIAS (1 << 30)
#define META_MASK ((1 << 20) - 1)
#define KEY_MAX 0x7fffffff
#define I_WBMIN 12
#define I_WBMAX 15
#define I_ROOT 18
#define I_ID 19
#define META_OFF (6 * ARITY)
#define IDS_OFF (9 * LEAF_K)

__device__ __forceinline__ int dec(float f) { return __float_as_int(f) - ID_BIAS; }

__device__ __forceinline__ float guarded_inv(float d) {
    float g = fabsf(d) < 1e-12f ? (d < 0.0f ? -1e-12f : 1e-12f) : d;
    return 1.0f / g;
}

__global__ void traverse2_kernel(
    const float* __restrict__ table, int n_internal, int n_leaf, int tlas_n, int stack_size,
    const float* __restrict__ origin, const float* __restrict__ direction,
    const float* __restrict__ tmax, const unsigned char* __restrict__ shadow,
    const unsigned char* __restrict__ active, int n, float t_min,
    float* __restrict__ out_t, int* __restrict__ out_tri, int* __restrict__ out_inst,
    float* __restrict__ out_u, float* __restrict__ out_v, unsigned char* __restrict__ out_found) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float wox = origin[3 * i], woy = origin[3 * i + 1], woz = origin[3 * i + 2];
    const float wdx = direction[3 * i], wdy = direction[3 * i + 1], wdz = direction[3 * i + 2];
    const bool sh = shadow[i] != 0;
    const int inst_base = n_internal + n_leaf;

    float best_t = tmax[i], best_u = 0.0f, best_v = 0.0f;
    int best_tri = -1, best_inst = -1, cur_inst = -1;
    bool found = false;
    float ox = wox, oy = woy, oz = woz, dx = wdx, dy = wdy, dz = wdz;

    int stack[MAX_STACK];
    int sp = 0;
    if (active[i]) stack[sp++] = 0;

    while (sp > 0) {
        const int entry = stack[--sp];
        const float* row = table + (long long)entry * ROW;
        const float t_cap = best_t;
        if (entry >= inst_base) {
            // --- instance row ------------------------------------------------
            float ix = guarded_inv(wdx), iy = guarded_inv(wdy), iz = guarded_inv(wdz);
            float t0x = (__ldg(row + I_WBMIN) - wox) * ix, t1x = (__ldg(row + I_WBMAX) - wox) * ix;
            float t0y = (__ldg(row + I_WBMIN + 1) - woy) * iy, t1y = (__ldg(row + I_WBMAX + 1) - woy) * iy;
            float t0z = (__ldg(row + I_WBMIN + 2) - woz) * iz, t1z = (__ldg(row + I_WBMAX + 2) - woz) * iz;
            float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
            float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
            if (tn <= tf && tf >= 0.0f && tn <= t_cap) {
                float m[12];
#pragma unroll
                for (int k = 0; k < 12; ++k) m[k] = __ldg(row + k);
                ox = (m[0] * wox + m[1] * woy) + m[2] * woz;
                oy = (m[4] * wox + m[5] * woy) + m[6] * woz;
                oz = (m[8] * wox + m[9] * woy) + m[10] * woz;
                ox = ox + m[3];
                oy = oy + m[7];
                oz = oz + m[11];
                dx = (m[0] * wdx + m[1] * wdy) + m[2] * wdz;
                dy = (m[4] * wdx + m[5] * wdy) + m[6] * wdz;
                dz = (m[8] * wdx + m[9] * wdy) + m[10] * wdz;
                cur_inst = dec(__ldg(row + I_ID));
                if (sp < stack_size) stack[sp] = dec(__ldg(row + I_ROOT));
                sp = min(sp + 1, stack_size);
            }
        } else if (entry >= n_internal) {
            // --- leaf row: LEAF_K-wide Moller-Trumbore ----------------------------
            float cand_t = INFINITY, cand_u = 0.0f, cand_v = 0.0f;
            int cand_j = -1;
            bool cand_any = false;
#pragma unroll 1
            for (int j = 0; j < LEAF_K; ++j) {
                float v0x = __ldg(row + j), v0y = __ldg(row + LEAF_K + j), v0z = __ldg(row + 2 * LEAF_K + j);
                float v1x = __ldg(row + 3 * LEAF_K + j), v1y = __ldg(row + 4 * LEAF_K + j),
                      v1z = __ldg(row + 5 * LEAF_K + j);
                float v2x = __ldg(row + 6 * LEAF_K + j), v2y = __ldg(row + 7 * LEAF_K + j),
                      v2z = __ldg(row + 8 * LEAF_K + j);
                float e1x = v1x - v0x, e1y = v1y - v0y, e1z = v1z - v0z;
                float e2x = v2x - v0x, e2y = v2y - v0y, e2z = v2z - v0z;
                float px = dy * e2z - dz * e2y;
                float py = dz * e2x - dx * e2z;
                float pz = dx * e2y - dy * e2x;
                float det = (e1x * px + e1y * py) + e1z * pz;
                bool valid = fabsf(det) > 1e-9f;
                float inv = valid ? 1.0f / det : 0.0f;
                float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
                float u = ((tx * px + ty * py) + tz * pz) * inv;
                float qx = ty * e1z - tz * e1y;
                float qy = tz * e1x - tx * e1z;
                float qz = tx * e1y - ty * e1x;
                float v = ((dx * qx + dy * qy) + dz * qz) * inv;
                float t = ((e2x * qx + e2y * qy) + e2z * qz) * inv;
                bool hit = valid && u >= 0.0f && v >= 0.0f && (u + v) <= 1.0f && t >= t_min &&
                           t <= t_cap;
                if (hit) {
                    cand_any = true;
                    if (t < cand_t) { cand_t = t; cand_u = u; cand_v = v; cand_j = j; }
                }
            }
            if (cand_any && cand_t < best_t) {
                best_t = cand_t;
                best_tri = dec(__ldg(row + IDS_OFF + cand_j));
                best_inst = cur_inst;
                best_u = cand_u;
                best_v = cand_v;
            }
            found = found || cand_any;
            if (found && sh) sp = 0;
        } else {
            // --- internal row: ARITY child slabs + nearest-first push ---------------
            const bool tl = entry < tlas_n;
            const float px = tl ? wox : ox, py = tl ? woy : oy, pz = tl ? woz : oz;
            const float ix = guarded_inv(tl ? wdx : dx), iy = guarded_inv(tl ? wdy : dy),
                        iz = guarded_inv(tl ? wdz : dz);
            int keys[ARITY];
            int n_push = 0;
#pragma unroll
            for (int c = 0; c < ARITY; ++c) {
                float t0x = (__ldg(row + c) - px) * ix, t1x = (__ldg(row + 3 * ARITY + c) - px) * ix;
                float t0y = (__ldg(row + ARITY + c) - py) * iy, t1y = (__ldg(row + 4 * ARITY + c) - py) * iy;
                float t0z = (__ldg(row + 2 * ARITY + c) - pz) * iz, t1z = (__ldg(row + 5 * ARITY + c) - pz) * iz;
                float tnear = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
                float tfar = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
                bool hit = tnear <= tfar && tfar >= 0.0f && tnear <= t_cap;
                float a_t = tnear > 0.0f ? tnear : 0.0f;
                int meta = dec(__ldg(row + META_OFF + c));
                float tA = (hit && meta >= 0) ? a_t : INFINITY;
                bool ok = tA < INFINITY && meta >= 0;
                keys[c] = ok ? (((__float_as_int(tA) >> 20) << 20) | (meta & META_MASK)) : KEY_MAX;
                n_push += ok ? 1 : 0;
            }
            // ascending insertion sort of the 8 keys (unique per row)
#pragma unroll
            for (int a = 1; a < ARITY; ++a) {
                int k = keys[a];
                int b = a - 1;
                while (b >= 0 && keys[b] > k) { keys[b + 1] = keys[b]; --b; }
                keys[b + 1] = k;
            }
            // farthest first, so the nearest child ends on top
            for (int k = n_push - 1; k >= 0; --k) {
                int pos = sp + (n_push - 1 - k);
                if (pos < stack_size) stack[pos] = keys[k] & META_MASK;
            }
            sp = min(sp + n_push, stack_size);
        }
    }
    out_t[i] = best_t;
    out_tri[i] = best_tri;
    out_inst[i] = best_inst;
    out_u[i] = best_u;
    out_v[i] = best_v;
    out_found[i] = found ? 1 : 0;
}

extern "C" int mrt_traverse2(const void* table, int n_internal, int n_leaf, int tlas_n,
                             int stack_size, const void* origin, const void* direction,
                             const void* tmax, const void* shadow, const void* active, int n,
                             float t_min, void* out_t, void* out_tri, void* out_inst,
                             void* out_u, void* out_v, void* out_found, void* stream) {
    if (n <= 0) return 0;
    const int block = 128;
    traverse2_kernel<<<(n + block - 1) / block, block, 0, (cudaStream_t)stream>>>(
        (const float*)table, n_internal, n_leaf, tlas_n, stack_size, (const float*)origin,
        (const float*)direction, (const float*)tmax, (const unsigned char*)shadow,
        (const unsigned char*)active, n, t_min, (float*)out_t, (int*)out_tri, (int*)out_inst,
        (float*)out_u, (float*)out_v, (unsigned char*)out_found);
    return (int)cudaGetLastError();
}
