// K2: two-level wide-BVH traversal, and K3: flat wide-BVH traversal: a
// compaction kernel, then a persistent traversal kernel.
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
// Ids decode as bitcast_i32(f) - 2^30. Each lane also counts the rows it
// popped (the JAX package's count_pops).
//
// K3 (FLAT, the third template parameter) replaces
// mrt_tpu/bvh/wide.py:_traverse_flat_rows (:936), the flat single-level
// table's loop for wide.closest_hit / any_hit / trace_mixed: K2's step with
// the instance branch compiled out. Every row below n_internal is internal,
// every other one a leaf; the ray stays in world space, so leaves and
// internal rows read the world registers, and leaf ids are the scene's
// global triangle ids (inst stays -1). Its instantiations <false, false,
// true> ("flat") and <false, true, true> ("flat_float_sort", tables above
// 2^20 - 1 rows) run the same row code as K2's; masks never reach the flat
// path. The world direction never changes, so a lane inverts it once (as
// _traverse_flat_rows does per ray, :945-946) and its internal rows skip
// the reciprocals. What bounds it is K2's, less the instance rows: the leaf
// operations and the distinct rows' float4s below, the internal operations
// with the 9 of the guarded reciprocals counted once per live lane instead
// of once per internal row, 51 B per live lane (30 in, 21 out: no instance
// id) and 26 B per dead lane.
//
// K2's two other template parameters give four instantiations; an unmasked
// scene with a table of at most 2^20 - 1 rows runs <false, false, false>,
// the code that existed before the other three:
//  * MASKED (twolevel.py:_step2's mask test, :618-623): each lane carries a
//    ray mask, and an instance row is skipped when its geometry mask (column
//    20, one more float4) shares no bit with it;
//  * FLOAT_SORT (wide.py:_sort_children, dispatched by _sorted_candidates
//    when the table has more than 2^20 - 1 rows, whose ids no longer fit the
//    packed key's 20 bits): the 8 (t, id) pairs sort in the JAX package's
//    24-comparator bitonic network, swapping on t[a] > t[b], in registers;
//    a child is pushed when its sorted t is finite. The network and its pair
//    order are the plain version's, so the pop order is too.
//
// The work the function needs (utils/bounds.py turns it into K2's least
// time). Counting each f32 add, sub, mul, div, min, max and compare once, a
// popped row costs:
//   internal  9 (3 guarded reciprocals) + 27 per child that is not empty
//               (6 sub, 6 mul, 10 min/max, 5 compares);
//   leaf      1 (the compare against best_t) + 59 per triangle that is not
//               a pad;
//   instance 34 for the world-slab cull, 33 more when the ray enters
//               (the 3x4 transform of origin and direction);
//   FLOAT_SORT 24 compares more per internal row (the network).
// Its bytes, each distinct row read once in float4s: an internal row's 14
// (224 B), a leaf row's 10 per group of 4 triangles up to the first pad, an
// instance row's 2 (world box, root, id; 3 with the mask when MASKED) and 3
// more if a ray enters it; and 55 B per live lane (30 in, 25 out; 4 more in
// when MASKED), 30 B per dead lane. What holds a
// simple one-thread-per-lane kernel far from that bound is lanes that do
// nothing and lanes that wait, and the design answers those:
//  * traverse2_compact_kernel, one thread per lane: live lanes are appended
//    to a device-side list (a warp ballot, a prefix over the block's warps
//    and one atomicAdd per block of 1024 lanes); dead lanes get the miss
//    record (t = tmax, tri = inst = -1, u = v = 0, found = 0, pops = 0) here
//    and are never traced. The list's length stays on the device: no host
//    sync. Its counters are zeroed first by traverse2_reset_kernel (a kernel
//    rather than a memset, so that K2's device time includes it).
//  * traverse2_kernel is persistent: its grid fills the SMs at the occupancy
//    the compiled kernel allows (asked of the runtime once per device), and
//    each warp takes 32 list entries at a time from a global counter until
//    the list is done (Aila and Laine's persistent warps), so no thread runs
//    a dead lane and a warp whose rays end early takes more work instead of
//    idling until the grid's last warp ends. Results are written to the
//    lane's own index; the order in which warps take work changes no result.
//  * Rows are read as float4 through the read-only path: 14 loads per
//    internal row (by halves, 4 children at a time), 10 per 4 triangles of a
//    leaf row (9 vertex planes and the ids), 2 for an instance cull and 3 more
//    to enter. A leaf's walk ends at its first group of 4 that starts with a
//    pad (the BVH build packs pads last; about 2.4 of 3 groups are used in run
//    A's BLASes).
//  * The 8 child keys sort in a 19-comparator network with fixed indices, so
//    they stay in registers. The stack is stack_size entries in local memory
//    (the BVH build's exact worst case, checked by the wrapper against
//    MAX_STACK).
// Measured on the card and not kept, since none lowered K2's frame time
// (PERF.md, Findings): the stack's first 16 entries in shared memory, a
// while-while loop, lanes that take a new ray as soon as theirs ends, 8
// blocks per SM forced by __launch_bounds__, and the live list sorted by
// the JAX package's coherence key (wide.py:_sort_keys_generic).
// The arithmetic is written op for op like the plain PyTorch version
// (kernels/traverse2.py:traverse_plain) and built with -fmad=false, so
// t/u/v are bit-equal to it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define ARITY 8
#define LEAF_K 12
#define ROW4 32  // float4s per 128-float row
#define MAX_STACK 128
#define BLOCK 128
#define COMPACT_BLOCK 1024
#define ID_BIAS (1 << 30)
#define META_MASK ((1 << 20) - 1)
#define KEY_MAX 0x7fffffff
#define FULL 0xffffffffu

struct Outputs {
    float* t;
    int* tri;
    int* inst;
    float* u;
    float* v;
    unsigned char* found;
    int* pops;
};

__device__ __forceinline__ int dec(float f) { return __float_as_int(f) - ID_BIAS; }

__device__ __forceinline__ float guarded_inv(float d) {
    float g = fabsf(d) < 1e-12f ? (d < 0.0f ? -1e-12f : 1e-12f) : d;
    return 1.0f / g;
}

// component k (a constant after unrolling) of a float4
__device__ __forceinline__ float at(const float4& q, int k) {
    return k == 0 ? q.x : (k == 1 ? q.y : (k == 2 ? q.z : q.w));
}

__device__ __forceinline__ void cswap(int& a, int& b) {
    const int lo = min(a, b), hi = max(a, b);
    a = lo;
    b = hi;
}

// One lane's ray and best hit. The world registers (wo, wd) never change;
// o, d hold the ray in the space of the BLAS being walked.
struct Lane {
    float wox, woy, woz, wdx, wdy, wdz;
    float ox, oy, oz, dx, dy, dz;
    float best_t, best_u, best_v;
    int best_tri, best_inst, cur_inst;
    int ray_mask;  // read only when MASKED
    bool found, shadow;
};

// Instance row: [0..11] the 3x4 inverse; [12..15] wbmin xyz, wbmax x;
// [16..19] wbmax y z, BLAS root, instance id; [20] the geometry mask.
template <bool MASKED>
__device__ __forceinline__ void instance_row(const float4* __restrict__ row, Lane& L, int* stack,
                                             int& sp, int stack_size) {
    if (MASKED && (dec(__ldg(row + 5).x) & L.ray_mask) == 0) return;
    const float4 a = __ldg(row + 3), b = __ldg(row + 4);
    float ix = guarded_inv(L.wdx), iy = guarded_inv(L.wdy), iz = guarded_inv(L.wdz);
    float t0x = (a.x - L.wox) * ix, t1x = (a.w - L.wox) * ix;
    float t0y = (a.y - L.woy) * iy, t1y = (b.x - L.woy) * iy;
    float t0z = (a.z - L.woz) * iz, t1z = (b.y - L.woz) * iz;
    float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
    float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
    if (tn <= tf && tf >= 0.0f && tn <= L.best_t) {
        const float4 m0 = __ldg(row), m1 = __ldg(row + 1), m2 = __ldg(row + 2);
        float ox = (m0.x * L.wox + m0.y * L.woy) + m0.z * L.woz;
        float oy = (m1.x * L.wox + m1.y * L.woy) + m1.z * L.woz;
        float oz = (m2.x * L.wox + m2.y * L.woy) + m2.z * L.woz;
        L.ox = ox + m0.w;
        L.oy = oy + m1.w;
        L.oz = oz + m2.w;
        L.dx = (m0.x * L.wdx + m0.y * L.wdy) + m0.z * L.wdz;
        L.dy = (m1.x * L.wdx + m1.y * L.wdy) + m1.z * L.wdz;
        L.dz = (m2.x * L.wdx + m2.y * L.wdy) + m2.z * L.wdz;
        L.cur_inst = dec(b.w);
        if (sp < stack_size) stack[sp] = dec(b.z);
        sp = min(sp + 1, stack_size);
    }
}

// Leaf row: 9 planes of LEAF_K vertex coordinates, then the LEAF_K ids, 4
// triangles per step. Pads (id -1, NaN vertices) are trailing and never hit,
// so the walk stops at the first group of 4 that starts with a pad.
__device__ __forceinline__ void leaf_row(const float4* __restrict__ row, Lane& L, int& sp,
                                         float t_min) {
    const float t_cap = L.best_t;
    float cand_t = INFINITY, cand_u = 0.0f, cand_v = 0.0f;
    int cand_id = -1;
    bool cand_any = false;
#pragma unroll 1
    for (int q = 0; q < LEAF_K / 4; ++q) {
        const float4 ids = __ldg(row + 27 + q);
        if (dec(ids.x) < 0) break;
        const float4 V0X = __ldg(row + q), V0Y = __ldg(row + 3 + q), V0Z = __ldg(row + 6 + q);
        const float4 V1X = __ldg(row + 9 + q), V1Y = __ldg(row + 12 + q), V1Z = __ldg(row + 15 + q);
        const float4 V2X = __ldg(row + 18 + q), V2Y = __ldg(row + 21 + q), V2Z = __ldg(row + 24 + q);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const float v0x = at(V0X, k), v0y = at(V0Y, k), v0z = at(V0Z, k);
            const float v1x = at(V1X, k), v1y = at(V1Y, k), v1z = at(V1Z, k);
            const float v2x = at(V2X, k), v2y = at(V2Y, k), v2z = at(V2Z, k);
            float e1x = v1x - v0x, e1y = v1y - v0y, e1z = v1z - v0z;
            float e2x = v2x - v0x, e2y = v2y - v0y, e2z = v2z - v0z;
            float px = L.dy * e2z - L.dz * e2y;
            float py = L.dz * e2x - L.dx * e2z;
            float pz = L.dx * e2y - L.dy * e2x;
            float det = (e1x * px + e1y * py) + e1z * pz;
            bool valid = fabsf(det) > 1e-9f;
            float inv = valid ? 1.0f / det : 0.0f;
            float tx = L.ox - v0x, ty = L.oy - v0y, tz = L.oz - v0z;
            float u = ((tx * px + ty * py) + tz * pz) * inv;
            float qx = ty * e1z - tz * e1y;
            float qy = tz * e1x - tx * e1z;
            float qz = tx * e1y - ty * e1x;
            float v = ((L.dx * qx + L.dy * qy) + L.dz * qz) * inv;
            float t = ((e2x * qx + e2y * qy) + e2z * qz) * inv;
            bool hit = valid && u >= 0.0f && v >= 0.0f && (u + v) <= 1.0f && t >= t_min &&
                       t <= t_cap;
            if (hit) {
                cand_any = true;
                if (t < cand_t) { cand_t = t; cand_u = u; cand_v = v; cand_id = dec(at(ids, k)); }
            }
        }
    }
    if (cand_any && cand_t < L.best_t) {
        L.best_t = cand_t;
        L.best_tri = cand_id;
        L.best_inst = L.cur_inst;
        L.best_u = cand_u;
        L.best_v = cand_v;
    }
    L.found = L.found || cand_any;
    if (L.found && L.shadow) sp = 0;
}

// One comparator of the float child sort (wide.py:_sort_children).
__device__ __forceinline__ void fswap(float* ts, int* ids, int a, int b) {
    const bool swap = ts[a] > ts[b];
    const float ta = swap ? ts[b] : ts[a], tb = swap ? ts[a] : ts[b];
    const int ia = swap ? ids[b] : ids[a], ib = swap ? ids[a] : ids[b];
    ts[a] = ta;
    ts[b] = tb;
    ids[a] = ia;
    ids[b] = ib;
}

// Internal row: 6 planes of ARITY child bounds (bmin xyz, bmax xyz), then the
// ARITY child ids; read by halves, 4 children at a time. TLAS rows (entry <
// tlas_n) test the world registers. FLAT: every row tests the world
// registers with the lane's world inverse direction (wix, wiy, wiz), taken
// once per lane as _traverse_flat_rows takes it once per ray; K2 ignores
// those three and inverts per row, since its direction changes at instances.
template <bool FLOAT_SORT, bool FLAT>
__device__ __forceinline__ void internal_row(const float4* __restrict__ row, bool tl, const Lane& L,
                                             float wix, float wiy, float wiz, int* stack, int& sp,
                                             int stack_size) {
    const float t_cap = L.best_t;
    const float px = tl ? L.wox : L.ox, py = tl ? L.woy : L.oy, pz = tl ? L.woz : L.oz;
    const float ix = FLAT ? wix : guarded_inv(tl ? L.wdx : L.dx),
                iy = FLAT ? wiy : guarded_inv(tl ? L.wdy : L.dy),
                iz = FLAT ? wiz : guarded_inv(tl ? L.wdz : L.dz);
    int keys[ARITY];
    float ts[ARITY];  // FLOAT_SORT: t and id per child
    int ids[ARITY];
    int n_push = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const float4 lx = __ldg(row + h), ly = __ldg(row + 2 + h), lz = __ldg(row + 4 + h);
        const float4 hx = __ldg(row + 6 + h), hy = __ldg(row + 8 + h), hz = __ldg(row + 10 + h);
        const float4 mt = __ldg(row + 12 + h);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            float t0x = (at(lx, k) - px) * ix, t1x = (at(hx, k) - px) * ix;
            float t0y = (at(ly, k) - py) * iy, t1y = (at(hy, k) - py) * iy;
            float t0z = (at(lz, k) - pz) * iz, t1z = (at(hz, k) - pz) * iz;
            float tnear = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
            float tfar = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
            bool hit = tnear <= tfar && tfar >= 0.0f && tnear <= t_cap;
            float a_t = tnear > 0.0f ? tnear : 0.0f;
            int meta = dec(at(mt, k));
            float tA = (hit && meta >= 0) ? a_t : INFINITY;
            if (FLOAT_SORT) {
                ts[4 * h + k] = tA;
                ids[4 * h + k] = meta;
            } else {
                bool ok = tA < INFINITY && meta >= 0;
                keys[4 * h + k] = ok ? (((__float_as_int(tA) >> 20) << 20) | (meta & META_MASK)) : KEY_MAX;
                n_push += ok ? 1 : 0;
            }
        }
    }
    if (FLOAT_SORT) {
        // wide._bitonic_pairs(8), in its order
        fswap(ts, ids, 0, 1); fswap(ts, ids, 3, 2); fswap(ts, ids, 4, 5); fswap(ts, ids, 7, 6);
        fswap(ts, ids, 0, 2); fswap(ts, ids, 1, 3); fswap(ts, ids, 6, 4); fswap(ts, ids, 7, 5);
        fswap(ts, ids, 0, 1); fswap(ts, ids, 2, 3); fswap(ts, ids, 5, 4); fswap(ts, ids, 7, 6);
        fswap(ts, ids, 0, 4); fswap(ts, ids, 1, 5); fswap(ts, ids, 2, 6); fswap(ts, ids, 3, 7);
        fswap(ts, ids, 0, 2); fswap(ts, ids, 1, 3); fswap(ts, ids, 4, 6); fswap(ts, ids, 5, 7);
        fswap(ts, ids, 0, 1); fswap(ts, ids, 2, 3); fswap(ts, ids, 4, 5); fswap(ts, ids, 6, 7);
#pragma unroll
        for (int k = 0; k < ARITY; ++k) n_push += isfinite(ts[k]) ? 1 : 0;
    } else {
        // ascending: an optimal 8-input sorting network (keys unique per row,
        // KEY_MAX pads last)
        cswap(keys[0], keys[2]); cswap(keys[1], keys[3]); cswap(keys[4], keys[6]); cswap(keys[5], keys[7]);
        cswap(keys[0], keys[4]); cswap(keys[1], keys[5]); cswap(keys[2], keys[6]); cswap(keys[3], keys[7]);
        cswap(keys[0], keys[1]); cswap(keys[2], keys[3]); cswap(keys[4], keys[5]); cswap(keys[6], keys[7]);
        cswap(keys[2], keys[4]); cswap(keys[3], keys[5]);
        cswap(keys[1], keys[4]); cswap(keys[3], keys[6]);
        cswap(keys[1], keys[2]); cswap(keys[3], keys[4]); cswap(keys[5], keys[6]);
    }
    // farthest deepest, so the nearest child ends on top (the finite sorted
    // t come first, so the first n_push slots are the ones pushed)
#pragma unroll
    for (int k = 0; k < ARITY; ++k) {
        const int pos = sp + (n_push - 1 - k);
        if (k < n_push && pos < stack_size) stack[pos] = FLOAT_SORT ? ids[k] : (keys[k] & META_MASK);
    }
    sp = min(sp + n_push, stack_size);
}

// counters[0]: live lanes listed so far; counters[1]: list entries taken.
__global__ void traverse2_reset_kernel(int* counters) {
    counters[0] = 0;
    counters[1] = 0;
}

__global__ void __launch_bounds__(COMPACT_BLOCK) traverse2_compact_kernel(
    const unsigned char* __restrict__ active, const float* __restrict__ tmax, int n,
    int* __restrict__ live, int* counters, Outputs out) {
    __shared__ int warp_base[COMPACT_BLOCK / 32];
    const int i = blockIdx.x * COMPACT_BLOCK + threadIdx.x;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const bool is_live = i < n && active[i] != 0;
    const unsigned ballot = __ballot_sync(FULL, is_live);
    if (lane == 0) warp_base[warp] = __popc(ballot);
    __syncthreads();
    if (warp == 0) {
        const int c = warp_base[lane];
        int incl = c;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(FULL, incl, o);
            if (lane >= o) incl += y;
        }
        const int total = __shfl_sync(FULL, incl, 31);
        int base = 0;
        if (lane == 0 && total > 0) base = atomicAdd(&counters[0], total);
        base = __shfl_sync(FULL, base, 0);
        warp_base[lane] = base + incl - c;
    }
    __syncthreads();
    if (is_live) {
        live[warp_base[warp] + __popc(ballot & ((1u << lane) - 1u))] = i;
    } else if (i < n) {
        out.t[i] = tmax[i];
        out.tri[i] = -1;
        out.inst[i] = -1;
        out.u[i] = 0.0f;
        out.v[i] = 0.0f;
        out.found[i] = 0;
        out.pops[i] = 0;
    }
}

// Trace live lane i to its end and write its results. FLAT: no instance
// rows, every internal row in world space.
template <bool MASKED, bool FLOAT_SORT, bool FLAT>
__device__ __forceinline__ void trace_lane(
    const float4* __restrict__ table, int n_internal, int n_leaf, int tlas_n, int stack_size,
    const float* __restrict__ origin, const float* __restrict__ direction,
    const float* __restrict__ tmax, const unsigned char* __restrict__ shadow,
    const int* __restrict__ ray_mask, float t_min, int i, const Outputs& out) {
    Lane L;
    L.wox = L.ox = origin[3 * i];
    L.woy = L.oy = origin[3 * i + 1];
    L.woz = L.oz = origin[3 * i + 2];
    L.wdx = L.dx = direction[3 * i];
    L.wdy = L.dy = direction[3 * i + 1];
    L.wdz = L.dz = direction[3 * i + 2];
    L.best_t = tmax[i];
    L.best_u = L.best_v = 0.0f;
    L.best_tri = L.best_inst = L.cur_inst = -1;
    L.found = false;
    L.shadow = shadow[i] != 0;
    L.ray_mask = MASKED ? ray_mask[i] : 0;
    const int inst_base = n_internal + n_leaf;
    float wix = 0.0f, wiy = 0.0f, wiz = 0.0f;
    if (FLAT) {
        wix = guarded_inv(L.wdx);
        wiy = guarded_inv(L.wdy);
        wiz = guarded_inv(L.wdz);
    }

    int stack[MAX_STACK];
    int pops = 0, sp = 0;
    stack[sp++] = 0;
    while (sp > 0) {
        const int entry = stack[--sp];
        ++pops;
        const float4* row = table + (long long)entry * ROW4;
        if (!FLAT && entry >= inst_base) instance_row<MASKED>(row, L, stack, sp, stack_size);
        else if (entry >= n_internal) leaf_row(row, L, sp, t_min);
        else internal_row<FLOAT_SORT, FLAT>(row, FLAT || entry < tlas_n, L, wix, wiy, wiz, stack,
                                            sp, stack_size);
    }
    out.t[i] = L.best_t;
    out.tri[i] = L.best_tri;
    out.inst[i] = L.best_inst;
    out.u[i] = L.best_u;
    out.v[i] = L.best_v;
    out.found[i] = L.found ? 1 : 0;
    out.pops[i] = pops;
}

// Persistent over the live list: each warp takes 32 entries at a time.
template <bool MASKED, bool FLOAT_SORT, bool FLAT>
__global__ void __launch_bounds__(BLOCK) traverse2_kernel(
    const float4* __restrict__ table, int n_internal, int n_leaf, int tlas_n, int stack_size,
    const float* __restrict__ origin, const float* __restrict__ direction,
    const float* __restrict__ tmax, const unsigned char* __restrict__ shadow,
    const int* __restrict__ ray_mask, float t_min, const int* __restrict__ live, int* counters,
    Outputs out) {
    const int lane = threadIdx.x & 31;
    const int n_live = counters[0];
    for (;;) {
        int base = 0;
        if (lane == 0) base = atomicAdd(&counters[1], 32);
        base = __shfl_sync(FULL, base, 0);
        if (base >= n_live) break;
        if (base + lane < n_live)
            trace_lane<MASKED, FLOAT_SORT, FLAT>(table, n_internal, n_leaf, tlas_n, stack_size,
                                                 origin, direction, tmax, shadow, ray_mask, t_min,
                                                 live[base + lane], out);
    }
}

// The persistent kernel's grid on the current device: SMs x the blocks per
// SM its registers allow (asked once per device and instantiation). Returns
// a CUDA error code.
template <bool MASKED, bool FLOAT_SORT, bool FLAT>
static int persistent_grid(int* blocks) {
    static int cached[64];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64 && cached[dev] > 0) {
        *blocks = cached[dev];
        return 0;
    }
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, traverse2_kernel<MASKED, FLOAT_SORT, FLAT>, BLOCK, 0);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    *blocks = sms * per_sm;
    if (dev < 64) cached[dev] = *blocks;
    return 0;
}

template <bool MASKED, bool FLOAT_SORT, bool FLAT>
static int launch_traverse(const float4* table, int n_internal, int n_leaf, int tlas_n,
                           int stack_size, const float* origin, const float* direction,
                           const float* tmax, const unsigned char* shadow, const int* ray_mask,
                           float t_min, const int* live, int* counters, const Outputs& out,
                           cudaStream_t s) {
    int blocks = 0;
    int rc = persistent_grid<MASKED, FLOAT_SORT, FLAT>(&blocks);
    if (rc != 0) return rc;
    traverse2_kernel<MASKED, FLOAT_SORT, FLAT><<<blocks, BLOCK, 0, s>>>(
        table, n_internal, n_leaf, tlas_n, stack_size, origin, direction, tmax, shadow, ray_mask,
        t_min, live, counters, out);
    return (int)cudaGetLastError();
}

// scratch: n + 2 ints (the live list, then the two counters). ray_mask: n
// ints, or null for the unmasked instantiations; float_sort != 0 selects the
// float child sort. flat != 0 runs K3 over a flat table of internal rows
// [0, n_internal) and leaf rows after them (n_leaf, tlas_n and ray_mask are
// not read; out_inst is filled with -1).
extern "C" int mrt_traverse2(const void* table, int n_internal, int n_leaf, int tlas_n,
                             int stack_size, const void* origin, const void* direction,
                             const void* tmax, const void* shadow, const void* active,
                             const void* ray_mask, int float_sort, int flat, int n, float t_min,
                             void* out_t, void* out_tri, void* out_inst, void* out_u, void* out_v,
                             void* out_found, void* out_pops, void* scratch, void* stream) {
    if (n <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    int* live = (int*)scratch;
    int* counters = live + n;
    Outputs out{(float*)out_t, (int*)out_tri, (int*)out_inst, (float*)out_u, (float*)out_v,
                (unsigned char*)out_found, (int*)out_pops};
    traverse2_reset_kernel<<<1, 1, 0, s>>>(counters);
    traverse2_compact_kernel<<<(n + COMPACT_BLOCK - 1) / COMPACT_BLOCK, COMPACT_BLOCK, 0, s>>>(
        (const unsigned char*)active, (const float*)tmax, n, live, counters, out);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const float4* tb = (const float4*)table;
    const float *o = (const float*)origin, *d = (const float*)direction, *tm = (const float*)tmax;
    const unsigned char* sh = (const unsigned char*)shadow;
    const int* rm = (const int*)ray_mask;
    if (flat && float_sort)
        return launch_traverse<false, true, true>(tb, n_internal, 0, 0, stack_size, o, d, tm, sh,
                                                  nullptr, t_min, live, counters, out, s);
    if (flat)
        return launch_traverse<false, false, true>(tb, n_internal, 0, 0, stack_size, o, d, tm, sh,
                                                   nullptr, t_min, live, counters, out, s);
    if (rm != nullptr && float_sort)
        return launch_traverse<true, true, false>(tb, n_internal, n_leaf, tlas_n, stack_size, o, d,
                                                  tm, sh, rm, t_min, live, counters, out, s);
    if (rm != nullptr)
        return launch_traverse<true, false, false>(tb, n_internal, n_leaf, tlas_n, stack_size, o, d,
                                                   tm, sh, rm, t_min, live, counters, out, s);
    if (float_sort)
        return launch_traverse<false, true, false>(tb, n_internal, n_leaf, tlas_n, stack_size, o,
                                                   d, tm, sh, rm, t_min, live, counters, out, s);
    return launch_traverse<false, false, false>(tb, n_internal, n_leaf, tlas_n, stack_size, o, d,
                                                tm, sh, rm, t_min, live, counters, out, s);
}
