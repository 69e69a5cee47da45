// K4: refit_rows — the leaf rows and the bottom-up internal rows of a BVH
// table region; K5: refit_tlas — the instance rows and the TLAS rows of a
// two-level BVH, run by the last block of K4's launch.
//
// K4 replaces mrt_tpu/bvh/twolevel.py:_refit_group (:387, with
// _pack_leaf_rows :367) as looped by refit (:460) over the mesh groups, and
// mrt_tpu/bvh/wide.py:refit (:358). Its instantiations: BLAS = true
// ("blas"), every BLAS group a two-level refit rewrites, in one launch, from
// the object-space vertex pool through each group's local triangle indices,
// writing the groups' root boxes, then K5; BLAS = false ("flat"), the whole
// flat table from world triangles v0, v1, v2, with optional row_ids (the
// ids the leaf rows encode, -1 on pads) and SBVH leaf clip boxes (both
// kinds take the clip boxes: +-inf rows clamp nothing).
// K5 replaces the instance and TLAS part of mrt_tpu/bvh/twolevel.py:refit
// (:460-520): each instance row holds the 3x4 world->object inverse (the
// 3x3 by Gaussian elimination with partial pivoting, below; the
// translation -(Rinv t) summed left to right), the world box of the 8
// transformed corners of its group's root box, and the encoded root, id and
// mask; the TLAS rows follow bottom-up.
//
// Design. A warp takes four leaf rows, eight lanes each: a lane gathers
// three triangle slots (ids, then the three vertex ids, then nine
// coordinates, all its loads in flight together), stages them in shared
// memory, and the warp stores each row whole, 32 lanes x one float4; a
// leaf's box is a shuffle reduction over its lanes (min - 1e-7, max +
// 1e-7, then the clip clamp). After one fence for the four boxes, a lane
// of each leaf adds one to its parent's arrival count; the warp then walks
// up from each parent whose count its arrival completed (the row's
// children that any leaf reaches, precomputed per BVH), one at a time:
// lanes 0-7 read the 8 child boxes through L2 (__ldcg: other SMs wrote
// them; a per-row mask says which hold one), the row is staged and stored
// the same way, its box reduced by shuffles, then the warp's arrival at
// the next parent (__threadfence before it, so the box is visible first),
// on up while it is the last; at a two-level group's root it writes the
// root box. Min and max are exact in any order, so the bits do not depend
// on which child arrives last or on the reduction's tree. Rows no leaf
// reaches (a padded shard's internal rows) have all-empty boxes and are
// written by warps of their own. The arrival counts live with the BVH,
// zeroed once where it is made, and the last arriver sets its row's count
// back to 0, so a launch leaves them all 0 for the next (a BVH's refits
// run in stream order). Every shuffle and ballot sits where the whole warp
// is: the walk-ups are taken in turn by the whole warp.
// K5 is the block that finishes the launch last: each block, after its
// rows, fences and adds one to the BVH's done count; the block that
// completes it sets it back to 0 and runs K5 (a refit that rewrites no
// group launches that one block alone): the root boxes of the groups not
// rewritten copied from the input, the instances a thread each, then
// `tlas_depth` passes over the (small) TLAS, as the plain version.
// What probes on the card chose (PERF.md, Findings): a warp per leaf row
// (20 lanes idle in the gathers, five shuffle steps a box) ran run G's
// 1.4M-row build no faster than the thread per row it replaced; four leaves
// a warp ran faster, eight spilled. 40 registers (6 blocks a SM) beat 32 on
// the per-frame tables; 64 (K5's body unbounded) halved the blocks a SM.
// The fence's kind (fence.acq_rel.gpu against __threadfence) made no
// difference; 512-thread blocks, and a grid of resident blocks striding
// over the work, ran slower.
//
// The 3x3 inverse, in this order, which the plain version
// (kernels/refit.py:_affine_inverse) repeats in torch ops: the row with the
// largest |a_i0| (the first on ties) swapped to the top, r0 = 1 / a00, the
// multipliers a_i0 * r0, the rows below updated (a_ij - l_i * a_0j, the
// identity's rows alike); the same for column 1 (r1, one multiplier);
// r2 = 1 / a22; then the columns of the result from the last row up: x2 =
// b2 * r2, b1 and b0 less x2 * a_i2, x1 = b1 * r1, b0 less x1 * a01, x0 =
// b0 * r0. (LAPACK's getrf scales by the pivot's reciprocal as well.)
//
// Semantics kept bit for bit: min and max propagate a NaN operand, as
// torch.amin / torch.minimum and jnp.min do (fminf/fmaxf would drop it);
// pad slots hold NaN vertices and take no part in the box; empty children
// hold +inf / -inf; ids are bitcast(id + 2^30). Built with -fmad=false, so
// every product and sum rounds on its own, in the plain version's order;
// the reciprocals are IEEE divisions (__fdiv_rn), as PyTorch's reciprocal.
//
// Bound: bytes. Per leaf row 512 B written and 36 B read per triangle
// (three gathered vertices) plus its 48 B of ids; per internal row 512 B
// written and its 32 B of child ids read (utils/bounds.py: blas_refit,
// flat_refit, tlas_refit, refit). The operations (a min and a max per
// vertex coordinate, per child box coordinate) take a small fraction of
// that time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ARITY = 8;
constexpr int LEAF_K = 12;
constexpr int ROW = 128;
constexpr int ID_BIAS = 1 << 30;
constexpr int BLOCK = 256;
constexpr int WARPS = BLOCK / 32;
// blocks a SM holds (40 registers; K5's body, one block's, spills rather
// than cut the rows' occupancy)
constexpr int MIN_BLOCKS = 6;
// a warp's leaf rows, and the lanes and triangle slots each takes
constexpr int LEAVES_PER_WARP = 4;
constexpr int LEAF_LANES = 32 / LEAVES_PER_WARP;                // lanes a leaf row
constexpr int SLOTS = (LEAF_K + LEAF_LANES - 1) / LEAF_LANES;  // triangle slots a lane
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float enc(int id) { return __int_as_float(id + ID_BIAS); }

// min and max that return a NaN operand (torch.amin's and torch.minimum's
// semantics; fminf and fmaxf return the other operand)
__device__ __forceinline__ float nmin(float a, float b) {
    return (a != a) ? a : ((b != b) ? b : (b < a ? b : a));
}
__device__ __forceinline__ float nmax(float a, float b) {
    return (a != a) ? a : ((b != b) ? b : (b > a ? b : a));
}

// the same in one instruction, for the reductions of the rows' boxes: a NaN
// operand gives the canonical NaN. An f32 add on the card gives it for any
// NaN too, so from the leaf box's -1e-7 / +1e-7 on a box holds nmin's bits
// (bit-equal with a NaN vertex on the card: chip_smoke.py, phase D)
__device__ __forceinline__ float qmin(float a, float b) {
    float d;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
    return d;
}
__device__ __forceinline__ float qmax(float a, float b) {
    float d;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
    return d;
}

struct RowsParams {
    float* table;            // (n_internal + n_leaf, 128): row = entry id
    int n_internal;
    const int* node_child;   // (n_internal, 8) entry ids, -1 empty
    const int* parent;       // (n_internal + n_leaf,) -1 none, -(g + 2) root of group g
    const int* need;         // (n_internal,) arrivals a row waits for; 0: unreached
    const unsigned char* boxed;  // (n_internal,) bit j: child j holds a box (a leaf or a reached row)
    const int* leaf_tri;     // (n_leaf, 12) triangle ids (BLAS: group-local), -1 pad
    const float* leaf_clip;  // (n_leaf, 6) or null
    const int* leaves;       // the leaf indices to refit, or null: 0 .. n_leaves - 1
    int n_leaves;
    const int* unreached;    // internal rows no leaf reaches
    int n_unreached;
    // flat
    const float* v0;
    const float* v1;
    const float* v2;
    const int* row_ids;      // (n_leaf, 12) or null
    // blas
    const float* verts;      // (V, 3) the vertex pool
    const long long* tris_at;  // (G,) the address of each group's (Tm, 3) local vertex ids
    const int* vstart;       // (G,) each group's first vertex in verts
    const int* leaf_group;   // (n_leaf,)
    float* root_bmin;        // (G, 3)
    float* root_bmax;
    // scratch
    float* ebox;             // (n_internal + n_leaf, 6) entry boxes
    int* arrivals;           // (n_internal,) all 0 before and after a launch
};

struct TlasParams {
    float* table;
    long long inst_base;     // n_internal + n_leaf: the first instance row
    int n_inst, tlas_n, tlas_depth, n_groups, refit_all;
    const int* tlas_child;   // (tlas_n, 8) entry ids: < tlas_n TLAS rows, >= inst_base instances
    const float* M;          // (I, 4, 4)
    const int* inst_group;   // (I,)
    const int* group_root;   // (G,) root entry
    const int* inst_mask;    // (I,)
    const int* group_skinned;  // (G,)
    const float* old_bmin;   // (G, 3) the input BVH's root boxes
    const float* old_bmax;
    float* root_bmin;        // (G, 3) the refit's (K4 wrote the groups it refit)
    float* root_bmax;
    float* box;              // (tlas_n + I, 6) scratch: TLAS rows, then instances
    int* done;               // blocks of the launch finished; 0 before and after it
};

// element `i` of the box (lo x, y, z, hi x, y, z), without indexing a
// register array by a lane
__device__ __forceinline__ float box_elem(const float* lo, const float* hi, int i) {
    return i == 0 ? lo[0] : i == 1 ? lo[1] : i == 2 ? lo[2] : i == 3 ? hi[0] : i == 4 ? hi[1] : hi[2];
}

// a box's 6 values from a group of `width` lanes, lane `s` of the group
// values s, s + width, ...: to `box`, or (store_root) to mesh group g's
// root box
__device__ __forceinline__ void store_box6(float* box, int s, int width, const float* lo,
                                           const float* hi) {
    for (int i = s; i < 6; i += width) box[i] = box_elem(lo, hi, i);
}
__device__ __forceinline__ void store_root(const RowsParams& p, int g, int s, int width,
                                           const float* lo, const float* hi) {
    for (int i = s; i < 6; i += width)
        (i < 3 ? p.root_bmin : p.root_bmax)[g * 3 + i % 3] = box_elem(lo, hi, i);
}

// the box over each group of `width` lanes (a power of 2: the groups
// reduce apart), then lane `src`'s in every lane (`src` may differ by
// lane; a NaN's bits or a zero's sign may differ between the lanes' trees)
__device__ __forceinline__ void group_box(float* lo, float* hi, int width, int src) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        if (off >= width) continue;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            lo[a] = qmin(lo[a], __shfl_xor_sync(FULL, lo[a], off));
            hi[a] = qmax(hi[a], __shfl_xor_sync(FULL, hi[a], off));
        }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        lo[a] = __shfl_sync(FULL, lo[a], src);
        hi[a] = __shfl_sync(FULL, hi[a], src);
    }
}

// internal row r by the warp from its children's boxes (an empty or
// unreached child: +inf / -inf; `boxed`: the row's mask), lane j < 8
// child j (its id `c`); its box, the min and max over them, in lo/hi
// (every lane)
__device__ void internal_row(const RowsParams& p, int r, int c, unsigned boxed, int lane, float* st,
                             float* lo, float* hi) {
    const float inf = __int_as_float(0x7f800000);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        lo[a] = inf;
        hi[a] = -inf;
    }
    if (lane < ARITY) {
        if ((boxed >> lane) & 1u) {
            const float* b = p.ebox + (long long)c * 6;
#pragma unroll
            for (int a = 0; a < 3; ++a) {
                lo[a] = __ldcg(b + a);
                hi[a] = __ldcg(b + 3 + a);
            }
        }
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            st[a * ARITY + lane] = lo[a];
            st[(3 + a) * ARITY + lane] = hi[a];
        }
        st[6 * ARITY + lane] = enc(c);
    }
    __syncwarp();
    float4* row = reinterpret_cast<float4*>(p.table + (long long)r * ROW);
    // floats 0-55 staged (6 planes of 8 child boxes, 8 ids), 56-127 zeros
    row[lane] = lane < 14 ? reinterpret_cast<const float4*>(st)[lane] : make_float4(0.f, 0.f, 0.f, 0.f);
    __syncwarp();  // the stage read before it is written again
    group_box(lo, hi, ARITY, 0);
}

// an internal row no leaf reaches, by the warp: every child box empty, the
// ids as they are
__device__ void unreached_row(const RowsParams& p, int r, int lane) {
    const float inf = __int_as_float(0x7f800000);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (lane < 6) {
        v = make_float4(inf, inf, inf, inf);
    } else if (lane < 12) {
        v = make_float4(-inf, -inf, -inf, -inf);
    } else if (lane < 14) {
        const int* k = p.node_child + (long long)r * ARITY + 4 * (lane - 12);
        v = make_float4(enc(__ldg(k)), enc(__ldg(k + 1)), enc(__ldg(k + 2)), enc(__ldg(k + 3)));
    }
    reinterpret_cast<float4*>(p.table + (long long)r * ROW)[lane] = v;
}

// the walk-up from internal row r, whose last arrival this warp made: its
// row and box, then an arrival at its parent, on up while it is the last
template <bool BLAS>
__device__ void walk_up(const RowsParams& p, int r, int lane, float* st) {
    float lo[3], hi[3];
    for (;;) {
        const int next = __ldg(p.parent + r);
        const unsigned boxed = __ldg(p.boxed + r);
        const int c = lane < ARITY ? __ldg(p.node_child + (long long)r * ARITY + lane) : -1;
        __threadfence();  // the other children's boxes after their arrivals
        internal_row(p, r, c, boxed, lane, st, lo, hi);
        store_box6(p.ebox + (long long)r * 6, lane, 32, lo, hi);
        if (lane == 0) p.arrivals[r] = 0;  // no other warp touches it again in this launch
        if (next < 0) {
            if (BLAS && next <= -2) store_root(p, -next - 2, lane, 32, lo, hi);
            return;
        }
        const int need = __ldg(p.need + next);
        __threadfence();  // this row's box (and count) before its arrival
        __syncwarp();
        int old = 0;
        if (lane == 0) old = atomicAdd(p.arrivals + next, 1);
        old = __shfl_sync(FULL, old, 0);
        if (old != need - 1) return;  // the whole warp: `old` is lane 0's
        r = next;
    }
}

// warp w's work: the leaves [w * LEAVES_PER_WARP, +LEAVES_PER_WARP) of the
// launch, LEAF_LANES lanes each, then the walk-ups their arrivals
// complete; past the leaves' warps, an unreached row each
template <bool BLAS>
__device__ void rows_warp(const RowsParams& p, long long w, int lane, float* st) {
    const long long leaf_warps = ((long long)p.n_leaves + LEAVES_PER_WARP - 1) / LEAVES_PER_WARP;
    if (w >= leaf_warps) {
        w -= leaf_warps;
        if (w < p.n_unreached) unreached_row(p, __ldg(p.unreached + w), lane);
        return;
    }
    const float inf = __int_as_float(0x7f800000), nan = __int_as_float(0x7fc00000);
    const int m = lane / LEAF_LANES, s = lane % LEAF_LANES;
    const long long item = w * LEAVES_PER_WARP + m;
    const bool has = item < p.n_leaves;
    const int l = !has ? -1 : p.leaves != nullptr ? __ldg(p.leaves + item) : (int)item;
    const int up = has ? __ldg(p.parent + p.n_internal + l) : -1;
    const int need = up >= 0 && s == 0 ? __ldg(p.need + up) : 0;
    float lo[3], hi[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        lo[a] = inf;
        hi[a] = -inf;
    }
    // leaf l's row staged at sr: 9 vertex planes of 12 slots (v0.x ..
    // v2.z), 12 ids, 8 zeros; lane s gathers slots s, s + LEAF_LANES, ...
    float* sr = st + m * ROW;
    if (has) {
        const int* gt = nullptr;
        int vs = 0;
        if (BLAS) {
            const int g = __ldg(p.leaf_group + l);
            gt = reinterpret_cast<const int*>(__ldg(p.tris_at + g));
            vs = __ldg(p.vstart + g);
        }
        int tid[SLOTS];
#pragma unroll
        for (int u = 0; u < SLOTS; ++u) {
            const int k = s + u * LEAF_LANES;
            tid[u] = k < LEAF_K ? __ldg(p.leaf_tri + (long long)l * LEAF_K + k) : -1;
        }
        float v[SLOTS][9];
#pragma unroll
        for (int u = 0; u < SLOTS; ++u) {
            const float* src[3] = {p.v0, p.v1, p.v2};
            if (tid[u] >= 0) {
#pragma unroll
                for (int j = 0; j < 3; ++j)
                    src[j] = BLAS ? p.verts + (long long)(vs + __ldg(gt + tid[u] * 3 + j)) * 3
                                  : src[j] + (long long)tid[u] * 3;
            }
#pragma unroll
            for (int j = 0; j < 3; ++j)
#pragma unroll
                for (int a = 0; a < 3; ++a) v[u][3 * j + a] = tid[u] >= 0 ? __ldg(src[j] + a) : nan;
        }
#pragma unroll
        for (int u = 0; u < SLOTS; ++u) {
            const int k = s + u * LEAF_LANES;
            if (k >= LEAF_K) continue;
            if (tid[u] >= 0) {
#pragma unroll
                for (int q = 0; q < 9; ++q) {
                    lo[q % 3] = qmin(lo[q % 3], v[u][q]);
                    hi[q % 3] = qmax(hi[q % 3], v[u][q]);
                }
            }
#pragma unroll
            for (int q = 0; q < 9; ++q) sr[q * LEAF_K + k] = v[u][q];
            int id = tid[u];
            if (!BLAS && p.row_ids != nullptr)
                id = tid[u] < 0 ? -1 : __ldg(p.row_ids + (long long)l * LEAF_K + k);
            sr[9 * LEAF_K + k] = enc(id);
        }
#pragma unroll
        for (int z = s; z < ROW - 10 * LEAF_K; z += LEAF_LANES) sr[10 * LEAF_K + z] = 0.f;  // 120-127
    }
    __syncwarp();
    // the rows, a whole row (32 lanes x one float4) a store
#pragma unroll
    for (int mm = 0; mm < LEAVES_PER_WARP; ++mm) {
        const int lm = __shfl_sync(FULL, l, mm * LEAF_LANES);
        if (lm >= 0)
            reinterpret_cast<float4*>(p.table + (long long)(p.n_internal + lm) * ROW)[lane] =
                reinterpret_cast<const float4*>(st + mm * ROW)[lane];
    }
    __syncwarp();  // the stage read before it is written again
    group_box(lo, hi, LEAF_LANES, m * LEAF_LANES);
    if (has) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            lo[a] = lo[a] - 1e-7f;
            hi[a] = hi[a] + 1e-7f;
        }
        if (p.leaf_clip != nullptr) {
            const float* c = p.leaf_clip + (long long)l * 6;
#pragma unroll
            for (int a = 0; a < 3; ++a) {
                lo[a] = nmax(lo[a], __ldg(c + a));
                hi[a] = nmin(hi[a], __ldg(c + 3 + a));
            }
        }
        store_box6(p.ebox + (p.n_internal + l) * 6LL, s, LEAF_LANES, lo, hi);
        if (BLAS && up <= -2) store_root(p, -up - 2, s, LEAF_LANES, lo, hi);
    }
    // the leaves' arrivals, a lane each, after one fence for their boxes
    __threadfence();
    __syncwarp();
    bool last = false;
    if (s == 0 && up >= 0) last = atomicAdd(p.arrivals + up, 1) == need - 1;
    unsigned done = __ballot_sync(FULL, last);
    while (done != 0u) {  // the same in every lane
        const int src = __ffs(done) - 1;
        done &= done - 1u;
        walk_up<BLAS>(p, __shfl_sync(FULL, up, src), lane, st);
    }
}

// x, y = y, x where c
__device__ __forceinline__ void swap_if(bool c, float& x, float& y) {
    const float a = x, b = y;
    x = c ? b : a;
    y = c ? a : b;
}

// X = the inverse of the 3x3 a (the order in the header; the plain
// version's _affine_inverse)
__device__ void inverse3(float a[3][3], float X[3][3]) {
    float b[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) b[i][j] = i == j ? 1.f : 0.f;
    // column 0: the row with the largest |a_i0|, the first on ties
    const bool p1 = fabsf(a[1][0]) > fabsf(a[0][0]);
    const float best = p1 ? fabsf(a[1][0]) : fabsf(a[0][0]);
    const bool p2 = fabsf(a[2][0]) > best;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        swap_if(p1 && !p2, a[0][j], a[1][j]);
        swap_if(p2, a[0][j], a[2][j]);
        swap_if(p1 && !p2, b[0][j], b[1][j]);
        swap_if(p2, b[0][j], b[2][j]);
    }
    const float r0 = __fdiv_rn(1.f, a[0][0]);
    const float l1 = a[1][0] * r0, l2 = a[2][0] * r0;
#pragma unroll
    for (int j = 1; j < 3; ++j) {
        a[1][j] = a[1][j] - l1 * a[0][j];
        a[2][j] = a[2][j] - l2 * a[0][j];
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        b[1][j] = b[1][j] - l1 * b[0][j];
        b[2][j] = b[2][j] - l2 * b[0][j];
    }
    // column 1
    const bool s = fabsf(a[2][1]) > fabsf(a[1][1]);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        swap_if(s, a[1][j], a[2][j]);
        swap_if(s, b[1][j], b[2][j]);
    }
    const float r1 = __fdiv_rn(1.f, a[1][1]);
    const float l = a[2][1] * r1;
    a[2][2] = a[2][2] - l * a[1][2];
#pragma unroll
    for (int j = 0; j < 3; ++j) b[2][j] = b[2][j] - l * b[1][j];
    const float r2 = __fdiv_rn(1.f, a[2][2]);
    // the rows of the result from the last up
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        X[2][j] = b[2][j] * r2;
        b[1][j] = b[1][j] - X[2][j] * a[1][2];
        b[0][j] = b[0][j] - X[2][j] * a[0][2];
        X[1][j] = b[1][j] * r1;
        b[0][j] = b[0][j] - X[1][j] * a[0][1];
        X[0][j] = b[0][j] * r0;
    }
}

__device__ void instance_row(const TlasParams& p, int i) {
    const int g = __ldg(p.inst_group + i);
    float lo[3], hi[3], R[3][3], A[3][3], tinv[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {  // K4's blocks wrote them: through L2
        lo[a] = __ldcg(p.root_bmin + g * 3 + a);
        hi[a] = __ldcg(p.root_bmax + g * 3 + a);
    }
    const float* m = p.M + (long long)i * 16;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) A[a][b] = __ldg(m + 4 * a + b);
    inverse3(A, R);
    const float t0 = __ldg(m + 3), t1 = __ldg(m + 7), t2 = __ldg(m + 11);
#pragma unroll
    for (int a = 0; a < 3; ++a) tinv[a] = -(R[a][0] * t0 + R[a][1] * t1 + R[a][2] * t2);
    float wlo[3], whi[3];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
        float q[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            float s = (float)((c >> a) & 1);
            q[a] = lo[a] * (1.0f - s) + hi[a] * s;
        }
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            float w = __ldg(m + 4 * a) * q[0] + __ldg(m + 4 * a + 1) * q[1]
                      + __ldg(m + 4 * a + 2) * q[2] + __ldg(m + 4 * a + 3);
            wlo[a] = c == 0 ? w : nmin(wlo[a], w);
            whi[a] = c == 0 ? w : nmax(whi[a], w);
        }
    }
    float v[24];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        v[4 * a] = R[a][0];
        v[4 * a + 1] = R[a][1];
        v[4 * a + 2] = R[a][2];
        v[4 * a + 3] = tinv[a];
        v[12 + a] = wlo[a];
        v[15 + a] = whi[a];
    }
    v[18] = enc(__ldg(p.group_root + g));
    v[19] = enc(i);
    v[20] = enc(__ldg(p.inst_mask + i));
    v[21] = v[22] = v[23] = 0.f;
    float4* row = reinterpret_cast<float4*>(p.table + (p.inst_base + i) * ROW);
#pragma unroll
    for (int q = 0; q < 6; ++q) row[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
#pragma unroll
    for (int q = 6; q < ROW / 4; ++q) row[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    store_box6(p.box + (long long)(p.tlas_n + i) * 6, 0, 1, wlo, whi);
}

// the box-scratch index of TLAS child entry c, or -1 when empty
__device__ __forceinline__ int tlas_slot(const TlasParams& p, int c) {
    if (c < 0) return -1;
    return c >= p.inst_base ? p.tlas_n + (int)(c - p.inst_base) : c;
}

// K5, by one whole block
__device__ void tlas_rows(const TlasParams& p) {
    const float inf = __int_as_float(0x7f800000);
    // the root boxes of the groups K4 did not rewrite: the input's
    for (int g = threadIdx.x; g < p.n_groups; g += blockDim.x) {
        if (!p.refit_all && !__ldg(p.group_skinned + g)) {
#pragma unroll
            for (int a = 0; a < 3; ++a) {
                p.root_bmin[g * 3 + a] = __ldg(p.old_bmin + g * 3 + a);
                p.root_bmax[g * 3 + a] = __ldg(p.old_bmax + g * 3 + a);
            }
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < p.n_inst; i += blockDim.x) instance_row(p, i);
    for (int t = threadIdx.x; t < p.tlas_n; t += blockDim.x) {
        const float lo[3] = {inf, inf, inf}, hi[3] = {-inf, -inf, -inf};
        store_box6(p.box + (long long)t * 6, 0, 1, lo, hi);
    }
    __syncthreads();
    // tlas_depth passes, as the plain version: a row of height h is exact
    // after pass h, and a pass rewrites an exact row with the same bits
    for (int pass = 0; pass < p.tlas_depth; ++pass) {
        for (int t = threadIdx.x; t < p.tlas_n; t += blockDim.x) {
            float lo[3] = {inf, inf, inf}, hi[3] = {-inf, -inf, -inf};
            for (int j = 0; j < ARITY; ++j) {
                int s = tlas_slot(p, __ldg(p.tlas_child + t * ARITY + j));
#pragma unroll
                for (int a = 0; a < 3; ++a) {
                    float cl = s < 0 ? inf : p.box[s * 6 + a];
                    float ch = s < 0 ? -inf : p.box[s * 6 + 3 + a];
                    lo[a] = j == 0 ? cl : nmin(lo[a], cl);
                    hi[a] = j == 0 ? ch : nmax(hi[a], ch);
                }
            }
            store_box6(p.box + (long long)t * 6, 0, 1, lo, hi);
        }
        __syncthreads();
    }
    for (int t = threadIdx.x; t < p.tlas_n; t += blockDim.x) {
        float v[56];  // 6 planes of 8 child boxes, 8 ids
#pragma unroll
        for (int j = 0; j < ARITY; ++j) {
            int c = __ldg(p.tlas_child + t * ARITY + j);
            int s = tlas_slot(p, c);
            v[6 * ARITY + j] = enc(c);
#pragma unroll
            for (int a = 0; a < 3; ++a) {
                v[a * ARITY + j] = s < 0 ? inf : p.box[s * 6 + a];
                v[(3 + a) * ARITY + j] = s < 0 ? -inf : p.box[s * 6 + 3 + a];
            }
        }
        float4* row = reinterpret_cast<float4*>(p.table + (long long)t * ROW);
#pragma unroll
        for (int q = 0; q < 14; ++q) row[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
#pragma unroll
        for (int q = 14; q < ROW / 4; ++q) row[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
}

template <bool BLAS>
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS) refit_rows_kernel(RowsParams p, TlasParams t) {
    __shared__ float4 stage[WARPS][LEAVES_PER_WARP * ROW / 4];
    __shared__ int last;
    const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
    rows_warp<BLAS>(p, (long long)blockIdx.x * WARPS + wib, lane, reinterpret_cast<float*>(stage[wib]));
    if (!BLAS) return;
    // K5 in the block that finishes last: every block's rows and root
    // boxes before its count, the others' after the last count
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(t.done, 1) == (int)gridDim.x - 1;
    __syncthreads();
    if (!last) return;
    if (threadIdx.x == 0) *t.done = 0;
    __threadfence();
    tlas_rows(t);
}

}  // namespace

extern "C" int mrt_refit_flat(void* table, int n_internal, const void* node_child, const void* parent,
                              const void* need, const void* boxed, const void* leaf_tri,
                              const void* leaf_clip,
                              int n_leaves, const void* unreached, int n_unreached, const void* v0,
                              const void* v1, const void* v2, const void* row_ids, void* ebox,
                              void* arrivals, void* stream) {
    const long long work = ((long long)n_leaves + LEAVES_PER_WARP - 1) / LEAVES_PER_WARP + n_unreached;
    if (work <= 0) return 0;
    RowsParams p{};
    p.table = (float*)table;
    p.n_internal = n_internal;
    p.node_child = (const int*)node_child;
    p.parent = (const int*)parent;
    p.need = (const int*)need;
    p.boxed = (const unsigned char*)boxed;
    p.leaf_tri = (const int*)leaf_tri;
    p.leaf_clip = (const float*)leaf_clip;
    p.n_leaves = n_leaves;
    p.unreached = (const int*)unreached;
    p.n_unreached = n_unreached;
    p.v0 = (const float*)v0;
    p.v1 = (const float*)v1;
    p.v2 = (const float*)v2;
    p.row_ids = (const int*)row_ids;
    p.ebox = (float*)ebox;
    p.arrivals = (int*)arrivals;
    const unsigned blocks = (unsigned)((work + WARPS - 1) / WARPS);
    refit_rows_kernel<false><<<blocks, BLOCK, 0, (cudaStream_t)stream>>>(p, TlasParams{});
    return (int)cudaGetLastError();
}

extern "C" int mrt_refit_twolevel(
    void* table, int n_internal, const void* node_child, const void* parent, const void* need,
    const void* boxed, const void* leaf_tri, const void* leaf_clip, const void* leaves, int n_leaves,
    const void* unreached, int n_unreached, const void* verts, const void* tris_at,
    const void* vstart, const void* leaf_group, void* root_bmin, void* root_bmax, void* ebox,
    void* arrivals, long long inst_base, int n_inst, int tlas_n, int tlas_depth, int n_groups,
    int refit_all, const void* M, const void* inst_group, const void* group_root,
    const void* inst_mask, const void* group_skinned, const void* old_bmin, const void* old_bmax,
    void* tlas_box, void* done, void* stream) {
    RowsParams p{};
    p.table = (float*)table;
    p.n_internal = n_internal;
    p.node_child = (const int*)node_child;
    p.parent = (const int*)parent;
    p.need = (const int*)need;
    p.boxed = (const unsigned char*)boxed;
    p.leaf_tri = (const int*)leaf_tri;
    p.leaf_clip = (const float*)leaf_clip;
    p.leaves = (const int*)leaves;
    p.n_leaves = n_leaves;
    p.unreached = (const int*)unreached;
    p.n_unreached = n_unreached;
    p.verts = (const float*)verts;
    p.tris_at = (const long long*)tris_at;
    p.vstart = (const int*)vstart;
    p.leaf_group = (const int*)leaf_group;
    p.root_bmin = (float*)root_bmin;
    p.root_bmax = (float*)root_bmax;
    p.ebox = (float*)ebox;
    p.arrivals = (int*)arrivals;
    TlasParams t{(float*)table, inst_base, n_inst, tlas_n, tlas_depth, n_groups, refit_all,
                 (const int*)node_child, (const float*)M, (const int*)inst_group,
                 (const int*)group_root, (const int*)inst_mask, (const int*)group_skinned,
                 (const float*)old_bmin, (const float*)old_bmax, (float*)root_bmin,
                 (float*)root_bmax, (float*)tlas_box, (int*)done};
    // at least one block: the last block runs K5 even when no row is refit
    const long long work = ((long long)n_leaves + LEAVES_PER_WARP - 1) / LEAVES_PER_WARP + n_unreached;
    const unsigned blocks = (unsigned)(work > 0 ? (work + WARPS - 1) / WARPS : 1);
    refit_rows_kernel<true><<<blocks, BLOCK, 0, (cudaStream_t)stream>>>(p, t);
    return (int)cudaGetLastError();
}
