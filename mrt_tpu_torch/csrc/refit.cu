// K4: refit_rows — the leaf rows and the bottom-up internal rows of a BVH
// table region; K5: refit_tlas — the instance rows and the TLAS rows of a
// two-level BVH.
//
// K4 replaces mrt_tpu/bvh/twolevel.py:_refit_group (:387, with
// _pack_leaf_rows :367) as looped by refit (:460) over the mesh groups, and
// mrt_tpu/bvh/wide.py:refit (:358). Its instantiations: BLAS = true
// ("blas"), every BLAS group a two-level refit rewrites, in one launch, from
// the object-space vertex pool through each group's local triangle indices,
// writing the groups' root boxes; BLAS = false ("flat"), the whole flat
// table from world triangles v0, v1, v2, with optional row_ids (the ids the
// leaf rows encode, -1 on pads) and SBVH leaf clip boxes (both kinds take
// the clip boxes: +-inf rows clamp nothing).
// K5 replaces the instance and TLAS part of mrt_tpu/bvh/twolevel.py:refit
// (:460-520): each instance row holds the 3x4 world->object inverse (the
// 3x3 from the library, as the JAX package takes jnp.linalg.inv, the
// translation -(Rinv t) summed left to right), the world box of the 8
// transformed corners of its group's root box, and the encoded root, id and
// mask; the TLAS rows follow bottom-up.
//
// Design. The JAX package and the plain version refit an internal region
// in `depth` passes, each gathering every row's child boxes. Here one
// thread per leaf row gathers its triangles' vertices, writes its row and
// its box (min - 1e-7, max + 1e-7, then the clip clamp), stores the box,
// and adds one to its parent's arrival count (__threadfence before, so the
// box is visible first). The thread whose arrival completes the count
// (the row's children that any leaf reaches, precomputed per BVH) reads
// the child boxes through L2 (__ldcg: another SM wrote them), writes the
// parent's row and box, and walks on up; at a two-level group's root it
// writes the root box. Min and max are exact in any order, so the bits do
// not depend on which child arrives last. Rows no leaf reaches (a padded
// shard's internal rows) have all-empty boxes and are written by threads
// of their own. The arrival counts live with the BVH, zeroed once where it
// is made, and the last arriver sets its row's count back to 0, so a
// launch leaves them all 0 for the next (a BVH's refits run in stream
// order). K5 is one block: the instances, then `tlas_depth` passes over
// the (small) TLAS, as the plain version.
//
// Semantics kept bit for bit: min and max propagate a NaN operand, as
// torch.amin / torch.minimum and jnp.min do (fminf/fmaxf would drop it);
// pad slots hold NaN vertices and take no part in the box; empty children
// hold +inf / -inf; ids are bitcast(id + 2^30). Built with -fmad=false, so
// every product and sum rounds on its own, in the plain version's order.
//
// Bound: bytes. Per leaf row 512 B written and 36 B read per triangle
// (three gathered vertices) plus its 48 B of ids; per internal row 512 B
// written and its 32 B of child ids read (utils/bounds.py: k4_blas,
// flat_refit, k5). The operations (a min and a max per vertex coordinate,
// per child box coordinate) take a small fraction of that time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ARITY = 8;
constexpr int LEAF_K = 12;
constexpr int ROW = 128;
constexpr int ID_BIAS = 1 << 30;
constexpr int K4_BLOCK = 128;
constexpr int K5_BLOCK = 256;

__device__ __forceinline__ float enc(int id) { return __int_as_float(id + ID_BIAS); }

// min and max that return a NaN operand (torch.amin's and torch.minimum's
// semantics; fminf and fmaxf return the other operand)
__device__ __forceinline__ float nmin(float a, float b) {
    return (a != a) ? a : ((b != b) ? b : (b < a ? b : a));
}
__device__ __forceinline__ float nmax(float a, float b) {
    return (a != a) ? a : ((b != b) ? b : (b > a ? b : a));
}

__device__ __forceinline__ void store12(float4* dst, const float* v) {
    dst[0] = make_float4(v[0], v[1], v[2], v[3]);
    dst[1] = make_float4(v[4], v[5], v[6], v[7]);
    dst[2] = make_float4(v[8], v[9], v[10], v[11]);
}

__device__ __forceinline__ void store8(float4* dst, const float* v) {
    dst[0] = make_float4(v[0], v[1], v[2], v[3]);
    dst[1] = make_float4(v[4], v[5], v[6], v[7]);
}

struct RowsParams {
    float* table;            // (n_internal + n_leaf, 128): row = entry id
    int n_internal;
    const int* node_child;   // (n_internal, 8) entry ids, -1 empty
    const int* parent;       // (n_internal + n_leaf,) -1 none, -(g + 2) root of group g
    const int* need;         // (n_internal,) arrivals a row waits for; 0: unreached
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
    const int* tris;         // (sum Tm, 3) group-local vertex ids
    const int* toff;         // (G,) each group's first triangle in tris
    const int* vstart;       // (G,) each group's first vertex in verts
    const int* leaf_group;   // (n_leaf,)
    float* root_bmin;        // (G, 3)
    float* root_bmax;
    // scratch
    float* ebox;             // (n_internal + n_leaf, 6) entry boxes
    int* arrivals;           // (n_internal,) all 0 before and after a launch
};

__device__ __forceinline__ void store_box(float* ebox, int e, const float* lo, const float* hi) {
    float* b = ebox + (long long)e * 6;
    b[0] = lo[0]; b[1] = lo[1]; b[2] = lo[2];
    b[3] = hi[0]; b[4] = hi[1]; b[5] = hi[2];
}

// leaf row l: 9 vertex planes of 12 slots (v0.x .. v2.z), 12 ids, zeros;
// its box in lo/hi
template <bool BLAS>
__device__ void leaf_row(const RowsParams& p, int l, float* lo, float* hi) {
    int tid[LEAF_K];
    const int* ids = p.leaf_tri + (long long)l * LEAF_K;
#pragma unroll
    for (int k = 0; k < LEAF_K; ++k) tid[k] = __ldg(ids + k);
    int toff = 0, vs = 0;
    if (BLAS) {
        int g = __ldg(p.leaf_group + l);
        toff = __ldg(p.toff + g);
        vs = __ldg(p.vstart + g);
    }
    float4* row = reinterpret_cast<float4*>(p.table + (long long)(p.n_internal + l) * ROW);
    const float inf = __int_as_float(0x7f800000), nan = __int_as_float(0x7fc00000);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        lo[a] = inf;
        hi[a] = -inf;
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        float x[LEAF_K], y[LEAF_K], z[LEAF_K];
#pragma unroll
        for (int k = 0; k < LEAF_K; ++k) {
            if (tid[k] < 0) {
                x[k] = y[k] = z[k] = nan;
                continue;
            }
            const float* v;
            if (BLAS) {
                int vid = __ldg(p.tris + (long long)(toff + tid[k]) * 3 + j);
                v = p.verts + (long long)(vs + vid) * 3;
            } else {
                v = (j == 0 ? p.v0 : j == 1 ? p.v1 : p.v2) + (long long)tid[k] * 3;
            }
            x[k] = __ldg(v);
            y[k] = __ldg(v + 1);
            z[k] = __ldg(v + 2);
            lo[0] = nmin(lo[0], x[k]); hi[0] = nmax(hi[0], x[k]);
            lo[1] = nmin(lo[1], y[k]); hi[1] = nmax(hi[1], y[k]);
            lo[2] = nmin(lo[2], z[k]); hi[2] = nmax(hi[2], z[k]);
        }
        store12(row + (3 * j + 0) * 3, x);
        store12(row + (3 * j + 1) * 3, y);
        store12(row + (3 * j + 2) * 3, z);
    }
    float id[LEAF_K];
#pragma unroll
    for (int k = 0; k < LEAF_K; ++k) {
        int v = tid[k];
        if (!BLAS && p.row_ids != nullptr)
            v = v < 0 ? -1 : __ldg(p.row_ids + (long long)l * LEAF_K + k);
        id[k] = enc(v);
    }
    store12(row + 27, id);
    row[30] = make_float4(0.f, 0.f, 0.f, 0.f);
    row[31] = make_float4(0.f, 0.f, 0.f, 0.f);
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
}

// internal row r from its children's boxes (an empty or unreached child:
// +inf / -inf); its box, the min and max over them, in lo/hi
__device__ void internal_row(const RowsParams& p, int r, float* lo, float* hi) {
    const float inf = __int_as_float(0x7f800000);
    float cmin[3][ARITY], cmax[3][ARITY], id[ARITY];
    const int* kids = p.node_child + (long long)r * ARITY;
#pragma unroll
    for (int j = 0; j < ARITY; ++j) {
        int c = __ldg(kids + j);
        id[j] = enc(c);
        bool boxed = c >= 0 && (c >= p.n_internal || __ldg(p.need + c) > 0);
        if (boxed) {
            const float* b = p.ebox + (long long)c * 6;
#pragma unroll
            for (int a = 0; a < 3; ++a) {
                cmin[a][j] = __ldcg(b + a);
                cmax[a][j] = __ldcg(b + 3 + a);
            }
        } else {
#pragma unroll
            for (int a = 0; a < 3; ++a) {
                cmin[a][j] = inf;
                cmax[a][j] = -inf;
            }
        }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        lo[a] = cmin[a][0];
        hi[a] = cmax[a][0];
#pragma unroll
        for (int j = 1; j < ARITY; ++j) {
            lo[a] = nmin(lo[a], cmin[a][j]);
            hi[a] = nmax(hi[a], cmax[a][j]);
        }
    }
    float4* row = reinterpret_cast<float4*>(p.table + (long long)r * ROW);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        store8(row + 2 * a, cmin[a]);
        store8(row + 2 * (3 + a), cmax[a]);
    }
    store8(row + 12, id);
#pragma unroll
    for (int q = 14; q < ROW / 4; ++q) row[q] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// an internal row no leaf reaches: every child box empty, the ids as they are
__device__ void unreached_row(const RowsParams& p, int r) {
    const float inf = __int_as_float(0x7f800000);
    float4* row = reinterpret_cast<float4*>(p.table + (long long)r * ROW);
    const float4 lo = make_float4(inf, inf, inf, inf), hi = make_float4(-inf, -inf, -inf, -inf);
#pragma unroll
    for (int q = 0; q < 6; ++q) row[q] = lo;
#pragma unroll
    for (int q = 6; q < 12; ++q) row[q] = hi;
    float id[ARITY];
    const int* kids = p.node_child + (long long)r * ARITY;
#pragma unroll
    for (int j = 0; j < ARITY; ++j) id[j] = enc(__ldg(kids + j));
    store8(row + 12, id);
#pragma unroll
    for (int q = 14; q < ROW / 4; ++q) row[q] = make_float4(0.f, 0.f, 0.f, 0.f);
}

template <bool BLAS>
__global__ void __launch_bounds__(K4_BLOCK) refit_rows_kernel(RowsParams p) {
    long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= p.n_leaves) {
        t -= p.n_leaves;
        if (t < p.n_unreached) unreached_row(p, __ldg(p.unreached + t));
        return;
    }
    int l = p.leaves != nullptr ? __ldg(p.leaves + t) : (int)t;
    float lo[3], hi[3];
    leaf_row<BLAS>(p, l, lo, hi);
    int e = p.n_internal + l;
    store_box(p.ebox, e, lo, hi);
    int up = __ldg(p.parent + e);
    while (up >= 0) {
        __threadfence();  // this entry's box before its arrival
        if (atomicAdd(p.arrivals + up, 1) != __ldg(p.need + up) - 1) return;
        p.arrivals[up] = 0;  // the last arrival: no other thread touches it again
        __threadfence();  // the other children's boxes after their arrivals
        internal_row(p, up, lo, hi);
        store_box(p.ebox, up, lo, hi);
        up = __ldg(p.parent + up);
    }
    if (BLAS && up <= -2) {
        int g = -up - 2;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            p.root_bmin[g * 3 + a] = lo[a];
            p.root_bmax[g * 3 + a] = hi[a];
        }
    }
}

struct TlasParams {
    float* table;
    long long inst_base;     // n_internal + n_leaf: the first instance row
    int n_inst, tlas_n, tlas_depth, n_groups, refit_all;
    const int* tlas_child;   // (tlas_n, 8) entry ids: < tlas_n TLAS rows, >= inst_base instances
    const float* M;          // (I, 4, 4)
    const float* rinv;       // (I, 3, 3) at strides s0, s1, s2 (elements)
    long long s0, s1, s2;
    const int* inst_group;   // (I,)
    const int* group_root;   // (G,) root entry
    const int* inst_mask;    // (I,)
    const int* group_skinned;  // (G,)
    const float* old_bmin;   // (G, 3) the input BVH's root boxes
    const float* old_bmax;
    float* root_bmin;        // (G, 3) the refit's (K4 wrote the groups it refit)
    float* root_bmax;
    float* box;              // (tlas_n + I, 6) scratch: TLAS rows, then instances
};

__device__ void instance_row(const TlasParams& p, int i) {
    int g = __ldg(p.inst_group + i);
    float lo[3], hi[3], R[3][3], tinv[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        lo[a] = p.root_bmin[g * 3 + a];
        hi[a] = p.root_bmax[g * 3 + a];
    }
    const float* m = p.M + (long long)i * 16;
    const float* ri = p.rinv + i * p.s0;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) R[a][b] = __ldg(ri + a * p.s1 + b * p.s2);
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
    store_box(p.box, p.tlas_n + i, wlo, whi);
}

// the box-scratch index of TLAS child entry c, or -1 when empty
__device__ __forceinline__ int tlas_slot(const TlasParams& p, int c) {
    if (c < 0) return -1;
    return c >= p.inst_base ? p.tlas_n + (int)(c - p.inst_base) : c;
}

__global__ void __launch_bounds__(K5_BLOCK) refit_tlas_kernel(TlasParams p) {
    const float inf = __int_as_float(0x7f800000);
    // the root boxes of the groups no K4 launch rewrote: the input's
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
        store_box(p.box, t, lo, hi);
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
            store_box(p.box, t, lo, hi);
        }
        __syncthreads();
    }
    for (int t = threadIdx.x; t < p.tlas_n; t += blockDim.x) {
        float cmin[3][ARITY], cmax[3][ARITY], id[ARITY];
        for (int j = 0; j < ARITY; ++j) {
            int c = __ldg(p.tlas_child + t * ARITY + j);
            int s = tlas_slot(p, c);
            id[j] = enc(c);
#pragma unroll
            for (int a = 0; a < 3; ++a) {
                cmin[a][j] = s < 0 ? inf : p.box[s * 6 + a];
                cmax[a][j] = s < 0 ? -inf : p.box[s * 6 + 3 + a];
            }
        }
        float4* row = reinterpret_cast<float4*>(p.table + (long long)t * ROW);
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            store8(row + 2 * a, cmin[a]);
            store8(row + 2 * (3 + a), cmax[a]);
        }
        store8(row + 12, id);
#pragma unroll
        for (int q = 14; q < ROW / 4; ++q) row[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
}

}  // namespace

extern "C" int mrt_refit_rows(int blas, void* table, int n_internal, const void* node_child,
                              const void* parent, const void* need, const void* leaf_tri,
                              const void* leaf_clip, const void* leaves, int n_leaves,
                              const void* unreached, int n_unreached, const void* v0,
                              const void* v1, const void* v2, const void* row_ids,
                              const void* verts, const void* tris, const void* toff,
                              const void* vstart, const void* leaf_group, void* root_bmin,
                              void* root_bmax, void* ebox, void* arrivals, void* stream) {
    long long n = (long long)n_leaves + n_unreached;
    if (n <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    RowsParams p{(float*)table, n_internal, (const int*)node_child, (const int*)parent,
                 (const int*)need, (const int*)leaf_tri, (const float*)leaf_clip,
                 (const int*)leaves, n_leaves, (const int*)unreached, n_unreached,
                 (const float*)v0, (const float*)v1, (const float*)v2, (const int*)row_ids,
                 (const float*)verts, (const int*)tris, (const int*)toff, (const int*)vstart,
                 (const int*)leaf_group, (float*)root_bmin, (float*)root_bmax, (float*)ebox,
                 (int*)arrivals};
    unsigned blocks = (unsigned)((n + K4_BLOCK - 1) / K4_BLOCK);
    if (blas)
        refit_rows_kernel<true><<<blocks, K4_BLOCK, 0, s>>>(p);
    else
        refit_rows_kernel<false><<<blocks, K4_BLOCK, 0, s>>>(p);
    return (int)cudaGetLastError();
}

extern "C" int mrt_refit_tlas(void* table, long long inst_base, int n_inst, int tlas_n,
                              int tlas_depth, int n_groups, int refit_all,
                              const void* node_child, const void* M, const void* rinv,
                              long long s0, long long s1, long long s2, const void* inst_group,
                              const void* group_root, const void* inst_mask,
                              const void* group_skinned, const void* old_bmin,
                              const void* old_bmax, void* root_bmin, void* root_bmax,
                              void* box, void* stream) {
    TlasParams p{(float*)table, inst_base, n_inst, tlas_n, tlas_depth, n_groups, refit_all,
                 (const int*)node_child, (const float*)M, (const float*)rinv, s0, s1, s2,
                 (const int*)inst_group, (const int*)group_root, (const int*)inst_mask,
                 (const int*)group_skinned, (const float*)old_bmin, (const float*)old_bmax,
                 (float*)root_bmin, (float*)root_bmax, (float*)box};
    refit_tlas_kernel<<<1, K5_BLOCK, 0, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}
