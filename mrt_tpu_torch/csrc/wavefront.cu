// K6 sample_start, K7 shade_hit, K8 resolve_shadow: the wavefront's
// per-bounce body between the traversals.
//
// Replaces the body of mrt_tpu/render/wavefront.py:trace_tile, which XLA
// fuses into a few programs per bounce on the TPU: K6 its camera rays and
// per-sample state (camera_rays/init_state, :290-363), K7 and K8 the bounce
// loop's body (:372-1020). The port ran that body as ~1,700 eager torch ops
// per iteration over the whole wavefront (kernels/wavefront.py keeps them as
// the plain versions); here each stage is one launch.
//
// What each computes, op for op as the plain version on the card (PyTorch's
// CUDA kernels), so that the outputs are its bits:
//   K6: Halton dims 0/1 (24 digits, bases 2 and 3) of offsets + base + sidx,
//       the pixel's camera ray, the sample's fresh lane state.
//   K7: first the previous iteration's shadow ray (K8's add, folded in:
//       accumulated += contrib where it was cast and is not occluded), then
//       the hit record, the environment on a miss, the interpolated normal,
//       the material, the glass branch (Fresnel, the Halton transparency
//       pick, reflect or refract), emission, the light pick (uniform or
//       power, by the plain version's cdf) and the four light types, PBR or
//       legacy shading, the shadow ray, then the throughput, dead-lane and
//       cosine-hemisphere bounce update. A lane that was not live when the
//       closest-hit batch was traced only resolves and clears its shadow
//       mask. Its textured and debug instantiations
//       (shade_hit_tex_kernel<MAPS, MIPS, DEBUG>, textured_hit) add the rest
//       of trace_tile's hit (:572-714): the texture maps of the hit's
//       material from the channel-packed atlas (4 bilinear taps of 16
//       floats) or, with mipmaps, the ray cone's LOD and two taps of each
//       map's mip chain (assets/texture.py:sample_packed, sample_trilinear),
//       normal mapping in the triangle's tangent basis, and the debug views,
//       which write the colour at the first hit and retire the lane.
//   K8: after a sample's last iteration, the last shadow rays' add.
//   K13 gp_rows and K14 banded_taps, under geometry sharding (the gp axis,
//       dist/geometry.py), where a rank holds only its shard's shade and
//       motion rows and maybe one row band of the packed atlas. Their rows
//       cover only the step's live lanes, compacted in lane order: K13 scans
//       the live flags into each lane's position (pos, -1 where dead) and its
//       inverse (lane_of), then writes each live lane's rows at its position
//       where this rank owns the hit triangle (zeros elsewhere); K14 this
//       rank's share of each live lane's packed sample, at the same
//       position. A psum over gp after each (outside the kernels: a
//       collective cannot run in one) completes them, and K7's lane-row form
//       (shade_hit_rows_kernel) reads them at pos[i] where the single
//       device's K7 reads the frame's tables at the triangle's. The flags
//       are the same on every rank (gp replicates the rays), so is the map,
//       and each psum adds rows of one lane.
// The radiance adds keep the plain loop's order: env(k), emission(k),
// contrib(k), env(k+1). Matching PyTorch's CUDA ops: a division by a Python
// scalar is a multiply by the f32 reciprocal (x / PI, x / (2 PI), x / 8);
// 1 / x and a normalisation's v / |v| are true divisions; Python constants
// are the f32 of the double (F(x)); clamp propagates NaN (clampf);
// torch.pow(x, 5.0) is powf; dot products add x, y, z in that order;
// searchsorted is left-sided; torch.remainder of f32 is fmodf, then + b
// where the signs differ; torch.minimum keeps a NaN; log2 and sqrt are
// log2f and sqrtf. Built with -fmad=false, so no multiply-add is
// contracted.
//
// Bound: bytes, per listed lane. K7 reads the raw hit record (20 B: t, the
// local triangle and instance, u, v), the lane state (~105 B), the lane's
// shade row and material row (128 B, gathered by its triangle and
// resource), and writes the state and the shadow ray (~85 B); its
// operations (~600 f32, dominated by six 11-digit Halton loops of ~10 ops
// each) put it near the ridge. Each listed lane also reads its shadow mask
// and occlusion, and a lane that adds reads its contribution
// (utils/bounds.py:k7_listed, :k8). A textured hit also reads its texture
// bits (16 B), its taps (4 texels of the packed atlas, of each texel's 64 B
// the float4 groups its maps read, or 2 x 4 texels of 16 B per map with
// mipmaps; the bound counts each distinct texel once with its maps'
// channels, since neighbouring hits share them) and a 72-B motion row where
// the LOD, the tangent basis or the motion view needs its vertices:
// scattered loads, a 32-B sector each at least, in a chain of dependent
// loads (the shade row, the material's bits and the rect, with mipmaps the
// level rects, then the texels). What held the textured instantiations
// further from the bound than the untextured K7 is that chain's latency at
// few warps: their registers (117 packed, 96 with mipmaps: the taps' 16
// float4 in flight beside the body's) left 2 blocks of 256 an SM for the
// whole body, on every listed lane. Below (TEX_BLOCKS) they hold 3.
//
// What held the full-width design (one thread per lane of the whole
// wavefront, K8 a second full-width launch, the hits remade by torch ops)
// from that bound, and what this one does about it:
//  * Dead lanes. After the first bounces few lanes are live, scattered
//    through warps that are mostly dead, so each live lane's field loads
//    cost a 32-B sector apiece and every dead lane still read and wrote a
//    byte. Here K7 runs over a device-side lane list: each launch appends
//    the lanes that are live or hold a shadow ray after it to the list the
//    next launch reads (the live ones at its front, so that they share
//    warps); a lane outside the list is dead with its mask already clear.
//    The list's length stays on the device; its live part's length (one
//    int32 per launch) is what the host reads to end the loop.
//  * Idle warps and atomics. A list's length is on the device only, so a
//    listed K7 runs the grid that is resident at once (the SMs times the
//    blocks the runtime reports for its registers), its blocks striding
//    over the list 256 entries a round; a block compacts its round's lanes
//    (ballots, a prefix over its warps) and appends them with one atomicAdd
//    per part of the list, as K2's compaction does. The first step of a
//    sample, over every lane, runs one round per block.
//  * K8's launch per iteration, over every lane: folded into the next K7
//    for its listed lanes; K8 stays only as the trailing resolve after a
//    sample's last iteration, over the last list, writing only the lanes
//    that add.
//  * The hits' glue: K7 reads the traversal's record and makes the flat id
//    (flat_tri_base[inst] + tri, int32, as bvh/twolevel.py's _hits) itself.
//  * Dependent scalar row gathers: the shade row is 4 float4 loads and the
//    material row 3, through the read-only path (rows 16-B aligned, checked
//    by the wrapper).
// Counters: two int32 per step slot s (list s's live lanes at its front,
// its lanes that only hold a shadow ray at its back),
// zeroed once per sample; step s reads list s (slot s, the list buffer
// s % 2; step 0: every lane) and writes list s + 1. Packing the live lanes
// at the front keeps them together in warps: late in a sample most listed
// lanes only resolve, and mixed with them a live lane would take its warp
// through the whole body for a few lanes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "halton.cuh"

#define F(x) ((float)(x))

namespace {

constexpr double PI_D = 3.14159265358979323846;  // shade.py:PI

// kernels/wavefront.py:LaneState's fields, in that order
struct Lane {
    float *ray_o, *ray_d, *color, *accumulated;
    int *bounce, *step, *tpasses;
    bool* active;
    int *rays, *prim_tri;
    float *prim_u, *prim_v, *cone_t;
    float *diffuse_albedo, *specular_albedo, *normal, *roughness;
    bool* wrote_gb;
};
static_assert(sizeof(Lane) == 18 * sizeof(void*), "Lane mirrors LaneState's 18 fields");

// kernels/wavefront.py:_frame_ptrs's order
struct Frame {
    const int *pixel_x, *pixel_y, *offsets;
    const float *camera, *lights, *shade_rows, *mat_rows;
    const int* step_bases;
    const float *env_map, *env_intensity;
};
static_assert(sizeof(Frame) == 10 * sizeof(void*), "Frame mirrors _frame_ptrs");

// kernels/traverse2.py:TraverseOut's t, tri, inst, u, v, as the closest-hit
// traversal wrote them, and a two-level BVH's first flat triangle id per
// instance (null for a flat table, whose tri is already the global id)
struct Raw {
    const float* t;
    const int *tri, *inst;
    const float *u, *v;
    const int* tri_base;
};
static_assert(sizeof(Raw) == 6 * sizeof(void*), "Raw mirrors kernels/wavefront.py:_raw_ptrs");

struct ShadowOut {
    float *origin, *direction, *distance, *contrib;
    bool* need;
};

// What the textured instantiations read beyond Frame: the atlas (the
// channel-packed level 0 and the mip chains, assets/texture.py), the motion
// rows (current and previous world vertices of each triangle), the pixel's
// cone angle, and the motion view's previous camera and sample-0 record;
// kernels/wavefront.py:_maps_ptrs's order (null where not needed)
struct Maps {
    const float* packed;       // (Hp, Wp, 16): every map of a resource at one rect
    const int* packed_rects;   // (R, 4): x0 y0 w h
    const float* texels;       // (H, W, 4): every map's mip chain (TextureAtlas.texels4)
    const int* rects;          // (R, 7, 4): level 0's rect per map
    const int* mip_rects;      // (R, 7, 12, 4)
    const int* n_levels;       // (R, 7)
    const float* motion_rows;  // (T, 18): v0 v1 v2, then their previous positions
    const float* pixel_angle;  // 0-d
    const float* prev_camera;  // (12,): the previous frame's position right up forward
    const float* prev_motion;  // (P, 2)
    const bool* had0;          // (P,): sample 0's first ray hit
    const float* motion0;      // (P, 2): its motion
};
static_assert(sizeof(Maps) == 12 * sizeof(void*), "Maps mirrors kernels/wavefront.py:_maps_ptrs");

struct MapsInfo {
    // bits 4m..4m+3: where some resource has map m (SceneStatics.any_map),
    // the float4 groups of the packed texel that map m reads (bit q:
    // channels 4q..4q+3), else 0 (kernels/wavefront.py:map_groups)
    int map_groups;
    int debug_mode;  // 0, or the debug view 1-7
    int packed_w, texel_w;  // the packed atlas's and the texels' widths
    float width, height;    // the render's, for the motion view
};

enum {
    FLAG_SAMPLE0 = 1,
    FLAG_GBUFFER = 2,
    FLAG_REFRACTION = 4,
    FLAG_ENVIRONMENT = 8,
    FLAG_LEGACY = 16,
    FLAG_POWER = 32,
    FLAG_RESOLVE = 64,  // a shadow ray of the previous iteration is pending
    FLAG_AO = 128,      // core/types.py:ENABLE_AO
};

// assets/texture.py's map types, the material's texture bits
// (core/types.py:MATERIAL_TEXTURE_*), the packed texel's channels and the
// debug views (core/types.py:DEBUG_MODE_*)
enum { MAP_BASECOLOR, MAP_NORMAL, MAP_ROUGHNESS, MAP_METALLIC, MAP_AO, MAP_OPACITY, MAP_EMISSION,
       N_MAP_TYPES, MAX_MIPS = 12, PACKED_C = 16 };
enum { TEX_BASECOLOR = 1, TEX_NORMAL = 2, TEX_ROUGHNESS = 4, TEX_METALLIC = 8, TEX_AO = 16,
       TEX_EMISSION = 32, TEX_OPACITY = 64 };
enum { PK_BASECOLOR = 0, PK_NORMAL = 3, PK_EMISSION = 6, PK_ROUGHNESS = 9, PK_METALLIC = 10,
       PK_AO = 11, PK_OPACITY = 12 };
enum { DEBUG_BASECOLOR = 1, DEBUG_NORMAL, DEBUG_ROUGHNESS, DEBUG_METALLIC, DEBUG_AO,
       DEBUG_EMISSION, DEBUG_MOTION };

// kernels/wavefront.py:pack_lights's columns
enum {
    LC_TYPE = 0, LC_POS = 1, LC_COLOR = 4, LC_DIR = 7, LC_FWD = 10, LC_RIGHT = 13, LC_UP = 16,
    LC_COS = 19, LC_PMF = 20, LC_CDF = 21, LIGHT_COLS = 22,
};

enum { LIGHT_SPOT = 2, LIGHT_POINT = 3, LIGHT_AREA = 4 };
enum { SHADING_STEPS = 20, STEP_COLS = 12, STEP_MAX_DIGITS = 11 };

struct f3 {
    float x, y, z;
};

__device__ __forceinline__ f3 mk(float x, float y, float z) { return f3{x, y, z}; }
__device__ __forceinline__ f3 ld3(const float* p) { return mk(p[0], p[1], p[2]); }
__device__ __forceinline__ void st3(float* p, f3 v) {
    p[0] = v.x;
    p[1] = v.y;
    p[2] = v.z;
}
__device__ __forceinline__ f3 operator+(f3 a, f3 b) { return mk(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ f3 operator-(f3 a, f3 b) { return mk(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ f3 operator*(f3 a, f3 b) { return mk(a.x * b.x, a.y * b.y, a.z * b.z); }
__device__ __forceinline__ f3 operator*(f3 a, float s) { return mk(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ f3 operator-(f3 a) { return mk(-a.x, -a.y, -a.z); }

// torch.clamp on CUDA: NaN passes through, else min(max(v, lo), hi)
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
    return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_min(float v, float lo) { return isnan(v) ? v : fmaxf(v, lo); }
__device__ __forceinline__ float saturate(float v) { return clampf(v, 0.0f, 1.0f); }

// shade.py:dot3, length, normalize, cross
__device__ __forceinline__ float dot3(f3 a, f3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ float length3(f3 v) { return sqrtf(dot3(v, v)); }
__device__ __forceinline__ f3 normalize(f3 v) {
    float l = clamp_min(length3(v), F(1e-20));
    return mk(v.x / l, v.y / l, v.z / l);
}
__device__ __forceinline__ f3 cross(f3 a, f3 b) {
    return mk(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}

// torch.remainder of int32: the sign of the divisor
__device__ __forceinline__ int py_mod(int a, int b) {
    int r = a % b;
    return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}
__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// the plain version's ``offsets + base + sidx`` (int32, wrapping)
__device__ __forceinline__ int halton_index(int offset, int hbase) {
    return (int)((unsigned)offset + (unsigned)hbase);
}

// kernels/wavefront.py:sample_environment, times the intensity
__device__ f3 sample_environment(const float* env, int he, int we, float intensity, f3 d) {
    const float inv_two_pi = 1.0f / F(2.0 * PI_D);
    const float inv_pi = 1.0f / F(PI_D);
    float u = 0.5f + atan2f(d.z, d.x) * inv_two_pi;
    float v = clampf(0.5f - asinf(clampf(d.y, -1.0f, 1.0f)) * inv_pi, 0.0f, 1.0f);
    float x = u * (float)we - 0.5f;
    float y = v * (float)he - 0.5f;
    float x0 = floorf(x);
    float y0 = floorf(y);
    float fx = x - x0;
    float fy = y - y0;
    int xi = (int)x0;
    int yi = (int)y0;
    int xi0 = py_mod(xi, we);
    int xi1 = py_mod(xi + 1, we);
    int yi0 = clampi(yi, 0, he - 1);
    int yi1 = clampi(yi + 1, 0, he - 1);
    f3 c00 = ld3(env + 3 * (yi0 * we + xi0));
    f3 c10 = ld3(env + 3 * (yi0 * we + xi1));
    f3 c01 = ld3(env + 3 * (yi1 * we + xi0));
    f3 c11 = ld3(env + 3 * (yi1 * we + xi1));
    float gx = 1.0f - fx;
    float gy = 1.0f - fy;
    f3 top = c00 * gx + c10 * fx;
    f3 bot = c01 * gx + c11 * fx;
    f3 e = top * gy + bot * fy;
    return e * intensity;
}

struct LightSample {
    f3 dir, col;
    float dist;
};

// shade.py:evaluate_light for the picked light (the plain version computes
// every type and selects; each type's own expression is the same)
__device__ LightSample evaluate_light(const float* L, float ua, float ub, f3 p) {
    int type = (int)L[LC_TYPE];
    f3 lpos = ld3(L + LC_POS), lcol = ld3(L + LC_COLOR), ldir = ld3(L + LC_DIR);
    LightSample s;
    if (type == LIGHT_AREA) {
        float uu0 = ua * 2.0f - 1.0f;
        float uu1 = ub * 2.0f - 1.0f;
        f3 sp = lpos + ld3(L + LC_RIGHT) * uu0 + ld3(L + LC_UP) * uu1;
        f3 dir = sp - p;
        float dist = length3(dir);
        float inv_d = 1.0f / clamp_min(dist, F(1e-3));
        dir = dir * inv_d;
        f3 col = lcol * (inv_d * inv_d);
        col = col * saturate(dot3(-dir, ld3(L + LC_FWD)));
        s.dir = dir;
        s.col = col;
        s.dist = dist;
    } else if (type == LIGHT_SPOT || type == LIGHT_POINT) {
        f3 s_vec = lpos - p;
        float s_dist = length3(s_vec);
        float s_inv = 1.0f / clamp_min(s_dist, F(1e-3));
        f3 s_dir = s_vec * s_inv;
        f3 col = lcol * (s_inv * s_inv);
        if (type == LIGHT_SPOT) {
            f3 cone_dir = normalize(ldir);
            bool in_cone = dot3(-s_dir, cone_dir) > L[LC_COS];
            col = in_cone ? col : mk(0.0f, 0.0f, 0.0f);
        }
        s.dir = s_dir;
        s.col = col;
        s.dist = s_dist;
    } else {  // sunlight (and an unused slot): a direction, no falloff
        s.dir = -normalize(ldir);
        s.col = lcol;
        s.dist = INFINITY;
    }
    return s;
}

// --- the textured instantiations' pieces --------------------------------------------

// torch.remainder of f32 on CUDA: fmod, then + b where the signs differ
__device__ __forceinline__ float py_fmodf(float a, float b) {
    float m = fmodf(a, b);
    if ((m != 0.0f) && ((b < 0.0f) != (m < 0.0f))) m += b;
    return m;
}

// torch.minimum: a NaN on either side is the result
__device__ __forceinline__ float minimum(float a, float b) {
    return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

// assets/texture.py:_packed_taps and _bilinear_rect's addressing: repeat
// inside the rect (x0 y0 w h), the four taps' global texel coordinates and
// the bilinear weights
struct Taps {
    int x0, x1, y0, y1;
    float fx, fy;
};

__device__ __forceinline__ Taps repeat_taps(int4 rect, float tu, float tv) {
    const float x0 = (float)rect.x, y0 = (float)rect.y, w = (float)rect.z, h = (float)rect.w;
    const float u = tu - floorf(tu);
    const float v = tv - floorf(tv);
    const float x = u * w - 0.5f;
    const float y = v * h - 0.5f;
    const float xf = floorf(x);
    const float yf = floorf(y);
    Taps t;
    t.fx = x - xf;
    t.fy = y - yf;
    t.x0 = (int)(x0 + py_fmodf(xf, w));
    t.x1 = (int)(x0 + py_fmodf(xf + 1.0f, w));
    t.y0 = (int)(y0 + py_fmodf(yf, h));
    t.y1 = (int)(y0 + py_fmodf(yf + 1.0f, h));
    return t;
}

// the plain order: top = c00 (1 - fx) + c10 fx, bot likewise, top (1 - fy) + bot fy
__device__ __forceinline__ float blend(float c00, float c10, float c01, float c11, float gx,
                                       float fx, float gy, float fy) {
    const float top = c00 * gx + c10 * fx;
    const float bot = c01 * gx + c11 * fx;
    return top * gy + bot * fy;
}

// assets/texture.py:sample_packed: one bilinear sample of resource res at
// uv, of the float4 groups of its PACKED_C channels in ``groups`` (bit q:
// channels 4q..4q+3; 4 taps of a float4 each); the other channels of out
// are left as they are
__device__ __forceinline__ void sample_packed(const Maps& M, int packed_w, int res, float tu,
                                              float tv, int groups, float out[PACKED_C]) {
    const Taps t = repeat_taps(__ldg(reinterpret_cast<const int4*>(M.packed_rects) + res), tu, tv);
    const float4* p = reinterpret_cast<const float4*>(M.packed);
    const float4* p00 = p + 4 * (long long)(t.y0 * packed_w + t.x0);
    const float4* p10 = p + 4 * (long long)(t.y0 * packed_w + t.x1);
    const float4* p01 = p + 4 * (long long)(t.y1 * packed_w + t.x0);
    const float4* p11 = p + 4 * (long long)(t.y1 * packed_w + t.x1);
    const float gx = 1.0f - t.fx, gy = 1.0f - t.fy;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        if (!((groups >> q) & 1)) continue;
        const float4 a = __ldg(p00 + q), b = __ldg(p10 + q), c = __ldg(p01 + q), d = __ldg(p11 + q);
        out[4 * q] = blend(a.x, b.x, c.x, d.x, gx, t.fx, gy, t.fy);
        out[4 * q + 1] = blend(a.y, b.y, c.y, d.y, gx, t.fx, gy, t.fy);
        out[4 * q + 2] = blend(a.z, b.z, c.z, d.z, gx, t.fx, gy, t.fy);
        out[4 * q + 3] = blend(a.w, b.w, c.w, d.w, gx, t.fx, gy, t.fy);
    }
}

// K7's lane-row form on a banded atlas: the packed sample at row ``row`` (the
// lane's position) of the (n_live, PACKED_C) buffer that K14 and a psum over
// gp wrote (M.packed then), its float4 groups in ``groups``
__device__ __forceinline__ void lane_taps(const Maps& M, int row, int groups,
                                          float out[PACKED_C]) {
    const float4* p = reinterpret_cast<const float4*>(M.packed) + 4 * (long long)row;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        if (!((groups >> q) & 1)) continue;
        const float4 a = __ldg(p + q);
        out[4 * q] = a.x;
        out[4 * q + 1] = a.y;
        out[4 * q + 2] = a.z;
        out[4 * q + 3] = a.w;
    }
}

// texel (x, y) of the mip chains: one 16-B load of the float4 copy
__device__ __forceinline__ f3 texel(const Maps& M, int texel_w, int x, int y) {
    const float4* p = reinterpret_cast<const float4*>(M.texels);
    const float4 c = __ldg(p + (long long)(y * texel_w + x));
    return mk(c.x, c.y, c.z);
}

// assets/texture.py:_bilinear_rect: a bilinear sample of the texels inside rect
__device__ __forceinline__ f3 bilinear_rect(const Maps& M, int texel_w, int4 rect, float tu,
                                            float tv) {
    const Taps t = repeat_taps(rect, tu, tv);
    const f3 c00 = texel(M, texel_w, t.x0, t.y0), c10 = texel(M, texel_w, t.x1, t.y0);
    const f3 c01 = texel(M, texel_w, t.x0, t.y1), c11 = texel(M, texel_w, t.x1, t.y1);
    const float gx = 1.0f - t.fx, gy = 1.0f - t.fy;
    return mk(blend(c00.x, c10.x, c01.x, c11.x, gx, t.fx, gy, t.fy),
              blend(c00.y, c10.y, c01.y, c11.y, gx, t.fx, gy, t.fy),
              blend(c00.z, c10.z, c01.z, c11.z, gx, t.fx, gy, t.fy));
}

// assets/texture.py:sample_trilinear: map m of resource res at the ray
// cone's lod_base, plus half log2 of the map's level-0 texel count
__device__ __forceinline__ f3 sample_trilinear(const Maps& M, int texel_w, int res, int m,
                                               float tu, float tv, float lod_base) {
    const int rm = res * N_MAP_TYPES + m;
    const int4 r0 = __ldg(reinterpret_cast<const int4*>(M.rects) + rm);
    const float nl = (float)__ldg(M.n_levels + rm);
    const float size0 = clamp_min((float)r0.z * (float)r0.w, 1.0f);
    const float lod = minimum(clamp_min(lod_base + 0.5f * log2f(size0), 0.0f), nl - 1.0f);
    const float l0 = floorf(lod);
    const float l1 = minimum(l0 + 1.0f, nl - 1.0f);
    const float frac = lod - l0;
    const int4* mr = reinterpret_cast<const int4*>(M.mip_rects) + (long long)rm * MAX_MIPS;
    const f3 c0 = bilinear_rect(M, texel_w, __ldg(mr + (int)l0), tu, tv);
    const f3 c1 = bilinear_rect(M, texel_w, __ldg(mr + (int)l1), tu, tv);
    return c0 * (1.0f - frac) + c1 * frac;
}

// kernels/wavefront.py:_project: screen x, y over the clamped depth
__device__ __forceinline__ void project(const float* cam, f3 pos, float& sx, float& sy) {
    const f3 view = pos - ld3(cam);
    const float denom = clamp_min(dot3(view, ld3(cam + 9)), F(0.001));
    sx = dot3(view, ld3(cam + 3)) / denom;
    sy = dot3(view, ld3(cam + 6)) / denom;
}

__global__ void sample_start_kernel(Lane S, Frame Fr, const int* __restrict__ total, int n,
                                    int hbase, int sidx, float width, float height) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    int hidx = halton_index(Fr.offsets[i], hbase);
    float rx = mrt_halton_base(hidx, 2, 24);
    float ry = mrt_halton_base(hidx, 3, 24);
    float u = ((float)Fr.pixel_x[i] + rx) / width * 2.0f - 1.0f;
    float v = ((float)Fr.pixel_y[i] + ry) / height * 2.0f - 1.0f;
    const float* cam = Fr.camera;
    f3 d = ld3(cam + 3) * u + ld3(cam + 6) * v + ld3(cam + 9);
    st3(S.ray_o + 3 * i, ld3(cam));
    st3(S.ray_d + 3 * i, normalize(d));
    st3(S.color + 3 * i, mk(1.0f, 1.0f, 1.0f));
    st3(S.accumulated + 3 * i, mk(0.0f, 0.0f, 0.0f));
    S.bounce[i] = 0;
    S.step[i] = 0;
    S.tpasses[i] = 0;
    S.active[i] = total[i] > sidx;
    S.rays[i] = 0;
    S.prim_tri[i] = -1;
    S.prim_u[i] = 0.0f;
    S.prim_v[i] = 0.0f;
    S.cone_t[i] = 0.0f;
}

// The first 2 * N2 floats of triangle tri's motion row (18 floats, 72 B:
// 8-B aligned, so float2 loads)
template <int N2>
__device__ __forceinline__ void motion_row(const Maps& M, int tri, float m[2 * N2]) {
    const float2* p = reinterpret_cast<const float2*>(M.motion_rows) + 9 * (long long)tri;
#pragma unroll
    for (int k = 0; k < N2; ++k) {
        const float2 a = __ldg(p + k);
        m[2 * k] = a.x;
        m[2 * k + 1] = a.y;
    }
}

// What a hit's material gives the shading, after its texture maps
struct Surface {
    f3 albedo, emission;
    float roughness, metallic, ao, opacity;
    f3 shading_nrm;
};

// The textured and debug instantiations' part of a hit (the untextured K7
// has none of it): with MIPS (which comes with MAPS) the ray cone's length
// and LOD;
// the texture maps (map m is sampled where some resource has it and the
// material's bit is set: the plain version samples every lane and
// selects), each replacing or scaling its part of sf; with DEBUG the
// view's colour replaces the radiance, the lane retires and the function
// returns true; else a normal map bends sf.shading_nrm. s2, s3: the shade
// row's last two float4 (the uvs); mrow: the material row; row: the index
// of the hit's motion row (its triangle, or in the lane-row form the lane's
// position). TAPS: the packed sample is that row of M.packed (K14's taps).
template <bool MAPS, bool MIPS, bool DEBUG, bool TAPS>
__device__ __forceinline__ bool textured_hit(const Lane& S, const ShadowOut& Sh, const Frame& Fr,
                                             const Maps& M, const MapsInfo& I, int i, int row,
                                             int res, int flags, int rays, float t, float hu,
                                             float hv, float w, float4 s2, float4 s3, f3 ray_d,
                                             f3 nrm, const float4* mrow, Surface& sf) {
    static_assert(MAPS || !MIPS, "mipmaps come with the MAPS instantiation");
    static_assert(!TAPS || (MAPS && !MIPS), "per-lane taps replace the packed sample");
    float lod_base = 0.0f;
    if constexpr (MIPS) {
        // the ray cone's mip LOD: its radius grows with the path length, its
        // footprint goes to uv units by the triangle's uv area over its world area
        // (the hit's world vertices v0 v1 v2: the motion row's first 9 floats)
        const float cone = S.cone_t[i] + t;
        S.cone_t[i] = cone;
        float mv[10];
        motion_row<5>(M, row, mv);
        const f3 v0 = mk(mv[0], mv[1], mv[2]);
        const float world_area =
            0.5f * length3(cross(mk(mv[3], mv[4], mv[5]) - v0, mk(mv[6], mv[7], mv[8]) - v0));
        const float du1x = s2.w - s2.y, du1y = s3.x - s2.z;
        const float du2x = s3.y - s2.y, du2y = s3.z - s2.z;
        const float uv_area = 0.5f * fabsf(du1x * du2y - du1y * du2x);
        const float cos_inc = clamp_min(fabsf(dot3(ray_d, nrm)), 0.25f);
        const float footprint_w = cone * __ldg(M.pixel_angle) / cos_inc;
        const float footprint_uv = footprint_w * sqrtf(uv_area / clamp_min(world_area, F(1e-12)));
        lod_base = log2f(clamp_min(footprint_uv, F(1e-8)));
    }

    int mflags = 0;
    float tu = 0.0f, tv = 0.0f;
    float pk[PACKED_C] = {};
    f3 base_sample = mk(1.0f, 0.0f, 1.0f);  // magenta: the base colour view without a map
    auto groups_of = [&](int m) { return (I.map_groups >> (4 * m)) & 15; };
    auto has = [&](int m, int bit) { return groups_of(m) != 0 && (mflags & bit) != 0; };
    auto sample3 = [&](int m, int c0) -> f3 {  // map m: with mipmaps its chain, else the packed
        if constexpr (MIPS) return sample_trilinear(M, I.texel_w, res, m, tu, tv, lod_base);
        else if constexpr (MAPS) return mk(pk[c0], pk[c0 + 1], pk[c0 + 2]);
        else return mk(0.0f, 0.0f, 0.0f);  // no map to sample: never called
    };
    auto sample1 = [&](int m, int c0) -> float { return sample3(m, c0).x; };
    if constexpr (MAPS) {
        mflags = (int)__ldg(mrow + 3).x;
        // the barycentric blend of the uvs (u uv1 + v uv2 + w uv0), y flipped
        tu = hu * s2.w + hv * s3.y + w * s2.y;
        tv = 1.0f - (hu * s3.x + hv * s3.z + w * s2.z);
        if constexpr (!MIPS) {
            // only the packed texel's float4 groups that the hit's maps read
            auto read = [&](int m, int bit) { return has(m, bit) ? groups_of(m) : 0; };
            const int groups = read(MAP_BASECOLOR, TEX_BASECOLOR) | read(MAP_NORMAL, TEX_NORMAL) |
                               read(MAP_ROUGHNESS, TEX_ROUGHNESS) |
                               read(MAP_METALLIC, TEX_METALLIC) |
                               ((flags & FLAG_AO) ? read(MAP_AO, TEX_AO) : 0) |
                               read(MAP_OPACITY, TEX_OPACITY) | read(MAP_EMISSION, TEX_EMISSION);
            if (groups) {
                if constexpr (TAPS) lane_taps(M, row, groups, pk);
                else sample_packed(M, I.packed_w, res, tu, tv, groups, pk);
            }
        }
        if (has(MAP_BASECOLOR, TEX_BASECOLOR)) {
            base_sample = sample3(MAP_BASECOLOR, PK_BASECOLOR);
            sf.albedo = sf.albedo * base_sample;
        }
        if (has(MAP_ROUGHNESS, TEX_ROUGHNESS)) sf.roughness = sample1(MAP_ROUGHNESS, PK_ROUGHNESS);
        if (has(MAP_METALLIC, TEX_METALLIC)) sf.metallic = sample1(MAP_METALLIC, PK_METALLIC);
        if ((flags & FLAG_AO) && has(MAP_AO, TEX_AO)) sf.ao = sample1(MAP_AO, PK_AO);
        if (has(MAP_OPACITY, TEX_OPACITY))
            sf.opacity = sf.opacity * sample1(MAP_OPACITY, PK_OPACITY);
        if (has(MAP_EMISSION, TEX_EMISSION)) sf.emission = sample3(MAP_EMISSION, PK_EMISSION);
    }

    // debug views: the colour at the hit replaces the radiance, the lane retires
    if constexpr (DEBUG) {
        const f3 magenta = mk(1.0f, 0.0f, 1.0f);
        const int mode = I.debug_mode;
        f3 dbg;
        if (mode == DEBUG_BASECOLOR) {
            dbg = base_sample;
        } else if (mode == DEBUG_NORMAL) {
            dbg = nrm * 0.5f + mk(0.5f, 0.5f, 0.5f);
            if constexpr (MAPS) {
                if (has(MAP_NORMAL, TEX_NORMAL)) dbg = sample3(MAP_NORMAL, PK_NORMAL);
            }
        } else if (mode == DEBUG_ROUGHNESS) {
            dbg = mk(sf.roughness, sf.roughness, sf.roughness);
        } else if (mode == DEBUG_METALLIC) {
            dbg = mk(sf.metallic, sf.metallic, sf.metallic);
        } else if (mode == DEBUG_AO) {
            dbg = (flags & FLAG_AO) ? mk(sf.ao, sf.ao, sf.ao) : magenta;
        } else if (mode == DEBUG_EMISSION) {
            dbg = sf.emission;
        } else {  // the motion view: sample 0's motion (kernels/wavefront.py:screen_motion)
            float mpx, mpy;
            if (flags & FLAG_SAMPLE0) {
                float m[18];
                motion_row<9>(M, row, m);
                const f3 obj = mk(m[3], m[4], m[5]) * hu + mk(m[6], m[7], m[8]) * hv +
                               mk(m[0], m[1], m[2]) * w;
                const f3 prev = mk(m[12], m[13], m[14]) * hu + mk(m[15], m[16], m[17]) * hv +
                                mk(m[9], m[10], m[11]) * w;
                float sx, sy, psx, psy;
                project(Fr.camera, obj, sx, sy);
                project(M.prev_camera, prev, psx, psy);
                const float right_scale = clamp_min(length3(ld3(Fr.camera + 3)), F(1e-5));
                const float up_scale = clamp_min(length3(ld3(Fr.camera + 6)), F(1e-5));
                mpx = (sx - psx) * (I.width / (2.0f * right_scale));
                mpy = -((sy - psy) * (I.height / (2.0f * up_scale)));
            } else if (M.had0[i]) {
                mpx = M.motion0[2 * i];
                mpy = M.motion0[2 * i + 1];
            } else {
                mpx = M.prev_motion[2 * i];
                mpy = M.prev_motion[2 * i + 1];
            }
            const float scx = clampf(mpx * F(0.05), -1.0f, 1.0f);
            const float scy = clampf(mpy * F(0.05), -1.0f, 1.0f);
            const float mag = clampf(sqrtf(mpx * mpx + mpy * mpy) * F(0.1), 0.0f, 1.0f);
            dbg = mk(scx * 0.5f + 0.5f, scy * 0.5f + 0.5f, mag);
        }
        st3(S.accumulated + 3 * i, dbg);
        S.active[i] = false;
        S.rays[i] = rays;
        Sh.need[i] = false;
        return true;
    }

    // normal mapping: the map's tangent-space normal in the triangle's
    // tangent basis (render/shade.py:tangent_basis_rows), Gram-Schmidt
    // against the interpolated normal
    if constexpr (MAPS) {
        if (has(MAP_NORMAL, TEX_NORMAL)) {
            float mv[10];
            motion_row<5>(M, row, mv);
            const f3 v0 = mk(mv[0], mv[1], mv[2]);
            const f3 e1 = mk(mv[3], mv[4], mv[5]) - v0, e2 = mk(mv[6], mv[7], mv[8]) - v0;
            const float du1x = s2.w - s2.y, du1y = s3.x - s2.z;
            const float du2x = s3.y - s2.y, du2y = s3.z - s2.z;
            const float denom = du1x * du2y - du1y * du2x;
            bool valid = fabsf(denom) >= F(1e-8);
            const float r = valid ? 1.0f / denom : 0.0f;
            const f3 tangent = (e1 * du2y - e2 * du1y) * r;
            const f3 bitangent = (e2 * du1x - e1 * du2x) * r;
            valid = valid && (length3(tangent) > F(1e-8)) && (length3(bitangent) > F(1e-8));
            if (valid) {
                const f3 world_t = normalize(tangent - nrm * dot3(tangent, nrm));
                const f3 world_b = normalize(cross(nrm, world_t));
                const f3 sm = sample3(MAP_NORMAL, PK_NORMAL);
                const f3 nm = mk(sm.x * 2.0f - 1.0f, sm.y * 2.0f - 1.0f, sm.z * 2.0f - 1.0f);
                sf.shading_nrm = normalize(world_t * nm.x + world_b * nm.y + nrm * nm.z);
            }
        }
    }
    return false;
}

// One listed lane of K7: the previous iteration's shadow ray, then this
// iteration's body. Sets alive (the lane is live after it) and keep (live,
// or holding a shadow ray: the lane belongs to the next list).
// The instantiation <false, false, false> is the untextured K7. MAPS: the
// scene has texture maps (SceneStatics.any_map; per map in
// I.map_groups), sampled from the packed atlas, or with MIPS trilinearly at
// the ray cone's LOD (use_mipmaps, which also carries the cone's length and
// comes with MAPS);
// a normal map bends the shading normal. DEBUG: a debug view
// (I.debug_mode): the colour at the first hit replaces the radiance and the
// lane retires, casting no shadow ray. LANE: the lane-row form of
// geometry sharding, which reads the hit's shade and motion rows at the
// lane's position pos[i] of K13's compacted rows (Fr.shade_rows,
// M.motion_rows then) instead of at the triangle's; TAPS: also the packed
// sample at that position of K14's (M.packed then).
template <bool MAPS, bool MIPS, bool DEBUG, bool LANE, bool TAPS>
__device__ __forceinline__ void shade_lane(const Lane& S, const Frame& Fr, const Raw& R,
                                           const ShadowOut& Sh, const bool* __restrict__ occluded,
                                           const Maps* M, const MapsInfo* I,
                                           const int* __restrict__ pos,
                                           int i, int hbase, int n_lights, int env_h, int env_w,
                                           int flags, int max_bounces, bool& alive, bool& keep) {
    // K8 folded in: the resolve of the previous iteration comes first, as the
    // plain loop adds contrib(k) before env(k+1)
    const bool add = (flags & FLAG_RESOLVE) && Sh.need[i] && !occluded[i];
    if (!S.active[i]) {  // the plain version leaves a dead lane's state as it is
        if (add) st3(S.accumulated + 3 * i, ld3(S.accumulated + 3 * i) + ld3(Sh.contrib + 3 * i));
        Sh.need[i] = false;
        return;
    }
    f3 acc = ld3(S.accumulated + 3 * i);
    if (flags & FLAG_RESOLVE) acc = acc + (add ? ld3(Sh.contrib + 3 * i) : mk(0.0f, 0.0f, 0.0f));
    int rays = S.rays[i] + 1;
    f3 ray_o = ld3(S.ray_o + 3 * i), ray_d = ld3(S.ray_d + 3 * i);
    f3 color = ld3(S.color + 3 * i);
    // the hit record as bvh/twolevel.py's _hits makes it: a hit needs a
    // triangle (and, in a two-level BVH, an instance); its flat id is the
    // instance's first flat id plus the local one
    int tri = R.tri[i];
    bool hit = tri >= 0;
    if (R.tri_base != nullptr) {
        const int inst = R.inst[i];
        hit = hit && inst >= 0;
        if (hit) tri = R.tri_base[inst] + tri;
    }
    if (flags & FLAG_ENVIRONMENT) {
        f3 ce = mk(0.0f, 0.0f, 0.0f);
        if (!hit)
            ce = color * sample_environment(Fr.env_map, env_h, env_w, Fr.env_intensity[0], ray_d);
        acc = acc + ce;
    }
    if (!hit) {  // retires; the emission add of a lane that is not lit is + 0
        st3(S.accumulated + 3 * i, acc + mk(0.0f, 0.0f, 0.0f));
        S.active[i] = false;
        S.rays[i] = rays;
        Sh.need[i] = false;
        return;
    }
    int bounce = S.bounce[i], step = S.step[i], tpasses = S.tpasses[i];
    const float t = R.t[i], hu = R.u[i], hv = R.v[i];
    // shade row [n0(3) n1(3) n2(3) uv0(2) uv1(2) uv2(2) resource]: 4 float4,
    // the triangle's, or in the lane-row form the lane's position's
    int row = tri;
    if constexpr (LANE) row = __ldg(pos + i);
    const float4* srow = reinterpret_cast<const float4*>(Fr.shade_rows) + 4 * (long long)row;
    const float4 s0 = __ldg(srow), s1 = __ldg(srow + 1), s2 = __ldg(srow + 2), s3 = __ldg(srow + 3);
    const int res = (int)s3.w;
    const f3 wp = ray_o + ray_d * t;
    const float w = 1.0f - hu - hv;

    // primary hit record (bounce 0, sample 0)
    if ((flags & FLAG_SAMPLE0) && bounce == 0) {
        S.prim_tri[i] = tri;
        S.prim_u[i] = hu;
        S.prim_v[i] = hv;
    }

    // surface normal
    f3 nrm_raw = mk(s0.w, s1.x, s1.y) * hu + mk(s1.z, s1.w, s2.x) * hv + mk(s0.x, s0.y, s0.z) * w;
    f3 nrm = length3(nrm_raw) < F(1e-10) ? -ray_d : normalize(nrm_raw);
    f3 shading_nrm = nrm;  // bent by a normal map (MAPS)

    // material row [base(3) specular(3) emission(3) spec_exp ior opacity flags ...]: 3 float4
    // (untextured: roughness 1, metallic 0, ao 1)
    const float4* mrow = reinterpret_cast<const float4*>(Fr.mat_rows) + 4 * (long long)res;
    const float4 m0 = __ldg(mrow), m1 = __ldg(mrow + 1), m2 = __ldg(mrow + 2);
    f3 albedo = mk(m0.x, m0.y, m0.z);
    f3 emission = mk(m1.z, m1.w, m2.x);
    float roughness = 1.0f, metallic = 0.0f, ao = 1.0f;
    float opacity = clampf(m2.w, 0.0f, 1.0f);
    if constexpr (MAPS || MIPS || DEBUG) {
        Surface sf{albedo, emission, roughness, metallic, ao, opacity, shading_nrm};
        if (textured_hit<MAPS, MIPS, DEBUG, TAPS>(S, Sh, Fr, *M, *I, i, row, res, flags, rays, t,
                                                  hu, hv, w, s2, s3, ray_d, nrm, mrow, sf))
            return;  // a debug view: the lane retired
        albedo = sf.albedo;
        emission = sf.emission;
        roughness = sf.roughness;
        metallic = sf.metallic;
        ao = sf.ao;
        opacity = sf.opacity;
        shading_nrm = sf.shading_nrm;
    }

    // G-buffer: sample 0's first hit, before the glass branch
    if ((flags & FLAG_GBUFFER) && (flags & FLAG_SAMPLE0) && !S.wrote_gb[i]) {
        st3(S.diffuse_albedo + 3 * i, albedo * (1.0f - metallic));
        st3(S.specular_albedo + 3 * i,
            mk(F(0.04), F(0.04), F(0.04)) + (albedo - mk(F(0.04), F(0.04), F(0.04))) * metallic);
        st3(S.normal + 3 * i, shading_nrm * 0.5f + mk(0.5f, 0.5f, 0.5f));
        S.roughness[i] = clampf(roughness, 0.0f, 1.0f);
        S.wrote_gb[i] = true;
    }

    // glass / transparency branch
    const int* bases = Fr.step_bases + STEP_COLS * clampi(step, 0, SHADING_STEPS - 1);
    bool glass = false;
    if (flags & FLAG_REFRACTION) {
        const float ior = clamp_min(m2.z, 1.0f);
        const float clamped_op = clampf(opacity, 0.0f, 1.0f);
        glass = (clamped_op < F(0.999)) || (ior > F(1.01));
        if (glass) {
            f3 N = shading_nrm;
            const f3 I = ray_d;
            float cosi = clampf(dot3(-I, N), -1.0f, 1.0f);
            const bool inside = cosi < 0.0f;
            cosi = fabsf(cosi);
            N = inside ? -N : N;
            const float eta_i = inside ? ior : 1.0f;
            const float eta_t = inside ? 1.0f : ior;
            const float eta = eta_i / eta_t;
            const float k = 1.0f - eta * eta * (1.0f - cosi * cosi);
            const float r0 = (eta_t - eta_i) / (eta_t + eta_i);
            const float f0 = r0 * r0;
            const float Fres = f0 + (1.0f - f0) * powf(clampf(1.0f - cosi, 0.0f, 1.0f), 5.0f);
            const float transmission = 1.0f - clamped_op;
            const float reflect_w = Fres;
            const float refract_w = (1.0f - Fres) * transmission;
            const float total_w = clamp_min(reflect_w + refract_w, F(1e-4));
            const float reflect_prob = reflect_w / total_w;
            const float choice = mrt_halton_base(halton_index(Fr.offsets[i], hbase), bases[3],
                                                 STEP_MAX_DIGITS);
            const bool do_reflect = (k < 0.0f) || (choice < reflect_prob);
            f3 new_dir;
            if (do_reflect) {
                new_dir = normalize(I - N * (2.0f * dot3(I, N)));
            } else {
                const float cos_t = sqrtf(clamp_min(k, 0.0f));
                new_dir = normalize(I * eta + N * (eta * cosi - cos_t));
            }
            ray_d = new_dir;
            ray_o = wp + new_dir * F(1e-3);
            color = do_reflect ? color * total_w : color * total_w * albedo;
            const bool consume_bounce = do_reflect;
            int g_bounce = consume_bounce ? bounce + 1 : bounce;
            int g_tp = consume_bounce ? 0 : tpasses + 1;
            if (!consume_bounce && g_tp > max_bounces) {
                g_bounce = g_bounce + 1;
                g_tp = 0;
            }
            step = step + 1;
            bounce = g_bounce;
            tpasses = g_tp;
        }
    }
    bool lit = !glass;
    acc = acc + (lit ? color * emission : mk(0.0f, 0.0f, 0.0f));
    bool active = true;
    bool need = false;

    if (lit) {
        // the five post-glass dims, at this step (a lit lane did not advance)
        const int hidx = halton_index(Fr.offsets[i], hbase);
        const float light_sample = mrt_halton_base(hidx, bases[0], STEP_MAX_DIGITS);
        const float u_area0 = mrt_halton_base(hidx, bases[1], STEP_MAX_DIGITS);
        const float u_area1 = mrt_halton_base(hidx, bases[2], STEP_MAX_DIGITS);
        const float u_b0 = mrt_halton_base(hidx, bases[4], STEP_MAX_DIGITS);
        const float u_b1 = mrt_halton_base(hidx, bases[5], STEP_MAX_DIGITS);

        // pick 1 of N lights
        int li;
        float light_weight;
        if (flags & FLAG_POWER) {
            li = 0;  // searchsorted, left: the entries of the cdf below the sample
            for (int j = 0; j < n_lights; ++j) li += Fr.lights[j * LIGHT_COLS + LC_CDF] < light_sample;
            li = clampi(li, 0, n_lights - 1);
            light_weight = 1.0f / clamp_min(Fr.lights[li * LIGHT_COLS + LC_PMF], F(1e-8));
        } else {
            li = min((int)(light_sample * (float)n_lights), n_lights - 1);
            light_weight = (float)n_lights;
        }
        LightSample ls = evaluate_light(Fr.lights + li * LIGHT_COLS, u_area0, u_area1, wp);
        const f3 l_col = ls.col * light_weight;

        // shading
        f3 contrib;
        f3 new_color;
        const f3 Ldir = normalize(ls.dir);
        const float n_dot_l = saturate(dot3(shading_nrm, Ldir));
        if (flags & FLAG_LEGACY) {
            const f3 legacy_color = color * albedo;
            const bool dead_before = length3(legacy_color) < F(0.001);
            active = !dead_before;
            lit = !dead_before;
            need = lit && (length3(l_col) > F(0.0001)) && (n_dot_l > 0.0f);
            contrib = legacy_color * l_col * n_dot_l;
            new_color = legacy_color * ao;
        } else {
            const float pr = clampf(roughness, F(0.04), 1.0f);
            const float alpha = pr * pr;
            const f3 c04 = mk(F(0.04), F(0.04), F(0.04));
            const f3 F0 = c04 + (albedo - c04) * metallic;
            const f3 V = normalize(-ray_d);
            const bool has_light = length3(l_col) > F(0.0001);
            const f3 Hv = normalize(V + Ldir);
            const float n_dot_v = saturate(dot3(shading_nrm, V));
            const float n_dot_h = saturate(dot3(shading_nrm, Hv));
            const float v_dot_h = saturate(dot3(V, Hv));
            const float p5 = powf(clampf(1.0f - v_dot_h, 0.0f, 1.0f), 5.0f);
            const f3 Fr3 = F0 + (mk(1.0f, 1.0f, 1.0f) - F0) * p5;
            const float a2 = alpha * alpha;
            const float denom = (n_dot_h * n_dot_h) * (a2 - 1.0f) + 1.0f;
            const float D = a2 / clamp_min(F(PI_D) * denom * denom, F(1e-7));
            float kk = pr + 1.0f;
            kk = (kk * kk) * (1.0f / 8.0f);
            const float gv = n_dot_v / clamp_min(n_dot_v * (1.0f - kk) + kk, F(1e-7));
            const float gl = n_dot_l / clamp_min(n_dot_l * (1.0f - kk) + kk, F(1e-7));
            const float G = gv * gl;
            const float spec_den = clamp_min(4.0f * n_dot_v * n_dot_l, F(1e-4));
            const f3 dg = Fr3 * (D * G);
            const f3 specular = mk(dg.x / spec_den, dg.y / spec_den, dg.z / spec_den);
            const f3 kD = (mk(1.0f, 1.0f, 1.0f) - Fr3) * (1.0f - metallic);
            const f3 diffuse = kD * albedo * (1.0f / F(PI_D));
            const f3 direct = (diffuse + specular) * l_col * n_dot_l;
            need = has_light;
            contrib = color * direct;
            new_color = color * albedo * ((1.0f - metallic) * ao);
        }
        rays += need;
        if (need) {
            st3(Sh.origin + 3 * i, wp + nrm * F(1e-3));
            st3(Sh.direction + 3 * i, ls.dir);
            Sh.distance[i] = ls.dist - F(1e-3);
            st3(Sh.contrib + 3 * i, contrib);
        }

        // after the shadow ray: throughput, dead lanes, the next bounce
        if (lit) {
            color = new_color;
            if (length3(color) < F(0.001)) {
                active = false;
                lit = false;
            }
        }
        if (lit) {
            const float phi = F(2.0 * PI_D) * u_b0;
            const float cos_phi = cosf(phi);
            const float sin_phi = sinf(phi);
            const float cos_theta = sqrtf(u_b1);
            const float sin_theta = sqrtf(clamp_min(1.0f - cos_theta * cos_theta, 0.0f));
            const f3 right = normalize(cross(shading_nrm, mk(F(0.0072), 1.0f, F(0.0034))));
            const f3 forward = cross(right, shading_nrm);
            ray_d = right * (sin_theta * cos_phi) + shading_nrm * cos_theta +
                    forward * (sin_theta * sin_phi);
            ray_o = wp + nrm * F(1e-3);
            step = step + 1;
            bounce = bounce + 1;
            tpasses = 0;
        }
    }
    st3(S.ray_o + 3 * i, ray_o);
    st3(S.ray_d + 3 * i, ray_d);
    st3(S.color + 3 * i, color);
    st3(S.accumulated + 3 * i, acc);
    S.bounce[i] = bounce;
    S.step[i] = step;
    S.tpasses[i] = tpasses;
    alive = active && bounce < max_bounces;
    keep = alive || need;
    S.active[i] = alive;
    S.rays[i] = rays;
    Sh.need[i] = need;
}


constexpr unsigned FULL = 0xffffffffu;
const int SHADE_BLOCK = 256;

// counters[2 * s + k] of step slot s: k = 0 the lanes live after step s - 1
// (list s's front), 1 the lanes that only hold a shadow ray (its back)
enum { C_LIVE = 0, C_REST = 1, C_SLOT = 2 };
constexpr int SHADE_WARPS = SHADE_BLOCK / 32;

// Entry j of a list of n lanes whose front holds n_live entries and whose
// back the rest, from the end down
__device__ __forceinline__ int list_entry(const int* __restrict__ list, int j, int n_live, int n) {
    return j < n_live ? list[j] : list[n - 1 - (j - n_live)];
}

// Over step s's list (every lane when in is null), a block's 256 entries a
// round, the rounds strided over the grid. The lanes live after the step are
// appended to the front of out, those that only hold a shadow ray to its
// back: a warp ballot, a prefix over the block's warps and one atomicAdd per
// block, round and part, so the next step's live lanes share warps. The
// structs come by value and the maps by pointer (null in the untextured
// K7): so the untextured instantiation keeps, register for register, the
// instructions it had as a kernel of its own (kernels/sass_diff.py).
template <bool MAPS, bool MIPS, bool DEBUG, bool LANE, bool TAPS>
__device__ __forceinline__ void shade_rounds(
    Lane S, Frame Fr, Raw R, ShadowOut Sh,
    const bool* __restrict__ occluded, const int* __restrict__ in, int* __restrict__ out,
    const int* __restrict__ cin, int* cout, int n, int hbase, int n_lights, int env_h, int env_w,
    int flags, int max_bounces, const Maps* M, const MapsInfo* I, const int* __restrict__ pos) {
    __shared__ int at[2][SHADE_WARPS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n_live = in != nullptr ? cin[C_LIVE] : n;
    const int n_in = in != nullptr ? n_live + cin[C_REST] : n;
    for (int base = blockIdx.x * SHADE_BLOCK; base < n_in; base += gridDim.x * SHADE_BLOCK) {
        const int j = base + threadIdx.x;
        bool alive = false, keep = false;
        int i = 0;
        if (j < n_in) {
            i = in != nullptr ? list_entry(in, j, n_live, n) : j;
            shade_lane<MAPS, MIPS, DEBUG, LANE, TAPS>(S, Fr, R, Sh, occluded, M, I, pos, i, hbase,
                                                      n_lights, env_h, env_w, flags, max_bounces,
                                                      alive, keep);
        }
        const unsigned front = __ballot_sync(FULL, alive);
        const unsigned back = __ballot_sync(FULL, keep && !alive);
        if (lane == 0) {
            at[0][warp] = __popc(front);
            at[1][warp] = __popc(back);
        }
        __syncthreads();
        if (warp == 0) {
            const int c0 = lane < SHADE_WARPS ? at[0][lane] : 0;
            const int c1 = lane < SHADE_WARPS ? at[1][lane] : 0;
            int s0 = c0, s1 = c1;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int y0 = __shfl_up_sync(FULL, s0, o);
                const int y1 = __shfl_up_sync(FULL, s1, o);
                if (lane >= o) {
                    s0 += y0;
                    s1 += y1;
                }
            }
            const int t0 = __shfl_sync(FULL, s0, 31), t1 = __shfl_sync(FULL, s1, 31);
            int b0 = 0, b1 = 0;
            if (lane == 0) {
                if (t0 > 0) b0 = atomicAdd(&cout[C_LIVE], t0);
                if (t1 > 0) b1 = atomicAdd(&cout[C_REST], t1);
            }
            b0 = __shfl_sync(FULL, b0, 0);
            b1 = __shfl_sync(FULL, b1, 0);
            if (lane < SHADE_WARPS) {
                at[0][lane] = b0 + s0 - c0;
                at[1][lane] = b1 + s1 - c1;
            }
        }
        __syncthreads();
        const unsigned below = (1u << lane) - 1u;
        if (alive) out[at[0][warp] + __popc(front & below)] = i;
        else if (keep) out[n - 1 - (at[1][warp] + __popc(back & below))] = i;
        __syncthreads();  // at[] is rewritten next round
    }
}

// The untextured K7. 4 blocks of 256 a SM (64 registers, a few bytes of the
// body spilled): the occupancy of the full-width K7; at the 80 registers it
// takes unbounded, 3 fit. It reads no Maps.
__global__ void __launch_bounds__(SHADE_BLOCK, 4) shade_hit_kernel(
    Lane S, Frame Fr, Raw R, ShadowOut Sh, const bool* __restrict__ occluded,
    const int* __restrict__ in, int* __restrict__ out, const int* __restrict__ cin, int* cout,
    int n, int hbase, int n_lights, int env_h, int env_w, int flags, int max_bounces) {
    shade_rounds<false, false, false, false, false>(S, Fr, R, Sh, occluded, in, out, cin, cout, n,
                                                    hbase, n_lights, env_h, env_w, flags,
                                                    max_bounces, nullptr, nullptr, nullptr);
}

// K7's textured and debug instantiations (and their lane-row forms):
// TEX_BLOCKS blocks of 256 a SM, at most 80 registers. They fit with a few
// bytes spilled because a hit reads only the packed float4 groups its maps
// read (MapsInfo.map_groups: 2 of 4, one 32-B sector a tap, where a floor
// has a base-colour and a normal map), a mip texel as one 16-B load of the
// float4 copy (texels4: 8 loads a map instead of 24), and the tangent basis
// its motion row where it needs it. At 2 blocks the fewer loads alone gain
// nothing, at 4 (64 registers) the spills eat the gain, and the textured
// part out of line costs its call's frame on every textured hit.
constexpr int TEX_BLOCKS = 3;
template <bool MAPS, bool MIPS, bool DEBUG>
__global__ void __launch_bounds__(SHADE_BLOCK, TEX_BLOCKS) shade_hit_tex_kernel(
    Lane S, Frame Fr, Raw R, ShadowOut Sh, const bool* __restrict__ occluded,
    const int* __restrict__ in, int* __restrict__ out, const int* __restrict__ cin, int* cout,
    int n, int hbase, int n_lights, int env_h, int env_w, int flags, int max_bounces, Maps M,
    MapsInfo I) {
    shade_rounds<MAPS, MIPS, DEBUG, false, false>(S, Fr, R, Sh, occluded, in, out, cin, cout, n,
                                                  hbase, n_lights, env_h, env_w, flags,
                                                  max_bounces, &M, &I, nullptr);
}

// K7's lane-row form (geometry sharding): the rows, and on a banded atlas
// the packed sample, at the lane's position pos[i] of the compacted rows
// that K13 and K14 wrote for the step's n_rows live lanes and a psum over gp
// completed (the buffers stand where the frame's tables stood:
// Fr.shade_rows, M.motion_rows, M.packed). The motion rows follow the
// n_rows shade rows in K13's buffer, so their address is Fr.shade_rows +
// 16 n_rows: an argument, and no pointer packed anew per step. The
// occupancy of the instantiation it mirrors.
template <bool MAPS, bool MIPS, bool DEBUG, bool TAPS>
__global__ void __launch_bounds__(SHADE_BLOCK, (MAPS || DEBUG) ? TEX_BLOCKS : 4)
    shade_hit_rows_kernel(
    Lane S, Frame Fr, Raw R, ShadowOut Sh, const bool* __restrict__ occluded,
    const int* __restrict__ in, int* __restrict__ out, const int* __restrict__ cin, int* cout,
    int n, int hbase, int n_lights, int env_h, int env_w, int flags, int max_bounces, Maps M,
    MapsInfo I, const int* __restrict__ pos, int n_rows) {
    Maps Ml = M;
    Ml.motion_rows = Fr.shade_rows + 16LL * n_rows;
    shade_rounds<MAPS, MIPS, DEBUG, true, TAPS>(S, Fr, R, Sh, occluded, in, out, cin, cout, n,
                                                hbase, n_lights, env_h, env_w, flags, max_bounces,
                                                &Ml, &I, pos);
}

typedef void (*ShadeTexKernel)(Lane, Frame, Raw, ShadowOut, const bool*, const int*, int*,
                               const int*, int*, int, int, int, int, int, int, int, Maps,
                               MapsInfo);
typedef void (*ShadeRowsKernel)(Lane, Frame, Raw, ShadowOut, const bool*, const int*, int*,
                                const int*, int*, int, int, int, int, int, int, int, Maps,
                                MapsInfo, const int*, int);

// K7's instantiations by variant: bit 0 MAPS, 1 MIPS, 2 DEBUG, 3 the
// lane-row form, 4 its per-lane taps (0: the untextured shade_hit_kernel;
// 1-7 TEX_KERNELS, 8-31 ROWS_KERNELS[variant - 8]).
// Mipmaps come with MAPS (a scene without maps samples none, and keeps the
// cone's length), so variants 2 and 6 have none; the taps replace the
// packed sample, so they come with MAPS and without MIPS.
constexpr int N_VARIANTS = 32, ROWS_FIRST = 8;
const ShadeTexKernel TEX_KERNELS[ROWS_FIRST] = {
    nullptr,
    shade_hit_tex_kernel<true, false, false>,
    nullptr,
    shade_hit_tex_kernel<true, true, false>,
    shade_hit_tex_kernel<false, false, true>,
    shade_hit_tex_kernel<true, false, true>,
    nullptr,
    shade_hit_tex_kernel<true, true, true>,
};
const ShadeRowsKernel ROWS_KERNELS[N_VARIANTS - ROWS_FIRST] = {
    shade_hit_rows_kernel<false, false, false, false>,  // 8
    shade_hit_rows_kernel<true, false, false, false>,
    nullptr,
    shade_hit_rows_kernel<true, true, false, false>,
    shade_hit_rows_kernel<false, false, true, false>,
    shade_hit_rows_kernel<true, false, true, false>,
    nullptr,
    shade_hit_rows_kernel<true, true, true, false>,
    nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,  // 16-23
    nullptr,
    shade_hit_rows_kernel<true, false, false, true>,  // 25
    nullptr, nullptr, nullptr,
    shade_hit_rows_kernel<true, false, true, true>,  // 29
    nullptr, nullptr,
};

// The instantiation of K7 for ``variant``, null where there is none
const void* shade_fn(int variant) {
    if (variant < 0 || variant >= N_VARIANTS) return nullptr;
    if (variant == 0) return (const void*)shade_hit_kernel;
    if (variant < ROWS_FIRST) return (const void*)TEX_KERNELS[variant];
    return (const void*)ROWS_KERNELS[variant - ROWS_FIRST];
}

// The trailing resolve of a sample: accumulated += contrib over the last
// list (its front and back; lengths in its slot), where the shadow ray was
// cast and is not occluded.
__global__ void resolve_shadow_kernel(float* __restrict__ acc, const float* __restrict__ contrib,
                                      const bool* __restrict__ need,
                                      const bool* __restrict__ occluded,
                                      const int* __restrict__ list, const int* __restrict__ slot,
                                      int n) {
    const int n_live = slot[C_LIVE];
    const int n_in = n_live + slot[C_REST];
    for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < n_in; j += gridDim.x * blockDim.x) {
        const int i = list_entry(list, j, n_live, n);
        if (need[i] && !occluded[i]) st3(acc + 3 * i, ld3(acc + 3 * i) + ld3(contrib + 3 * i));
    }
}

// K13 gp_rows: the local half of the JAX package's _tri_rows
// (mrt_tpu/render/wavefront.py:76-85, at :527, :547, :701 and :1034) under
// geometry sharding, over the step's live lanes only, compacted in lane
// order. Per lane i that is live (every lane when live is null), its
// position pos[i] = the live lanes before it (-1 where dead), lane_of[pos]
// = i, and at row pos[i] the hit triangle's shade row (16 f32) and/or motion
// row (18 f32) where ids[i] >= 0 and this rank's shard holds the triangle
// (g2l[id] >= 0), zeros where not. The flags, and so the map, are the same
// on every rank (gp replicates the rays), so a psum over gp of the n_live
// rows adds rows of one lane, and each element has one nonzero contributor
// (the sum is exact).
//
// Two launches over tiles of GP_TILE lanes, a block a tile, each thread 4
// neighbouring lanes (their flags one 4-B load, their pos one 16-B store,
// where aligned): the first counts each tile's live lanes; the second sums
// the counts of the tiles before its own (576 tiles at 589,824 lanes; the
// sum's reads grow with the square of the tiles, 33 MB of L2 at a 4M-lane
// batch) for the tile's first position, scans its threads' counts (warp
// shuffles, then the warps' totals), writes pos, lists its live lanes in
// shared memory (small tiles: 8 KB a block, so several blocks an SM keep
// loads in flight), reads each
// one's id and g2l entry once (one thread a lane) and writes lane_of, then
// copies the rows: a thread a float4 of the shade rows (64-B rows) and a
// float2 of the motion rows (72-B rows), neighbouring threads on
// neighbouring addresses, from the owner's row or zeros. Dead lanes cost
// their flag and their pos entry; the rows and the psum carry n_live rows.
// Bound: bytes (the P flags, pos written, the live lanes' ids, lane_of
// written, each distinct g2l entry and owned row once, the rows written).
// In a gp step the two launches make the map alone (ids null), before the
// hit combine, and the rows come after it from K13's third kernel,
// gp_gather_kernel (below), which the combine's winner writes; the rows
// written here are sample 0's motion rows (every lane, g2l's owner).
constexpr int GP_THREADS = 256, GP_ITEMS = 4, GP_TILE = GP_THREADS * GP_ITEMS;

// The live flags of lanes i0 .. i0 + 3 as bits (lanes past n dead; every
// lane live when live is null)
__device__ __forceinline__ unsigned live_bits(const bool* __restrict__ live, int i0, int n) {
    if (i0 >= n) return 0u;
    const int m = n - i0 < GP_ITEMS ? n - i0 : GP_ITEMS;
    if (live == nullptr) return (1u << m) - 1u;
    unsigned bits = 0u;
    if (m == GP_ITEMS && (reinterpret_cast<uintptr_t>(live + i0) & 3) == 0) {
        const unsigned w = __ldg(reinterpret_cast<const unsigned*>(live + i0));
#pragma unroll
        for (int b = 0; b < GP_ITEMS; ++b)
            if ((w >> (8 * b)) & 0xffu) bits |= 1u << b;
    } else {
        for (int k = 0; k < m; ++k)
            if (live[i0 + k]) bits |= 1u << k;
    }
    return bits;
}

// The sum of x over the block (every thread gets it); red: GP_THREADS / 32 ints
__device__ __forceinline__ int gp_block_sum(int x, int* red) {
    x = __reduce_add_sync(FULL, x);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
    __syncthreads();
    int t = 0;
#pragma unroll
    for (int w = 0; w < GP_THREADS / 32; ++w) t += red[w];
    __syncthreads();  // red is written again by the caller's next use
    return t;
}

__global__ void __launch_bounds__(GP_THREADS) gp_rows_count_kernel(
    const bool* __restrict__ live, int* __restrict__ counts, int n) {
    __shared__ int red[GP_THREADS / 32];
    const int c = __popc(live_bits(live, blockIdx.x * GP_TILE + GP_ITEMS * threadIdx.x, n));
    const int t = gp_block_sum(c, red);
    if (threadIdx.x == 0) counts[blockIdx.x] = t;
}

__global__ void __launch_bounds__(GP_THREADS) gp_rows_kernel(
    const bool* __restrict__ live, const int* __restrict__ ids, const int* __restrict__ g2l,
    const float* __restrict__ shade, const float* __restrict__ motion,
    const int* __restrict__ counts, int* __restrict__ pos, int* __restrict__ lane_of,
    float* __restrict__ out_shade, float* __restrict__ out_motion, int n, int n_rows) {
    __shared__ int s_lane[GP_TILE];  // the tile's live lanes, in order
    __shared__ int s_loc[GP_TILE];   // their rows in the shard (-1: another rank's, or no hit)
    __shared__ int red[GP_THREADS / 32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int base = blockIdx.x * GP_TILE;
    const int i0 = base + GP_ITEMS * threadIdx.x;
    const unsigned bits = live_bits(live, i0, n);
    // the tile's first position: the live lanes of the tiles before it
    int prefix = base;
    if (live != nullptr) {
        int s = 0;
        for (int k = threadIdx.x; k < (int)blockIdx.x; k += GP_THREADS) s += __ldg(counts + k);
        prefix = gp_block_sum(s, red);
    }
    // the thread's lanes' offsets in the tile: an exclusive scan of the
    // threads' counts
    const int c = __popc(bits);
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += y;
    }
    if (lane == 31) red[warp] = incl;
    __syncthreads();
    int before = 0, n_tile = 0;
#pragma unroll
    for (int w = 0; w < GP_THREADS / 32; ++w) {
        const int t = red[w];
        before += w < warp ? t : 0;
        n_tile += t;
    }
    int off = before + incl - c;
    int p[GP_ITEMS];
#pragma unroll
    for (int k = 0; k < GP_ITEMS; ++k) {
        p[k] = -1;
        if ((bits >> k) & 1u) {
            s_lane[off] = i0 + k;
            p[k] = prefix + off++;
        }
    }
    if (i0 + GP_ITEMS <= n && (reinterpret_cast<uintptr_t>(pos + i0) & 15) == 0) {
        *reinterpret_cast<int4*>(pos + i0) = make_int4(p[0], p[1], p[2], p[3]);
    } else {
#pragma unroll
        for (int k = 0; k < GP_ITEMS; ++k)
            if (i0 + k < n) pos[i0 + k] = p[k];
    }
    __syncthreads();
    // rows past n_rows (the caller's count; equal to the live lanes) are not written
    int n_out = n_rows - prefix < n_tile ? n_rows - prefix : n_tile;
    if (n_out < 0) n_out = 0;
    // each live lane's id and g2l entry, read once (ids null: the map alone)
    for (int k = threadIdx.x; k < n_out; k += GP_THREADS) {
        const int i = s_lane[k];
        if (ids != nullptr) {
            const int id = __ldg(ids + i);
            s_loc[k] = id >= 0 ? __ldg(g2l + id) : -1;
        }
        lane_of[prefix + k] = i;
    }
    __syncthreads();
    if (out_shade != nullptr) {
        const float4* src = reinterpret_cast<const float4*>(shade);
        float4* dst = reinterpret_cast<float4*>(out_shade) + 4 * (long long)prefix;
#pragma unroll 4
        for (int e = threadIdx.x; e < 4 * n_out; e += GP_THREADS) {
            const int loc = s_loc[e >> 2];
            dst[e] = loc >= 0 ? __ldg(src + 4 * (long long)loc + (e & 3))
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
    }
    if (out_motion != nullptr) {
        const float2* src = reinterpret_cast<const float2*>(motion);
        float2* dst = reinterpret_cast<float2*>(out_motion) + 9 * (long long)prefix;
#pragma unroll 4
        for (int e = threadIdx.x; e < 9 * n_out; e += GP_THREADS) {
            const int k = e / 9;
            const int loc = s_loc[k];
            dst[e] = loc >= 0 ? __ldg(src + 9 * (long long)loc + (e - 9 * k))
                              : make_float2(0.0f, 0.0f);
        }
    }
}

// A gp step's hit combine (the JAX package's combine_hits_across,
// mrt_tpu/render/wavefront.py:180-198) over its live lanes, in K13's order
// (row j is lane lane_of[j]'s), split at its collectives:
//   K15 gp_hit_keys: each row's key (hit_key) from its lane's t and tri;
//   one in-place pmin over gp of the n keys: the reference's t_min and
//   winner rank at once;
//   K13's gather (gp_gather_kernel): the rank whose own key equals the
//   minimum and whose triangle is >= 0 (the winner) writes the payload
//   (tri + 1, u, v as int32 bits) and the triangle's shade and/or motion
//   rows from its shard, every other rank zeros; one in-place int32 psum
//   over gp of payload and rows (one nonzero contributor an element: exact);
//   K16 gp_lane_unpack: t (the key's high word), tri (payload - 1), u and
//   v into the closest-hit record at lane lane_of[j], where K7 reads them.
// The step's shadow rays come from its live lanes only, so their occlusion
// takes the same map: K15's second form gathers it (uint8) to rows, an
// in-place pmax over gp reduces it, K16's second form scatters it back.
//
// The key: (bits(t) << 32) | r', r' the rank where tri >= 0, else 2^30. A
// hit's t is >= 0 (the triangle test takes t >= t_min = 0, which no NaN
// passes) or +inf (a miss: the ray's max distance), and for such t the
// order of the int64 keys is the order of (t, r'). The reference compares
// t as floats, so -0.0 ties +0.0: over more than one rank (canon) the key
// holds -0.0 as +0.0, and the winner's u, v and rows have -0.0 written as
// +0.0 (what the reference's float psum with zeros gives); an axis of one
// rank reduces nothing and keeps them as they are, as the reference does.
// Bounds: bytes (utils/bounds.py:gp_hit_keys, :gp_gather, :gp_lane_unpack).
constexpr unsigned NO_WINNER = 1u << 30;
constexpr unsigned NEG_ZERO = 0x80000000u;

__device__ __forceinline__ unsigned plus_zero_bits(unsigned b, bool canon) {
    return canon && b == NEG_ZERO ? 0u : b;
}

__device__ __forceinline__ float plus_zero(float x, bool canon) {
    return __uint_as_float(plus_zero_bits(__float_as_uint(x), canon));
}

__device__ __forceinline__ long long hit_key(float t, int tri, int rank, bool canon) {
    const unsigned hi = plus_zero_bits(__float_as_uint(t), canon);
    const unsigned lo = tri >= 0 ? (unsigned)rank : NO_WINNER;
    return (long long)(((unsigned long long)hi << 32) | lo);
}

__global__ void gp_hit_keys_kernel(const float* __restrict__ t, const int* __restrict__ tri,
                                   const int* __restrict__ lane_of, long long* __restrict__ keys,
                                   int n, int rank, bool canon) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= n) return;
    const int i = __ldg(lane_of + j);
    keys[j] = hit_key(__ldg(t + i), __ldg(tri + i), rank, canon);
}

__global__ void gp_hit_keys_occluded_kernel(const bool* __restrict__ occluded,
                                            const int* __restrict__ lane_of,
                                            unsigned char* __restrict__ occ, int n) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j < n) occ[j] = occluded[__ldg(lane_of + j)] ? 1 : 0;
}

// K13's gather: a block a tile of GP_TILE rows; a thread a row finds the
// winner (its own key recomputed from the record, the reduced key read) and
// writes the payload, then the rows are copied as gp_rows_kernel copies
// them (a thread a float4 of the shade rows, a float2 of the motion rows).
__global__ void __launch_bounds__(GP_THREADS) gp_gather_kernel(
    const float* __restrict__ t, const int* __restrict__ tri, const float* __restrict__ u,
    const float* __restrict__ v, const long long* __restrict__ keys,
    const int* __restrict__ lane_of, const int* __restrict__ g2l,
    const float* __restrict__ shade, const float* __restrict__ motion,
    float* __restrict__ out_shade, float* __restrict__ out_motion, int* __restrict__ payload,
    int n, int rank, bool canon) {
    __shared__ int s_loc[GP_TILE];  // the winner's row in this shard, else -1
    const int base = blockIdx.x * GP_TILE;
    const int n_out = n - base < GP_TILE ? n - base : GP_TILE;
    for (int k = threadIdx.x; k < n_out; k += GP_THREADS) {
        const int j = base + k;
        const int i = __ldg(lane_of + j);
        const int tr = __ldg(tri + i);
        const bool win = tr >= 0 && hit_key(__ldg(t + i), tr, rank, canon) == __ldg(keys + j);
        s_loc[k] = win ? __ldg(g2l + tr) : -1;
        int* p = payload + 3 * (long long)j;
        p[0] = win ? tr + 1 : 0;
        p[1] = win ? (int)plus_zero_bits(__float_as_uint(__ldg(u + i)), canon) : 0;
        p[2] = win ? (int)plus_zero_bits(__float_as_uint(__ldg(v + i)), canon) : 0;
    }
    __syncthreads();
    if (out_shade != nullptr) {
        const float4* src = reinterpret_cast<const float4*>(shade);
        float4* dst = reinterpret_cast<float4*>(out_shade) + 4 * (long long)base;
#pragma unroll 4
        for (int e = threadIdx.x; e < 4 * n_out; e += GP_THREADS) {
            const int loc = s_loc[e >> 2];
            float4 r = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (loc >= 0) {
                r = __ldg(src + 4 * (long long)loc + (e & 3));
                r = make_float4(plus_zero(r.x, canon), plus_zero(r.y, canon),
                                plus_zero(r.z, canon), plus_zero(r.w, canon));
            }
            dst[e] = r;
        }
    }
    if (out_motion != nullptr) {
        const float2* src = reinterpret_cast<const float2*>(motion);
        float2* dst = reinterpret_cast<float2*>(out_motion) + 9 * (long long)base;
#pragma unroll 4
        for (int e = threadIdx.x; e < 9 * n_out; e += GP_THREADS) {
            const int k = e / 9;
            const int loc = s_loc[k];
            float2 r = make_float2(0.0f, 0.0f);
            if (loc >= 0) {
                r = __ldg(src + 9 * (long long)loc + (e - 9 * k));
                r = make_float2(plus_zero(r.x, canon), plus_zero(r.y, canon));
            }
            dst[e] = r;
        }
    }
}

__global__ void gp_lane_unpack_kernel(const long long* __restrict__ keys,
                                      const int* __restrict__ payload,
                                      const int* __restrict__ lane_of, float* __restrict__ t,
                                      int* __restrict__ tri, float* __restrict__ u,
                                      float* __restrict__ v, int n) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= n) return;
    const int i = __ldg(lane_of + j);
    const int* p = payload + 3 * (long long)j;
    t[i] = __uint_as_float((unsigned)((unsigned long long)__ldg(keys + j) >> 32));
    tri[i] = __ldg(p) - 1;
    u[i] = __int_as_float(__ldg(p + 1));
    v[i] = __int_as_float(__ldg(p + 2));
}

__global__ void gp_lane_unpack_occluded_kernel(const unsigned char* __restrict__ occ,
                                               const int* __restrict__ lane_of,
                                               bool* __restrict__ occluded, int n) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j < n) occluded[__ldg(lane_of + j)] = occ[j] != 0;
}

// K14 banded_taps: this rank's share of the packed bilinear sample on a
// gp-banded atlas (mrt_tpu/assets/texture.py:355 sample_packed_banded, at
// mrt_tpu/render/wavefront.py:607-613), over K13's n compacted rows of the
// step's live lanes: row j is lane lane_of[j]'s. From its psum'd shade row
// (the uvs and the resource) and the lane's barycentrics, the texture
// coordinate as K7's textured_hit makes it, the resource's packed rect, the
// four taps with repeat addressing; the taps on rows of this rank's band
// [band_lo, band_lo + band_h) weigh in, the others add zeros (a band holds
// whole rows, so each row term of the sum is whole on its owner, and the
// psum over gp of the shares is the whole sample), written at row j. Four
// threads a row, one float4 of the 16 channels each, so that the texel
// loads and the stores are 16 B a thread on neighbouring addresses; the
// first of the four reads the row's uvs, the lane's u, v and the rect and
// computes the addressing once, and shuffles hand it to the other three (at
// a warp-uniform point: every thread of a launched warp takes them).
// Bound: bytes (the rows' uvs, lane_of, u, v, the rects, each distinct band
// texel tapped once, the samples written).
__global__ void banded_taps_kernel(const float* __restrict__ rows, const float* __restrict__ u,
                                   const float* __restrict__ v, const int* __restrict__ lane_of,
                                   const int* __restrict__ rects, const float* __restrict__ band,
                                   int band_lo, int band_h, int packed_w, float* __restrict__ out,
                                   int n) {
    const int k = blockIdx.x * blockDim.x + threadIdx.x;
    const int j = k >> 2, q = k & 3;
    const bool valid = j < n;
    int x0 = 0, x1 = 0, y0 = 0, y1 = 0;
    float fx = 0.0f, fy = 0.0f;
    if (valid && q == 0) {
        const float4* srow = reinterpret_cast<const float4*>(rows) + 4 * (long long)j;
        const float4 s2 = __ldg(srow + 2), s3 = __ldg(srow + 3);
        const int res = (int)s3.w;
        const int i = __ldg(lane_of + j);
        const float hu = __ldg(u + i), hv = __ldg(v + i);
        const float w = 1.0f - hu - hv;
        // the barycentric blend of the uvs (u uv1 + v uv2 + w uv0), y flipped
        const float tu = hu * s2.w + hv * s3.y + w * s2.y;
        const float tv = 1.0f - (hu * s3.x + hv * s3.z + w * s2.z);
        const Taps t = repeat_taps(__ldg(reinterpret_cast<const int4*>(rects) + res), tu, tv);
        x0 = t.x0;
        x1 = t.x1;
        y0 = t.y0;
        y1 = t.y1;
        fx = t.fx;
        fy = t.fy;
    }
    x0 = __shfl_sync(FULL, x0, 0, 4);
    x1 = __shfl_sync(FULL, x1, 0, 4);
    y0 = __shfl_sync(FULL, y0, 0, 4);
    y1 = __shfl_sync(FULL, y1, 0, 4);
    fx = __shfl_sync(FULL, fx, 0, 4);
    fy = __shfl_sync(FULL, fy, 0, 4);
    if (!valid) return;
    const float4* p = reinterpret_cast<const float4*>(band) + q;
    const int ly0 = y0 - band_lo, ly1 = y1 - band_lo;
    const bool own0 = ly0 >= 0 && ly0 < band_h, own1 = ly1 >= 0 && ly1 < band_h;
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float4 a = own0 ? __ldg(p + 4 * (long long)(ly0 * packed_w + x0)) : z;
    const float4 b = own0 ? __ldg(p + 4 * (long long)(ly0 * packed_w + x1)) : z;
    const float4 c = own1 ? __ldg(p + 4 * (long long)(ly1 * packed_w + x0)) : z;
    const float4 d = own1 ? __ldg(p + 4 * (long long)(ly1 * packed_w + x1)) : z;
    const float gx = 1.0f - fx, gy = 1.0f - fy;
    reinterpret_cast<float4*>(out)[k] =
        make_float4(blend(a.x, b.x, c.x, d.x, gx, fx, gy, fy),
                    blend(a.y, b.y, c.y, d.y, gx, fx, gy, fy),
                    blend(a.z, b.z, c.z, d.z, gx, fx, gy, fy),
                    blend(a.w, b.w, c.w, d.w, gx, fx, gy, fy));
}

__global__ void halton_kernel(const int* __restrict__ idx, const int* __restrict__ base,
                              float* __restrict__ out, int n, int digits) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) out[i] = mrt_halton_base(idx[i], base[i], digits);
}

const int BLOCK = 256;

unsigned blocks(int n) { return (unsigned)((n + BLOCK - 1) / BLOCK); }

template <typename T>
T unpack(void* const* p) {
    T out;
    memcpy(&out, p, sizeof(T));
    return out;
}

// The grid of a K7 instantiation (variant, as TEX_KERNELS) that is resident
// at once on the current device: SMs x the blocks per SM its registers
// allow, asked once per device and variant; and the SM count (for K8's
// grid). Returns a CUDA error code.
int shade_grid(int variant, int* blocks_out, int* sms_out) {
    static int cached_blocks[N_VARIANTS][64], cached_sms[64];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64 && cached_blocks[variant][dev] > 0) {
        *blocks_out = cached_blocks[variant][dev];
        *sms_out = cached_sms[dev];
        return 0;
    }
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    const void* fn = shade_fn(variant);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, SHADE_BLOCK, 0);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    *blocks_out = sms * per_sm;
    *sms_out = sms;
    if (dev < 64) {
        cached_blocks[variant][dev] = *blocks_out;
        cached_sms[dev] = sms;
    }
    return 0;
}

}  // namespace

extern "C" int mrt_sample_start(void* const* lane, void* const* frame, const void* total, int n,
                                int hbase, int sidx, float width, float height, void* stream) {
    if (n <= 0) return 0;
    sample_start_kernel<<<blocks(n), BLOCK, 0, (cudaStream_t)stream>>>(
        unpack<Lane>(lane), unpack<Frame>(frame), (const int*)total, n, hbase, sidx, width,
        height);
    return (int)cudaGetLastError();
}

// Step ``step`` of a sample (0: its first, over every lane). lists: two
// lists of n int32 (step s reads list s % 2 and writes list (s + 1) % 2);
// counters: 2 int32 per step slot, zeroed at the sample's start; occluded:
// the previous step's any-hit result (read from step 1 on). variant: bit 0
// texture maps, 1 mipmaps, 2 a debug view, 3 the lane-row form, 4 its
// per-lane taps (0: the untextured K7); maps: _maps_ptrs's pointers (read
// by the textured and debug instantiations); map_groups: MapsInfo's, the
// packed texel's float4 groups of each map some resource has; pos, n_rows:
// the lane-row form's map from lanes to K13's rows and their count (ignored
// by the other instantiations).
extern "C" int mrt_shade_hit(void* const* lane, void* const* frame, void* const* raw,
                             void* const* shadow, void* const* maps, const void* occluded,
                             void* lists, void* counters, int step, int n, int hbase, int n_lights,
                             int env_h, int env_w, int flags, int max_bounces, int variant,
                             int map_groups, int debug_mode, int packed_w, int texel_w,
                             float width, float height, const void* pos, int n_rows,
                             void* stream) {
    if (n <= 0) return 0;
    if (shade_fn(variant) == nullptr || (variant >= ROWS_FIRST && pos == nullptr))
        return (int)cudaErrorInvalidValue;
    int grid = 0, sms = 0;
    int rc = shade_grid(variant, &grid, &sms);
    if (rc != 0) return rc;
    int* l = (int*)lists;
    int* c = (int*)counters + C_SLOT * step;
    if (step > 0) flags |= FLAG_RESOLVE;
    // step 0 runs one round per block over every lane; a list's length is on
    // the device only, so later steps take the grid that is resident at once
    const unsigned full = (unsigned)((n + SHADE_BLOCK - 1) / SHADE_BLOCK);
    if (step == 0 || full < (unsigned)grid) grid = (int)full;
    const int* in = step > 0 ? l + (size_t)(step & 1) * n : nullptr;
    int* out = l + (size_t)((step + 1) & 1) * n;
    if (variant == 0) {
        shade_hit_kernel<<<grid, SHADE_BLOCK, 0, (cudaStream_t)stream>>>(
            unpack<Lane>(lane), unpack<Frame>(frame), unpack<Raw>(raw), unpack<ShadowOut>(shadow),
            (const bool*)occluded, in, out, c, c + C_SLOT, n, hbase, n_lights, env_h, env_w, flags,
            max_bounces);
    } else if (variant < ROWS_FIRST) {
        const MapsInfo info{map_groups, debug_mode, packed_w, texel_w, width, height};
        TEX_KERNELS[variant]<<<grid, SHADE_BLOCK, 0, (cudaStream_t)stream>>>(
            unpack<Lane>(lane), unpack<Frame>(frame), unpack<Raw>(raw), unpack<ShadowOut>(shadow),
            (const bool*)occluded, in, out, c, c + C_SLOT, n, hbase, n_lights, env_h, env_w, flags,
            max_bounces, unpack<Maps>(maps), info);
    } else {
        const MapsInfo info{map_groups, debug_mode, packed_w, texel_w, width, height};
        ROWS_KERNELS[variant - ROWS_FIRST]<<<grid, SHADE_BLOCK, 0, (cudaStream_t)stream>>>(
            unpack<Lane>(lane), unpack<Frame>(frame), unpack<Raw>(raw), unpack<ShadowOut>(shadow),
            (const bool*)occluded, in, out, c, c + C_SLOT, n, hbase, n_lights, env_h, env_w, flags,
            max_bounces, unpack<Maps>(maps), info, (const int*)pos, n_rows);
    }
    return (int)cudaGetLastError();
}

// The trailing resolve after ``steps`` steps: over list ``steps`` (its
// length on the device, in slot ``steps``).
extern "C" int mrt_resolve_shadow(void* acc, const void* contrib, const void* need,
                                  const void* occluded, const void* lists, const void* counters,
                                  int steps, int n, void* stream) {
    if (n <= 0 || steps <= 0) return 0;
    int grid = 0, sms = 0;
    int rc = shade_grid(0, &grid, &sms);
    if (rc != 0) return rc;
    const unsigned g = blocks(n) < (unsigned)(sms * 8) ? blocks(n) : (unsigned)(sms * 8);
    resolve_shadow_kernel<<<g, BLOCK, 0, (cudaStream_t)stream>>>(
        (float*)acc, (const float*)contrib, (const bool*)need, (const bool*)occluded,
        (const int*)lists + (size_t)(steps & 1) * n, (const int*)counters + C_SLOT * steps, n);
    return (int)cudaGetLastError();
}

extern "C" int mrt_halton(const void* idx, const void* base, void* out, int n, int digits,
                          void* stream) {
    if (n <= 0) return 0;
    halton_kernel<<<blocks(n), BLOCK, 0, (cudaStream_t)stream>>>(
        (const int*)idx, (const int*)base, (float*)out, n, digits);
    return (int)cudaGetLastError();
}

// K13 over n lanes: the map (pos (n,), lane_of (n_rows,)) of the lanes
// live (every lane when live is null), and the rows of the first n_rows of
// them (n_rows: the live lanes, counted by the caller): out_shade
// (n_rows, 16) and/or out_motion (n_rows, 18), either null when not wanted;
// with ids null (and both outputs null) the map alone, a gp step's scan;
// counts: one int32 a tile of GP_TILE lanes (scratch).
extern "C" int mrt_gp_rows(const void* ids, const void* live, const void* g2l, const void* shade,
                           const void* motion, void* counts, void* pos, void* lane_of,
                           void* out_shade, void* out_motion, int n, int n_rows, void* stream) {
    if (n <= 0) return 0;
    const unsigned tiles = (unsigned)((n + GP_TILE - 1) / GP_TILE);
    if (live != nullptr) {
        gp_rows_count_kernel<<<tiles, GP_THREADS, 0, (cudaStream_t)stream>>>(
            (const bool*)live, (int*)counts, n);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    gp_rows_kernel<<<tiles, GP_THREADS, 0, (cudaStream_t)stream>>>(
        (const bool*)live, (const int*)ids, (const int*)g2l, (const float*)shade,
        (const float*)motion, (const int*)counts, (int*)pos, (int*)lane_of, (float*)out_shade,
        (float*)out_motion, n, n_rows);
    return (int)cudaGetLastError();
}

// K15 over the n rows of a gp step's map: with t and tri (the closest-hit
// record, (P,) each) each row's key into keys (n,) int64; with occluded
// ((P,) bool; t and tri null) each row's lane's occlusion into occ (n,)
// uint8. rank: this rank's index on the gp axis; canon: the axis has more
// than one rank.
extern "C" int mrt_gp_hit_keys(const void* t, const void* tri, const void* occluded,
                               const void* lane_of, void* keys, void* occ, int n, int rank,
                               int canon, void* stream) {
    if (n <= 0) return 0;
    if (occluded != nullptr)
        gp_hit_keys_occluded_kernel<<<blocks(n), BLOCK, 0, (cudaStream_t)stream>>>(
            (const bool*)occluded, (const int*)lane_of, (unsigned char*)occ, n);
    else
        gp_hit_keys_kernel<<<blocks(n), BLOCK, 0, (cudaStream_t)stream>>>(
            (const float*)t, (const int*)tri, (const int*)lane_of, (long long*)keys, n, rank,
            canon != 0);
    return (int)cudaGetLastError();
}

// K13's gather over the n rows of a gp step's map: t, tri, u, v the
// closest-hit record ((P,) each), keys (n,) the keys reduced by min over
// gp, lane_of (n,); the winner's rows from this shard's tables (g2l, shade,
// motion) into out_shade (n, 16) and/or out_motion (n, 18), either null when
// not wanted, and the payload (n, 3) int32.
extern "C" int mrt_gp_gather(const void* t, const void* tri, const void* u, const void* v,
                             const void* keys, const void* lane_of, const void* g2l,
                             const void* shade, const void* motion, void* out_shade,
                             void* out_motion, void* payload, int n, int rank, int canon,
                             void* stream) {
    if (n <= 0) return 0;
    const unsigned tiles = (unsigned)((n + GP_TILE - 1) / GP_TILE);
    gp_gather_kernel<<<tiles, GP_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)t, (const int*)tri, (const float*)u, (const float*)v,
        (const long long*)keys, (const int*)lane_of, (const int*)g2l, (const float*)shade,
        (const float*)motion, (float*)out_shade, (float*)out_motion, (int*)payload, n, rank,
        canon != 0);
    return (int)cudaGetLastError();
}

// K16 over the n rows of a gp step's map: with keys and payload (the
// reduced keys (n,) and the summed payload (n, 3)) the combined hit into the
// record's t, tri, u, v ((P,) each) at lane lane_of[j]; with occ ((n,)
// uint8; keys and payload null) the occlusion into occluded ((P,) bool).
extern "C" int mrt_gp_lane_unpack(const void* keys, const void* payload, const void* occ,
                                  const void* lane_of, void* t, void* tri, void* u, void* v,
                                  void* occluded, int n, void* stream) {
    if (n <= 0) return 0;
    if (occ != nullptr)
        gp_lane_unpack_occluded_kernel<<<blocks(n), BLOCK, 0, (cudaStream_t)stream>>>(
            (const unsigned char*)occ, (const int*)lane_of, (bool*)occluded, n);
    else
        gp_lane_unpack_kernel<<<blocks(n), BLOCK, 0, (cudaStream_t)stream>>>(
            (const long long*)keys, (const int*)payload, (const int*)lane_of, (float*)t,
            (int*)tri, (float*)u, (float*)v, n);
    return (int)cudaGetLastError();
}

// K14 over n compacted rows: rows (n, 16) psum'd shade rows, lane_of (n,)
// their lanes, u/v (P,) the lanes' barycentrics, the packed rects (R, 4),
// this rank's band (band_h, packed_w, 16) from global row band_lo; out
// (n, 16).
extern "C" int mrt_banded_taps(const void* rows, const void* u, const void* v,
                               const void* lane_of, const void* rects, const void* band,
                               int band_lo, int band_h, int packed_w, void* out, int n,
                               void* stream) {
    if (n <= 0) return 0;
    banded_taps_kernel<<<blocks(4 * n), BLOCK, 0, (cudaStream_t)stream>>>(
        (const float*)rows, (const float*)u, (const float*)v, (const int*)lane_of,
        (const int*)rects, (const float*)band, band_lo, band_h, packed_w, (float*)out, n);
    return (int)cudaGetLastError();
}
