// K6 sample_start, K7 shade_hit, K8 resolve_shadow: the wavefront's
// per-bounce body between the traversals.
//
// Replaces the body of mrt_tpu/render/wavefront.py:trace_tile, which XLA
// fuses into a few programs per bounce on the TPU: K6 its camera rays and
// per-sample state (camera_rays/init_state, :290-363), K7 and K8 the bounce
// loop's body (:372-1020). The port ran that body as ~1,700 eager torch ops
// per iteration over the whole wavefront (kernels/wavefront.py keeps them as
// the plain versions); here each stage is one launch, one thread per lane.
//
// What each computes, op for op as the plain version on the card (PyTorch's
// CUDA kernels), so that the outputs are its bits:
//   K6: Halton dims 0/1 (24 digits, bases 2 and 3) of offsets + base + sidx,
//       the pixel's camera ray, the sample's fresh lane state.
//   K7: the hit record, the environment on a miss, the interpolated normal,
//       the material, the glass branch (Fresnel, the Halton transparency
//       pick, reflect or refract), emission, the light pick (uniform or
//       power, by the plain version's cdf) and the four light types, PBR or
//       legacy shading, the shadow ray, then the throughput, dead-lane and
//       cosine-hemisphere bounce update. A lane that was not live when the
//       closest-hit batch was traced writes only its shadow mask.
//   K8: accumulated += contrib where the shadow ray is live and unoccluded.
// Matching PyTorch's CUDA ops: a division by a Python scalar is a multiply
// by the f32 reciprocal (x / PI, x / (2 PI), x / 8); 1 / x and a
// normalisation's v / |v| are true divisions; Python constants are the f32
// of the double (F(x)); clamp propagates NaN (clampf); torch.pow(x, 5.0) is
// powf; dot products add x, y, z in that order; searchsorted is left-sided.
// Built with -fmad=false, so no multiply-add is contracted.
//
// Bound: bytes, per live lane. K7 reads the hits (16 B), the lane state
// (~105 B), the lane's shade row and material row (128 B, gathered by its
// triangle and resource) and writes the state and the shadow ray (~85 B);
// its operations (~600 f32, dominated by six 11-digit Halton loops of ~10
// ops each) put it near the ridge. The design is the simple one: SoA
// state, one thread per lane, no shared-memory staging. A lane that is dead
// costs one byte read and one written.

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

struct Hits {
    const float* t;
    const int* tri;
    const float *u, *v;
};

struct ShadowOut {
    float *origin, *direction, *distance, *contrib;
    bool* need;
};

enum {
    FLAG_SAMPLE0 = 1,
    FLAG_GBUFFER = 2,
    FLAG_REFRACTION = 4,
    FLAG_ENVIRONMENT = 8,
    FLAG_LEGACY = 16,
    FLAG_POWER = 32,
};

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

__global__ void shade_hit_kernel(Lane S, Frame Fr, Hits Hh, ShadowOut Sh, int n, int hbase,
                                 int n_lights, int env_h, int env_w, int flags, int max_bounces) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    if (!S.active[i]) {  // the plain version leaves a dead lane's state as it is
        Sh.need[i] = false;
        return;
    }
    int rays = S.rays[i] + 1;
    f3 ray_o = ld3(S.ray_o + 3 * i), ray_d = ld3(S.ray_d + 3 * i);
    f3 color = ld3(S.color + 3 * i), acc = ld3(S.accumulated + 3 * i);
    const int tri = Hh.tri[i];
    const bool hit = tri >= 0;
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
    const float t = Hh.t[i], hu = Hh.u[i], hv = Hh.v[i];
    const float* srow = Fr.shade_rows + 16 * (long long)tri;
    const int res = (int)srow[15];
    const f3 wp = ray_o + ray_d * t;
    const float w = 1.0f - hu - hv;

    // primary hit record (bounce 0, sample 0)
    if ((flags & FLAG_SAMPLE0) && bounce == 0) {
        S.prim_tri[i] = tri;
        S.prim_u[i] = hu;
        S.prim_v[i] = hv;
    }

    // surface normal
    f3 nrm_raw = ld3(srow + 3) * hu + ld3(srow + 6) * hv + ld3(srow) * w;
    f3 nrm = length3(nrm_raw) < F(1e-10) ? -ray_d : normalize(nrm_raw);
    const f3 shading_nrm = nrm;  // no normal map on the kernel route

    // material (no texture maps on the kernel route: roughness 1, metallic 0, ao 1)
    const float* mrow = Fr.mat_rows + 16 * (long long)res;
    const f3 albedo = ld3(mrow);
    const f3 emission = ld3(mrow + 6);
    const float roughness = 1.0f, metallic = 0.0f, ao = 1.0f;
    const float opacity = clampf(mrow[11], 0.0f, 1.0f);

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
        const float ior = clamp_min(mrow[10], 1.0f);
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
    S.active[i] = active && bounce < max_bounces;
    S.rays[i] = rays;
    Sh.need[i] = need;
}

__global__ void resolve_shadow_kernel(float* __restrict__ acc, const float* __restrict__ contrib,
                                      const bool* __restrict__ need,
                                      const bool* __restrict__ occluded, int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    f3 add = mk(0.0f, 0.0f, 0.0f);
    if (need[i] && !occluded[i]) add = ld3(contrib + 3 * i);
    st3(acc + 3 * i, ld3(acc + 3 * i) + add);
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

}  // namespace

extern "C" int mrt_sample_start(void* const* lane, void* const* frame, const void* total, int n,
                                int hbase, int sidx, float width, float height, void* stream) {
    if (n <= 0) return 0;
    sample_start_kernel<<<blocks(n), BLOCK, 0, (cudaStream_t)stream>>>(
        unpack<Lane>(lane), unpack<Frame>(frame), (const int*)total, n, hbase, sidx, width,
        height);
    return (int)cudaGetLastError();
}

extern "C" int mrt_shade_hit(void* const* lane, void* const* frame, void* const* hits,
                             void* const* shadow, int n, int hbase, int n_lights, int env_h,
                             int env_w, int flags, int max_bounces, void* stream) {
    if (n <= 0) return 0;
    shade_hit_kernel<<<blocks(n), BLOCK, 0, (cudaStream_t)stream>>>(
        unpack<Lane>(lane), unpack<Frame>(frame), unpack<Hits>(hits), unpack<ShadowOut>(shadow),
        n, hbase, n_lights, env_h, env_w, flags, max_bounces);
    return (int)cudaGetLastError();
}

extern "C" int mrt_resolve_shadow(void* acc, const void* contrib, const void* need,
                                  const void* occluded, int n, void* stream) {
    if (n <= 0) return 0;
    resolve_shadow_kernel<<<blocks(n), BLOCK, 0, (cudaStream_t)stream>>>(
        (float*)acc, (const float*)contrib, (const bool*)need, (const bool*)occluded, n);
    return (int)cudaGetLastError();
}

extern "C" int mrt_halton(const void* idx, const void* base, void* out, int n, int digits,
                          void* stream) {
    if (n <= 0) return 0;
    halton_kernel<<<blocks(n), BLOCK, 0, (cudaStream_t)stream>>>(
        (const int*)idx, (const int*)base, (float*)out, n, digits);
    return (int)cudaGetLastError();
}
