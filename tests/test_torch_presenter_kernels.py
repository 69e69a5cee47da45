"""Kernels K9 ``svgf_reproject``, K10 ``atrous_pass``, K11
``temporal_resolve`` and K12 ``resize`` (``mrt_tpu_torch/kernels/presenter.py``,
``csrc/presenter.cu``, ``csrc/presenter.cuh``) on the CPU:

- the plain versions composed (K9, then K10 at steps 1, 2, 4, the last
  remodulating) against ``mrt_tpu.upscale.denoise.svgf_filter`` over five
  fed-back frames, and the bilinear resize then K11's plain version against
  ``mrt_tpu.upscale.temporal.temporal_upscale``: within 1e-5 relative RMSE
  (the JAX package's dot products and XLA:CPU's fusions add in another
  order), at sizes where the edge clamp matters in every pass ((5,7) is
  smaller than the step-4 halo), with motion that leaves the image and a
  depth jump (disocclusion);
- ``svgf_filter`` and ``temporal_upscale`` on CPU tensors bit-equal to the
  plain stages they run;
- each wrapper raising on a meta tensor, on float64 and on a non-contiguous
  input;
- the kernels' per-pixel bodies (``presenter.cuh``) compiled by the host
  compiler with ``-ffp-contract=off``: K9 bit-equal to its plain version,
  K10 (run tile by tile as its kernel runs it: staged with the clamped
  halo, partial tiles at the right and bottom) and K11 within 1e-6
  relative RMSE: the host's ``expf`` and
  ``sqrtf`` and PyTorch's CPU ``exp`` and ``sqrt`` may differ in the last
  place (PyTorch's CPU ``sqrt`` is not correctly rounded: 0.7 % of random
  inputs differ from NumPy's). On the card, where both are CUDA's
  ``expf`` and ``sqrtf``, ``chip_smoke.py`` holds all three bit for bit.
  K12 (only multiplies and adds) bit-equal to its plain version, in the
  spatial chain's and the temporal chain's forms, shrinking (K > 6) and
  with an axis kept.
"""

import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrt_tpu.upscale import denoise as jdenoise
from mrt_tpu.upscale import temporal as jtemporal
from mrt_tpu_torch.kernels import build
from mrt_tpu_torch.kernels import presenter as K
from mrt_tpu_torch.upscale import denoise, spatial, temporal
from mrt_tpu_torch.utils.image import relative_rmse
from test_torch_scene_bvh import one_torch_thread  # noqa: F401

TOL = 1e-5


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a, np.float32))


def _frame(rng, h, w, f):
    """Frame ``f``'s inputs: colour, a G-buffer (zero diffuse albedo on a
    tenth of the pixels), depth with a jump in frame 3 (disocclusion),
    motion within 1 px on even frames and up to 3/4 of the image on odd
    ones (taps that leave it)."""
    n = rng.normal(size=(h, w, 3))
    n[..., 1] += 3.0
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    gb = dict(diffuse_albedo=rng.random((h, w, 3)) * 0.8 * (rng.random((h, w, 1)) > 0.1),
              specular_albedo=rng.random((h, w, 3)) * 0.1, normal=n * 0.5 + 0.5,
              roughness=rng.random((h, w)))
    gb = {k: np.asarray(v, np.float32) for k, v in gb.items()}
    depth = np.ones((h, w), np.float32) + np.float32(0.01) * rng.random((h, w), np.float32)
    if f == 3:
        depth[h // 4:h // 2 + 1, w // 4:w // 2 + 1] = 3.0
    reach = 1.0 if f % 2 == 0 else 0.75 * max(h, w)
    motion = rng.uniform(-reach, reach, (h, w, 2)).astype(np.float32)
    color = rng.random((h, w, 3), dtype=np.float32) * 2.0
    return color, gb, depth, motion


def _plain_denoise(color, gb, depth, motion, state):
    g = {k: _t(v) for k, v in gb.items()}
    depth = _t(depth)
    demod, m1, m2, hl, normal, var, lum = K.svgf_reproject_plain(
        _t(color), g["diffuse_albedo"], g["specular_albedo"], g["normal"], depth, _t(motion),
        state)
    filt, fvar = demod, var
    for step in K.ATROUS_STEPS[:-1]:
        filt, fvar, lum = K.atrous_pass_plain(filt, fvar, lum, normal, depth, step)
    out = K.atrous_pass_plain(filt, fvar, lum, normal, depth, K.ATROUS_STEPS[-1],
                              g["diffuse_albedo"], g["specular_albedo"])
    return out, denoise.DenoiseState(demod, m1, m2, hl, depth, normal)


@pytest.mark.parametrize("size", [(5, 7), (24, 32)])
def test_plain_stages_match_jax_denoiser(size):
    h, w = size
    rng = np.random.default_rng(h * w)
    st_j, st_p = jdenoise.init_state(h, w), denoise.init_state(h, w, "cpu")
    for f in range(5):
        color, gb, depth, motion = _frame(rng, h, w, f)
        out_j, st_j = jdenoise.svgf_filter(jnp.asarray(color), {k: jnp.asarray(v)
                                                                for k, v in gb.items()},
                                           jnp.asarray(depth), jnp.asarray(motion), st_j)
        out_p, st_p = _plain_denoise(color, gb, depth, motion, st_p)
        assert relative_rmse(out_p.numpy(), out_j) < TOL, f
        for field in denoise.DenoiseState._fields:
            err = relative_rmse(getattr(st_p, field).numpy(), getattr(st_j, field))
            assert err < TOL, (f, field, err)
    lengths = st_p.history_length.numpy()
    assert lengths.max() > 1.0 and lengths.min() == 1.0  # history built, and reset


@pytest.mark.parametrize("history_weight", [0.0, 0.9])
def test_plain_resolve_matches_jax_temporal(history_weight):
    rng = np.random.default_rng(int(history_weight * 10))
    h, w, oh, ow = 12, 16, 20, 27
    hist_j = hist_p = np.zeros((oh, ow, 4), np.float32)
    hist_p = _t(hist_p)
    for f in range(4):
        color, _, depth, motion = _frame(rng, h, w, f)
        out_j, hist_j = jtemporal.temporal_upscale(jnp.asarray(color), jnp.asarray(depth),
                                                   jnp.asarray(motion), jnp.asarray(hist_j),
                                                   oh, ow, history_weight)
        up = spatial.resize(torch.cat([_t(color), _t(depth)[..., None], _t(motion)], dim=-1),
                            oh, ow, "bilinear")
        out_p, hist_p = K.temporal_resolve_plain(up, hist_p, history_weight, ow / w, oh / h)
        assert relative_rmse(out_p.numpy(), out_j) < TOL, f
        assert relative_rmse(hist_p.numpy(), hist_j) < TOL, f


def test_cpu_entry_points_are_the_plain_stages():
    """``svgf_filter`` and ``temporal_upscale`` on CPU tensors: bit-equal to
    the plain stages composed, and no kernel launched."""
    K.reset_launches()
    rng = np.random.default_rng(7)
    h, w = 9, 13
    st_a = st_b = denoise.init_state(h, w, "cpu")
    hist_a = hist_b = torch.zeros((18, 26, 4))
    for f in range(3):
        color, gb, depth, motion = _frame(rng, h, w, f)
        out_a, st_a = denoise.svgf_filter(_t(color), {k: _t(v) for k, v in gb.items()},
                                          _t(depth), _t(motion), st_a)
        out_b, st_b = _plain_denoise(color, gb, depth, motion, st_b)
        assert torch.equal(out_a, out_b)
        assert all(torch.equal(a, b) for a, b in zip(st_a, st_b))
        lin_a, hist_a = temporal.temporal_upscale(out_a, _t(depth), _t(motion), hist_a, 18, 26,
                                                  0.9 * (f > 0))
        up = spatial.resize(torch.cat([out_b, _t(depth)[..., None], _t(motion)], dim=-1),
                            18, 26, "bilinear")
        lin_b, hist_b = K.temporal_resolve_plain(up, hist_b, 0.9 * (f > 0), 2.0, 2.0)
        assert torch.equal(lin_a, lin_b) and torch.equal(hist_a, hist_b)
    assert K.launches == dict.fromkeys(K.KERNELS, 0)


def _wrapper_inputs(device="cpu", dtype=torch.float32):
    h, w = 4, 6
    z = dict(device=device, dtype=dtype)
    v3, v1 = torch.ones((h, w, 3), **z), torch.ones((h, w), **z)
    state = denoise.DenoiseState(v3, v1, v1, v1, v1, v3)
    return dict(
        svgf_reproject=lambda: K.svgf_reproject(v3, v3, v3, v3, v1, torch.zeros((h, w, 2), **z),
                                                state),
        atrous_pass=lambda: K.atrous_pass(v3, v1, v1, v3, v1, 2),
        atrous_pass_last=lambda: K.atrous_pass(v3, v1, v1, v3, v1, 4, v3, v3),
        temporal_resolve=lambda: K.temporal_resolve(torch.ones((h, w, 6), **z),
                                                    torch.ones((h, w, 4), **z), 0.9, 2.0, 2.0))


@pytest.mark.parametrize("wrapper", ["svgf_reproject", "atrous_pass", "atrous_pass_last",
                                     "temporal_resolve"])
def test_wrappers_raise(wrapper):
    with pytest.raises(ValueError, match="unsupported device"):
        _wrapper_inputs("meta")[wrapper]()
    with pytest.raises(TypeError, match="float32"):
        _wrapper_inputs(dtype=torch.float64)[wrapper]()
    calls = _wrapper_inputs()
    calls[wrapper]()  # the plain version on the CPU
    h, w = 4, 6
    skew = torch.ones((w, h, 3)).transpose(0, 1)  # (h, w, 3), not contiguous
    bad = dict(
        svgf_reproject=lambda: K.svgf_reproject(skew, *(torch.ones((h, w, 3)),) * 3,
                                                torch.ones((h, w)), torch.ones((h, w, 2)),
                                                denoise.init_state(h, w, "cpu")),
        atrous_pass=lambda: K.atrous_pass(skew, torch.ones((h, w)), torch.ones((h, w)),
                                          torch.ones((h, w, 3)), torch.ones((h, w)), 2),
        atrous_pass_last=lambda: K.atrous_pass(*(torch.ones((h, w, 3)), torch.ones((h, w)),
                                                 torch.ones((h, w)), torch.ones((h, w, 3)),
                                                 torch.ones((h, w))), 4, skew, skew),
        temporal_resolve=lambda: K.temporal_resolve(torch.ones((w, h, 6)).transpose(0, 1),
                                                    torch.ones((h, w, 4)), 0.9, 2.0, 2.0))
    with pytest.raises(ValueError, match="not contiguous"):
        bad[wrapper]()
    if wrapper == "atrous_pass":
        with pytest.raises(ValueError, match="step"):
            K.atrous_pass(*(torch.ones((h, w, 3)), torch.ones((h, w)), torch.ones((h, w)),
                            torch.ones((h, w, 3)), torch.ones((h, w))), 3)


_HARNESS = r'''
#include <vector>
#include "presenter.cuh"
using namespace mrt_presenter;
extern "C" void k9(const float* const* in, float* const* out, int h, int w) {
    for (long long p = 0; p < (long long)h * w; ++p)
        svgf_reproject_px(p, h, w, in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8],
                          in[9], in[10], in[11], out[0], out[1], out[2], out[3], out[4], out[5],
                          out[6]);
}
// K10 as its kernel runs it: per tile, every staged pixel, then every
// output pixel inside the image
template <int STEP>
void k10_tiles(const float* const* in, float* const* out, int h, int w) {
    std::vector<float> planes(AP_PLANES * AtrousTile<STEP>::N);
    for (int y0 = 0; y0 < h; y0 += ATROUS_TH)
        for (int x0 = 0; x0 < w; x0 += ATROUS_TW) {
            for (int i = 0; i < AtrousTile<STEP>::N; ++i)
                atrous_stage<STEP>(i, x0, y0, h, w, in[0], in[1], in[2], in[3], in[4],
                                   planes.data());
            for (int ty = 0; ty < ATROUS_TH; ++ty)
                for (int tx = 0; tx < ATROUS_TW; ++tx)
                    if (x0 + tx < w && y0 + ty < h)
                        atrous_tile_px<STEP>(tx, ty, x0, y0, w, planes.data(), in[5], in[6],
                                             out[0], out[1], out[2]);
        }
}
extern "C" void k10(const float* const* in, float* const* out, int h, int w, int step) {
    if (step == 1) k10_tiles<1>(in, out, h, w);
    if (step == 2) k10_tiles<2>(in, out, h, w);
    if (step == 4) k10_tiles<4>(in, out, h, w);
}
extern "C" void k11(const float* up, const float* hist, float* out, float* new_hist, int h,
                    int w, float hw, float sx, float sy) {
    for (long long p = 0; p < (long long)h * w; ++p)
        temporal_resolve_px(p, h, w, up, (const float4*)hist, out, (float4*)new_hist, hw, sx, sy);
}
// K12 per output pixel: the sources staged as one (h, w, C) image, each
// vertical tap's horizontal sums (their taps in two pieces, as the kernel
// takes them over chunks of staged columns), then the tap
extern "C" void k12(const float* const* src, const int* cs, int h, int w, const int* row_first,
                    const float* row_w, int kr, const int* col_first, const float* col_w, int kc,
                    int oh, int ow, int clamp, float* out) {
    ResizeSrc s = {{src[0], src[1], src[2]}, {cs[0], cs[1], cs[2]}};
    int C = cs[0] + cs[1] + cs[2];
    std::vector<float> img((size_t)h * w * C);
    for (int r = 0; r < h; ++r)
        for (int c = 0; c < w; ++c) resize_stage_px(s, w, r, c, &img[((size_t)r * w + c) * C]);
    float sums[RESIZE_MAX_C] = {}, acc[RESIZE_MAX_C] = {};
    int half = kc / 2;
    for (int oy = 0; oy < oh; ++oy)
        for (int ox = 0; ox < ow; ++ox) {
            for (int k = 0; k < kr; ++k) {
                const float* x = &img[((size_t)(row_first[oy] + k) * w + col_first[ox]) * C];
                const float* wt = col_w + ox * kc;
                resize_row_px(x, C, wt, 0, half, sums, 1);
                resize_row_px(x + half * C, C, wt + half, half, kc - half, sums, 1);
                for (int c = 0; c < C; ++c)
                    acc[c] = resize_tap(acc[c], sums[c], row_w[oy * kr + k], k);
            }
            for (int c = 0; c < C; ++c)
                out[((long long)oy * ow + ox) * C + c] = resize_out(acc[c], clamp != 0);
        }
}
// K12's 32x32 tiles as their kernel runs them: per tile the inputs it
// reads (resize_span), staged rows_chunk x cols_chunk pixels at a time;
// per chunk of columns each lane's taps in it (resize_chunk_taps) into the
// horizontal sums, per chunk of rows each output row's taps in it
extern "C" void k12_tiles(const float* const* src, const int* cs, int h, int w,
                          const int* row_first, const float* row_w, int kr, const int* col_first,
                          const float* col_w, int kc, int oh, int ow, int rows_chunk,
                          int cols_chunk, int clamp, float* out) {
    ResizeSrc s = {{src[0], src[1], src[2]}, {cs[0], cs[1], cs[2]}};
    int C = cs[0] + cs[1] + cs[2];
    std::vector<float> stage((size_t)rows_chunk * cols_chunk * C), sums;
    sums.resize((size_t)rows_chunk * C * RESIZE_TW);
    for (int oy0 = 0; oy0 < oh; oy0 += RESIZE_TH)
        for (int ox0 = 0; ox0 < ow; ox0 += RESIZE_TW) {
            ResizeSpan rows = resize_span(row_first, oy0, mrt_imin(oy0 + RESIZE_TH, oh), kr);
            ResizeSpan cols = resize_span(col_first, ox0, mrt_imin(ox0 + RESIZE_TW, ow), kc);
            std::vector<float> acc((size_t)RESIZE_TH * RESIZE_TW * C, 0.0f);
            for (int r0 = rows.lo; r0 < rows.hi; r0 += rows_chunk) {
                int nr = mrt_imin(rows_chunk, rows.hi - r0);
                for (int c0 = cols.lo; c0 < cols.hi; c0 += cols_chunk) {
                    int nc = mrt_imin(cols_chunk, cols.hi - c0);
                    for (int rr = 0; rr < nr; ++rr)
                        for (int cc = 0; cc < nc; ++cc)
                            resize_stage_px(s, w, r0 + rr, c0 + cc, &stage[(rr * nc + cc) * C]);
                    for (int lane = 0; lane < RESIZE_TW && ox0 + lane < ow; ++lane) {
                        int ox = ox0 + lane, fc = col_first[ox];
                        ResizeSpan taps = resize_chunk_taps(c0, nc, fc, kc);
                        if (taps.lo >= taps.hi) continue;
                        for (int rr = 0; rr < nr; ++rr)
                            resize_row_px(&stage[(rr * nc + fc + taps.lo - c0) * C], C,
                                          col_w + (long long)ox * kc + taps.lo, taps.lo,
                                          taps.hi - taps.lo, &sums[rr * C * RESIZE_TW + lane],
                                          RESIZE_TW);
                    }
                }
                for (int i = 0; i < RESIZE_TH && oy0 + i < oh; ++i)
                    for (int lane = 0; lane < RESIZE_TW && ox0 + lane < ow; ++lane) {
                        int oy = oy0 + i, fr = row_first[oy];
                        ResizeSpan taps = resize_chunk_taps(r0, nr, fr, kr);
                        for (int k = taps.lo; k < taps.hi; ++k)
                            for (int c = 0; c < C; ++c) {
                                float& a = acc[(i * RESIZE_TW + lane) * C + c];
                                a = resize_tap(a, sums[((fr + k - r0) * C + c) * RESIZE_TW + lane],
                                               row_w[(long long)oy * kr + k], k);
                            }
                    }
            }
            for (int i = 0; i < RESIZE_TH && oy0 + i < oh; ++i)
                for (int lane = 0; lane < RESIZE_TW && ox0 + lane < ow; ++lane)
                    for (int c = 0; c < C; ++c)
                        out[((long long)(oy0 + i) * ow + ox0 + lane) * C + c] =
                            resize_out(acc[(i * RESIZE_TW + lane) * C + c], clamp != 0);
        }
}
// K12's strip form as its kernel runs it: per tile (resize_strip_tile) its
// planes and rows' table staged (resize_stage_plane, resize_stage_table;
// NaN where nothing is staged), then
// every thread of the block on its column (resize_strip_col) over the
// tile's rows, a warp storing the columns inside the image
// (resize_strip_cols)
template <int K, int C0, int C1, int C2>
void k12_strip_tiles(const float* const* src, int w, int oh, int ow, const int* row_first,
                     const float* row_w, const int* col_first, const float* col_w, int rt,
                     int clamp, float* out) {
    constexpr int C = C0 + C1 + C2;
    int tiles_x = (ow + RESIZE_STRIP_W - 1) / RESIZE_STRIP_W;
    int tiles = tiles_x * ((oh + rt - 1) / rt);
    auto copy = [](float* d, const float* s) { *d = *s; };
    std::vector<float> planes;
    for (int t = 0; t < tiles; ++t) {
        ResizeTile T = resize_strip_tile(t, tiles_x, rt, oh, ow, row_first, col_first, K, K);
        planes.assign((size_t)(T.r.hi - T.r.lo) * (T.c.hi - T.c.lo) * C + rt * (K + 1), NAN);
        float* pl = planes.data();
        resize_stage_plane<C0>(src[0], w, T, pl + resize_plane_at<C0, C1, C2>(T, 0), 0, 1, 0, 1,
                               copy);
        resize_stage_plane<C1>(src[1], w, T, pl + resize_plane_at<C0, C1, C2>(T, 1), 0, 1, 0, 1,
                               copy);
        resize_stage_plane<C2>(src[2], w, T, pl + resize_plane_at<C0, C1, C2>(T, 2), 0, 1, 0, 1,
                               copy);
        resize_stage_table<K>(row_first, row_w, T, pl + resize_plane_at<C0, C1, C2>(T, 3), 0, 1,
                              copy);
        for (int thread = 0; thread < RESIZE_STRIP_W; ++thread) {
            int n = resize_strip_cols(T, thread / 32), lane = thread % 32;
            resize_strip<K, C0, C1, C2>(
                pl, T, resize_strip_col(T, thread), col_first, col_w,
                [&](int oy, const float* o) {
                    if (lane >= n) return;
                    for (int c = 0; c < C; ++c)
                        out[((long long)oy * ow + T.ox0 + thread) * C + c] =
                            resize_out(o[c], clamp != 0);
                });
        }
    }
}
extern "C" void k12_strip(const float* const* src, const int* cs, int w, int oh, int ow,
                          const int* row_first, const float* row_w, const int* col_first,
                          const float* col_w, int k, int rt, int clamp, float* out) {
    if (cs[0] == 3 && cs[1] == 0 && k == 6)
        k12_strip_tiles<6, 3, 0, 0>(src, w, oh, ow, row_first, row_w, col_first, col_w, rt,
                                    clamp, out);
    if (cs[0] == 3 && cs[1] == 1 && cs[2] == 2 && k == 2)
        k12_strip_tiles<2, 3, 1, 2>(src, w, oh, ow, row_first, row_w, col_first, col_w, rt,
                                    clamp, out);
}
'''


@pytest.fixture(scope="module")
def presenter_lib(tmp_path_factory):
    """csrc/presenter.cuh's per-pixel bodies compiled by the host compiler."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.fail("no host C++ compiler to build csrc/presenter.cuh with")
    d = tmp_path_factory.mktemp("presenter")
    (d / "presenter_host.cpp").write_text(_HARNESS)
    lib = d / "libpresenter_host.so"
    subprocess.run([cxx, "-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
                    f"-I{build.CSRC}", str(d / "presenter_host.cpp"), "-o", str(lib)],
                   check=True, capture_output=True, timeout=120)
    return ctypes.CDLL(str(lib))


def _ptrs(ts):
    arr = (ctypes.c_void_p * len(ts))(*(None if t is None else t.data_ptr() for t in ts))
    return ctypes.cast(arr, ctypes.c_void_p)


def _bits_equal(a, b):
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


@pytest.mark.parametrize("size", [(5, 7), (24, 32), (19, 41)])
def test_host_compiled_kernels_match_plain(presenter_lib, size):
    h, w = size
    lib = presenter_lib
    rng = np.random.default_rng(11 + h)
    state = denoise.init_state(h, w, "cpu")
    hist = torch.zeros((2 * h, 2 * w, 4))
    k10_err = k11_err = 0.0
    for f in range(5):
        color, gb, depth, motion = _frame(rng, h, w, f)
        ins = [_t(color), _t(gb["diffuse_albedo"]), _t(gb["specular_albedo"]), _t(gb["normal"]),
               _t(depth), _t(motion), *state]
        want = K.svgf_reproject_plain(*ins[:6], state)
        got = [torch.empty_like(t) for t in want]
        lib.k9(_ptrs(ins), _ptrs(got), h, w)
        assert all(_bits_equal(a, b) for a, b in zip(got, want)), f
        demod, m1, m2, hl, normal, var, lum = want
        filt, fvar = demod, var
        for step in K.ATROUS_STEPS:
            last = step == K.ATROUS_STEPS[-1]
            remod = (ins[1], ins[2]) if last else (None, None)
            want = K.atrous_pass_plain(filt, fvar, lum, normal, ins[4], step,
                                       *(remod if last else ()))
            got = [torch.empty_like(filt), torch.empty_like(fvar), torch.empty_like(lum)]
            lib.k10(_ptrs([filt, fvar, lum, normal, ins[4], *remod]),
                    _ptrs(got if not last else [got[0], None, None]), h, w, step)
            for a, b in zip(got, [want] if last else want):
                k10_err = max(k10_err, relative_rmse(a.numpy(), b.numpy()))
            if not last:
                filt, fvar, lum = want
        state = denoise.DenoiseState(demod, m1, m2, hl, ins[4], normal)
        up = spatial.resize(torch.cat([ins[0], ins[4][..., None], ins[5]], dim=-1), 2 * h, 2 * w,
                            "bilinear").contiguous()
        for weight in (0.0, 0.9):
            want = K.temporal_resolve_plain(up, hist, weight, 2.0, 2.0)
            got = [torch.empty_like(t) for t in want]
            lib.k11(ctypes.c_void_p(up.data_ptr()), ctypes.c_void_p(hist.data_ptr()),
                    ctypes.c_void_p(got[0].data_ptr()), ctypes.c_void_p(got[1].data_ptr()),
                    2 * h, 2 * w, ctypes.c_float(weight), ctypes.c_float(2.0),
                    ctypes.c_float(2.0))
            for a, b in zip(got, want):
                k11_err = max(k11_err, relative_rmse(a.numpy(), b.numpy()))
        hist = want[1]
    assert k10_err < 1e-6 and k11_err < 1e-6, (k10_err, k11_err)


@pytest.mark.parametrize("method,src,dst,chans,clamp", [
    ("lanczos3", (43, 43), (64, 64), (3,), True),
    ("bilinear", (16, 24), (32, 48), (3, 0, 2), False),
    ("lanczos3", (20, 20), (13, 13), (6,), False),
    ("bilinear", (12, 20), (12, 41), (3, 0, 2), False)],
    ids=["spatial-chain", "temporal-chain", "downscale", "one-axis"])
def test_host_compiled_resize_bit_equal(presenter_lib, method, src, dst, chans, clamp):
    """K12's body (``resize_stage_px``, ``resize_row_px`` with each sum's
    taps in two pieces, ``resize_tap``, ``resize_out``) over every output
    pixel: bit-equal to ``resize_plain`` on sources with negative values
    (the clamp's case); a channel count 0 is an (h,w) source."""
    rng = np.random.default_rng(sum(src) + len(chans))
    h, w = src
    sources = [_t(rng.normal(size=src + ((c,) if c else ()))) for c in chans]
    rows = spatial.band_table(h, dst[0], method, torch.device("cpu"))
    cols = spatial.band_table(w, dst[1], method, torch.device("cpu"))
    want = K.resize_plain(sources, rows, cols, clamp)
    got = torch.empty_like(want)
    n_ch = [max(c, 1) for c in chans]
    presenter_lib.k12(_ptrs(sources + [None] * (3 - len(sources))),
                      (ctypes.c_int * 3)(*(n_ch + [0] * (3 - len(n_ch)))), h, w,
                      *(ctypes.c_void_p(t.data_ptr()) for t in (rows.first, rows.weights)),
                      rows.weights.shape[1],
                      *(ctypes.c_void_p(t.data_ptr()) for t in (cols.first, cols.weights)),
                      cols.weights.shape[1], *dst, int(clamp), ctypes.c_void_p(got.data_ptr()))
    assert _bits_equal(got, want)
    assert (bool((want < 0).any()) != clamp) and want.shape == dst + (sum(n_ch),)


def _c_ptrs(*ts):
    return (ctypes.c_void_p(t.data_ptr()) for t in ts)


@pytest.mark.parametrize("method,src,dst,chans,clamp,form", [
    ("lanczos3", (45, 139), (90, 278), (3,), True, "strip"),
    ("lanczos3", (7, 301), (13, 450), (3,), True, "strip"),
    ("lanczos3", (67, 343), (100, 512), (3,), True, "strip"),
    ("bilinear", (21, 135), (42, 270), (3, 1, 2), False, "strip"),
    ("lanczos3", (128, 640), (4, 10), (3, 1, 2), False, "tiles"),
    ("lanczos3", (40, 90), (23, 51), (3, 0, 2), False, "small-chunks")],
    ids=["2x-odd", "one-short-tile-row", "demo-ratio", "bilinear-6ch", "downscale-64x",
         "downscale-small-chunks"])
def test_host_compiled_resize_tiles_bit_equal(presenter_lib, method, src, dst, chans, clamp, form):
    """K12 over every tile and thread as its kernel runs it, the tile logic
    (``resize_strip_tile``, ``resize_strip_col``, ``resize_strip_cols``,
    ``resize_stage_plane``; ``resize_span``, ``resize_chunk_taps``)
    host-compiled from ``presenter.cuh``: the strip form at the rows a tile
    that the wrapper picks (partial tiles at the right and bottom edges, a
    single row of tiles shorter than a tile, and the demo's 686 -> 1024
    ratio), and the 32x32 tiles staged in the chunks the wrapper picks for
    a 64x downscale, or in chunks of 7 x 9 pixels. Bit-equal to
    ``resize_plain``, every output written (the output starts as NaN, the
    plain one has none)."""
    rng = np.random.default_rng(sum(src) + sum(dst))
    h, w = src
    sources = [_t(rng.normal(size=src + ((c,) if c > 1 else ()))) for c in chans if c]
    n_ch = [c for c in chans if c] + [0] * (3 - len([c for c in chans if c]))
    rows = spatial.band_table(h, dst[0], method, torch.device("cpu"))
    cols = spatial.band_table(w, dst[1], method, torch.device("cpu"))
    kr, kc = rows.weights.shape[1], cols.weights.shape[1]
    want = K.resize_plain(sources, rows, cols, clamp)
    assert not bool(want.isnan().any())
    got = torch.full_like(want, float("nan"))
    srcs = _ptrs(sources + [None] * (3 - len(sources)))
    cs = (ctypes.c_int * 3)(*n_ch)
    rt = K.resize_strip_rows(rows, cols, [c for c in chans if c], kr, kc)
    assert (rt == K.RESIZE_STRIP_ROWS) == (form == "strip")
    if form == "strip":
        presenter_lib.k12_strip(srcs, cs, w, *dst, *_c_ptrs(rows.first, rows.weights, cols.first,
                                                           cols.weights), kr, rt, int(clamp),
                                ctypes.c_void_p(got.data_ptr()))
    else:
        chunks = K._resize_chunks(rows, cols, sum(n_ch)) if form == "tiles" else (7, 9)
        assert chunks[0] < rows.span_h or chunks[1] < cols.span_w  # staged in chunks
        presenter_lib.k12_tiles(srcs, cs, h, w, *_c_ptrs(rows.first, rows.weights), kr,
                                *_c_ptrs(cols.first, cols.weights), kc, *dst, *chunks, int(clamp),
                                ctypes.c_void_p(got.data_ptr()))
    assert _bits_equal(got, want)


@pytest.mark.parametrize("method,src,dst,chans,want", [
    ("lanczos3", (1080, 1920), (2160, 3840), (3,), 16),
    ("bilinear", (1080, 1920), (2160, 3840), (3, 1, 2), 16),
    ("lanczos3", (686, 686), (1024, 1024), (3,), 16),
    ("lanczos3", (541, 963), (1082, 1926), (3,), 16),
    ("lanczos3", (1000, 1000), (1010, 1010), (3,), 0),
    ("bilinear", (1080, 1920), (2160, 3840), (6,), 0),
    ("lanczos3", (1080, 1920), (2160, 3840), (3, 1, 2), 0),
    ("lanczos3", (200, 200), (100, 100), (3,), 0)],
    ids=["E-4K-lanczos3", "E-4K-bilinear", "M-demo", "odd-2x", "near-1x-too-wide",
         "one-6ch-source", "lanczos3-6ch", "downscale"])
def test_resize_strip_rows(method, src, dst, chans, want):
    """The strip form's tile rows: 16 at run E's 4K (both forms), the
    demo's 1024^2 and the synthetic 963x541 frame's 2x; 0 (the 32x32
    tiles) where a tile's two stage buffers exceed the shared memory (a
    Lanczos-3 upscale near 1x, 21 input rows by 261 columns) and for shapes
    it is not compiled for."""
    cpu = torch.device("cpu")
    rows, cols = (spatial.band_table(n, m, method, cpu) for n, m in zip(src, dst))
    assert K.resize_strip_rows(rows, cols, chans, rows.weights.shape[1],
                               cols.weights.shape[1]) == want


def test_sass_tap_count(monkeypatch):
    """``sass_diff.tap_instructions`` on a made-up dump of an unrolled K10
    (6 instructions a tap, two ``MUFU.EX2`` each, predicated and not):
    the body's period per tap; a kernel without 50 raises."""
    from mrt_tpu_torch.kernels import sass_diff

    tap = ["LDS R2, [R3]", "@!P0 MUFU.EX2 R4, R5", "FADD R6, R6, R4", "FMUL R7, R7, R4",
           "@P1 MUFU.EX2 R8, R9", "FADD R6, R6, R8"]
    body = ["MOV R1, c[0x0][0x28]"] + tap * 25 + ["EXIT", "BRA `(.L_0)"]
    lines = [f"/*{16 * i:04x}*/ {op} ; /* 0x000fe20000000f00 */" for i, op in enumerate(body)]
    dumps = {"_Z18atrous_pass_kernelILi1EEvv": lines, "_Z13resize_kernelv": lines[:5]}
    monkeypatch.setattr(sass_diff, "dump", lambda binary: dumps)
    got = sass_diff.tap_instructions("lib.so")
    assert got == {1: dict(kernel="_Z18atrous_pass_kernelILi1EEvv", per_tap=6.0, ex2=50, rcp=0,
                           total=len(body))}
    assert sass_diff.instructions(lines[:3])[1:] == ["LDS", "MUFU.EX2"]
    dumps["_Z18atrous_pass_kernelILi1EEvv"] = lines[:-20]
    with pytest.raises(RuntimeError, match="MUFU.EX2"):
        sass_diff.tap_instructions("lib.so")


def test_sass_slot_count(monkeypatch):
    """``sass_diff.slot_instructions`` on a made-up dump of K12's strip form
    with K = 2 taps and C = 1 channel (a slot: 2 FMUL for an input row's
    width taps, 2 for an output row's height taps, 9 instructions): the
    instructions of a slot; a kernel whose FMUL count is not 2 K C K
    raises."""
    from mrt_tpu_torch.kernels import sass_diff

    slot = ["LDS R2, [R3]", "FMUL R4, R2, R5", "LDS R6, [R3+0x4]", "FMUL R7, R6, R8",
            "FADD R4, R4, R7", "FMUL R9, R4, R10", "FMUL R11, R12, R13", "FADD R9, R9, R11",
            "STG.E.128 [R14], R16"]
    body = ["S2R R0, SR_TID.X"] + slot * 2 + ["EXIT"]
    lines = [f"/*{16 * i:04x}*/ {op} ; /* 0x000fe20000000f00 */" for i, op in enumerate(body)]
    name = "_Z19resize_strip_kernelILi2ELi1ELi0ELi0EEvv"
    dumps = {name: lines, "_Z18atrous_pass_kernelILi1EEvv": lines[:3]}
    monkeypatch.setattr(sass_diff, "dump", lambda binary: dumps)
    assert sass_diff.slot_instructions("lib.so") == {"K2C1": dict(
        kernel=name, per_slot=9.0, fmul=4.0, fadd=2.0, lds=2.0, total=len(body))}
    dumps[name] = lines[:-5]
    with pytest.raises(RuntimeError, match="FMUL"):
        sass_diff.slot_instructions("lib.so")


def test_presenter_bounds():
    """K12's and K10's bounds at run E's shapes: K12 by bytes (each value
    once, the tables once; its operations a fraction), K10 by operations,
    and with a tap counted as its SASS issues it (94 instructions, the
    count ``chip_smoke.py`` prints) above the source's floor."""
    from mrt_tpu_torch.utils import bounds

    ms, by = bounds.resize(1080, 1920, 2160, 3840, 6, 2, 2)
    assert by == "bytes"
    assert ms == pytest.approx(((1080 * 1920 + 2160 * 3840) * 6 * 4 + (2160 * 3 + 3840 * 3) * 4)
                               / bounds.PEAK_BYTES * 1e3)
    ops = (1080 * 3840 * 11 + 2160 * 3840 * 11) * 3
    assert bounds.resize(1080, 1920, 2160, 3840, 3, 6, 6)[0] > ops / bounds.PEAK_F32_OPS * 1e3
    floor, sass = bounds.atrous_pass(1080, 1920), bounds.atrous_pass(1080, 1920, tap_ops=94)
    assert floor[1] == sass[1] == "operations" and sass[0] > 2 * floor[0]


def test_chip_smoke_phase_3p_on_cpu():
    """``chip_smoke.py``'s phase 3p at a small size on the CPU (where each
    wrapper is its plain version): the synthetic inputs reach the edges
    the phase is for, and every field it compares is found equal."""
    import chip_smoke
    from mrt_tpu_torch.kernels import present
    from mrt_tpu_torch.utils import bounds

    h, w = 36, 64
    inp = chip_smoke.synthetic_presenter_inputs(torch, torch.device("cpu"), h, w)
    state = denoise.DenoiseState(*inp["state"])
    assert float(state.history_length.max()) == 32.0 and inp["weights"][0] == 0.0
    assert float(inp["motion"].abs().max()) > w  # motion that leaves the image
    albedo = inp["gb"]["diffuse_albedo"] + inp["gb"]["specular_albedo"]
    assert bool((albedo == 0).all(dim=-1).any())  # zero albedo
    line = chip_smoke.check_presenter(torch, "cpu", inp, present, bounds)
    assert line["not_bit_equal"] == {} and line["k1_mismatches"] == 0
    assert len(line["fields"]) == 13 and line["times"] == {}


@pytest.mark.parametrize("mode, checked", [("spatial", True), ("temporal", False)])
def test_chip_smoke_phase_m_resize_check_on_cpu(monkeypatch, mode, checked):
    """``chip_smoke.py``'s K12 check at phase M's demo shape on the CPU, at
    the demo's 0.67 scale (48 -> 72; CUDA-event and profiler timing
    stubbed): the spatial present's resize is held against its plain
    version and the dense products; a renderer that presents through
    another chain is passed over."""
    from types import SimpleNamespace

    import chip_smoke

    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, reps: 0.0)
    monkeypatch.setattr(chip_smoke, "device_ms", lambda *a, **k: 0.0)
    rng = np.random.default_rng(7)
    accum = torch.from_numpy(rng.random((48, 40, 3), dtype=np.float32) * 2.0)
    r = SimpleNamespace(render_height=48, render_width=40, output_height=72, output_width=60,
                        upscaler_mode=mode, accum=accum)
    out = chip_smoke.check_spatial_resize(torch, "cpu", r)
    if not checked:
        assert out is None
        return
    assert out["taps"] == [6, 6] and out["output"] == [60, 72]
    assert out["fields"]["output"]["differing"] == 0
    assert out["vs_dense"] <= chip_smoke.RESIZE_DENSE_TOL and out["bound_by"] == "bytes"
