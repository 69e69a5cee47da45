"""K1's tonemap and quantize in the epilogue of the kernel that ends an
upscaled present (``csrc/present.cuh``, the uint8 forms of K11 and K12 in
``csrc/presenter.cuh``/``presenter.cu``), on the CPU:

- ``quantize`` compiled by the host compiler (``-ffp-contract=off``, as the
  card's ``-fmad=false``): uint8-equal to ``tonemap_quantize_plain`` on K1's
  edge cases (tolerance: none), and its quotient ``tone_div`` bit-equal to
  the IEEE division from reciprocals up to 2 ulp off;
- K12's uint8 strip form tile by tile and thread by thread, each warp's
  output row through ``store_row`` lane by lane, and its 32x32-tile form:
  equal to ``tonemap_quantize_plain(resize_plain(...))``, at output widths
  whose rows are 16-byte aligned (a width divisible by 16) and at widths
  whose rows are not, every byte written;
- K11's uint8 body against ``tonemap_quantize_plain`` of
  ``temporal_resolve_plain``: byte-equal to K1 on the f32 body's output,
  within 1 of the plain bytes and only where the f32 body differs from the
  plain version (the host's ``expf``/``sqrtf`` against PyTorch's CPU ones,
  as ``test_torch_presenter_kernels.py`` allows), the new history bit-equal
  to the f32 body's;
- ``present_device`` on the CPU in every mode equal to
  ``tonemap_quantize_plain(present_linear(r)[0])`` with the same new state,
  and within 1 LSB of the JAX package's ``present_device`` on the same
  buffers and state, made from a seed with numpy (one 16x16 render at
  32x32) under sub-pixel motion, and of its chain's ops run one by one
  under motion that leaves the image;
- a uint8 wrapper that raises reaches the caller of ``present_device``;
- the uint8 forms' bounds, and the wrappers' checks.
"""

import ctypes
import shutil
import subprocess
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrt_tpu.kernels.present import tonemap_quantize as jax_tonemap_quantize
from mrt_tpu.upscale import denoise as jdenoise
from mrt_tpu.upscale import presenter as jpresenter
from mrt_tpu.upscale import spatial as jspatial
from mrt_tpu.upscale import temporal as jtemporal
from mrt_tpu_torch.kernels import build, present
from mrt_tpu_torch.kernels import presenter as K
from mrt_tpu_torch.upscale import denoise, presenter, spatial
from mrt_tpu_torch.utils import bounds
from mrt_tpu_torch.utils.image import relative_rmse
from test_torch_scene_bvh import one_torch_thread  # noqa: F401

MODES = ("off", "spatial", "temporal", "denoised")

_HARNESS = r'''
#include <cstring>
#include <vector>
#include "presenter.cuh"
using namespace mrt_presenter;
extern "C" void quantize_all(const float* x, unsigned char* out, long long n) {
    for (long long i = 0; i < n; ++i) out[i] = mrt_tonemap::quantize(x[i]);
}
// quantize's quotient from a reciprocal k ulp off the correctly rounded one
extern "C" void tone_div_all(const float* x, float* out, long long n, int k) {
    for (long long i = 0; i < n; ++i) {
        float d = 1.0f + x[i], r = 1.0f / d;
        unsigned int u;
        memcpy(&u, &r, 4);
        u += k;
        memcpy(&r, &u, 4);
        out[i] = mrt_tonemap::tone_div(x[i], d, r);
    }
}
// K11's body per output pixel, as f32 (quantize 0) or uint8
extern "C" void k11(const float* up, const float* hist, void* out, float* new_hist, int h,
                    int w, float hw, float sx, float sy, int quantize) {
    for (long long p = 0; p < (long long)h * w; ++p) {
        if (quantize)
            temporal_resolve_px(p, h, w, up, (const float4*)hist, (unsigned char*)out,
                                (float4*)new_hist, hw, sx, sy);
        else
            temporal_resolve_px(p, h, w, up, (const float4*)hist, (float*)out, (float4*)new_hist,
                                hw, sx, sy);
    }
}
// K12's uint8 strip form (6 taps, 3 channels of one source) as its kernel
// runs it: per tile its plane and rows' table staged, every thread of the
// block on its column over the tile's rows putting its bytes into its
// warp's row buffer, then each warp's row stored lane by lane (store_row)
extern "C" void k12_strip_u8(const float* src, int w, int oh, int ow, const int* row_first,
                             const float* row_w, const int* col_first, const float* col_w, int rt,
                             unsigned char* out) {
    constexpr int K = 6, C = 3;
    int tiles_x = (ow + RESIZE_STRIP_W - 1) / RESIZE_STRIP_W;
    int tiles = tiles_x * ((oh + rt - 1) / rt);
    auto copy = [](float* d, const float* s) { *d = *s; };
    std::vector<float> planes;
    std::vector<unsigned char> rows((size_t)rt * RESIZE_STRIP_W * C + 16);
    // 16-byte aligned, as the kernel's shared row buffers
    unsigned char* rowbuf = rows.data() + ((16 - ((unsigned long long)rows.data() & 15)) & 15);
    for (int t = 0; t < tiles; ++t) {
        ResizeTile T = resize_strip_tile(t, tiles_x, rt, oh, ow, row_first, col_first, K, K);
        planes.assign((size_t)(T.r.hi - T.r.lo) * (T.c.hi - T.c.lo) * C + rt * (K + 1), NAN);
        float* pl = planes.data();
        resize_stage_plane<C>(src, w, T, pl + resize_plane_at<C, 0, 0>(T, 0), 0, 1, 0, 1, copy);
        resize_stage_table<K>(row_first, row_w, T, pl + resize_plane_at<C, 0, 0>(T, 3), 0, 1,
                              copy);
        for (int thread = 0; thread < RESIZE_STRIP_W; ++thread)
            resize_strip<K, C, 0, 0>(
                pl, T, resize_strip_col(T, thread), col_first, col_w,
                [&](int oy, const float* o) {
                    unsigned char* buf = rowbuf + ((size_t)(oy - T.oy0) * RESIZE_STRIP_W) * C;
                    for (int c = 0; c < C; ++c)
                        put(buf + thread * C + c, resize_out(o[c], true));
                });
        for (int oy = T.oy0; oy < T.oy1; ++oy)
            for (int warp = 0; warp < RESIZE_STRIP_WARPS; ++warp) {
                int n = resize_strip_cols(T, warp) * C;
                if (n <= 0) continue;
                const unsigned char* buf =
                    rowbuf + ((size_t)(oy - T.oy0) * RESIZE_STRIP_W + 32 * warp) * C;
                unsigned char* dst = out + ((long long)oy * ow + T.ox0 + 32 * warp) * C;
                for (int lane = 0; lane < 32; ++lane) store_row(buf, n, dst, lane);
            }
    }
}
// K12's uint8 32x32-tile form (any shape) per output pixel: all of an
// output's taps from the whole staged image, its bytes put as the tile
// epilogue puts them
extern "C" void k12_tiles_u8(const float* src, int h, int w, const int* row_first,
                             const float* row_w, int kr, const int* col_first, const float* col_w,
                             int kc, int oh, int ow, unsigned char* out) {
    constexpr int C = 3;
    ResizeSrc s = {{src, nullptr, nullptr}, {C, 0, 0}};
    std::vector<float> img((size_t)h * w * C);
    for (int r = 0; r < h; ++r)
        for (int c = 0; c < w; ++c) resize_stage_px(s, w, r, c, &img[((size_t)r * w + c) * C]);
    for (int oy = 0; oy < oh; ++oy)
        for (int ox = 0; ox < ow; ++ox) {
            float acc[C] = {}, sums[C];
            for (int k = 0; k < kr; ++k) {
                const float* x = &img[((size_t)(row_first[oy] + k) * w + col_first[ox]) * C];
                resize_row_px(x, C, col_w + (long long)ox * kc, 0, kc, sums, 1);
                for (int c = 0; c < C; ++c)
                    acc[c] = resize_tap(acc[c], sums[c], row_w[(long long)oy * kr + k], k);
            }
            for (int c = 0; c < C; ++c)
                put(out + ((long long)oy * ow + ox) * C + c, resize_out(acc[c], true));
        }
}
'''


@pytest.fixture(scope="module")
def fused_lib(tmp_path_factory):
    """present.cuh and presenter.cuh's uint8 forms compiled by the host
    compiler."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.fail("no host C++ compiler to build csrc/presenter.cuh with")
    d = tmp_path_factory.mktemp("present_fused")
    (d / "fused_host.cpp").write_text(_HARNESS)
    lib = d / "libfused_host.so"
    subprocess.run([cxx, "-O2", "-ffp-contract=off", "-fno-strict-aliasing", "-std=c++17",
                    "-shared", "-fPIC", f"-I{build.CSRC}", str(d / "fused_host.cpp"), "-o",
                    str(lib)], check=True, capture_output=True, timeout=120)
    return ctypes.CDLL(str(lib))


def _p(t):
    return ctypes.c_void_p(t.data_ptr())


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a, np.float32))


def test_host_quantize_equals_plain(fused_lib):
    """K1's body, the one ``quantize`` every uint8 form runs: uint8-equal
    to the plain version on zeros, tiny, huge and exact .5 landings, and on
    negative values, values near -1, the ends of the range where the
    quotient decides the byte (2^-60, 2^24) and their neighbours."""
    x = present.edge_case_inputs(48, 64, seed=3)
    edges = torch.tensor([0.0, -0.0, 2.0 ** -60, 2.0 ** 24, -1.0, -2.0, -0.5, 1e-38, 3e38, -3e38,
                          1e-45, 0.5, 1.0, 254.0, 255.0, 508.0, 509.0, 510.0])
    edges = torch.cat([edges, torch.nextafter(edges, torch.full_like(edges, float("inf"))),
                       torch.nextafter(edges, torch.full_like(edges, -float("inf")))])
    x = torch.cat([x.reshape(-1), edges])
    got = torch.empty(x.shape, dtype=torch.uint8)
    fused_lib.quantize_all(_p(x), _p(got), ctypes.c_longlong(x.numel()))
    assert torch.equal(got, present.tonemap_quantize_plain(x))


@pytest.mark.parametrize("k", [-2, -1, 0, 1, 2])
def test_host_tone_div_is_the_rounded_quotient(fused_lib, k):
    """``tone_div``, quantize's quotient where it decides the byte (2^-60
    <= c < 2^24), from a reciprocal up to 2 ulp off 1 / (1 + c) (the
    card's ``rcp.approx`` is within 1): bit-equal to the IEEE quotient
    ``c / (1 + c)`` on 2^20 values spread over that range's binades, each
    binade's ends and K1's exact .5 landings. (Every float of the range
    was checked so when the design was made.)"""
    g = torch.Generator().manual_seed(k + 2)
    logs = torch.rand(1 << 20, generator=g, dtype=torch.float64) * 84.0 - 60.0
    c = torch.exp2(logs).float()
    ends = torch.exp2(torch.arange(-60.0, 24.0)).float()
    x = torch.cat([c, ends, torch.nextafter(ends, torch.zeros_like(ends))[1:],
                   present.edge_case_inputs(16, 16).reshape(-1)])
    x = x[(x >= 2.0 ** -60) & (x < 2.0 ** 24)].contiguous()
    got = torch.empty_like(x)
    fused_lib.tone_div_all(_p(x), _p(got), ctypes.c_longlong(x.numel()), k)
    assert torch.equal(got.view(torch.int32), (x / (1.0 + x)).view(torch.int32))


@pytest.mark.parametrize("src,dst,form", [
    ((24, 40), (48, 80), "strip"),
    ((21, 49), (42, 98), "strip"),
    ((35, 171), (70, 342), "strip"),
    ((40, 90), (23, 51), "tiles"),
    ((64, 64), (2, 3), "tiles")],
    ids=["aligned-rows", "unaligned-rows", "partial-tile", "downscale", "downscale-64x"])
def test_host_resize_u8_equals_quantized_plain(fused_lib, src, dst, form):
    """K12's uint8 form (Lanczos-3 of 3 channels, clamped: the spatial
    present) equal to ``tonemap_quantize_plain`` of ``resize_plain``, every
    byte written (run over outputs filled with 0 and with 255). An output
    width divisible by 16 stores every row in 16-byte stores; 98 and 342
    give rows at 2-, 4- and 16-byte aligned offsets (the other stores), 342
    a partial last tile of 86 columns."""
    rng = np.random.default_rng(sum(src) + sum(dst))
    h, w = src
    x = _t(rng.normal(size=src + (3,)) * 2.0 + 0.5)  # negative values too (the clamp)
    rows = spatial.band_table(h, dst[0], "lanczos3", torch.device("cpu"))
    cols = spatial.band_table(w, dst[1], "lanczos3", torch.device("cpu"))
    kr, kc = rows.weights.shape[1], cols.weights.shape[1]
    want = present.tonemap_quantize_plain(K.resize_plain((x,), rows, cols, True))
    assert torch.equal(K.resize((x,), rows, cols, True, quantize=True), want)
    rt = K.resize_strip_rows(rows, cols, [3], kr, kc)
    assert (rt == K.RESIZE_STRIP_ROWS) == (form == "strip")
    if form == "strip":
        aligned = [(oy * dst[1] * 3) % 16 == 0 for oy in range(dst[0])]
        assert all(aligned) == (dst[1] % 16 == 0) and any(aligned)
    for fill in (0, 255):
        got = torch.full(want.shape, fill, dtype=torch.uint8)
        if form == "strip":
            fused_lib.k12_strip_u8(_p(x), w, *dst, _p(rows.first), _p(rows.weights),
                                   _p(cols.first), _p(cols.weights), rt, _p(got))
        else:
            fused_lib.k12_tiles_u8(_p(x), h, w, _p(rows.first), _p(rows.weights), kr,
                                   _p(cols.first), _p(cols.weights), kc, *dst, _p(got))
        assert torch.equal(got, want), fill


@pytest.mark.parametrize("size", [(7, 9), (16, 24)])
def test_host_temporal_resolve_u8(fused_lib, size):
    """K11's uint8 body: K1's bytes of the f32 body's output, within 1 of
    the plain bytes where the f32 body and the plain version differ (host
    ``expf``/``sqrtf``) and equal elsewhere; its history bit-equal to the
    f32 body's."""
    h, w = size
    oh, ow = 2 * h, 2 * w
    rng = np.random.default_rng(h * w)
    up = _t(np.concatenate([rng.random((oh, ow, 3)) * 3.0, 1.0 + 0.1 * rng.random((oh, ow, 1)),
                            rng.uniform(-w, w, (oh, ow, 2))], axis=-1))
    hist = _t(np.concatenate([rng.random((oh, ow, 3)) * 3.0, 1.0 + 0.1 * rng.random((oh, ow, 1))],
                             axis=-1))
    for weight in (0.0, 0.9):
        args = (oh, ow, ctypes.c_float(weight), ctypes.c_float(2.0), ctypes.c_float(2.0))
        out_f, hist_f = torch.empty((oh, ow, 3)), torch.empty((oh, ow, 4))
        out_8, hist_8 = torch.empty((oh, ow, 3), dtype=torch.uint8), torch.empty((oh, ow, 4))
        fused_lib.k11(_p(up), _p(hist), _p(out_f), _p(hist_f), *args, 0)
        fused_lib.k11(_p(up), _p(hist), _p(out_8), _p(hist_8), *args, 1)
        plain, _ = K.temporal_resolve_plain(up, hist, weight, 2.0, 2.0)
        k1 = torch.empty_like(out_8)
        fused_lib.quantize_all(_p(out_f), _p(k1), ctypes.c_longlong(out_f.numel()))
        assert torch.equal(out_8, k1) and torch.equal(hist_8.view(torch.int32),
                                                      hist_f.view(torch.int32))
        diff = (out_8.int() - present.tonemap_quantize_plain(plain).int()).abs()
        assert int(diff.max()) <= 1
        assert not bool((diff > 0)[out_f.view(torch.int32) == plain.view(torch.int32)].any())


def _buffers(mode, seed=0, reach=2.0):
    """A 16x16 render presented at 32x32 (at 16x16 in the off mode): the
    accumulation, depth, motion (up to ``reach`` render pixels a frame),
    G-buffer, history and denoiser state as numpy arrays made from
    ``seed``; the state's variance (second moment less the first's square)
    at least 0.05."""
    rng = np.random.default_rng(seed)
    h = w = 16
    oh, ow = (h, w) if mode == "off" else (2 * h, 2 * w)
    n = rng.normal(size=(h, w, 3))
    n[..., 1] += 3.0
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    f = np.float32
    depth = (1.0 + 0.01 * rng.random((h, w))).astype(f)
    m1 = rng.random((h, w))  # the moments as a frame leaves them: m2 >= m1^2
    return dict(
        out=(oh, ow), accum=(rng.random((h, w, 3)) * 3.0).astype(f), depth=depth,
        motion=rng.uniform(-reach, reach, (h, w, 2)).astype(f),
        gbuffer=dict(diffuse_albedo=(rng.random((h, w, 3)) * 0.8).astype(f),
                     specular_albedo=(rng.random((h, w, 3)) * 0.1).astype(f),
                     normal=(n * 0.5 + 0.5).astype(f), roughness=rng.random((h, w)).astype(f)),
        history=np.concatenate([rng.random((oh, ow, 3)) * 3.0,
                                1.0 + 0.01 * rng.random((oh, ow, 1))], axis=-1).astype(f),
        state=((rng.random((h, w, 3)) * 2.0).astype(f), m1.astype(f),
               (m1 * m1 + 0.05 + 0.1 * rng.random((h, w))).astype(f),
               np.floor(rng.random((h, w)) * 33.0).astype(f), depth.copy(), n.astype(f)))


def _renderer(mode, b, to):
    """A renderer's presenter view of buffers ``b``: ``to`` makes each array
    the framework's (torch or jnp)."""
    return SimpleNamespace(
        upscaler_mode=mode, output_height=b["out"][0], output_width=b["out"][1],
        accumulation_weight=0.9, accum=to(b["accum"]), depth=to(b["depth"]),
        motion=to(b["motion"]), gbuffer={k: to(v) for k, v in b["gbuffer"].items()},
        _upscale_history=to(b["history"]),
        _denoise_state=(denoise.DenoiseState if to is _t else jdenoise.DenoiseState)(
            *(to(a) for a in b["state"])))


@pytest.mark.parametrize("mode", MODES)
def test_present_device_is_the_quantized_linear_present(mode):
    """On the CPU, in every mode: the uint8 image of ``present_device``
    (the chain's last kernel in its uint8 form, or K1 on the accumulation)
    equals ``tonemap_quantize_plain`` of ``present_linear``'s output, and
    the new state is the same; no kernel launched."""
    b = _buffers(mode)
    present.launches = 0
    K.reset_launches()
    r = _renderer(mode, b, _t)
    lin, hist, dstate = presenter.present_linear(r)
    img = presenter.present_device(r)
    assert img.dtype == torch.uint8 and img.shape == b["out"] + (3,)
    assert torch.equal(img, present.tonemap_quantize_plain(lin))
    if mode in ("temporal", "denoised"):
        assert torch.equal(r._upscale_history, hist)
    if mode == "denoised":
        assert all(torch.equal(a, c) for a, c in zip(r._denoise_state, dstate))
    assert present.launches == 0 and K.launches == dict.fromkeys(K.KERNELS, 0)


def _jax_ops(mode, rj, out):
    """The JAX package's chain for ``mode`` run op by op on ``rj``'s buffers
    and state: (uint8 image, new history or None, new DenoiseState or
    None)."""
    color, hist, dstate = rj.accum, None, None
    if mode == "denoised":
        color, dstate = jdenoise.svgf_filter(color, rj.gbuffer, rj.depth, rj.motion,
                                             rj._denoise_state)
    if mode in ("temporal", "denoised"):
        color, hist = jtemporal.temporal_upscale(color, rj.depth, rj.motion, rj._upscale_history,
                                                 *out, 0.9)
    elif mode == "spatial":
        color = jspatial.upscale(color, *out)
    return np.asarray(jax_tonemap_quantize(color)), hist, dstate


def _check_state(rp, hist, dstate):
    if hist is not None:
        assert relative_rmse(rp._upscale_history.numpy(), hist) < 1e-5
    if dstate is not None:
        for a, c in zip(rp._denoise_state, dstate):
            assert relative_rmse(a.numpy(), c) < 1e-5


@pytest.mark.parametrize("mode", MODES)
def test_present_device_matches_jax(mode):
    """The port's ``present_device`` against the JAX package's on the same
    buffers and state of a still frame (every history tap valid): the
    image within 1 LSB (the bar of ``test_torch_presenter.py``); the new
    history and DenoiseState within 1e-5 relative RMSE of the JAX chain's
    ops run one by one. (The JAX package's jitted ``present_device``
    leaves a history up to 8e-5 off its own ops run one by one on such
    made-up frames: where the denoiser's variance is small, its luma weight
    ``exp(-|dl| / (4 sqrt(var) + 1e-4))`` magnifies last-place
    differences.)"""
    b = _buffers(mode, seed=1, reach=0.0)
    rp, rj = _renderer(mode, b, _t), _renderer(mode, b, jnp.asarray)
    img_p = presenter.present_device(rp).numpy()
    img_j = np.asarray(jpresenter.present_device(_renderer(mode, b, jnp.asarray)))
    assert img_p.shape == img_j.shape == b["out"] + (3,)
    assert int(np.abs(img_p.astype(int) - img_j.astype(int)).max()) <= 1
    _check_state(rp, *_jax_ops(mode, rj, b["out"])[1:])


@pytest.mark.parametrize("mode", ["temporal", "denoised"])
def test_present_device_matches_jax_ops_with_motion_leaving_the_image(mode):
    """Motion up to 2 render pixels (history taps off the image, the
    denoiser's moments restarted there at a variance of 0, where the JAX
    package's jitted chain differs from its own ops by several LSB): the
    port's ``present_device`` within 1 LSB of the JAX chain's ops run one
    by one (``svgf_filter``, ``temporal_upscale``, ``tonemap_quantize``),
    the new state within 1e-5 relative RMSE."""
    b = _buffers(mode, seed=1, reach=2.0)
    rp, rj = _renderer(mode, b, _t), _renderer(mode, b, jnp.asarray)
    img_p = presenter.present_device(rp).numpy()
    img_j, hist, dstate = _jax_ops(mode, rj, b["out"])
    assert int(np.abs(img_p.astype(int) - img_j.astype(int)).max()) <= 1
    _check_state(rp, hist, dstate)


@pytest.mark.parametrize("wrapper,mode", [("resize", "spatial"), ("temporal_resolve", "temporal"),
                                          ("temporal_resolve", "denoised")])
def test_uint8_wrapper_error_reaches_the_caller(monkeypatch, wrapper, mode):
    """``present_device`` takes its route by mode and shape, not by catching
    an error: where the uint8 form raises, the error reaches its caller (no
    fall back to the f32 form and K1)."""
    real = getattr(K, wrapper)
    at = {"resize": 4, "temporal_resolve": 5}[wrapper]  # ``quantize``'s position

    def raising(*args, **kw):
        if kw.get("quantize", len(args) > at and args[at]):
            raise RuntimeError(f"{wrapper} uint8 form failed")
        return real(*args, **kw)

    monkeypatch.setattr(K, wrapper, raising)
    r = _renderer(mode, _buffers(mode), _t)
    presenter.present_linear(r)  # the f32 chain does not reach the uint8 form
    with pytest.raises(RuntimeError, match="uint8 form failed"):
        presenter.present_device(r)


def test_uint8_forms_checks_and_bounds():
    """``resize(..., quantize=True)`` takes 3 channels in all; the uint8
    forms' bounds write 1 B an output value, and each present's bound is
    below the f32 chain's with K1 (K1's own at render size)."""
    x = torch.ones((6, 8, 3))
    rows, cols = (spatial.band_table(n, 2 * n, "bilinear", torch.device("cpu")) for n in (6, 8))
    with pytest.raises(ValueError, match="3 channels"):
        K.resize((x, x[..., 0].contiguous()), rows, cols, quantize=True)
    assert K.resize((x,), rows, cols, quantize=True).dtype == torch.uint8
    ms8, by8 = bounds.resize(1080, 1920, 2160, 3840, 3, 6, 6, quantize=True)
    ms, by = bounds.resize(1080, 1920, 2160, 3840, 3, 6, 6)
    assert by == "bytes" and ms8 < 0.5 * ms
    assert bounds.temporal_resolve(2160, 3840, True)[0] < bounds.temporal_resolve(2160, 3840)[0]
    for mode in ("spatial", "temporal", "denoised"):
        fused, f32 = (bounds.present(mode, 1080, 1920, 2160, 3840, fused=f)[0]
                      for f in (True, False))
        assert fused < f32 - bounds.k1((2160, 3840, 3))[0] * 0.99
    assert bounds.present("spatial", 576, 1024, 576, 1024) == bounds.k1((576, 1024, 3))


def test_chip_smoke_phase_3p_uint8_on_cpu():
    """``chip_smoke.py``'s phase-3p checks of the uint8 forms on the CPU at
    an odd size (where each wrapper is its plain version): every form
    checked, every byte and history bit equal."""
    import chip_smoke

    inp = chip_smoke.synthetic_presenter_inputs(torch, torch.device("cpu"), 27, 49)
    line = chip_smoke.check_presenter(torch, "cpu", inp, present, bounds)
    assert sorted(line["u8"]) == sorted(
        ["resize_u8 lanczos3 3ch clamped", "resize_u8 lanczos3 3ch downscale"]
        + [f"temporal_resolve_u8 {c} weight {hw}" for c in ("temporal", "denoised")
           for hw in inp["weights"]])
    assert all(d["vs_k1"] == d["vs_plain"] == d.get("history_differing", 0) == 0
               for d in line["u8"].values())


@pytest.mark.parametrize("mode", MODES)
def test_chip_smoke_e_mode_checks_present_device_on_cpu(mode):
    """``chip_smoke.py``'s run-E check on the CPU (where each wrapper is its
    plain version): the main path's ``present_device`` byte-equal to K1 on
    the linear chain's output and handing over the linear chain's state,
    the renderer's own state put back after; an image one byte off, or a
    stale state handed over, fails the check."""
    import chip_smoke
    from mrt_tpu_torch.core import types as T

    r = _renderer(mode, _buffers(mode), _t)
    r.present_device = lambda: presenter.present_device(r)
    before = (r._upscale_history, r._denoise_state)
    out, _ = chip_smoke.check_e_mode(torch, r, present, presenter, T)
    assert out["present_device"] == dict(vs_k1=0, lsb=0, state_bit_equal=True)
    assert r._upscale_history is before[0] and r._denoise_state is before[1]

    def off_by_one():
        img = presenter.present_device(r)
        img[0, 0, 0] ^= 1
        return img

    def stale_history():
        img = presenter.present_device(r)
        object.__setattr__(r, "_upscale_history", before[0])
        return img

    for wrong in (off_by_one,) + ((stale_history,) if mode in ("temporal", "denoised") else ()):
        r.present_device = wrong
        with pytest.raises(AssertionError, match="present_device disagrees"):
            chip_smoke.check_e_mode(torch, r, present, presenter, T)
