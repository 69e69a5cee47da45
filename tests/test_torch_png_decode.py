"""The port's PNG decoder (``mrt_tpu_torch/utils/image.py:decode_png``) and
baseline JPEG decoder (``mrt_tpu_torch/utils/jpeg.py:decode_jpeg``), which
``assets/texture.py:load_image`` uses for such textures PIL or no PIL,
against PIL's ``Image.open(...).convert("RGB")``, uint8-equal.

Images are made from numpy seeds and written by a small encoder here, so
that every non-interlaced 8-bit colour type (0 grey, 2 RGB, 3 palette, 4
grey + alpha, 6 RGBA) meets every filter (0-4, Paeth included) on every
row, and rows of mixed filters; PIL's own writer adds its choice of
filters; every bit depth, Adam7 and the JPEG samplings are held to PIL too.
``load_image`` is also held to PIL's result with PIL unimportable (PNGs and
baseline JPEGs still decode; a progressive JPEG gives None).
"""

import io
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from mrt_tpu_torch.assets import texture as tex
from mrt_tpu_torch.utils.image import decode_png, read_png
from mrt_tpu_torch.utils.jpeg import decode_jpeg

CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
FILTERS = ["0", "1", "2", "3", "4", "mixed"]


def _predict(ft: int, a, b, c):
    if ft == 0:
        return 0
    if ft == 1:
        return a
    if ft == 2:
        return b
    if ft == 3:
        return (a + b) // 2
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
         (1, 0, 2, 1))
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


def _row_bytes(row: np.ndarray, depth: int) -> np.ndarray:
    """One scanline's samples (w * bpp ints) packed big-endian at ``depth``
    bits, a byte-aligned row."""
    s = row.reshape(-1).astype(np.int64)
    if depth == 16:
        return np.stack([s >> 8, s & 255], 1).reshape(-1)
    if depth < 8:
        per = 8 // depth
        t = np.zeros(-(-s.size // per) * per, np.int64)
        t[:s.size] = s
        return (t.reshape(-1, per) << (depth * np.arange(per - 1, -1, -1))).sum(1)
    return s


def _filtered(px: np.ndarray, filters, depth: int) -> bytes:
    h, w, bpp = px.shape
    step = max(1, bpp * depth // 8)  # filters look one pixel (at least a byte) back
    rows, prev = [], None
    for y in range(h):
        cur = _row_bytes(px[y], depth)
        prev = np.zeros_like(cur) if prev is None else prev
        a = np.concatenate([np.zeros(step, np.int64), cur[:-step]])
        c = np.concatenate([np.zeros(step, np.int64), prev[:-step]])
        ft = filters[y % len(filters)]
        filtered = (cur - _predict(ft, a, prev, c)) % 256
        rows.append(bytes([ft]) + filtered.astype(np.uint8).tobytes())
        prev = cur
    return b"".join(rows)


def _encode(px: np.ndarray, ctype: int, filters, palette=None, depth: int = 8,
            interlace: int = 0) -> bytes:
    """A PNG of the (h, w, bpp) samples ``px`` at ``depth`` bits, row y
    filtered with ``filters[y]`` (cycled); with ``interlace`` the seven
    Adam7 passes, each filtered as an image of its own."""
    h, w, bpp = px.shape
    if interlace:
        body = b"".join(_filtered(px[y0::dy, x0::dx], filters, depth)
                        for y0, x0, dy, dx in ADAM7 if y0 < h and x0 < w)
    else:
        body = _filtered(px, filters, depth)

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(
            ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)

    head = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", head)
    if palette is not None:
        out += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return out + chunk(b"IDAT", zlib.compress(body)) + chunk(b"IEND", b"")


def _pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _image(ctype: int, seed: int, h: int = 23, w: int = 37):
    """Seeded samples with smooth and noisy parts (every filter's
    predictions matter), and a palette for type 3."""
    rng = np.random.default_rng(seed)
    bpp = CHANNELS[ctype]
    yy, xx = np.mgrid[:h, :w]
    smooth = (yy[..., None] * 7 + xx[..., None] * 3 + np.arange(bpp) * 50) % 256
    px = np.where(rng.random((h, w, bpp)) < 0.5, smooth, rng.integers(0, 256, (h, w, bpp)))
    palette = None
    if ctype == 3:
        palette = rng.integers(0, 256, (200, 3))
        px = px % 200
    return px.astype(np.uint8), palette


@pytest.mark.parametrize("filt", FILTERS)
@pytest.mark.parametrize("ctype", sorted(CHANNELS))
def test_decode_matches_pil(ctype, filt):
    px, palette = _image(ctype, seed=ctype * 10 + len(filt) + int(filt == "mixed"))
    h = px.shape[0]
    filters = [y % 5 for y in range(h)] if filt == "mixed" else [int(filt)] * h
    data = _encode(px, ctype, filters, palette)
    want = _pil_rgb(data)
    got = decode_png(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("mode", ["L", "RGB", "P", "LA", "RGBA"])
def test_decode_matches_pil_writer(mode, tmp_path):
    rng = np.random.default_rng(len(mode))
    rgba = rng.integers(0, 256, (41, 29, 4), dtype=np.uint8)
    rgba[:20] = rgba[:20] // 16 * 16  # a smooth band: PIL's writer then filters rows
    img = Image.fromarray(rgba, "RGBA").convert(mode)
    path = tmp_path / f"{mode}.png"
    img.save(path)
    want = np.asarray(Image.open(path).convert("RGB"))
    assert np.array_equal(read_png(str(path)), want)
    got = tex.load_image(str(path))
    assert got.dtype == np.float32 and np.array_equal(got, want.astype(np.float32) / 255.0)


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("ctype,depth", [(c, d) for c, ds in sorted(DEPTHS.items()) for d in ds])
def test_decode_every_depth_matches_pil(ctype, depth, interlace):
    """Every colour type at every bit depth PNG allows, plain and Adam7, at
    sizes where passes are empty or one pixel wide and sub-byte rows end
    mid-byte: uint8-equal to PIL's ``convert("RGB")`` (16-bit grey
    saturates, 16-bit colour keeps the high byte)."""
    for h, w in ((23, 37), (1, 1), (3, 2), (9, 17)):
        rng = np.random.default_rng(ctype * 100 + depth * 2 + interlace + h)
        palette = None
        if ctype == 3:
            n = min(1 << depth, 200)
            palette = rng.integers(0, 256, (n, 3))
            px = rng.integers(0, n, (h, w, 1))
        else:
            px = rng.integers(0, 1 << depth, (h, w, CHANNELS[ctype]))
            if depth == 16:  # both sides of the 8-bit saturation
                px.flat[0], px.flat[-1] = 255, 256
        data = _encode(px, ctype, [0, 1, 2, 3, 4], palette, depth=depth, interlace=interlace)
        want = _pil_rgb(data)
        got = decode_png(data)
        assert got.dtype == np.uint8 and got.shape == want.shape == (h, w, 3)
        assert np.array_equal(got, want), (h, w)


def test_sixteen_bit_grey_saturates():
    """The rule PIL follows for 16-bit grey, written out: min(v, 255)."""
    vals = np.array([0, 255, 256, 4095, 65535])
    data = _encode(vals.reshape(1, 5, 1), 0, [0], depth=16)
    assert _pil_rgb(data)[0, :, 0].tolist() == [0, 255, 255, 255, 255]
    assert np.array_equal(decode_png(data), _pil_rgb(data))


def _jpeg_image(h: int, w: int, seed: int) -> np.ndarray:
    """Smooth gradients with a share of noisy pixels (every coefficient
    band and clipped IDCT outputs)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([(yy * 5 + xx * 3) % 256, (xx * 7) % 256, (yy * 11 + 50) % 256], -1)
    noise = rng.integers(0, 256, (h, w, 3))
    return np.where(rng.random((h, w, 1)) < 0.3, noise, base).astype(np.uint8)


JPEG_SAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2, "grey": 0, "rgb": 0}


@pytest.mark.parametrize("restart", [0, 1, 3])
@pytest.mark.parametrize("sampling", sorted(JPEG_SAMPLING))
def test_decode_jpeg_matches_pil(sampling, restart):
    """Baseline JPEGs as PIL writes them (libjpeg-turbo), in every chroma
    sampling, grey and RGB (no colour transform, an Adobe marker), with and
    without restart intervals, at sizes that
    are and are not whole MCUs and at three qualities: the decoder is
    uint8-equal to PIL's ``convert("RGB")`` (the bar reached: 0 LSB)."""
    for h, w in ((64, 64), (37, 53), (1, 1), (9, 17), (16, 3), (2, 2)):
        for q in (95, 50, 10):
            img = Image.fromarray(_jpeg_image(h, w, h * w + q))
            if sampling == "grey":
                img = img.convert("L")
            buf = io.BytesIO()
            kw = dict(quality=q, subsampling=JPEG_SAMPLING[sampling], keep_rgb=sampling == "rgb")
            if restart:
                kw["restart_marker_blocks"] = restart
            img.save(buf, "JPEG", **kw)
            data = buf.getvalue()
            assert (b"\xff\xdd" in data) == bool(restart)
            want = _pil_rgb(data)
            got = decode_jpeg(data)
            assert got.dtype == np.uint8 and got.shape == want.shape == (h, w, 3)
            assert np.array_equal(got, want), (h, w, q)


def test_decode_jpeg_refuses_progressive():
    buf = io.BytesIO()
    Image.fromarray(_jpeg_image(16, 16, 0)).save(buf, "JPEG", progressive=True)
    with pytest.raises(ValueError, match="progressive"):
        decode_jpeg(buf.getvalue())


def test_load_image_without_pil(tmp_path, monkeypatch):
    """With PIL unimportable (as on a machine without it), ``load_image``
    textures 8-bit, 16-bit, sub-byte and Adam7 PNGs and baseline JPEGs
    uint8-equal to what PIL gives with PIL present; a progressive JPEG,
    which only PIL reads, and a missing file give None."""
    px, _ = _image(6, seed=3)
    rng = np.random.default_rng(4)
    files = {
        "t.png": _encode(px, 6, [4] * px.shape[0]),
        "sixteen.png": _encode(rng.integers(0, 1 << 16, (23, 37, 1)), 0, [1], depth=16),
        "normal16.png": _encode(rng.integers(0, 1 << 16, (23, 37, 3)), 2, [4], depth=16),
        "two_bit.png": _encode(rng.integers(0, 4, (23, 37, 1)), 0, [2], depth=2),
        "adam7.png": _encode(px, 6, [0, 1, 2, 3, 4], interlace=1),
    }
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
    for name, sub in (("t.jpg", 2), ("t444.jpg", 0)):
        Image.fromarray(px[..., :3]).save(tmp_path / name, quality=90, subsampling=sub)
    Image.fromarray(px[..., :3]).save(tmp_path / "p.jpg", progressive=True)
    names = sorted(files) + ["t.jpg", "t444.jpg"]
    want = {n: np.asarray(Image.open(tmp_path / n).convert("RGB"), np.float32) / 255.0
            for n in names + ["p.jpg"]}
    assert np.array_equal(tex.load_image(str(tmp_path / "p.jpg")), want["p.jpg"])
    monkeypatch.setitem(sys.modules, "PIL", None)  # import PIL now raises
    with pytest.raises(ImportError):
        import PIL  # noqa: F401
    for n in names:
        got = tex.load_image(str(tmp_path / n))
        assert got is not None and got.dtype == np.float32, n
        assert np.array_equal(got, want[n]), n
    assert tex.load_image(str(tmp_path / "p.jpg")) is None
    assert tex.load_image(str(tmp_path / "missing.png")) is None
