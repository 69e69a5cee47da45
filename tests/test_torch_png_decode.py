"""The port's PNG decoder (``mrt_tpu_torch/utils/image.py:decode_png``),
which ``assets/texture.py:load_image`` uses for PNG textures PIL or no PIL,
against PIL's ``Image.open(...).convert("RGB")``, uint8-equal.

Images are made from numpy seeds and written by a small encoder here, so
that every non-interlaced 8-bit colour type (0 grey, 2 RGB, 3 palette, 4
grey + alpha, 6 RGBA) meets every filter (0-4, Paeth included) on every
row, and rows of mixed filters; PIL's own writer adds its choice of
filters. ``load_image`` is also held to PIL's result with PIL unimportable
(a PNG still decodes; another file gives None, as before).
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


def _encode(px: np.ndarray, ctype: int, filters, palette=None, depth: int = 8) -> bytes:
    """A PNG of the (h, w, bpp) uint8 sample bytes ``px``, row y filtered
    with ``filters[y]``."""
    h, w, bpp = px.shape
    rows, prev = [], np.zeros(w * bpp, np.int64)
    for y in range(h):
        cur = px[y].reshape(-1).astype(np.int64)
        a = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        ft = filters[y]
        filtered = (cur - _predict(ft, a, prev, c)) % 256
        rows.append(bytes([ft]) + filtered.astype(np.uint8).tobytes())
        prev = cur

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(
            ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)

    head = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", head)
    if palette is not None:
        out += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return out + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b"")


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


def test_load_image_without_pil(tmp_path, monkeypatch):
    px, _ = _image(6, seed=3)
    png = tmp_path / "t.png"
    png.write_bytes(_encode(px, 6, [4] * px.shape[0]))
    jpg = tmp_path / "t.jpg"
    Image.fromarray(px[..., :3]).save(jpg)
    want = _pil_rgb(png.read_bytes()).astype(np.float32) / 255.0
    assert tex.load_image(str(jpg)) is not None  # PIL reads what the decoder does not
    monkeypatch.setitem(sys.modules, "PIL", None)  # import PIL now raises
    with pytest.raises(ImportError):
        import PIL  # noqa: F401
    assert np.array_equal(tex.load_image(str(png)), want)
    assert tex.load_image(str(jpg)) is None
    assert tex.load_image(str(tmp_path / "missing.png")) is None
    sixteen = tmp_path / "sixteen.png"  # 16-bit grey: not the decoder's, and no PIL
    sixteen.write_bytes(_encode(px[..., :2], 0, [1] * px.shape[0], depth=16))
    with pytest.raises(ValueError, match="8-bit"):
        read_png(str(sixteen))
    assert tex.load_image(str(sixteen)) is None
