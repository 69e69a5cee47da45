"""Image metrics and golden IO — a NumPy copy of ``mrt_tpu/utils/image.py``:
golden renders are kept as compressed arrays and compared by RMSE; and the
port's image files, with no imaging library: ``write_png`` (zlib) and
``write_gif`` (animated, one fixed palette); ``read_png``/``decode_png``,
which read any PNG (the texture files too), and ``read_gif``, which reads
back what ``write_gif`` writes. Baseline JPEG textures are decoded by
``utils/jpeg.py``."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    return float(np.sqrt(np.mean((a - b) ** 2)))


def relative_rmse(a: np.ndarray, b: np.ndarray) -> float:
    """RMSE normalized by the reference's RMS (the '1% RMSE' metric)."""
    b = np.asarray(b, np.float64)
    denom = float(np.sqrt(np.mean(b**2)))
    return rmse(a, b) / max(denom, 1e-12)


def save_golden(path: str, image: np.ndarray):
    np.savez_compressed(path, image=np.asarray(image, np.float32))


def load_golden(path: str) -> np.ndarray:
    return np.load(path)["image"]


def write_png(path: str, image_u8: np.ndarray):
    """Write an (H,W,3) uint8 RGB image as an 8-bit PNG, row 0 at the top."""
    img = np.ascontiguousarray(image_u8, np.uint8)
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"write_png wants (H,W,3) RGB, got {img.shape}")
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + chunk(b"IEND", b""))


PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples per pixel of each colour type (grey, RGB, palette index, grey +
# alpha, RGBA) and the bit depths PNG allows it
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7's seven passes: first row, first column, row step, column step
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
          (1, 0, 2, 1))


def read_png(path: str) -> np.ndarray:
    """The (H,W,3) uint8 RGB image of a PNG file (see ``decode_png``)."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def decode_png(data: bytes, name: str = "PNG") -> np.ndarray:
    """The (H,W,3) uint8 RGB image of a PNG of any colour type and bit depth
    (filters 0-4, plain or Adam7-interlaced), as PIL's ``convert("RGB")``
    gives it:

    - grey of 1, 2 or 4 bits is scaled to 8 bits (x 255, 85, 17), grey of
      16 bits saturates (PIL opens it as mode ``I;16``, whose ``RGB`` is
      ``min(v, 255)``), then it is replicated;
    - 16-bit grey + alpha, RGB and RGBA keep each sample's high byte (PIL
      opens them as the 8-bit modes ``RGBA``, ``RGB`` and ``RGBA``);
    - alpha is dropped and palette indices (1-8 bits) are looked up.

    Raises ``ValueError`` on a depth the colour type does not allow, a bad
    chunk CRC, short scanlines or a palette index past the palette."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{name}: not a PNG")
    pos, head, palette, idat = 8, None, None, []
    while pos + 12 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if (len(body) != n or struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
                != zlib.crc32(kind + body)):
            raise ValueError(f"{name}: bad CRC in chunk {kind!r}")
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if head is None:
        raise ValueError(f"{name}: no IHDR chunk")
    w, h, depth, ctype, comp, filt, interlace = head
    if (depth not in _PNG_DEPTHS.get(ctype, ()) or (comp, filt) != (0, 0)
            or interlace not in (0, 1)):
        raise ValueError(f"{name}: not a PNG of a colour type and bit depth PNG defines: {head}")
    ch = _PNG_CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if not interlace:
        px = _scanlines(raw, h, w, ch, depth, name)[0]
    else:
        px = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
        used = 0
        for y0, x0, dy, dx in _ADAM7:
            ph, pw = len(range(y0, h, dy)), len(range(x0, w, dx))
            if ph and pw:  # an empty pass has no scanlines, not even filter bytes
                px[y0::dy, x0::dx], n = _scanlines(raw[used:], ph, pw, ch, depth, name)
                used += n
    if ctype == 3:
        if palette is None or int(px.max(initial=0)) >= palette.shape[0]:
            raise ValueError(f"{name}: a palette index past the palette")
        return palette[px[..., 0]]
    if ctype == 0:
        grey = (np.minimum(px, 255) if depth == 16 else px * (255 // ((1 << depth) - 1)))
        return np.repeat(grey.astype(np.uint8), 3, axis=2)
    if depth == 16:
        px = (px >> 8).astype(np.uint8)
    if ctype == 4:
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def _scanlines(raw: np.ndarray, h: int, w: int, ch: int, depth: int, name: str):
    """The (h, w, ch) samples (uint16 at 16 bits, else uint8) of the ``h``
    scanlines of ``w`` pixels at the front of ``raw``, and the bytes they
    took. Filters work on bytes, a pixel's worth (at least one) apart."""
    row = (w * ch * depth + 7) // 8
    bpp = max(1, ch * depth // 8)
    n = h * (1 + row)
    if raw.size < n:
        raise ValueError(f"{name}: {raw.size} bytes of scanlines for {w}x{h}, {ch} samples of "
                         f"{depth} bits")
    b = _unfilter(raw[:n].reshape(h, 1 + row), h, row // bpp, bpp, name).reshape(h, row)
    if depth == 16:
        s = (b[:, 0::2].astype(np.uint16) << 8) | b[:, 1::2]
    elif depth < 8:
        bits = np.unpackbits(b, axis=1).reshape(h, row * 8 // depth, depth)
        s = (bits << np.arange(depth - 1, -1, -1, dtype=np.uint8)).sum(axis=2, dtype=np.uint8)
    else:
        s = b
    return s[:, :w * ch].reshape(h, w, ch), n


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int, name: str) -> np.ndarray:
    """(h, w, bpp) uint8 pixels of scanlines ``raw`` (h, 1 + w * bpp), each
    led by its filter type: None, Sub, Up, Average or Paeth, undone. A pixel
    depends only on its left, upper and upper-left neighbours, so each
    anti-diagonal of pixels is undone at once."""
    ft = raw[:, 0]
    if int(ft.max(initial=0)) > 4:
        raise ValueError(f"{name}: filter type {int(ft.max())}")
    data = raw[:, 1:].reshape(h, w, bpp)
    if not ft.any():
        return data.copy()
    data = data.astype(np.int16)
    out = np.zeros((h + 1, w + 1, bpp), np.int16)  # a zero row above and column left
    for d in range(h + w - 1):
        y = np.arange(max(0, d - w + 1), min(h, d + 1))
        x = d - y
        a, b, c = out[y + 1, x], out[y, x + 1], out[y, x]  # left, up, up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        f = ft[y][:, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4], [a, b, (a + b) >> 1, paeth], 0)
        out[y + 1, x + 1] = (data[y, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


# GIF: one global palette of 256 colours, the 6x6x6 cube (levels 0, 51, ...,
# 255) and 40 greys between. A pixel takes the entry whose largest channel
# error is least; the cube alone bounds that error by GIF_QUANT_ERROR.
GIF_QUANT_ERROR = 25
_CUBE = np.arange(6) * 51
_GREYS = np.round(np.arange(1, 41) * 255 / 41).astype(np.int16)
_PALETTE = np.concatenate([
    np.stack(np.meshgrid(_CUBE, _CUBE, _CUBE, indexing="ij"), -1).reshape(216, 3),
    np.repeat(_GREYS[:, None], 3, axis=1)]).astype(np.uint8)
# The LZW stream holds 9-bit literal codes only, a clear code before each run
# of _GIF_RUN: a decoder's table then stays below 512 entries (it would widen
# its codes after 254 literals), so the codes pack without any dictionary.
_GIF_CLEAR, _GIF_END, _GIF_RUN = 256, 257, 250
_LEVEL = (np.arange(256) + 25) // 51  # each channel value's nearest cube level
_CUBE_36, _CUBE_6, _CUBE_1 = ((_LEVEL * k).astype(np.uint8) for k in (36, 6, 1))
_CUBE_ERR = np.abs(np.arange(256) - _LEVEL * 51).astype(np.uint8)
# the grey nearest to (min + max) / 2, by min + max
_GREY_OF_SUM = np.clip(np.round(np.arange(511) / 2 * 41 / 255) - 1, 0, 39).astype(np.uint8)


def _gif_quantize(image_u8: np.ndarray) -> np.ndarray:
    """(H,W,3) uint8 -> (H,W) uint8 indices into ``_PALETTE`` (table
    lookups per channel, and per min + max channel for the greys)."""
    v = np.asarray(image_u8, np.uint8)
    r, g, b = v[..., 0], v[..., 1], v[..., 2]
    cube = _CUBE_36[r] + _CUBE_6[g] + _CUBE_1[b]
    cube_err = np.maximum(np.maximum(_CUBE_ERR[r], _CUBE_ERR[g]), _CUBE_ERR[b])
    lo = np.minimum(np.minimum(r, g), b).astype(np.int16)
    hi = np.maximum(np.maximum(r, g), b).astype(np.int16)
    grey = _GREY_OF_SUM[lo + hi]
    level = _GREYS[grey]
    grey_err = np.maximum(hi - level, level - lo)
    return np.where(grey_err < cube_err, grey + np.uint8(216), cube)


def _lzw_literals(index: np.ndarray) -> bytes:
    """The LZW data of ``index`` (uint8) as 9-bit literal codes, in GIF
    sub-blocks: a clear code before every _GIF_RUN literals, an end code."""
    n = index.size
    runs = -(-n // _GIF_RUN)
    literals = np.zeros(runs * _GIF_RUN, np.uint16)
    literals[:n] = index.ravel()
    codes = np.full((runs, 1 + _GIF_RUN), _GIF_CLEAR, np.uint16)
    codes[:, 1:] = literals.reshape(runs, _GIF_RUN)
    codes = np.append(codes.ravel()[: runs + n], np.uint16(_GIF_END))  # the last run's padding cut
    bits = ((codes[:, None] >> np.arange(9, dtype=np.uint16)) & 1).astype(np.uint8)
    data = np.packbits(bits.ravel(), bitorder="little")
    full, rest = divmod(data.size, 255)
    blocks = np.empty((full, 256), np.uint8)
    blocks[:, 0] = 255
    blocks[:, 1:] = data[: full * 255].reshape(full, 255)
    tail = bytes([rest]) + data[full * 255:].tobytes() if rest else b""
    return blocks.tobytes() + tail + b"\x00"


def write_gif(path: str, frames, duration: float = 1 / 30, loop: int = 0):
    """Write (H,W,3) uint8 RGB ``frames`` (row 0 at the top) as an animated
    GIF, ``duration`` seconds a frame (in hundredths), looping ``loop``
    times (0: forever). Colours are quantized to ``_PALETTE``; NumPy
    only, no imaging library."""
    frames = [np.ascontiguousarray(f, np.uint8) for f in frames]
    h, w, _ = frames[0].shape
    if any(f.shape != (h, w, 3) for f in frames):
        raise ValueError(f"write_gif wants (H,W,3) RGB frames of one size, got "
                         f"{sorted({f.shape for f in frames})}")
    delay = int(round(duration * 100))
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0), _PALETTE.tobytes(),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loop) + b"\x00"]
    for f in frames:
        out += [b"\x21\xf9\x04\x04" + struct.pack("<H", delay) + b"\x00\x00",
                b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0), b"\x08",
                _lzw_literals(_gif_quantize(f))]
    out.append(b"\x3b")
    with open(path, "wb") as fh:
        fh.write(b"".join(out))


def read_gif(path: str):
    """(frames (N,H,W,3) uint8, delays in seconds) of a GIF as ``write_gif``
    writes it; raises ``ValueError`` on another LZW stream (one that
    widens its codes past 9 bits or refers to its table)."""
    data = open(path, "rb").read()
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError(f"{path}: not a GIF")
    w, h, flags = struct.unpack("<HHB", data[6:11])
    if not flags & 0x80:
        raise ValueError(f"{path}: no global palette")
    size = 2 << (flags & 7)
    palette = np.frombuffer(data[13:13 + 3 * size], np.uint8).reshape(size, 3)
    pos, frames, delays, delay = 13 + 3 * size, [], [], 0.0

    def sub_blocks(pos):
        parts = []
        while data[pos]:
            parts.append(data[pos + 1:pos + 1 + data[pos]])
            pos += 1 + data[pos]
        return b"".join(parts), pos + 1

    while data[pos] != 0x3B:
        if data[pos] == 0x21:
            label = data[pos + 1]
            body, pos = sub_blocks(pos + 2)
            if label == 0xF9:
                delay = struct.unpack("<H", body[1:3])[0] / 100
        elif data[pos] == 0x2C:
            x, y, fw, fh, fflags = struct.unpack("<HHHHB", data[pos + 1:pos + 10])
            if (x, y, fw, fh) != (0, 0, w, h) or fflags or data[pos + 10] != 8:
                raise ValueError(f"{path}: a frame write_gif does not write")
            body, pos = sub_blocks(pos + 11)
            bits = np.unpackbits(np.frombuffer(body, np.uint8), bitorder="little")
            n = bits.size // 9
            codes = (bits[: n * 9].reshape(n, 9).astype(np.uint16)
                     << np.arange(9, dtype=np.uint16)).sum(axis=1)
            ends = np.flatnonzero(codes == _GIF_END)
            if not ends.size or codes[0] != _GIF_CLEAR:
                raise ValueError(f"{path}: an LZW stream write_gif does not write")
            codes = codes[: ends[0]]
            runs = np.diff(np.append(np.flatnonzero(codes == _GIF_CLEAR), codes.size)) - 1
            if runs.max() > 254 or (codes > _GIF_CLEAR).any():
                raise ValueError(f"{path}: an LZW stream write_gif does not write")
            index = codes[codes != _GIF_CLEAR]
            if index.size != w * h:
                raise ValueError(f"{path}: a frame of {index.size} pixels, not {w * h}")
            frames.append(palette[index].reshape(h, w, 3))
            delays.append(delay)
        else:
            raise ValueError(f"{path}: unknown block {data[pos]:#x} at byte {pos}")
    return np.stack(frames), delays
