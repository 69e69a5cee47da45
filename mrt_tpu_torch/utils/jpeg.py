"""A NumPy decoder for baseline JPEG, byte-equal to libjpeg-turbo's output
(what PIL's ``Image.open(p).convert("RGB")`` gives where PIL is built on it).

Covers sequential Huffman-coded JPEG (SOF0 and SOF1) of 8-bit samples:
grey, and three components (YCbCr, or RGB by the Adobe marker or the
component ids) with sampling factors up to 2x2, interleaved or not, with or
without restart intervals. Progressive, arithmetic-coded, lossless,
12-bit and four-component (CMYK) files raise ``ValueError``.

libjpeg-turbo's default decompression is copied step by step:

- the accurate integer inverse DCT (``jidctint.c:jpeg_idct_islow``, 13-bit
  constants, two passes of 2 and 18 bits of descaling, its range-limit
  table), over all blocks at once;
- fancy upsampling (``jdsample.c``): the triangle filters ``h2v1``,
  ``h1v2`` and ``h2v2`` with their rounding biases, edges replicated, and
  plain replication where a component is at most two samples wide;
- ``jdcolor.c:ycc_rgb_convert`` with its 16-bit fixed-point tables.

The entropy decoder is a Python loop over the Huffman symbols (a 16-bit
lookup per symbol), so a 1024x1024 4:2:0 texture takes seconds.
"""

from __future__ import annotations

import re
import struct

import numpy as np

JPEG_SIGNATURE = b"\xff\xd8"

# zigzag position -> natural (row-major) index within the 8x8 block
_NATURAL = np.array(sorted(range(64), key=lambda i: (i // 8 + i % 8,
                                                      (i % 8) if (i // 8 + i % 8) % 2 == 0
                                                      else (i // 8))), np.int64)
_NATURAL_L = _NATURAL.tolist()

# jidctint.c's constants, FIX(x) = round(x * 2^13)
_CONST_BITS, _PASS1_BITS = 13, 2
_F0_298631336, _F0_390180644, _F0_541196100, _F0_765366865 = 2446, 3196, 4433, 6270
_F0_899976223, _F1_175875602, _F1_501321110, _F1_847759065 = 7373, 9633, 12299, 15137
_F1_961570560, _F2_053119869, _F2_562915447, _F3_072711026 = 16069, 16819, 20995, 25172


def _range_limit() -> np.ndarray:
    """The post-IDCT range-limit table (``jdmaster.c:prepare_range_limit_table``)
    indexed by ``x & 1023``: x + 128 clamped to [0, 255] for x in
    [-512, 511], and libjpeg's wrap outside."""
    t = np.zeros(1024, np.uint8)
    t[:128] = np.arange(128, 256)
    t[128:512] = 255
    t[896:] = np.arange(128)
    return t


_LIMIT = _range_limit()


def _fix16(x: float) -> int:
    return int(x * 65536 + 0.5)


def _ycc_tables():
    """``jdcolor.c:build_ycc_rgb_table``: Cr->R, Cb->B, Cr->G, Cb->G."""
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15
    cr_r = (_fix16(1.40200) * x + half) >> 16
    cb_b = (_fix16(1.77200) * x + half) >> 16
    cr_g = -_fix16(0.71414) * x
    cb_g = -_fix16(0.34414) * x + half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def _idct_1d(c: list, shift: int) -> list:
    """One pass of ``jpeg_idct_islow`` over 8 coefficient arrays (int64),
    descaled by ``shift`` bits: the even part, the odd part, the butterfly."""
    z2, z3 = c[2], c[6]
    z1 = (z2 + z3) * _F0_541196100
    tmp2 = z1 + z3 * (-_F1_847759065)
    tmp3 = z1 + z2 * _F0_765366865
    tmp0 = (c[0] + c[4]) << _CONST_BITS
    tmp1 = (c[0] - c[4]) << _CONST_BITS
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = c[7], c[5], c[3], c[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1_175875602
    t0, t1, t2, t3 = (t0 * _F0_298631336, t1 * _F2_053119869, t2 * _F3_072711026,
                      t3 * _F1_501321110)
    z1, z2 = z1 * (-_F0_899976223), z2 * (-_F2_562915447)
    z3, z4 = z3 * (-_F1_961570560) + z5, z4 * (-_F0_390180644) + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    return [_descale(v, shift) for v in (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                                         tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def idct_islow(coef: np.ndarray) -> np.ndarray:
    """(N, 64) dequantized coefficients (natural order, int) -> (N, 8, 8)
    uint8 samples, as ``jpeg_idct_islow``: columns first (down each
    column), then rows, then the range limit with the +128 level shift."""
    c = coef.astype(np.int64).reshape(-1, 8, 8)
    cols = _idct_1d([c[:, k, :] for k in range(8)], _CONST_BITS - _PASS1_BITS)  # [y] (N, 8)
    ws = np.stack(cols, axis=1)  # (N, y, u)
    rows = _idct_1d([ws[:, :, k] for k in range(8)], _CONST_BITS + _PASS1_BITS + 3)  # [x] (N, 8)
    out = np.stack(rows, axis=2)  # (N, y, x)
    return _LIMIT[out & 1023]


def _h2_fancy(x: np.ndarray, left_bias: int, right_bias: int, shift: int) -> np.ndarray:
    """Horizontal doubling by the triangle filter: output 2i is
    (3 x[i] + x[i-1] + left_bias) >> shift, 2i+1 is (3 x[i] + x[i+1] +
    right_bias) >> shift, the edges replicated (``x`` already holds the
    column sums' scale)."""
    left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.int64)
    out[:, 0::2] = (3 * x + left + left_bias) >> shift
    out[:, 1::2] = (3 * x + right + right_bias) >> shift
    return out


def _upsample(p: np.ndarray, hx: int, vx: int) -> np.ndarray:
    """A component plane (h, w) uint8 at full size (h * vx, w * hx) as
    ``jdsample.c`` upsamples it by default (fancy)."""
    x = p.astype(np.int64)
    w = x.shape[1]
    if (hx, vx) == (1, 1):
        return p
    if (hx, vx) == (2, 1) and w > 2:
        return _h2_fancy(x, 1, 2, 2).astype(np.uint8)
    if (hx, vx) == (1, 2):
        up = np.concatenate([x[:1], x[:-1]], axis=0)
        down = np.concatenate([x[1:], x[-1:]], axis=0)
        out = np.empty((2 * x.shape[0], w), np.int64)
        out[0::2] = (3 * x + up + 1) >> 2
        out[1::2] = (3 * x + down + 2) >> 2
        return out.astype(np.uint8)
    if (hx, vx) == (2, 2) and w > 2:
        up = np.concatenate([x[:1], x[:-1]], axis=0)
        down = np.concatenate([x[1:], x[-1:]], axis=0)
        out = np.empty((2 * x.shape[0], 2 * w), np.int64)
        out[0::2] = _h2_fancy(3 * x + up, 8, 7, 4)
        out[1::2] = _h2_fancy(3 * x + down, 8, 7, 4)
        return out.astype(np.uint8)
    return np.repeat(np.repeat(p, vx, axis=0), hx, axis=1)


def _huffman_lookup(counts, symbols):
    """16-bit-peek lookup of a DHT table: (code lengths, symbols) as lists
    of 65536 (length 0: no such code)."""
    length = np.zeros(1 << 16, np.int64)
    symbol = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for bits in range(1, 17):
        for _ in range(counts[bits - 1]):
            lo = code << (16 - bits)
            hi = (code + 1) << (16 - bits)
            length[lo:hi] = bits
            symbol[lo:hi] = symbols[k]
            code += 1
            k += 1
        code <<= 1
    return length.tolist(), symbol.tolist()


def _decode_interval(buf: bytes, blocks, pred, idx_out, val_out, name):
    """Decode the Huffman-coded blocks of one restart interval from
    ``buf`` (byte stuffing removed). ``blocks``: per block in coding order
    (component, flat index of its first coefficient, DC table, AC table);
    ``pred``: the DC predictors, zero at the interval's start. Appends
    each non-zero coefficient's flat index and value to its component's
    lists in ``idx_out`` and ``val_out``."""
    n, p, acc, nbits = len(buf), 0, 0, 0
    nat = _NATURAL_L
    for comp, base, (dlen, dsym), (alen, asym) in blocks:
        while nbits < 32:
            acc = (acc << 8) | (buf[p] if p < n else 0)
            p += 1
            nbits += 8
        acc &= (1 << nbits) - 1
        code = acc >> (nbits - 16)
        s = dsym[code]
        ln = dlen[code]
        if not ln:
            raise ValueError(f"{name}: bad Huffman code")
        nbits -= ln
        v = 0
        if s:
            v = (acc >> (nbits - s)) & ((1 << s) - 1)
            nbits -= s
            if v < (1 << (s - 1)):
                v -= (1 << s) - 1
        pred[comp] += v
        idx_c, val_c = idx_out[comp], val_out[comp]
        if pred[comp]:
            idx_c.append(base)
            val_c.append(pred[comp])
        k = 1
        while k < 64:
            if nbits < 32:
                while nbits < 48:
                    acc = (acc << 8) | (buf[p] if p < n else 0)
                    p += 1
                    nbits += 8
                acc &= (1 << nbits) - 1
            code = (acc >> (nbits - 16)) & 0xFFFF
            rs = asym[code]
            ln = alen[code]
            if not ln:
                raise ValueError(f"{name}: bad Huffman code")
            nbits -= ln
            s = rs & 15
            if s:
                k += rs >> 4
                if k > 63:
                    raise ValueError(f"{name}: a coefficient past the block's end")
                v = (acc >> (nbits - s)) & ((1 << s) - 1)
                nbits -= s
                if v < (1 << (s - 1)):
                    v -= (1 << s) - 1
                idx_c.append(base + nat[k])
                val_c.append(v)
                k += 1
            elif rs == 0xF0:
                k += 16
            else:
                break


def _entropy_segment(data: bytes, pos: int):
    """(the entropy-coded bytes from ``pos`` up to the next marker that is
    not a restart, split at the restart markers, stuffing removed; the
    position of that marker)."""
    end = pos
    while True:
        end = data.find(b"\xff", end)
        if end < 0 or end + 1 >= len(data):
            end = len(data)
            break
        nxt = data[end + 1]
        if nxt == 0 or 0xD0 <= nxt <= 0xD7:
            end += 2
        elif nxt == 0xFF:
            end += 1
        else:
            break
    parts = re.split(rb"\xff[\xd0-\xd7]", data[pos:end])
    return [s.replace(b"\xff\x00", b"\xff") for s in parts], end


def decode_jpeg(data: bytes, name: str = "JPEG") -> np.ndarray:
    """The (H,W,3) uint8 RGB image of a baseline JPEG (see the module's
    docstring); grey is replicated. Raises ``ValueError`` on any other
    JPEG or a damaged one."""
    if data[:2] != JPEG_SIGNATURE:
        raise ValueError(f"{name}: not a JPEG")
    qt, dc_t, ac_t = {}, {}, {}
    frame, restart, jfif, adobe = None, 0, False, None
    planes = None  # per component: (coefficient array, quant table)
    pos = 2
    while True:
        pos = data.find(b"\xff", pos)
        if pos < 0 or pos + 1 >= len(data):
            raise ValueError(f"{name}: no end-of-image marker")
        m = data[pos + 1]
        if m == 0xFF:
            pos += 1
            continue
        pos += 2
        if m == 0xD9:
            break
        if m == 0xD8 or 0xD0 <= m <= 0xD7 or m == 0x01:
            continue
        (seg_len,) = struct.unpack(">H", data[pos:pos + 2])
        body = data[pos + 2:pos + seg_len]
        pos += seg_len
        if m in (0xC0, 0xC1):
            prec, h, w, nf = struct.unpack(">BHHB", body[:6])
            if prec != 8 or h == 0 or w == 0 or nf not in (1, 3):
                raise ValueError(f"{name}: {prec}-bit, {w}x{h}, {nf} components: not a baseline "
                                 "JPEG this decoder reads")
            comps = []
            for i in range(nf):
                cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
                comps.append(dict(id=cid, h=hv >> 4, v=hv & 15, tq=tq))
            if any(not (1 <= c["h"] <= 2 and 1 <= c["v"] <= 2) for c in comps):
                raise ValueError(f"{name}: sampling factors past 2x2")
            hmax = max(c["h"] for c in comps)
            vmax = max(c["v"] for c in comps)
            mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
            for c in comps:
                c["bw"], c["bh"] = mcux * c["h"], mcuy * c["v"]
                c["w"], c["h_px"] = -(-w * c["h"] // hmax), -(-h * c["v"] // vmax)
            frame = dict(h=h, w=w, comps=comps, hmax=hmax, vmax=vmax, mcux=mcux, mcuy=mcuy)
            planes = [None] * nf
        elif 0xC2 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            raise ValueError(f"{name}: SOF{m - 0xC0} (progressive, lossless or arithmetic-coded)")
        elif m == 0xC4:
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = list(body[i + 1:i + 17])
                syms = list(body[i + 17:i + 17 + sum(counts)])
                (dc_t if tc == 0 else ac_t)[th] = _huffman_lookup(counts, syms)
                i += 17 + sum(counts)
        elif m == 0xDB:
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                if pq:
                    vals = np.frombuffer(body[i + 1:i + 129], ">u2").astype(np.int64)
                    i += 129
                else:
                    vals = np.frombuffer(body[i + 1:i + 65], np.uint8).astype(np.int64)
                    i += 65
                q = np.zeros(64, np.int64)
                q[_NATURAL] = vals
                qt[tq] = q
        elif m == 0xDD:
            (restart,) = struct.unpack(">H", body[:2])
        elif m == 0xE0:
            jfif = jfif or body[:5] == b"JFIF\x00"
        elif m == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif m == 0xDA:
            if frame is None:
                raise ValueError(f"{name}: a scan before the frame header")
            pos = _scan(data, pos, body, frame, planes, qt, dc_t, ac_t, restart, name)
    if frame is None or any(p is None for p in planes):
        raise ValueError(f"{name}: a component was never coded")
    return _assemble(frame, planes, jfif, adobe)


def _scan(data, pos, body, frame, planes, qt, dc_t, ac_t, restart, name) -> int:
    """Decode one scan into ``planes``; returns the position after it."""
    ns = body[0]
    comps = frame["comps"]
    by_id = {c["id"]: k for k, c in enumerate(comps)}
    sel = []
    for i in range(ns):
        cid, t = body[1 + 2 * i:3 + 2 * i]
        if cid not in by_id or (t >> 4) not in dc_t or (t & 15) not in ac_t:
            raise ValueError(f"{name}: a scan names an unknown component or table")
        sel.append((by_id[cid], dc_t[t >> 4], ac_t[t & 15]))
    blocks = []  # per MCU, its blocks in coding order
    if ns == 1:
        k, dct, act = sel[0]
        c = comps[k]
        for by in range(-(-c["h_px"] // 8)):
            for bx in range(-(-c["w"] // 8)):
                blocks.append([(k, (by * c["bw"] + bx) * 64, dct, act)])
    else:
        for my in range(frame["mcuy"]):
            for mx in range(frame["mcux"]):
                mcu = []
                for k, dct, act in sel:
                    c = comps[k]
                    for v in range(c["v"]):
                        for u in range(c["h"]):
                            b = (my * c["v"] + v) * c["bw"] + mx * c["h"] + u
                            mcu.append((k, b * 64, dct, act))
                blocks.append(mcu)
    intervals, end = _entropy_segment(data, pos)
    per = restart or len(blocks)
    idx = [[] for _ in comps]
    val = [[] for _ in comps]
    for i in range(0, len(blocks), per):
        j = i // per
        run = [b for mcu in blocks[i:i + per] for b in mcu]
        _decode_interval(intervals[j] if j < len(intervals) else b"", run, [0] * len(comps),
                         idx, val, name)
    for k, _, _ in sel:
        c = comps[k]
        coef = np.zeros(c["bh"] * c["bw"] * 64, np.int64)
        coef[np.array(idx[k], np.int64)] = np.array(val[k], np.int64)
        planes[k] = (coef.reshape(-1, 64), qt[c["tq"]].copy())
    return end


def _assemble(frame, planes, jfif, adobe) -> np.ndarray:
    """Dequantize, inverse-DCT, crop, upsample and colour-convert."""
    h, w = frame["h"], frame["w"]
    full = []
    for c, (coef, q) in zip(frame["comps"], planes):
        px = idct_islow(coef * q)  # (bh * bw, 8, 8)
        plane = px.reshape(c["bh"], c["bw"], 8, 8).transpose(0, 2, 1, 3).reshape(
            c["bh"] * 8, c["bw"] * 8)[:c["h_px"], :c["w"]]
        up = _upsample(plane, frame["hmax"] // c["h"], frame["vmax"] // c["v"])
        full.append(up[:h, :w])
    if len(full) == 1:
        return np.repeat(full[0][..., None], 3, axis=2)
    ids = [c["id"] for c in frame["comps"]]
    rgb = (adobe == 0) if adobe is not None and not jfif else (not jfif and ids == [82, 71, 66])
    if rgb:
        return np.stack(full, axis=2)
    y, cb, cr = (p.astype(np.int64) for p in full)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=2), 0, 255).astype(np.uint8)
