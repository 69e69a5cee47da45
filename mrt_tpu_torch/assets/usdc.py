"""USDC ("Pixar crate") binary layer reader and writer — counterpart of
``mrt_tpu/assets/usdc.py``, the same pure-Python code, so both packages
accept and refuse the same bytes and write the same crates. It decodes the
binary layers of real-world .usdz archives (Model.swift:63-70 loads these
through ModelIO; here the format is parsed directly).

Implements the crate container per the public file-format layout:
bootstrap + TOC sections (TOKENS / STRINGS / FIELDS / FIELDSETS / PATHS /
SPECS), TfFastCompression (chunked LZ4 block format), Usd_IntegerCompression
(2-bit code stream + variable-width deltas), the compressed path tree
(pathIndexes / elementTokenIndexes / jumps), and the ValueRep encodings the
mesh/skeleton/animation pipeline needs: inlined scalars/tokens, raw and
integer-compressed numeric arrays, token arrays, matrices, quats, and
TimeSamples.

The output is a prim tree compatible with usd.py's usda parser output
(_Prim-shaped: attrs / time_samples / rels / children), so both layer
formats feed the same Mesh/Skeleton/SkelAnimation extraction.
"""

from __future__ import annotations

import struct

import numpy as np


# ---------------------------------------------------------------------------
# LZ4 block + TfFastCompression framing
# ---------------------------------------------------------------------------

def lz4_block_decompress(src: bytes, max_out: int) -> bytes:
    """Decode one LZ4 BLOCK (not frame)."""
    out = bytearray()
    i = 0
    n = len(src)
    while i < n:
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        out += src[i : i + lit]
        i += lit
        if i >= n:
            break  # last sequence has no match part
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        mlen = (token & 0xF) + 4
        if (token & 0xF) == 15:
            while True:
                b = src[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        start = len(out) - offset
        if offset == 0:
            raise ValueError("corrupt lz4 stream (zero offset)")
        for k in range(mlen):  # may overlap; byte-by-byte is the semantics
            out.append(out[start + k])
        if len(out) > max_out:
            raise ValueError("lz4 output exceeds expected size")
    return bytes(out)


def tf_decompress(src: bytes, out_size: int) -> bytes:
    """TfFastCompression framing: leading chunk-count byte (0 = single bare
    chunk), else per-chunk int32 compressed sizes precede each LZ4 block."""
    if out_size == 0:
        return b""
    n_chunks = src[0]
    if n_chunks == 0:
        return lz4_block_decompress(src[1:], out_size)
    out = bytearray()
    i = 1
    for _ in range(n_chunks):
        (csize,) = struct.unpack_from("<i", src, i)
        i += 4
        out += lz4_block_decompress(src[i : i + csize], out_size - len(out))
        i += csize
    return bytes(out)


def lz4_block_compress(src: bytes) -> bytes:
    """Minimal VALID LZ4 block: emit everything as literals (no matches).
    Used only by the fixture writer — correctness over ratio."""
    out = bytearray()
    i = 0
    n = len(src)
    # one sequence of pure literals
    lit = n
    if lit >= 15:
        out.append(0xF0)
        rest = lit - 15
        while rest >= 255:
            out.append(255)
            rest -= 255
        out.append(rest)
    else:
        out.append(lit << 4)
    out += src
    return bytes(out)


def tf_compress(src: bytes) -> bytes:
    return bytes([0]) + lz4_block_compress(src)


# ---------------------------------------------------------------------------
# Usd_IntegerCompression
# ---------------------------------------------------------------------------

def decode_integers(data: bytes, count: int) -> np.ndarray:
    """2-bit code stream + variable-width deltas, running-sum decoded.
    codes: 0 -> commonValue, 1 -> int8, 2 -> int16, 3 -> int32."""
    if count == 0:
        return np.zeros(0, np.int64)
    (common,) = struct.unpack_from("<i", data, 0)
    ncode_bytes = (count * 2 + 7) // 8
    codes = data[4 : 4 + ncode_bytes]
    pos = 4 + ncode_bytes
    out = np.empty(count, np.int64)
    prev = 0
    for i in range(count):
        code = (codes[i >> 2] >> ((i & 3) * 2)) & 3
        if code == 0:
            delta = common
        elif code == 1:
            delta = struct.unpack_from("<b", data, pos)[0]
            pos += 1
        elif code == 2:
            delta = struct.unpack_from("<h", data, pos)[0]
            pos += 2
        else:
            delta = struct.unpack_from("<i", data, pos)[0]
            pos += 4
        prev += delta
        out[i] = prev
    return out


def encode_integers(vals) -> bytes:
    """Inverse of decode_integers (fixture writer): all deltas as int32
    (code 3), commonValue 0."""
    vals = list(int(v) for v in vals)
    count = len(vals)
    codes = bytearray((count * 2 + 7) // 8)
    data = bytearray()
    prev = 0
    for i, v in enumerate(vals):
        delta = v - prev
        prev = v
        codes[i >> 2] |= 3 << ((i & 3) * 2)
        data += struct.pack("<i", delta)
    return struct.pack("<i", 0) + bytes(codes) + bytes(data)


def read_compressed_ints(buf: bytes, off: int, count: int):
    """uint64 compressedSize + TfFastCompression'd integer stream.
    Returns (values, new offset)."""
    (csize,) = struct.unpack_from("<Q", buf, off)
    off += 8
    # decompressed working size bound (as in integerCoding.h)
    max_size = 4 + (count * 2 + 7) // 8 + count * 4
    raw = tf_decompress(buf[off : off + csize], max_size)
    off += csize
    return decode_integers(raw, count), off


# ---------------------------------------------------------------------------
# Crate reading
# ---------------------------------------------------------------------------

# value-rep type ids (crate data types)
T_BOOL, T_UCHAR, T_INT, T_UINT, T_INT64, T_UINT64 = 1, 2, 3, 4, 5, 6
T_HALF, T_FLOAT, T_DOUBLE, T_STRING, T_TOKEN, T_ASSET = 7, 8, 9, 10, 11, 12
T_QUATD, T_QUATF, T_QUATH = 13, 14, 15
T_VEC2D, T_VEC2F, T_VEC2H, T_VEC2I = 16, 17, 18, 19
T_VEC3D, T_VEC3F, T_VEC3H, T_VEC3I = 20, 21, 22, 23
T_VEC4D, T_VEC4F, T_VEC4H, T_VEC4I = 24, 25, 26, 27
T_MATRIX2D, T_MATRIX3D, T_MATRIX4D = 28, 29, 30
T_TOKEN_VECTOR = 43
T_SPECIFIER = 44
T_TIME_SAMPLES = 48

_ARRAY_BIT = 1 << 63
_INLINED_BIT = 1 << 62
_COMPRESSED_BIT = 1 << 61
_PAYLOAD_MASK = (1 << 48) - 1

_SCALAR_FMT = {
    T_BOOL: ("<i", 4), T_UCHAR: ("<B", 1), T_INT: ("<i", 4), T_UINT: ("<I", 4),
    T_INT64: ("<q", 8), T_UINT64: ("<Q", 8),
    T_HALF: ("<e", 2), T_FLOAT: ("<f", 4), T_DOUBLE: ("<d", 8),
}

_VEC_INFO = {
    T_VEC2F: (np.float32, 2), T_VEC2D: (np.float64, 2), T_VEC2H: (np.float16, 2),
    T_VEC2I: (np.int32, 2),
    T_VEC3F: (np.float32, 3), T_VEC3D: (np.float64, 3), T_VEC3H: (np.float16, 3),
    T_VEC3I: (np.int32, 3),
    T_VEC4F: (np.float32, 4), T_VEC4D: (np.float64, 4), T_VEC4H: (np.float16, 4),
    T_VEC4I: (np.int32, 4),
    T_QUATF: (np.float32, 4), T_QUATD: (np.float64, 4), T_QUATH: (np.float16, 4),
    T_MATRIX2D: (np.float64, 4), T_MATRIX3D: (np.float64, 9),
    T_MATRIX4D: (np.float64, 16),
    T_HALF: (np.float16, 1), T_FLOAT: (np.float32, 1), T_DOUBLE: (np.float64, 1),
    T_INT: (np.int32, 1), T_UINT: (np.uint32, 1), T_INT64: (np.int64, 1),
    T_UINT64: (np.uint64, 1), T_UCHAR: (np.uint8, 1), T_BOOL: (np.int32, 1),
}

# spec types (SdfSpecType)
SPEC_ATTRIBUTE = 2
SPEC_PRIM = 9
SPEC_RELATIONSHIP = 10
SPEC_PSEUDO_ROOT = 8


class CrateFile:
    def __init__(self, data: bytes):
        self.data = data
        if data[:8] != b"PXR-USDC":
            raise ValueError("not a usdc crate file")
        self.version = tuple(data[8:11])
        (toc_off,) = struct.unpack_from("<Q", data, 16)
        (n_sections,) = struct.unpack_from("<Q", data, toc_off)
        self.sections = {}
        off = toc_off + 8
        for _ in range(n_sections):
            name = data[off : off + 16].split(b"\0")[0].decode()
            start, size = struct.unpack_from("<QQ", data, off + 16)
            self.sections[name] = (start, size)
            off += 32
        self._read_tokens()
        self._read_strings()
        self._read_fields()
        self._read_fieldsets()
        self._read_paths()
        self._read_specs()

    # -- sections ------------------------------------------------------------
    def _read_tokens(self):
        start, size = self.sections["TOKENS"]
        buf = self.data
        (n,) = struct.unpack_from("<Q", buf, start)
        (usize,) = struct.unpack_from("<Q", buf, start + 8)
        (csize,) = struct.unpack_from("<Q", buf, start + 16)
        raw = tf_decompress(buf[start + 24 : start + 24 + csize], usize)
        toks = raw.split(b"\0")
        self.tokens = [t.decode("utf-8", "replace") for t in toks[:n]]

    def _read_strings(self):
        start, size = self.sections["STRINGS"]
        (n,) = struct.unpack_from("<Q", self.data, start)
        self.strings = list(
            struct.unpack_from(f"<{n}I", self.data, start + 8) if n else ()
        )

    def _read_fields(self):
        start, size = self.sections["FIELDS"]
        buf = self.data
        (n,) = struct.unpack_from("<Q", buf, start)
        off = start + 8
        token_idx, off = read_compressed_ints(buf, off, n)
        (reps_csize,) = struct.unpack_from("<Q", buf, off)
        off += 8
        reps_raw = tf_decompress(buf[off : off + reps_csize], n * 8)
        reps = np.frombuffer(reps_raw, "<u8", count=n)
        self.fields = [
            (self.tokens[int(t)], int(r)) for t, r in zip(token_idx, reps)
        ]

    def _read_fieldsets(self):
        start, size = self.sections["FIELDSETS"]
        buf = self.data
        (n,) = struct.unpack_from("<Q", buf, start)
        idx, _ = read_compressed_ints(buf, start + 8, n)
        # runs terminated by 0xFFFFFFFF (as uint32)
        sets = []
        cur = []
        for v in np.asarray(idx, np.int64) & 0xFFFFFFFF:
            if v == 0xFFFFFFFF:
                sets.append(cur)
                cur = []
            else:
                cur.append(int(v))
        self.fieldsets = sets
        # fieldset index in SPECS refers to the FLAT index of the run start
        self.fieldset_by_start = {}
        pos = 0
        for srun in sets:
            self.fieldset_by_start[pos] = srun
            pos += len(srun) + 1

    def _read_paths(self):
        start, size = self.sections["PATHS"]
        buf = self.data
        (n_paths,) = struct.unpack_from("<Q", buf, start)
        off = start + 8
        (n_enc,) = struct.unpack_from("<Q", buf, off)
        off += 8
        path_idx, off = read_compressed_ints(buf, off, n_enc)
        elem_tok, off = read_compressed_ints(buf, off, n_enc)
        jumps, off = read_compressed_ints(buf, off, n_enc)
        self.paths = [""] * n_paths

        # iterative version of _BuildDecompressedPathsImpl
        work = [(0, None)]  # (cur index, parent path or None for root)
        while work:
            cur, parent = work.pop()
            while cur is not None and cur < n_enc:
                this = cur
                if parent is None:
                    self.paths[int(path_idx[this])] = "/"
                    this_path = ""
                else:
                    tok_i = int(elem_tok[this])
                    is_prop = tok_i < 0
                    tok = self.tokens[abs(tok_i)]
                    this_path = f"{parent}.{tok}" if is_prop else f"{parent}/{tok}"
                    self.paths[int(path_idx[this])] = this_path
                j = int(jumps[this])
                has_child = j > 0 or j == -1
                has_sibling = j >= 0
                if has_child:
                    if has_sibling:
                        # sibling subtree starts at this + jump; same parent
                        work.append((this + j, parent))
                    parent = this_path  # descend: child is the next entry
                    cur = this + 1
                elif has_sibling:
                    cur = this + 1  # jump 0: the next entry is my sibling
                else:
                    cur = None  # jump -2: leaf, end of this branch

    def _read_specs(self):
        start, size = self.sections["SPECS"]
        buf = self.data
        (n,) = struct.unpack_from("<Q", buf, start)
        off = start + 8
        path_idx, off = read_compressed_ints(buf, off, n)
        fset_idx, off = read_compressed_ints(buf, off, n)
        spec_types, off = read_compressed_ints(buf, off, n)
        self.specs = [
            (int(p), int(f), int(t))
            for p, f, t in zip(path_idx, fset_idx, spec_types)
        ]

    # -- value unpacking -------------------------------------------------------
    def unpack(self, rep: int):
        ty = (rep >> 48) & 0xFF
        is_array = bool(rep & _ARRAY_BIT)
        is_inlined = bool(rep & _INLINED_BIT)
        is_compressed = bool(rep & _COMPRESSED_BIT)
        payload = rep & _PAYLOAD_MASK

        if ty == T_TOKEN and not is_array:
            if is_inlined:
                return self.tokens[payload]
            (idx,) = struct.unpack_from("<I", self.data, payload)
            return self.tokens[idx]
        if ty == T_STRING and not is_array:
            return self.tokens[self.strings[payload]] if is_inlined else None
        if ty == T_SPECIFIER:
            return ("def", "over", "class")[payload] if payload < 3 else "def"
        if ty == T_TIME_SAMPLES:
            return self._unpack_time_samples(payload)

        if not is_array:
            if ty in _SCALAR_FMT:
                fmt, sz = _SCALAR_FMT[ty]
                if is_inlined:
                    raw = struct.pack("<I", payload & 0xFFFFFFFF)[: max(sz, 4)]
                    if sz <= 4:
                        v = struct.unpack_from(fmt, raw.ljust(sz, b"\0"))[0]
                    else:
                        v = struct.unpack_from("<i", raw)[0]  # sign-extended int
                    return bool(v) if ty == T_BOOL else v
                return struct.unpack_from(fmt, self.data, payload)[0]
            if ty in _VEC_INFO:
                dt, width = _VEC_INFO[ty]
                if is_inlined:
                    # inlined vecs store int8 per component
                    comps = struct.pack("<I", payload & 0xFFFFFFFF)
                    vals = np.frombuffer(comps[:width], np.int8).astype(dt)
                    if ty == T_MATRIX4D:
                        # inlined matrix: diagonal from int8s
                        m = np.zeros((4, 4), np.float64)
                        d = np.frombuffer(comps[:4], np.int8)
                        np.fill_diagonal(m, d)
                        return m
                    return vals
                raw = np.frombuffer(self.data, dt, count=width, offset=payload)
                if ty == T_MATRIX4D:
                    return raw.reshape(4, 4).copy()
                if ty == T_MATRIX3D:
                    return raw.reshape(3, 3).copy()
                return raw.copy()
            return None

        # arrays
        dt, width = _VEC_INFO.get(ty, (None, None))
        if ty == T_TOKEN or ty == T_TOKEN_VECTOR:
            off = payload
            (cnt,) = struct.unpack_from("<Q", self.data, off)
            off += 8
            if cnt > len(self.data):  # corrupt count: can't exceed file size
                raise ValueError(f"corrupt token-array count {cnt}")
            idx = struct.unpack_from(f"<{cnt}I", self.data, off)
            return [self.tokens[i] for i in idx]
        if dt is None:
            return None
        off = payload
        if self.version >= (0, 7, 0):
            (cnt,) = struct.unpack_from("<Q", self.data, off)
            off += 8
        else:
            (cnt,) = struct.unpack_from("<I", self.data, off)
            off += 4
        if cnt * width > len(self.data):
            # corrupt count guard: even 1-byte elements cannot outnumber the
            # file's bytes — fail BEFORE attempting a giant allocation
            # (tests/test_loader_fuzz.py byte-flip corpus)
            raise ValueError(f"corrupt array count {cnt} (x{width})")
        n_elems = cnt * width
        if is_compressed and ty in (T_INT, T_UINT, T_INT64, T_UINT64):
            vals, _ = read_compressed_ints(self.data, off, int(n_elems))
            arr = np.asarray(vals).astype(dt)
        elif is_compressed:
            # compressed float arrays: code byte 'i' (ints) or 't' (table)
            code = self.data[off : off + 1]
            off += 1
            if code == b"i":
                ints, _ = read_compressed_ints(self.data, off, int(n_elems))
                arr = np.asarray(ints, np.int64).astype(dt)
            elif code == b"t":
                (lut_n,) = struct.unpack_from("<I", self.data, off)
                off += 4
                lut = np.frombuffer(self.data, dt, count=lut_n, offset=off)
                off += lut_n * np.dtype(dt).itemsize
                idx, _ = read_compressed_ints(self.data, off, int(n_elems))
                arr = lut[np.asarray(idx, np.int64)]
            else:
                raise ValueError(f"unknown float-compression code {code!r}")
        else:
            arr = np.frombuffer(self.data, dt, count=int(n_elems), offset=off).copy()
        if ty in (T_MATRIX4D,):
            return arr.reshape(int(cnt), 4, 4)
        if ty in (T_MATRIX3D,):
            return arr.reshape(int(cnt), 3, 3)
        if width > 1:
            return arr.reshape(int(cnt), width)
        return arr

    def _unpack_time_samples(self, payload: int):
        """TimeSamples rep: payload -> { 8-byte times rep layout }.
        Layout (uncompressed-structure version): uint64 timesRep; then
        uint64 numValues, value reps inline."""
        off = payload
        (times_rep,) = struct.unpack_from("<Q", self.data, off)
        times = self.unpack(times_rep)
        off += 8
        (n,) = struct.unpack_from("<Q", self.data, off)
        off += 8
        reps = struct.unpack_from(f"<{n}Q", self.data, off)
        values = [self.unpack(r) for r in reps]
        t = np.asarray(times, np.float64).reshape(-1)
        return dict(zip(t.tolist(), values))


def read_crate_prims(data: bytes):
    """Crate bytes -> (root prim tree in usd.py's _Prim shape, stage meta)."""
    from .usd import _Prim

    cf = CrateFile(data)
    prims: dict = {}
    stage_meta: dict = {}
    root = _Prim("Stage", "", "")
    prims[""] = root
    # create prims for every PrimSpec path first (sorted => parents first)
    spec_by_path = {}
    for p_i, f_i, s_t in cf.specs:
        spec_by_path[cf.paths[p_i]] = (f_i, s_t)
    for path in sorted(spec_by_path):
        f_i, s_t = spec_by_path[path]
        fields = {
            cf.fields[fi][0]: cf.fields[fi][1]
            for fi in cf.fieldset_by_start.get(f_i, [])
        }
        if s_t == SPEC_PSEUDO_ROOT or path == "/":
            for k, rep in fields.items():
                stage_meta[k] = cf.unpack(rep)
            continue
        if s_t == SPEC_PRIM:
            name = path.rsplit("/", 1)[-1]
            prim = _Prim(str(cf.unpack(fields.get("typeName", 0)) or ""), name, path)
            prims[path] = prim
            parent = path.rsplit("/", 1)[0]
            parent_prim = prims.get(parent or "", root)
            parent_prim.children.append(prim)
        elif s_t == SPEC_ATTRIBUTE:
            prim_path, attr = path.rsplit(".", 1)
            prim = prims.get(prim_path)
            if prim is None:
                continue
            if "default" in fields:
                val = cf.unpack(fields["default"])
                prim.attrs[attr] = val
            if "timeSamples" in fields:
                prim.time_samples[attr] = cf.unpack(fields["timeSamples"])
            for meta in ("elementSize", "interpolation"):
                if meta in fields:
                    prim.attrs[f"{attr}:{meta}"] = cf.unpack(fields[meta])
        elif s_t == SPEC_RELATIONSHIP:
            prim_path, rel = path.rsplit(".", 1)
            prim = prims.get(prim_path)
            if prim is None:
                continue
            tgt = fields.get("targetPaths")
            if tgt is not None:
                prim.rels[rel] = cf.unpack(tgt)
    return root, stage_meta


# ---------------------------------------------------------------------------
# Crate writing (fixtures + export). Emits version 0.8.0 with uncompressed
# value arrays and int32-delta integer streams — every construct the reader
# above decodes, so write->read round trips exactly.
# ---------------------------------------------------------------------------

class CrateWriter:
    def __init__(self):
        self.tokens: list = []
        self._tok_idx: dict = {}
        self.fields: list = []  # (token index, rep)
        self._field_idx: dict = {}
        self.fieldsets: list = []  # flat with 0xFFFFFFFF terminators
        self.specs: list = []  # (path index, fieldset start, spec type)
        self.blob = bytearray()  # value data heap (offsets patched at layout)
        self.paths: list = []  # path strings in creation order
        self._path_idx: dict = {}

    def token(self, s: str) -> int:
        if s not in self._tok_idx:
            self._tok_idx[s] = len(self.tokens)
            self.tokens.append(s)
        return self._tok_idx[s]

    def path(self, p: str) -> int:
        if p not in self._path_idx:
            self._path_idx[p] = len(self.paths)
            self.paths.append(p)
        return self._path_idx[p]

    # -- value reps -----------------------------------------------------------
    def _heap(self, raw: bytes) -> int:
        off = len(self.blob)
        self.blob += raw
        return off

    def rep_token(self, s: str) -> int:
        return (T_TOKEN << 48) | _INLINED_BIT | self.token(s)

    def rep_scalar(self, ty: int, value) -> int:
        fmt, sz = _SCALAR_FMT[ty]
        off = self._heap(struct.pack(fmt, value))
        return (ty << 48) | off

    def rep_matrix4d(self, m) -> int:
        off = self._heap(np.asarray(m, np.float64).reshape(16).tobytes())
        return (T_MATRIX4D << 48) | off

    def rep_array(self, ty: int, arr) -> int:
        dt, width = _VEC_INFO[ty]
        a = np.asarray(arr, dt)
        cnt = a.shape[0]
        raw = struct.pack("<Q", cnt) + a.tobytes()
        off = self._heap(raw)
        return (ty << 48) | _ARRAY_BIT | off

    def rep_token_array(self, toks) -> int:
        idx = [self.token(t) for t in toks]
        raw = struct.pack("<Q", len(idx)) + struct.pack(f"<{len(idx)}I", *idx)
        off = self._heap(raw)
        return (T_TOKEN << 48) | _ARRAY_BIT | off

    def rep_time_samples(self, samples: dict, ty: int) -> int:
        times = sorted(samples)
        times_rep = self.rep_array(T_DOUBLE, np.asarray(times, np.float64))
        value_reps = [self.rep_array(ty, samples[t]) for t in times]
        raw = struct.pack("<Q", times_rep) + struct.pack("<Q", len(value_reps))
        raw += struct.pack(f"<{len(value_reps)}Q", *value_reps)
        off = self._heap(raw)
        return (T_TIME_SAMPLES << 48) | off

    # -- specs ------------------------------------------------------------------
    def _field(self, name: str, rep: int) -> int:
        key = (name, rep)
        if key not in self._field_idx:
            self._field_idx[key] = len(self.fields)
            self.fields.append((self.token(name), rep))
        return self._field_idx[key]

    def add_spec(self, path: str, spec_type: int, fields: dict):
        start = len(self.fieldsets)
        for name, rep in fields.items():
            self.fieldsets.append(self._field(name, rep))
        self.fieldsets.append(0xFFFFFFFF)
        self.specs.append((self.path(path), start, spec_type))

    # -- path tree encoding -------------------------------------------------------
    def _encode_paths(self):
        # build the tree over all registered paths ("/" is implicit root)
        children: dict = {"": []}
        all_paths = set(self.paths)
        all_paths.discard("/")
        for p in sorted(all_paths):
            if "." in p.rsplit("/", 1)[-1]:
                parent, _, elem = p.rpartition(".")
            else:
                parent, _, elem = p.rpartition("/")
            children.setdefault(parent, []).append((elem, p, "." in p.rsplit("/", 1)[-1]))
            children.setdefault(p, [])
        self.path("/")

        entries = []  # (path string, elem token (signed), ...)

        def emit(path_key, path_str, elem_tok):
            my = len(entries)
            entries.append([self.path(path_str), elem_tok, -2])
            kids = children.get(path_key, [])
            if kids:
                entries[my][2] = -1  # has child (patched if sibling added)
            prev_head = None
            for elem, child_path, is_prop in kids:
                tok = self.token(elem)
                head = emit(child_path, child_path, -tok if is_prop else tok)
                if prev_head is not None:
                    # patch previous child's jump to point at this sibling
                    j = head - prev_head
                    old = entries[prev_head][2]
                    entries[prev_head][2] = j if old != -2 else 0
                    if old == -2:
                        pass  # sibling-only: decoder walks to next entry (j==0)
                    elif old == -1:
                        entries[prev_head][2] = j
                prev_head = head
            return my

        emit("", "/", 0)
        return entries

    def tobytes(self) -> bytes:
        entries = self._encode_paths()

        header = bytearray()
        header += b"PXR-USDC"
        header += bytes([0, 8, 0, 0, 0, 0, 0, 0])  # version 0.8.0
        header += b"\0" * 72  # toc offset (patched) + reserved
        # layout: header (88) | value heap | sections | toc
        base = 88
        out = bytearray(header)
        out += self.blob
        # value reps reference heap offsets relative to heap start; the reader
        # uses absolute offsets -> shift every non-inlined rep by base.
        # (Reps were built with heap-relative offsets; rewrite now.)

        def shift(rep: int) -> int:
            ty = (rep >> 48) & 0xFF
            if rep & _INLINED_BIT:
                return rep
            return (rep & ~_PAYLOAD_MASK) | ((rep & _PAYLOAD_MASK) + base)

        fields = [(t, shift(r)) for t, r in self.fields]

        # TimeSamples blobs contain NESTED reps that also need shifting: the
        # writer stores them heap-relative; walk specs' TimeSamples fields.
        for t, r in fields:
            if ((r >> 48) & 0xFF) == T_TIME_SAMPLES:
                off = r & _PAYLOAD_MASK
                (times_rep,) = struct.unpack_from("<Q", out, off)
                struct.pack_into("<Q", out, off, shift(times_rep))
                (n,) = struct.unpack_from("<Q", out, off + 8)
                for k in range(n):
                    (vr,) = struct.unpack_from("<Q", out, off + 16 + 8 * k)
                    struct.pack_into("<Q", out, off + 16 + 8 * k, shift(vr))

        sections = {}

        def add_section(name, payload: bytes):
            sections[name] = (len(out), len(payload))
            out.extend(payload)

        tok_blob = b"\0".join(t.encode() for t in self.tokens) + b"\0"
        comp = tf_compress(tok_blob)
        add_section(
            "TOKENS",
            struct.pack("<QQQ", len(self.tokens), len(tok_blob), len(comp)) + comp,
        )
        add_section("STRINGS", struct.pack("<Q", 0))

        def comp_ints(vals):
            raw = encode_integers(vals)
            c = tf_compress(raw)
            return struct.pack("<Q", len(c)) + c

        reps_raw = np.asarray([r for _, r in fields], "<u8").tobytes()
        reps_c = tf_compress(reps_raw)
        add_section(
            "FIELDS",
            struct.pack("<Q", len(fields))
            + comp_ints([t for t, _ in fields])
            + struct.pack("<Q", len(reps_c)) + reps_c,
        )
        add_section(
            "FIELDSETS",
            struct.pack("<Q", len(self.fieldsets))
            + comp_ints([v if v != 0xFFFFFFFF else -1 for v in self.fieldsets]),
        )
        # paths: entries are in DFS order; decode consumes signed elem tokens
        add_section(
            "PATHS",
            struct.pack("<Q", len(self.paths))
            + struct.pack("<Q", len(entries))
            + comp_ints([e[0] for e in entries])
            + comp_ints([e[1] for e in entries])
            + comp_ints([e[2] for e in entries]),
        )
        add_section(
            "SPECS",
            struct.pack("<Q", len(self.specs))
            + comp_ints([p for p, _, _ in self.specs])
            + comp_ints([f for _, f, _ in self.specs])
            + comp_ints([t for _, _, t in self.specs]),
        )

        toc_off = len(out)
        out += struct.pack("<Q", len(sections))
        for name, (start, size) in sections.items():
            out += name.encode().ljust(16, b"\0") + struct.pack("<QQ", start, size)
        struct.pack_into("<Q", out, 16, toc_off)
        return bytes(out)
