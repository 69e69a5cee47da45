"""USDZ/USDA loader — counterpart of ``mrt_tpu/assets/usd.py``, the same
NumPy code, so both packages load a file to equal arrays. It is the analog
of the reference's ModelIO USDZ path (Model.swift:63-122: USDZ-preferred
resolution, skeleton/animation discovery by tree traversal, per-mesh
skinning bind info).

Scope: the .usdz zip container (per spec: uncompressed, 64-byte aligned
entries — we read any stored zip) holding a USDA (text) layer, parsed with a
small recursive-descent reader covering the subset the pipeline needs:

* Mesh: points / faceVertexCounts / faceVertexIndices / normals /
  primvars:st (vertex interpolation), triangulated by fan
* SkelBindingAPI: primvars:skel:jointIndices/jointWeights (elementSize 4),
  skel:geomBindTransform
* Skeleton: joints / bindTransforms / restTransforms
* SkelAnimation: joints + translations/rotations/scales timeSamples

Matrix convention: USD is row-vector (p' = p @ M, world = local @ parent);
the engine is column-vector (Model.swift simd) — all matrices are transposed
on load so Skeleton.compute_global_transforms' parent @ local composition is
exact. Quaternions convert (w,x,y,z) -> (x,y,z,w).

Returns the same (MeshData, skin_info) contract as assets/gltf.load_gltf, so
models flow through the identical SkinData -> LBS -> BVH-refit pipeline.
"""

from __future__ import annotations

import io
import re
import zipfile
from pathlib import Path

import numpy as np

from .obj import MaterialDef, MeshData, SubmeshData, _generate_normals


# ---------------------------------------------------------------------------
# usda tokenizer / parser
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    \s*(?:
        (?P<comment>\#[^\n]*) |
        (?P<string>"(?:[^"\\]|\\.)*") |
        (?P<asset>@[^@]*@) |
        (?P<path><[^>]*>) |
        (?P<num>-?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][+-]?\d+)?) |
        (?P<punct>[\(\)\[\]\{\}=,;:]) |
        (?P<word>[A-Za-z_][A-Za-z0-9_:.\[\]]*)
    )
    """,
    re.VERBOSE,
)


def _tokenize(text: str):
    pos = 0
    out = []
    n = len(text)
    while pos < n:
        m = _TOKEN_RE.match(text, pos)
        if not m:
            pos += 1  # skip unknown char
            continue
        pos = m.end()
        if m.lastgroup == "comment":
            continue
        out.append((m.lastgroup, m.group().strip()))
    return out


class _Prim:
    def __init__(self, type_name: str, name: str, path: str):
        self.type = type_name
        self.name = name
        self.path = path
        self.attrs: dict = {}  # name -> value
        self.time_samples: dict = {}  # name -> {time: value}
        self.rels: dict = {}  # name -> target path
        self.children: list = []

    def find(self, type_name: str, out=None):
        out = [] if out is None else out
        if self.type == type_name:
            out.append(self)
        for c in self.children:
            c.find(type_name, out)
        return out


class _Parser:
    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0
        self.stage_meta: dict = {}

    def peek(self, k=0):
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else (None, None)

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def skip_balanced(self, open_tok, close_tok):
        depth = 0
        while self.i < len(self.toks):
            kind, val = self.next()
            if val == open_tok:
                depth += 1
            elif val == close_tok:
                depth -= 1
                if depth == 0:
                    return

    # -- values ---------------------------------------------------------------
    def parse_value(self):
        kind, val = self.peek()
        if val == "(":
            self.next()
            items = []
            while self.peek()[1] != ")":
                items.append(self.parse_value())
                if self.peek()[1] == ",":
                    self.next()
            self.next()
            return tuple(items)
        if val == "[":
            self.next()
            items = []
            while self.peek()[1] != "]":
                items.append(self.parse_value())
                if self.peek()[1] == ",":
                    self.next()
            self.next()
            return items
        if val == "{":
            # timeSamples dict {time: value, ...}
            self.next()
            d = {}
            while self.peek()[1] != "}":
                t = self.parse_value()
                if self.peek()[1] == ":":
                    self.next()
                v = self.parse_value()
                d[float(t)] = v
                if self.peek()[1] in (",", ";"):
                    self.next()
            self.next()
            return d
        if kind == "num":
            self.next()
            f = float(val)
            return int(f) if f.is_integer() and ("." not in val and "e" not in val.lower()) else f
        if kind == "string":
            self.next()
            return val[1:-1]
        if kind in ("asset", "path"):
            self.next()
            return val[1:-1]
        if kind == "word":
            self.next()
            if val == "None":
                return None
            return val
        self.next()
        return val

    # -- prims ------------------------------------------------------------------
    def parse_stage(self):
        root = _Prim("Stage", "", "")
        # optional stage metadata block right after the #usda line
        if self.peek()[1] == "(":
            j = self.i
            self.next()
            depth = 1
            while self.i < len(self.toks) and depth > 0:
                kind, val = self.next()
                if val == "(":
                    depth += 1
                elif val == ")":
                    depth -= 1
                elif kind == "word" and self.peek()[1] == "=":
                    self.next()
                    self.stage_meta[val] = self.parse_value()
            _ = j
        while self.i < len(self.toks):
            kind, val = self.peek()
            if val in ("def", "over", "class"):
                root.children.append(self.parse_prim(""))
            else:
                self.next()
        return root

    def parse_prim(self, parent_path: str) -> _Prim:
        self.next()  # def/over/class
        kind, val = self.peek()
        type_name = ""
        if kind == "word":
            type_name = val
            self.next()
        _, name_tok = self.next()  # "name"
        name = name_tok[1:-1] if name_tok and name_tok.startswith('"') else str(name_tok)
        path = f"{parent_path}/{name}"
        prim = _Prim(type_name, name, path)
        if self.peek()[1] == "(":
            self.skip_balanced("(", ")")
        assert self.next()[1] == "{", f"expected prim body at {path}"
        while True:
            kind, val = self.peek()
            if val == "}":
                self.next()
                return prim
            if val in ("def", "over", "class"):
                prim.children.append(self.parse_prim(path))
                continue
            self.parse_statement(prim)

    def parse_statement(self, prim: _Prim):
        # [uniform|custom|prepend|append|delete]* [rel|type] name[.timeSamples]
        #     (= value)? (metadata)?
        words = []
        while self.peek()[0] == "word" and self.peek(1)[1] != "=":
            words.append(self.next()[1])
            if len(words) > 6:
                break
        kind, val = self.peek()
        if kind == "word":
            name = self.next()[1]
        elif words:
            name = words.pop()
        else:
            self.next()
            return
        is_rel = "rel" in words
        is_timesamples = name.endswith(".timeSamples")
        if is_timesamples:
            name = name[: -len(".timeSamples")]
        if self.peek()[1] == "=":
            self.next()
            value = self.parse_value()
            if is_rel:
                prim.rels[name] = value
            elif is_timesamples:
                prim.time_samples[name] = value
            else:
                prim.attrs[name] = value
        if self.peek()[1] == "(":
            # attribute metadata (interpolation, elementSize, ...) — parse
            # shallow name=value pairs into attrs under "name:meta"
            self.next()
            depth = 1
            while self.i < len(self.toks) and depth > 0:
                k2, v2 = self.next()
                if v2 == "(":
                    depth += 1
                elif v2 == ")":
                    depth -= 1
                elif k2 == "word" and self.peek()[1] == "=":
                    self.next()
                    prim.attrs[f"{name}:{v2}"] = self.parse_value()


def parse_usda(text: str):
    """Returns (root prim tree, stage metadata)."""
    first_nl = text.find("\n")
    header = text[:first_nl] if first_nl > 0 else text
    if not header.startswith("#usda"):
        raise ValueError("not a usda layer")
    p = _Parser(_tokenize(text[first_nl + 1 :]))
    root = p.parse_stage()
    return root, p.stage_meta


# ---------------------------------------------------------------------------
# conversion helpers
# ---------------------------------------------------------------------------

def _np3(vals) -> np.ndarray:
    return np.asarray([list(v) for v in vals], np.float32)


def _mat4(v) -> np.ndarray:
    """USD matrix4d (row-vector) -> engine column-vector matrix (transpose)."""
    m = np.asarray([list(r) for r in v], np.float32)
    return m.T


def _quats_wxyz_to_xyzw(vals) -> np.ndarray:
    q = np.asarray([list(v) for v in vals], np.float32)
    return q[:, [1, 2, 3, 0]]


def _triangulate(counts, indices):
    tris = []
    k = 0
    for c in counts:
        c = int(c)
        for j in range(1, c - 1):
            tris.append((indices[k], indices[k + j], indices[k + j + 1]))
        k += c
    return np.asarray(tris, np.int32)


def _mesh_from_prim(mesh_prim: _Prim) -> MeshData:
    points = _np3(mesh_prim.attrs["points"])
    counts = mesh_prim.attrs.get("faceVertexCounts", [])
    indices = mesh_prim.attrs.get("faceVertexIndices", [])
    tris = _triangulate(counts, [int(i) for i in indices])

    n = mesh_prim.attrs.get("normals")
    if n is not None and len(n) == len(points):
        normals = _np3(n)
    else:
        normals = _generate_normals(points, tris)

    st = mesh_prim.attrs.get("primvars:st")
    if st is not None and len(st) == len(points):
        uvs = np.asarray([list(v) for v in st], np.float32)
    else:
        uvs = np.zeros((len(points), 2), np.float32)

    color = mesh_prim.attrs.get("primvars:displayColor")
    base = tuple(np.asarray(color[0], np.float32)) if color is not None and len(color) else (0.8, 0.8, 0.8)
    mat = MaterialDef(name=f"{mesh_prim.name}_mat", base_color=base)
    return MeshData(
        positions=points,
        normals=normals.astype(np.float32),
        uvs=uvs,
        submeshes=[SubmeshData(indices=tris, material=mat)],
    )


def _skin_info_from(mesh_prim: _Prim, skel_prim: _Prim | None, anim_prim: _Prim | None,
                    tcps: float, n_verts: int):
    from ..skinning import animation as anim_mod

    if skel_prim is None:
        return None
    joints = [str(j) for j in skel_prim.attrs.get("joints", [])]
    if not joints:
        return None
    bind = np.stack([_mat4(m) for m in skel_prim.attrs["bindTransforms"]])
    rest = np.stack([_mat4(m) for m in skel_prim.attrs["restTransforms"]])
    inverse_bind = np.linalg.inv(bind).astype(np.float32)
    skeleton = anim_mod.Skeleton(
        joint_paths=joints,
        rest_transforms=rest.astype(np.float32),
        inverse_bind_transforms=inverse_bind,
    )

    clip = None
    if anim_prim is not None:
        a_joints = [str(j) for j in anim_prim.attrs.get("joints", joints)]
        ts = anim_prim.time_samples
        times_t = sorted(ts.get("translations", {}))
        times = times_t or sorted(ts.get("rotations", {}))
        if times:
            K, J = len(times), len(a_joints)

            def track(name, width, default):
                samples = ts.get(name)
                uniform = anim_prim.attrs.get(name)
                out = np.tile(np.asarray(default, np.float32), (K, J, 1))
                for k, t in enumerate(times):
                    vals = None
                    if samples is not None:
                        vals = samples.get(t)
                        if vals is None:
                            vals = samples[min(samples, key=lambda x: abs(x - t))]
                    elif uniform is not None:
                        vals = uniform
                    if vals is not None:
                        arr = (
                            _quats_wxyz_to_xyzw(vals)
                            if width == 4
                            else np.asarray([list(v) for v in vals], np.float32)
                        )
                        out[k, : arr.shape[0]] = arr[:J]
                return out

            clip = anim_mod.AnimationClip(
                joint_paths=a_joints,
                times=(np.asarray(times, np.float32) / max(tcps, 1e-6)),
                translations=track("translations", 3, [0, 0, 0]),
                rotations=track("rotations", 4, [0, 0, 0, 1]),
                scales=track("scales", 3, [1, 1, 1]),
            )

    ji = mesh_prim.attrs.get("primvars:skel:jointIndices")
    jw = mesh_prim.attrs.get("primvars:skel:jointWeights")
    es = int(mesh_prim.attrs.get("primvars:skel:jointIndices:elementSize", 4))
    J = len(joints)
    if ji is None or jw is None:
        ji4 = np.zeros((n_verts, 4), np.int32)
        jw4 = np.zeros((n_verts, 4), np.float32)
        jw4[:, 0] = 1.0
    else:
        ji_a = np.asarray([int(x) for x in ji], np.int32).reshape(n_verts, es)
        jw_a = np.asarray([float(x) for x in jw], np.float32).reshape(n_verts, es)
        if es >= 4:
            ji4, jw4 = ji_a[:, :4], jw_a[:, :4]
        else:
            ji4 = np.zeros((n_verts, 4), np.int32)
            jw4 = np.zeros((n_verts, 4), np.float32)
            ji4[:, :es] = ji_a
            jw4[:, :es] = jw_a

    gb = mesh_prim.attrs.get("primvars:skel:geomBindTransform")
    geometry_bind = _mat4(gb) if gb is not None else np.eye(4, dtype=np.float32)

    rest_joints = bind[:, :3, 3].astype(np.float32)
    return dict(
        joint_indices=ji4,
        joint_weights=jw4,
        rest_joints=rest_joints,
        skeleton=skeleton,
        animation=clip,
        geometry_bind=geometry_bind.astype(np.float32),
    )


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def load_usda_text(text: str):
    """Parse a usda layer -> (MeshData, skin_info | None). Multiple Mesh prims
    merge into one MeshData with per-mesh submeshes (Mesh.swift:41-58)."""
    root, meta = parse_usda(text)
    return extract_scene(root, meta)


def extract_scene(root: _Prim, meta: dict):
    """Prim tree (from the usda parser OR the usdc crate reader) ->
    (MeshData, skin_info | None)."""
    tcps = float(meta.get("timeCodesPerSecond", 24.0))

    meshes = root.find("Mesh")
    if not meshes:
        raise ValueError("usda layer contains no Mesh prim")
    skels = root.find("Skeleton")
    anims = root.find("SkelAnimation")
    skel = skels[0] if skels else None
    anim = anims[0] if anims else None

    parts = [_mesh_from_prim(m) for m in meshes]
    if len(parts) == 1:
        mesh = parts[0]
    else:
        v_off = 0
        positions, normals, uvs, subs = [], [], [], []
        for p in parts:
            positions.append(p.positions)
            normals.append(p.normals)
            uvs.append(p.uvs)
            for s in p.submeshes:
                subs.append(SubmeshData(indices=s.indices + v_off, material=s.material))
            v_off += p.positions.shape[0]
        mesh = MeshData(
            positions=np.concatenate(positions),
            normals=np.concatenate(normals),
            uvs=np.concatenate(uvs),
            submeshes=subs,
        )

    skin_info = None
    if skel is not None and len(meshes) == 1:
        skin_info = _skin_info_from(meshes[0], skel, anim, tcps, mesh.positions.shape[0])
    return mesh, skin_info


def load_usdz(path: str | Path):
    """Load the first USD layer from a .usdz container (zip, stored entries).
    USDA layers parse natively; USDC (binary crate) layers decode via
    usdc.read_crate_prims (Model.swift:63-70 ModelIO-load analog)."""
    with zipfile.ZipFile(str(path)) as z:
        names = [n for n in z.namelist() if n.lower().endswith((".usda", ".usd", ".usdc"))]
        if not names:
            raise ValueError(f"{path}: no USD layer in archive")
        data = z.read(names[0])
    return _load_layer_bytes(data)


def _load_layer_bytes(data: bytes):
    if data[:8] == b"PXR-USDC":
        from .usdc import read_crate_prims

        root, meta = read_crate_prims(data)
        return extract_scene(root, meta)
    return load_usda_text(data.decode("utf-8"))


def load_usd(path: str | Path):
    """Dispatch .usdz (zip) / .usdc (binary crate) / .usda / .usd files."""
    p = Path(path)
    if p.suffix.lower() == ".usdz":
        return load_usdz(p)
    return _load_layer_bytes(p.read_bytes())
