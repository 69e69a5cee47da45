"""Wavefront OBJ + MTL loader.

The TPU-framework analog of the reference's ModelIO OBJ path
(``Model.swift:63-81,304-341``): produces the same logical buffer layout the
reference builds for each mesh/submesh —

* separate position / normal / uv vertex arrays (``Mesh.swift:25-39``)
* 32-bit triangle indices (``SubMesh.swift:243-265``)
* one submesh per material with a ``Material`` struct built from the MTL
  (``SubMesh.swift:291-324``: Kd -> baseColor, Ks -> specular, Ke -> emission,
  Ns -> specularExponent, Ni -> refractionIndex, d -> opacity)
* normals generated if missing (``Model.swift:137-145``)

Pure NumPy — asset loading is host-side work; arrays get device_put later.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path

import numpy as np


@dataclasses.dataclass
class MaterialDef:
    """Host-side material record (maps onto core.types.Materials rows)."""

    name: str = "default"
    base_color: tuple = (1.0, 1.0, 1.0)  # Kd
    specular: tuple = (0.0, 0.0, 0.0)  # Ks
    emission: tuple = (0.0, 0.0, 0.0)  # Ke
    specular_exponent: float = 0.0  # Ns
    refraction_index: float = 1.0  # Ni
    opacity: float = 1.0  # d (or 1 - Tr)
    # texture file paths (resolved relative to the MTL), or None
    map_base_color: str | None = None  # map_Kd
    map_normal: str | None = None  # map_bump / bump / norm
    map_roughness: str | None = None  # map_Pr
    map_metallic: str | None = None  # map_Pm
    map_ao: str | None = None  # map_Ka (AO by convention here)
    map_opacity: str | None = None  # map_d
    map_emission: str | None = None  # map_Ke


@dataclasses.dataclass
class SubmeshData:
    """Per-material draw unit — the analog of ``Submesh`` (SubMesh.swift:38-54)."""

    indices: np.ndarray  # (T,3) int32 into the mesh vertex arrays
    material: MaterialDef


@dataclasses.dataclass
class MeshData:
    """Loaded mesh: SoA vertex arrays + submeshes (``Mesh.swift:25-39``)."""

    positions: np.ndarray  # (V,3) f32
    normals: np.ndarray  # (V,3) f32
    uvs: np.ndarray  # (V,2) f32
    submeshes: list

    @property
    def triangle_count(self) -> int:
        return sum(s.indices.shape[0] for s in self.submeshes)


def _parse_floats(parts, n, default=0.0):
    vals = [float(p) for p in parts[:n]]
    while len(vals) < n:
        vals.append(default)
    return vals


def load_mtl(path: str | Path) -> dict[str, MaterialDef]:
    """Parse an MTL file into MaterialDef records."""
    path = Path(path)
    materials: dict[str, MaterialDef] = {}
    cur: MaterialDef | None = None
    if not path.exists():
        return materials
    base = path.parent
    for raw in path.read_text(errors="replace").splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        key = parts[0].lower()
        args = parts[1:]
        if key == "newmtl":
            cur = MaterialDef(name=" ".join(args) or "default")
            materials[cur.name] = cur
            continue
        if cur is None:
            continue
        if key == "kd":
            cur.base_color = tuple(_parse_floats(args, 3))
        elif key == "ks":
            cur.specular = tuple(_parse_floats(args, 3))
        elif key == "ke":
            cur.emission = tuple(_parse_floats(args, 3))
        elif key == "ns":
            cur.specular_exponent = _parse_floats(args, 1)[0]
        elif key == "ni":
            cur.refraction_index = _parse_floats(args, 1)[0]
        elif key == "d":
            cur.opacity = float(np.clip(_parse_floats(args, 1, 1.0)[0], 0.0, 1.0))
        elif key == "tr":
            cur.opacity = float(np.clip(1.0 - _parse_floats(args, 1)[0], 0.0, 1.0))
        elif key in ("map_kd",):
            cur.map_base_color = str(base / args[-1])
        elif key in ("map_bump", "bump", "norm", "map_kn"):
            cur.map_normal = str(base / args[-1])
        elif key in ("map_pr",):
            cur.map_roughness = str(base / args[-1])
        elif key in ("map_pm",):
            cur.map_metallic = str(base / args[-1])
        elif key in ("map_ka",):
            cur.map_ao = str(base / args[-1])
        elif key in ("map_d",):
            cur.map_opacity = str(base / args[-1])
        elif key in ("map_ke",):
            cur.map_emission = str(base / args[-1])
    return materials


def _generate_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (ModelIO ``addNormals`` analog,
    Model.swift:139)."""
    normals = np.zeros_like(positions)
    v0 = positions[indices[:, 0]]
    v1 = positions[indices[:, 1]]
    v2 = positions[indices[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)
    for k in range(3):
        np.add.at(normals, indices[:, k], fn)
    norm = np.linalg.norm(normals, axis=1, keepdims=True)
    return (normals / np.maximum(norm, 1e-12)).astype(np.float32)


def load_obj(path: str | Path) -> MeshData:
    """Load an OBJ file. Faces are fan-triangulated; v/vt/vn index triples are
    de-duplicated into unified vertex arrays (the 5-buffer vertex-descriptor
    layout of Model.swift:304-341, minus joint data which OBJ lacks)."""
    path = Path(path)
    raw_v: list = []
    raw_vt: list = []
    raw_vn: list = []
    materials: dict[str, MaterialDef] = {}
    cur_mtl = MaterialDef()
    # corner key -> unified index
    vert_map: dict[tuple, int] = {}
    out_pos: list = []
    out_uv: list = []
    out_nrm: list = []
    sub_indices: dict[str, list] = {}
    sub_mtls: dict[str, MaterialDef] = {"default": cur_mtl}
    cur_name = "default"

    def corner(tok: str) -> int:
        comp = tok.split("/")
        vi = int(comp[0])
        ti = int(comp[1]) if len(comp) > 1 and comp[1] else 0
        ni = int(comp[2]) if len(comp) > 2 and comp[2] else 0
        vi = vi - 1 if vi > 0 else len(raw_v) + vi
        ti = ti - 1 if ti > 0 else (len(raw_vt) + ti if ti else -1)
        ni = ni - 1 if ni > 0 else (len(raw_vn) + ni if ni else -1)
        key = (vi, ti, ni)
        idx = vert_map.get(key)
        if idx is None:
            idx = len(out_pos)
            vert_map[key] = idx
            out_pos.append(raw_v[vi])
            out_uv.append(raw_vt[ti] if ti >= 0 else (0.0, 0.0))
            out_nrm.append(raw_vn[ni] if ni >= 0 else None)
        return idx

    for raw in path.read_text(errors="replace").splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        key = parts[0]
        if key == "v":
            raw_v.append(tuple(_parse_floats(parts[1:], 3)))
        elif key == "vt":
            raw_vt.append(tuple(_parse_floats(parts[1:], 2)))
        elif key == "vn":
            raw_vn.append(tuple(_parse_floats(parts[1:], 3)))
        elif key == "mtllib":
            mtl_path = path.parent / " ".join(parts[1:])
            materials.update(load_mtl(mtl_path))
        elif key == "usemtl":
            name = " ".join(parts[1:])
            cur_name = name
            cur_mtl = materials.get(name, MaterialDef(name=name))
            sub_mtls[cur_name] = cur_mtl
        elif key == "f":
            ids = [corner(tok) for tok in parts[1:]]
            tris = sub_indices.setdefault(cur_name, [])
            for k in range(1, len(ids) - 1):
                tris.append((ids[0], ids[k], ids[k + 1]))

    positions = np.asarray(out_pos, np.float32).reshape(-1, 3)
    uvs = np.asarray(out_uv, np.float32).reshape(-1, 2)

    submeshes = []
    all_indices = []
    for name, tris in sub_indices.items():
        idx = np.asarray(tris, np.int32).reshape(-1, 3)
        submeshes.append(SubmeshData(indices=idx, material=sub_mtls[name]))
        all_indices.append(idx)
    if not submeshes:
        raise ValueError(f"OBJ contains no faces: {path}")
    indices_all = np.concatenate(all_indices, axis=0)

    have_all_normals = all(n is not None for n in out_nrm)
    if have_all_normals:
        normals = np.asarray(out_nrm, np.float32).reshape(-1, 3)
    else:
        normals = _generate_normals(positions, indices_all)
        # keep any authored normals
        for i, n in enumerate(out_nrm):
            if n is not None:
                normals[i] = n

    return MeshData(positions=positions, normals=normals, uvs=uvs, submeshes=submeshes)
