"""[The benchmark's reference: a frozen copy of ``mrt_tpu_torch/assets/obj.py``.]

Mesh and material types (the copy leaves out the OBJ and MTL loaders:
the reference reads no asset files).

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
