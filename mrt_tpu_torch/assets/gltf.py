"""glTF 2.0 loader (.gltf / .glb) — counterpart of ``mrt_tpu/assets/gltf.py``,
the same NumPy code, so both packages load a file to equal arrays: the
rigged-asset pipeline.

The reference loads rigged models from USDZ via ModelIO (Model.swift:63-122).
This image has no USD runtime, so glTF is this framework's portable rigged
format: meshes (POSITION/NORMAL/TEXCOORD_0/JOINTS_0/WEIGHTS_0), materials
(pbrMetallicRoughness -> our Material fields), skins (joints, inverse bind
matrices) and animations (translation/rotation/scale channels) all map onto
the same structures the USDZ path would fill (MeshData, SkinData, Skeleton,
AnimationClip).

Pure-Python/NumPy; no external deps (json + struct + base64).
"""

from __future__ import annotations

import base64
import json
import struct
from pathlib import Path

import numpy as np

from ..skinning.animation import AnimationClip, Skeleton
from ..utils import math3d
from .obj import MaterialDef, MeshData, SubmeshData

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


class GLTF:
    def __init__(self, doc: dict, buffers: list[bytes], base_dir: Path):
        self.doc = doc
        self.buffers = buffers
        self.base_dir = base_dir

    # --- binary plumbing ---------------------------------------------------
    def accessor(self, index: int) -> np.ndarray:
        acc = self.doc["accessors"][index]
        count = acc["count"]
        n = _TYPE_COUNTS[acc["type"]]
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        if "bufferView" not in acc:
            out = np.zeros((count, n), dtype)
        else:
            bv = self.doc["bufferViews"][acc["bufferView"]]
            buf = self.buffers[bv.get("buffer", 0)]
            offset = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
            stride = bv.get("byteStride", 0)
            elem = np.dtype(dtype).itemsize * n
            if stride and stride != elem:
                rows = []
                for i in range(count):
                    start = offset + i * stride
                    rows.append(np.frombuffer(buf, dtype, n, start))
                out = np.stack(rows)
            else:
                out = np.frombuffer(buf, dtype, count * n, offset).reshape(count, n)
        if acc.get("normalized") and dtype != np.float32:
            out = out.astype(np.float32) / np.iinfo(dtype).max
        return np.array(out)

    # --- scene graph ---------------------------------------------------------
    def node_local_matrix(self, node: dict) -> np.ndarray:
        if "matrix" in node:
            return np.asarray(node["matrix"], np.float32).reshape(4, 4).T  # column-major
        t = node.get("translation", [0, 0, 0])
        r = node.get("rotation", [0, 0, 0, 1])
        s = node.get("scale", [1, 1, 1])
        return (
            math3d.translate(t) @ math3d.quat_to_matrix(np.asarray(r, np.float32)) @ math3d.scale(s)
        ).astype(np.float32)

    def node_world_matrices(self) -> list[np.ndarray]:
        nodes = self.doc.get("nodes", [])
        parents = [-1] * len(nodes)
        for i, nd in enumerate(nodes):
            for c in nd.get("children", []):
                parents[c] = i
        world = [None] * len(nodes)

        def resolve(i):
            if world[i] is None:
                local = self.node_local_matrix(nodes[i])
                world[i] = local if parents[i] < 0 else resolve(parents[i]) @ local
            return world[i]

        for i in range(len(nodes)):
            resolve(i)
        return world

    def node_paths(self) -> list[str]:
        nodes = self.doc.get("nodes", [])
        parents = [-1] * len(nodes)
        for i, nd in enumerate(nodes):
            for c in nd.get("children", []):
                parents[c] = i

        def path(i):
            name = nodes[i].get("name", f"node{i}")
            return name if parents[i] < 0 else path(parents[i]) + "/" + name

        return [path(i) for i in range(len(nodes))]


def _load_doc(path: Path) -> GLTF:
    data = path.read_bytes()
    if data[:4] == b"glTF":  # .glb container
        _, _, _ = struct.unpack("<III", data[:12])
        offset = 12
        doc = None
        bin_chunk = b""
        while offset < len(data):
            clen, ctype = struct.unpack("<II", data[offset : offset + 8])
            chunk = data[offset + 8 : offset + 8 + clen]
            if ctype == 0x4E4F534A:  # JSON
                doc = json.loads(chunk)
            elif ctype == 0x004E4942:  # BIN
                bin_chunk = chunk
            offset += 8 + clen
        buffers = [bin_chunk]
    else:
        doc = json.loads(data)
        buffers = []
    g = GLTF(doc, buffers, path.parent)
    for i, b in enumerate(doc.get("buffers", [])):
        if len(g.buffers) > i:
            continue
        uri = b.get("uri", "")
        if uri.startswith("data:"):
            g.buffers.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            g.buffers.append((path.parent / uri).read_bytes())
    return g


def _material_from_gltf(g: GLTF, index: int | None) -> MaterialDef:
    m = MaterialDef()
    if index is None:
        return m
    mat = g.doc.get("materials", [])[index]
    m.name = mat.get("name", f"material{index}")
    pbr = mat.get("pbrMetallicRoughness", {})
    base = pbr.get("baseColorFactor", [1, 1, 1, 1])
    m.base_color = tuple(base[:3])
    m.opacity = float(base[3]) if mat.get("alphaMode") == "BLEND" else 1.0
    m.emission = tuple(mat.get("emissiveFactor", [0, 0, 0]))

    def tex_path(info):
        if not info:
            return None
        tex = g.doc["textures"][info["index"]]
        img = g.doc["images"][tex["source"]]
        uri = img.get("uri")
        if uri and not uri.startswith("data:"):
            return str(g.base_dir / uri)
        return None

    m.map_base_color = tex_path(pbr.get("baseColorTexture"))
    m.map_normal = tex_path(mat.get("normalTexture"))
    # glTF packs metallic(B)+roughness(G) into one texture; we sample .x so a
    # packed map is attached to both channels as an approximation
    mr = tex_path(pbr.get("metallicRoughnessTexture"))
    m.map_roughness = mr
    m.map_metallic = mr
    m.map_emission = tex_path(mat.get("emissiveTexture"))
    return m


def load_gltf(path: str | Path):
    """Load the first skinned (or first) mesh of a glTF file.

    Returns (MeshData, skin_info | None) where skin_info is a dict with
    joint_indices (V,4) int32, joint_weights (V,4) f32, skeleton (Skeleton),
    animation (AnimationClip | None), geometry_bind (4,4) — exactly what
    engine.scene.SkinData wants.
    """
    path = Path(path)
    g = _load_doc(path)
    doc = g.doc

    # pick the first node with a mesh (preferring skinned — the USDZ-preferred
    # resolution analog, Model.swift:63-67)
    nodes = doc.get("nodes", [])
    mesh_nodes = [i for i, nd in enumerate(nodes) if "mesh" in nd]
    if not mesh_nodes:
        raise ValueError(f"no mesh in {path}")
    skinned = [i for i in mesh_nodes if "skin" in nodes[i]]
    node_idx = (skinned or mesh_nodes)[0]
    node = nodes[node_idx]
    mesh = doc["meshes"][node["mesh"]]

    positions, normals, uvs, joints, weights = [], [], [], [], []
    submeshes = []
    v_base = 0
    for prim in mesh["primitives"]:
        attrs = prim["attributes"]
        pos = g.accessor(attrs["POSITION"]).astype(np.float32)
        count = pos.shape[0]
        positions.append(pos)
        normals.append(
            g.accessor(attrs["NORMAL"]).astype(np.float32)
            if "NORMAL" in attrs
            else np.full((count, 3), np.nan, np.float32)
        )
        uvs.append(
            g.accessor(attrs["TEXCOORD_0"]).astype(np.float32)[:, :2]
            if "TEXCOORD_0" in attrs
            else np.zeros((count, 2), np.float32)
        )
        joints.append(
            g.accessor(attrs["JOINTS_0"]).astype(np.int32)
            if "JOINTS_0" in attrs
            else np.zeros((count, 4), np.int32)
        )
        weights.append(
            g.accessor(attrs["WEIGHTS_0"]).astype(np.float32)
            if "WEIGHTS_0" in attrs
            else np.zeros((count, 4), np.float32)
        )
        if "indices" in prim:
            idx = g.accessor(prim["indices"]).reshape(-1).astype(np.int32)
        else:
            idx = np.arange(count, dtype=np.int32)
        idx = idx.reshape(-1, 3) + v_base
        submeshes.append(SubmeshData(indices=idx, material=_material_from_gltf(g, prim.get("material"))))
        v_base += count

    positions = np.concatenate(positions)
    normals = np.concatenate(normals)
    uvs = np.concatenate(uvs)
    joints_arr = np.concatenate(joints)
    weights_arr = np.concatenate(weights)

    if np.isnan(normals).any():
        from .obj import _generate_normals

        idx_all = np.concatenate([s.indices for s in submeshes])
        gen = _generate_normals(positions, idx_all)
        normals = np.where(np.isnan(normals), gen, normals)

    mesh_data = MeshData(positions=positions, normals=normals, uvs=uvs, submeshes=submeshes)

    skin_info = None
    if "skin" in node:
        skin = doc["skins"][node["skin"]]
        joint_nodes = skin["joints"]
        paths = g.node_paths()
        joint_paths = [paths[j] for j in joint_nodes]
        inv_bind = (
            g.accessor(skin["inverseBindMatrices"]).reshape(-1, 4, 4).transpose(0, 2, 1)
            if "inverseBindMatrices" in skin
            else np.tile(np.eye(4, dtype=np.float32), (len(joint_nodes), 1, 1))
        ).astype(np.float32)
        rest_local = np.stack([g.node_local_matrix(nodes[j]) for j in joint_nodes]).astype(np.float32)
        skeleton = Skeleton(
            joint_paths=joint_paths,
            rest_transforms=rest_local,
            inverse_bind_transforms=inv_bind,
        )
        # glTF parents may not be in joint order; recompute from node graph
        node_to_joint = {j: k for k, j in enumerate(joint_nodes)}
        parents = [-1] * len(nodes)
        for i, nd in enumerate(nodes):
            for c in nd.get("children", []):
                parents[c] = i
        jp = []
        for j in joint_nodes:
            p = parents[j]
            while p >= 0 and p not in node_to_joint:
                p = parents[p]
            jp.append(node_to_joint.get(p, -1))
        skeleton.parent_indices = np.asarray(jp, np.int32)

        animation = _load_animation(g, joint_nodes, joint_paths)
        worlds = g.node_world_matrices()
        skin_info = dict(
            joint_indices=joints_arr,
            joint_weights=weights_arr,
            rest_joints=np.stack([worlds[j][:3, 3] for j in joint_nodes]).astype(np.float32),
            skeleton=skeleton,
            animation=animation,
            geometry_bind=None,
        )
    return mesh_data, skin_info


def _load_animation(g: GLTF, joint_nodes: list[int], joint_paths: list[str]) -> AnimationClip | None:
    anims = g.doc.get("animations", [])
    if not anims:
        return None
    anim = anims[0]
    node_to_joint = {j: k for k, j in enumerate(joint_nodes)}
    n_j = len(joint_nodes)

    # collect the union of key times
    times_list = []
    channels = []
    for ch in anim["channels"]:
        tgt = ch["target"]
        node = tgt.get("node")
        if node not in node_to_joint:
            continue
        sampler = anim["samplers"][ch["sampler"]]
        t = g.accessor(sampler["input"]).reshape(-1).astype(np.float32)
        v = g.accessor(sampler["output"]).astype(np.float32)
        channels.append((node_to_joint[node], tgt["path"], t, v))
        times_list.append(t)
    if not channels:
        return None
    times = np.unique(np.concatenate(times_list))

    nodes = g.doc["nodes"]
    trans = np.tile(
        np.stack([np.asarray(nodes[j].get("translation", [0, 0, 0]), np.float32) for j in joint_nodes]),
        (len(times), 1, 1),
    )
    rots = np.tile(
        np.stack([np.asarray(nodes[j].get("rotation", [0, 0, 0, 1]), np.float32) for j in joint_nodes]),
        (len(times), 1, 1),
    )
    scales = np.tile(
        np.stack([np.asarray(nodes[j].get("scale", [1, 1, 1]), np.float32) for j in joint_nodes]),
        (len(times), 1, 1),
    )

    def resample(t_in, v_in, t_out):
        out = np.stack(
            [np.interp(t_out, t_in, v_in[:, k]) for k in range(v_in.shape[1])], axis=1
        )
        return out.astype(np.float32)

    for joint, path, t, v in channels:
        if path == "translation":
            trans[:, joint] = resample(t, v, times)
        elif path == "rotation":
            r = resample(t, v, times)
            n = np.linalg.norm(r, axis=1, keepdims=True)
            rots[:, joint] = r / np.maximum(n, 1e-9)
        elif path == "scale":
            scales[:, joint] = resample(t, v, times)

    return AnimationClip(
        joint_paths=joint_paths,
        times=times,
        translations=trans,
        rotations=rots,
        scales=scales,
    )
