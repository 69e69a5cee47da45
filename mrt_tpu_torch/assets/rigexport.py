"""Writers of a rigged mesh to the formats the loaders read: a USDZ holding
a binary crate layer (``usdc.CrateWriter``), a USDZ holding a USDA text
layer, and a GLB.

Each file holds one skinned Mesh (points, triangles, vertex normals and
UVs, the first submesh's base colour, four joint indices and weights per
vertex), its skeleton (joint paths, bind and rest transforms) and its clip
(per-key translations, rotations and scales). ``unit`` scales every length
as it is written: a rig modelled in metres written with ``unit=100`` is
authored in centimetres, as the reference's ``robot.usdz`` is, and its
model takes the reference's 0.01 scale. Loaded back, the arrays are the
written ones: indices, joint indices and weights bit for bit, floats to
their float32 values (the text layer prints nine significant digits), but
USD's scale track, which the schema keeps as half3. USD matrices are
row-vector (transposed on write, as on load), its quaternions (w, x, y,
z); glTF matrices column-major.
"""

from __future__ import annotations

import io
import json
import struct
import zipfile
from pathlib import Path

import numpy as np

from . import usdc

TIME_CODES_PER_SECOND = 24.0  # USD time codes per second of the clip


def rig_arrays(mesh, skin, unit: float = 1.0) -> dict:
    """The rig as flat arrays, lengths multiplied by ``unit``: float32
    points, normals, uvs, (T,3) int32 triangles, (V,4) joint indices and
    weights, joint paths, float64 column-vector bind (world), rest (local)
    and inverse bind transforms, and the clip's times and (K,J,·) tracks
    (rotations x, y, z, w)."""
    sk, clip = skin.skeleton, skin.animation
    d = np.diag([unit, unit, unit, 1.0])
    d_inv = np.diag([1.0 / unit, 1.0 / unit, 1.0 / unit, 1.0])

    def scaled(m):
        return d @ np.asarray(m, np.float64) @ d_inv

    inverse_bind = scaled(sk.inverse_bind_transforms)
    return dict(
        points=(np.asarray(mesh.positions, np.float64) * unit).astype(np.float32),
        normals=np.asarray(mesh.normals, np.float32),
        uvs=np.asarray(mesh.uvs, np.float32),
        triangles=np.concatenate([s.indices for s in mesh.submeshes]).astype(np.int32),
        color=np.asarray(mesh.submeshes[0].material.base_color, np.float32),
        joint_indices=np.asarray(skin.joint_indices, np.int32),
        joint_weights=np.asarray(skin.joint_weights, np.float32),
        joints=list(sk.joint_paths),
        rest=scaled(sk.rest_transforms),
        inverse_bind=inverse_bind,
        bind=np.linalg.inv(inverse_bind),
        times=np.asarray(clip.times, np.float64),
        translations=(np.asarray(clip.translations, np.float64) * unit).astype(np.float32),
        rotations=np.asarray(clip.rotations, np.float32),
        scales=np.asarray(clip.scales, np.float32),
    )


def _wxyz(q):
    return np.asarray(q, np.float32)[..., [3, 0, 1, 2]]


def usdc_layer(mesh, skin, unit: float = 1.0) -> bytes:
    """The rig as a binary crate layer (version 0.8.0)."""
    a = rig_arrays(mesh, skin, unit)
    w = usdc.CrateWriter()
    prim = lambda type_name: {"typeName": w.rep_token(type_name),  # noqa: E731
                              "specifier": (usdc.T_SPECIFIER << 48) | usdc._INLINED_BIT | 0}
    w.add_spec("/", usdc.SPEC_PSEUDO_ROOT, {
        "timeCodesPerSecond": w.rep_scalar(usdc.T_DOUBLE, TIME_CODES_PER_SECOND),
        "metersPerUnit": w.rep_scalar(usdc.T_DOUBLE, 1.0 / unit),
        "upAxis": w.rep_token("Y"),
        "defaultPrim": w.rep_token("Rig"),
    })
    w.add_spec("/Rig", usdc.SPEC_PRIM, prim("Xform"))
    w.add_spec("/Rig/character", usdc.SPEC_PRIM, prim("Mesh"))
    n_tris = a["triangles"].shape[0]
    attrs = {
        "points": w.rep_array(usdc.T_VEC3F, a["points"]),
        "normals": w.rep_array(usdc.T_VEC3F, a["normals"]),
        "primvars:st": w.rep_array(usdc.T_VEC2F, a["uvs"]),
        "faceVertexCounts": w.rep_array(usdc.T_INT, np.full(n_tris, 3, np.int32)),
        "faceVertexIndices": w.rep_array(usdc.T_INT, a["triangles"].reshape(-1)),
        "primvars:displayColor": w.rep_array(usdc.T_VEC3F, a["color"][None]),
        "primvars:skel:jointIndices": w.rep_array(usdc.T_INT, a["joint_indices"].reshape(-1)),
        "primvars:skel:jointWeights": w.rep_array(usdc.T_FLOAT, a["joint_weights"].reshape(-1)),
        "primvars:skel:geomBindTransform": w.rep_matrix4d(np.eye(4)),
    }
    for name, rep in attrs.items():
        fields = {"default": rep}
        if name == "primvars:skel:jointIndices":
            fields["elementSize"] = w.rep_scalar(usdc.T_INT, 4)
        w.add_spec(f"/Rig/character.{name}", usdc.SPEC_ATTRIBUTE, fields)
    w.add_spec("/Rig/skel", usdc.SPEC_PRIM, prim("Skeleton"))
    w.add_spec("/Rig/skel.joints", usdc.SPEC_ATTRIBUTE,
               {"default": w.rep_token_array(a["joints"])})
    for name in ("bind", "rest"):
        w.add_spec(f"/Rig/skel.{name}Transforms", usdc.SPEC_ATTRIBUTE, {
            "default": w.rep_array(usdc.T_MATRIX4D, a[name].transpose(0, 2, 1))})
    w.add_spec("/Rig/skel/anim", usdc.SPEC_PRIM, prim("SkelAnimation"))
    w.add_spec("/Rig/skel/anim.joints", usdc.SPEC_ATTRIBUTE,
               {"default": w.rep_token_array(a["joints"])})
    codes = a["times"] * TIME_CODES_PER_SECOND
    for name, ty, track in (("translations", usdc.T_VEC3F, a["translations"]),
                            ("rotations", usdc.T_QUATF, _wxyz(a["rotations"])),
                            ("scales", usdc.T_VEC3H, a["scales"])):
        samples = {float(t): track[k] for k, t in enumerate(codes)}
        w.add_spec(f"/Rig/skel/anim.{name}", usdc.SPEC_ATTRIBUTE,
                   {"timeSamples": w.rep_time_samples(samples, ty)})
    return w.tobytes()


def _nums(a) -> str:
    """Comma-separated values of ``a`` (floats as float32, nine digits)."""
    a = np.asarray(a)
    if a.dtype.kind == "f":
        return ", ".join(f"{x:.9g}" for x in a.astype(np.float32).astype(np.float64).ravel())
    return ", ".join(str(int(x)) for x in a.ravel())


def _tuples(a) -> str:
    a = np.asarray(a)
    return ", ".join(f"({_nums(row)})" for row in a.reshape(a.shape[0], -1))


def _matrices(ms) -> str:
    return ", ".join(f"( {_tuples(np.asarray(m, np.float64).T)} )" for m in ms)


def usda_layer(mesh, skin, unit: float = 1.0) -> str:
    """The rig as a USDA text layer."""
    a = rig_arrays(mesh, skin, unit)
    joints = ", ".join(f'"{j}"' for j in a["joints"])
    codes = a["times"] * TIME_CODES_PER_SECOND

    def samples(track):
        return ",\n                ".join(f"{t:.17g}: [{_tuples(track[k])}]"
                                          for k, t in enumerate(codes))

    vertex = '(\n            interpolation = "vertex"\n        )'
    by4 = '(\n            elementSize = 4\n            interpolation = "vertex"\n        )'
    return f"""#usda 1.0
(
    defaultPrim = "Rig"
    metersPerUnit = {1.0 / unit:.17g}
    timeCodesPerSecond = {TIME_CODES_PER_SECOND:.17g}
    upAxis = "Y"
)

def Xform "Rig"
{{
    def Mesh "character" (
        prepend apiSchemas = ["SkelBindingAPI"]
    )
    {{
        int[] faceVertexCounts = [{", ".join("3" for _ in range(a["triangles"].shape[0]))}]
        int[] faceVertexIndices = [{_nums(a["triangles"])}]
        point3f[] points = [{_tuples(a["points"])}]
        normal3f[] normals = [{_tuples(a["normals"])}] {vertex}
        texCoord2f[] primvars:st = [{_tuples(a["uvs"])}] {vertex}
        color3f[] primvars:displayColor = [({_nums(a["color"])})]
        int[] primvars:skel:jointIndices = [{_nums(a["joint_indices"])}] {by4}
        float[] primvars:skel:jointWeights = [{_nums(a["joint_weights"])}] {by4}
        matrix4d primvars:skel:geomBindTransform = {_matrices([np.eye(4)])}
        rel skel:skeleton = </Rig/skel>
    }}

    def Skeleton "skel"
    {{
        uniform token[] joints = [{joints}]
        uniform matrix4d[] bindTransforms = [{_matrices(a["bind"])}]
        uniform matrix4d[] restTransforms = [{_matrices(a["rest"])}]

        def SkelAnimation "anim"
        {{
            uniform token[] joints = [{joints}]
            float3[] translations.timeSamples = {{
                {samples(a["translations"])}
            }}
            quatf[] rotations.timeSamples = {{
                {samples(_wxyz(a["rotations"]))}
            }}
            half3[] scales.timeSamples = {{
                {samples(a["scales"])}
            }}
        }}
    }}
}}
"""


def usdz(layer: bytes, name: str = "character.usdc") -> bytes:
    """A .usdz archive (an uncompressed zip) holding one layer."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as z:
        z.writestr(name, layer)
    return buf.getvalue()


def glb(mesh, skin, unit: float = 1.0) -> bytes:
    """The rig as a binary glTF 2.0 file: one skinned mesh node, a node
    for the joint paths' common root holding the joint hierarchy, one skin,
    one animation with a translation, rotation and scale channel per joint.
    A joint node carries its rest transform as a translation (glTF forbids
    a matrix on an animated node), so the rest transforms must be
    translations, as a swing rig's are."""
    a = rig_arrays(mesh, skin, unit)
    rest = a["rest"]
    if not (np.allclose(rest[:, :3, :3], np.eye(3)) and np.allclose(rest[:, 3], [0, 0, 0, 1])):
        raise ValueError("glb: a rest transform is not a translation")
    joints = a["joints"]
    n_j = len(joints)
    names = [p.rsplit("/", 1)[-1] for p in joints]
    prefix = [p.rsplit("/", 1)[0] if "/" in p else None for p in joints]
    parents = [joints.index(q) if q in joints else -1 for q in prefix]
    if any(p >= j for j, p in enumerate(parents)):
        raise ValueError("glb: joints must follow their parents")
    roots = {prefix[j] for j, p in enumerate(parents) if p < 0}
    if len(roots) != 1:
        raise ValueError("glb: the top joints must share one parent path")
    root = roots.pop()

    blob = bytearray()
    views, accessors = [], []

    def accessor(arr, type_name, component=5126):
        arr = np.ascontiguousarray(arr)
        start = len(blob)
        raw = arr.tobytes()
        blob.extend(raw + b"\0" * (-len(raw) % 4))
        views.append({"buffer": 0, "byteOffset": start, "byteLength": len(raw)})
        accessors.append({"bufferView": len(views) - 1, "componentType": component,
                          "count": int(arr.shape[0]), "type": type_name})
        return len(accessors) - 1

    joint_dtype, joint_component = ((np.uint8, 5121) if n_j <= 256 else (np.uint16, 5123))
    attrs = {"POSITION": accessor(a["points"], "VEC3"), "NORMAL": accessor(a["normals"], "VEC3"),
             "TEXCOORD_0": accessor(a["uvs"], "VEC2"),
             "JOINTS_0": accessor(a["joint_indices"].astype(joint_dtype), "VEC4", joint_component),
             "WEIGHTS_0": accessor(a["joint_weights"], "VEC4")}
    indices = accessor(a["triangles"].reshape(-1).astype(np.uint32), "SCALAR", 5125)
    ibm = accessor(a["inverse_bind"].astype(np.float32).transpose(0, 2, 1).reshape(n_j, 16), "MAT4")
    times = accessor(a["times"].astype(np.float32), "SCALAR")

    nodes = [{"name": "character", "mesh": 0, "skin": 0}]
    first = len(nodes) + (root is not None)
    tops = [first + j for j, p in enumerate(parents) if p < 0]
    if root is not None:
        nodes.append({"name": root, "children": tops})
    for j in range(n_j):
        node = {"name": names[j],
                "translation": [float(x) for x in rest[j, :3, 3].astype(np.float32)]}
        kids = [first + k for k, p in enumerate(parents) if p == j]
        if kids:
            node["children"] = kids
        nodes.append(node)
    channels, samplers = [], []
    for j in range(n_j):
        for path, track, type_name in (("translation", a["translations"], "VEC3"),
                                       ("rotation", a["rotations"], "VEC4"),
                                       ("scale", a["scales"], "VEC3")):
            samplers.append({"input": times, "output": accessor(track[:, j], type_name)})
            channels.append({"sampler": len(samplers) - 1,
                             "target": {"node": first + j, "path": path}})
    color = [float(x) for x in a["color"]] + [1.0]
    doc = {
        "asset": {"version": "2.0"},
        "buffers": [{"byteLength": len(blob)}],
        "bufferViews": views,
        "accessors": accessors,
        "nodes": nodes,
        "meshes": [{"primitives": [{"attributes": attrs, "indices": indices, "material": 0}]}],
        "materials": [{"name": mesh.submeshes[0].material.name,
                       "pbrMetallicRoughness": {"baseColorFactor": color}}],
        "skins": [{"joints": [first + j for j in range(n_j)], "inverseBindMatrices": ibm}],
        "animations": [{"channels": channels, "samplers": samplers}],
        "scenes": [{"nodes": [0] + ([1] if root is not None else tops)}],
    }
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    out = b"glTF" + struct.pack("<II", 2, 12 + 8 + len(js) + 8 + len(blob))
    out += struct.pack("<II", len(js), 0x4E4F534A) + js
    return out + struct.pack("<II", len(blob), 0x004E4942) + bytes(blob)


def write_rig(directory, name: str, mesh, skin, unit: float = 1.0) -> dict:
    """Write the rig in each format to ``directory``: ``<name>.usdz`` (a
    crate layer), ``<name>_text.usdz`` (a USDA layer) and ``<name>.glb``.
    Returns the paths by format ("usdc", "usda", "glb")."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    paths = {"usdc": d / f"{name}.usdz", "usda": d / f"{name}_text.usdz", "glb": d / f"{name}.glb"}
    paths["usdc"].write_bytes(usdz(usdc_layer(mesh, skin, unit)))
    paths["usda"].write_bytes(usdz(usda_layer(mesh, skin, unit).encode(), "character.usda"))
    paths["glb"].write_bytes(glb(mesh, skin, unit))
    return paths
