"""[The benchmark's reference: a frozen copy of ``mrt_tpu_torch/engine/scene.py``.]

Scene graph + scene compiler — counterpart of ``mrt_tpu/engine/scene.py``.

``Scene``/``Model`` keep the JAX package's model list, lights, orbit
camera parameters and material overrides (the runtime moves, the
environment map and the texture atlas, which no cell of the benchmark
uses, are left out). ``Scene.compile(device)`` flattens every model into
one vertex/triangle pool in object space, per-instance 4x4 transforms and
a material table, as torch tensors on ``device``; the flattening is the JAX package's NumPy code, so the
arrays are equal. A skinned model (``Model(skin=SkinData(...))``) also gets
its dense weights and rest pose on the device (``Scene.skin_bundle``) and
its vertex slice in ``SceneStatics.skin_slices``. A model's name picks
its procedural stand-in (``_resolve_mesh``): the benchmark reads no asset
files.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .obj import MaterialDef, MeshData
from . import types as T
from .device import resolve as resolve_device
from . import lbs
from . import math3d


@dataclasses.dataclass
class ModelMaterialOverride:
    base_color: tuple | None = None
    refraction_index: float | None = None
    opacity: float | None = None

    @staticmethod
    def glass(tint=(0.95, 0.98, 1.0), refraction_index=1.52, opacity=0.08) -> "ModelMaterialOverride":
        return ModelMaterialOverride(tint, refraction_index, opacity)


@dataclasses.dataclass
class SkinData:
    """Per-model skinning bind info (MeshSkinningInfo analog, Mesh.swift:10-15)."""

    joint_indices: np.ndarray  # (V,4) int32, model-local joint ids
    joint_weights: np.ndarray  # (V,4) f32 (NOT normalized — Skinning.metal:26-31)
    rest_joints: np.ndarray  # (J,3) rest joint positions (procedural rigs)
    skeleton: object | None = None  # skinning.animation.Skeleton
    animation: object | None = None  # skinning.animation.AnimationClip
    geometry_bind: np.ndarray | None = None  # (4,4) geometryBindTransform
    current_time: float = 0.0


class Model:
    """One instance of a mesh with a TRS transform, skinned when ``skin``
    is given."""

    def __init__(self, name: str, position=(0.0, 0.0, 0.0), rotation=(0.0, 0.0, 0.0),
                 scale: float = 1.0, material_override: ModelMaterialOverride | None = None,
                 mesh: MeshData | None = None, skin: SkinData | None = None,
                 geometry_mask: int = T.GEOMETRY_MASK_GEOMETRY):
        self.name = name
        self.geometry_mask = int(geometry_mask)
        self.position = np.asarray(position, np.float32)
        self.rotation = np.asarray(rotation, np.float32)
        self.scale = float(scale)
        self.material_override = material_override
        self.mesh = mesh if mesh is not None else _resolve_mesh(name)
        self.skin = skin
        # rigged asset formats (USD, glTF) attach skin info during resolution
        si = getattr(self.mesh, "_skin_info", None)
        if self.skin is None and si:
            self.skin = SkinData(joint_indices=si["joint_indices"],
                                 joint_weights=si["joint_weights"],
                                 rest_joints=si["rest_joints"], skeleton=si["skeleton"],
                                 animation=si["animation"], geometry_bind=si["geometry_bind"])

    def effective_materials(self) -> list[MaterialDef]:
        """Per-submesh materials with this model's override applied (a
        snapshot: meshes may be shared between models)."""
        mats = []
        for sub in self.mesh.submeshes:
            m = dataclasses.replace(sub.material)
            if self.material_override is not None:
                _apply_override(m, self.material_override)
            mats.append(m)
        return mats

    @property
    def world_transform(self) -> np.ndarray:
        return math3d.trs(self.position, self.rotation, self.scale)


def _apply_override(mat: MaterialDef, o: ModelMaterialOverride):
    if o.base_color is not None:
        mat.base_color = tuple(o.base_color)
    if o.refraction_index is not None:
        mat.refraction_index = max(o.refraction_index, 1.0)
    if o.opacity is not None:
        mat.opacity = float(np.clip(o.opacity, 0.0, 1.0))


_MESH_CACHE: dict = {}


def _resolve_mesh(name: str) -> MeshData:
    """USD, glTF or OBJ from the asset search paths, else the procedural
    stand-ins of the JAX package. Cached by name, so models of one asset
    share one mesh (and one BLAS); pop a name from ``_MESH_CACHE`` to load
    its file again."""
    if name not in _MESH_CACHE:
        _MESH_CACHE[name] = _resolve_mesh_uncached(name)
    return _MESH_CACHE[name]


def _resolve_mesh_uncached(name: str) -> MeshData:
    """The procedural stand-ins of the app scene (the benchmark reads no
    asset files)."""
    from . import procedural

    if name == "dragon":
        return procedural.blob(subdivisions=6, radius=0.28, seed=7, material=MaterialDef(
            name="Dragon", base_color=(1.0, 0.0, 0.0), specular=(0.2, 0.2, 0.2)))
    if name == "bunny":
        return procedural.blob(subdivisions=5, radius=0.3, seed=13,
                               material=MaterialDef(name="Bunny", base_color=(0.9, 0.85, 0.8)))
    if name == "robot":
        mesh, ji, jw, rest = procedural.skinned_cylinder()
        mesh._skin_stub = (ji, jw, rest)  # picked up by make_app_scene
        return mesh
    if name == "sphere":
        return procedural.uv_sphere()
    if name.startswith("plane"):
        return procedural.plane()
    raise FileNotFoundError(f"No asset or procedural stand-in for model '{name}'")


class SkinModelData(NamedTuple):
    """Per-skinned-model device data: dense weights + rest pose."""

    weights_dense: torch.Tensor  # (Vm, J) f32
    rest_positions: torch.Tensor  # (Vm, 3)
    rest_normals: torch.Tensor  # (Vm, 3)


class SceneData(NamedTuple):
    """Flattened scene as device tensors."""

    positions_obj: torch.Tensor  # (V,3) f32 object space (rest or skinned)
    prev_positions_obj: torch.Tensor  # (V,3) f32 the previous frame's
    normals_obj: torch.Tensor  # (V,3) f32
    uvs: torch.Tensor  # (V,2) f32
    vertex_instance: torch.Tensor  # (V,) int32
    indices: torch.Tensor  # (Tr,3) int32 global vertex ids
    tri_resource: torch.Tensor  # (Tr,) int32
    tri_instance: torch.Tensor  # (Tr,) int32
    instance_transform: torch.Tensor  # (I,4,4) f32
    prev_instance_transform: torch.Tensor  # (I,4,4) f32
    materials: T.Materials
    lights: T.Lights


@dataclasses.dataclass(frozen=True)
class SceneStatics:
    """Per-scene facts that select code paths."""

    n_vertices: int
    n_triangles: int
    n_instances: int
    n_resources: int
    n_lights: int
    has_refraction: bool
    has_textures: bool = False  # a material names a map (not worked out here)
    has_masks: bool = False
    # per skinned model: (model_index, vertex_start, vertex_count)
    skin_slices: tuple = ()


class Scene:
    """Model list + lights + orbit camera parameters + compiler."""

    def __init__(self, width: int = 512, height: int = 512):
        self.models: list[Model] = []
        self.width = width
        self.height = height
        self.camera_target = np.zeros(3, np.float32)
        default_position = np.array([0.0, 1.0, 5.38], np.float32)
        offset = default_position - self.camera_target
        self.camera_distance = max(0.001, float(np.linalg.norm(offset)))
        self.camera_azimuth = float(np.arctan2(offset[0], offset[2]))
        self.camera_elevation = float(np.arcsin(offset[1] / self.camera_distance))
        self.camera_fov_degrees = 45.0
        self.is_dirty = False
        light1 = T.area_light(position=[0.0, 1.98, 0.0], forward=[0.0, -1.0, 0.0],
                              right=[0.25, 0.0, 0.0], up=[0.0, 0.0, 0.25], color=[4.0, 4.0, 4.0])
        light3 = T.spot_light(position=[2, 1, 4], direction=[-1.5, -0.5, -1.5],
                              cone_angle=25 / 180 * np.pi, color=[4, 4, 4])
        self.lights = T.concat_lights(light1, light3)
        self.skin_bundle: tuple = ()  # per skinned model, SkinModelData (set by compile)

    # --- compiler ------------------------------------------------------------------
    def instance_transforms(self) -> np.ndarray:
        return np.stack([m.world_transform for m in self.models]).astype(np.float32)

    def compile(self, device=None) -> tuple[SceneData, SceneStatics]:
        """Flatten the models into SceneData on ``device`` (default: the
        card; raises when there is none, so CPU use needs ``"cpu"``)."""
        device = resolve_device(device)
        positions, normals, uvs, vert_inst = [], [], [], []
        indices, tri_res, tri_inst = [], [], []
        mats: list[MaterialDef] = []
        skin_slices, skin_bundle = [], []
        v_base = 0
        for inst, model in enumerate(self.models):
            mesh = model.mesh
            if model.skin is not None:
                n_joints = model.skin.rest_joints.shape[0]
                skin_slices.append((inst, v_base, mesh.positions.shape[0]))
                skin_bundle.append(SkinModelData(
                    weights_dense=torch.as_tensor(lbs.dense_weights(
                        model.skin.joint_indices, model.skin.joint_weights, n_joints)).to(device),
                    rest_positions=torch.as_tensor(mesh.positions).to(device),
                    rest_normals=torch.as_tensor(mesh.normals).to(device)))
            positions.append(mesh.positions)
            normals.append(mesh.normals)
            uvs.append(mesh.uvs)
            vert_inst.append(np.full(mesh.positions.shape[0], inst, np.int32))
            for sub, mat in zip(mesh.submeshes, model.effective_materials()):
                res_id = len(mats)
                mats.append(mat)
                indices.append(sub.indices + v_base)
                tri_res.append(np.full(sub.indices.shape[0], res_id, np.int32))
                tri_inst.append(np.full(sub.indices.shape[0], inst, np.int32))
            v_base += mesh.positions.shape[0]

        n_res = len(mats)
        has_textures = any(getattr(m, f"map_{k}") is not None for m in mats
                           for k in ("base_color", "normal", "roughness", "metallic", "ao",
                                     "opacity", "emission"))

        def f32(rows, shape):
            return torch.as_tensor(np.asarray(rows, np.float32).reshape(shape))

        materials = T.Materials(
            base_color=f32([m.base_color for m in mats], (n_res, 3)),
            specular=f32([m.specular for m in mats], (n_res, 3)),
            emission=f32([m.emission for m in mats], (n_res, 3)),
            specular_exponent=f32([m.specular_exponent for m in mats], (n_res,)),
            refraction_index=f32([m.refraction_index for m in mats], (n_res,)),
            opacity=f32([m.opacity for m in mats], (n_res,)),
            texture_flags=torch.zeros(n_res, dtype=torch.int32),
        )

        transforms = self.instance_transforms()
        pos_np = np.concatenate(positions)
        idx_np = np.concatenate(indices)
        vinst_np = np.concatenate(vert_inst)
        tinst_np = np.concatenate(tri_inst)
        # host copies for the BVH builders
        self.host_mirror = dict(positions=pos_np, indices=idx_np, vertex_instance=vinst_np,
                                tri_instance=tinst_np, transforms=transforms)

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a)).to(device)

        pos = dev(pos_np)
        tfm = dev(transforms)
        data = SceneData(
            positions_obj=pos,
            prev_positions_obj=pos,
            normals_obj=dev(np.concatenate(normals)),
            uvs=dev(np.concatenate(uvs)),
            vertex_instance=dev(vinst_np),
            indices=dev(idx_np),
            tri_resource=dev(np.concatenate(tri_res)),
            tri_instance=dev(tinst_np),
            instance_transform=tfm,
            prev_instance_transform=tfm,
            materials=T.to_device(materials, device),
            lights=T.to_device(self.lights, device),
        )
        mats_ior = np.asarray([m.refraction_index for m in mats], np.float32)
        mats_op = np.asarray([m.opacity for m in mats], np.float32)
        statics = SceneStatics(
            n_vertices=int(pos_np.shape[0]),
            n_triangles=int(idx_np.shape[0]),
            n_instances=len(self.models),
            n_resources=n_res,
            n_lights=int(self.lights.count),
            has_refraction=bool(((mats_ior > 1.01) | (mats_op < 0.999)).any()),
            has_textures=has_textures,
            has_masks=any(m.geometry_mask != T.GEOMETRY_MASK_GEOMETRY for m in self.models),
            skin_slices=tuple(skin_slices),
        )
        self.skin_bundle = tuple(skin_bundle)
        return data, statics


def world_geometry(scene: SceneData):
    """Apply per-instance transforms to the vertex pool. Returns
    (positions_world, prev_positions_world, normals_world); normals go
    through the instance matrix itself, as in the JAX package."""
    vi = scene.vertex_instance.long()
    M = scene.instance_transform[vi]
    Mp = scene.prev_instance_transform[vi]
    pos_w = math3d.apply_affine(M, scene.positions_obj, True)
    prev_w = math3d.apply_affine(Mp, scene.prev_positions_obj, True)
    nrm_w = math3d.apply_affine(M, scene.normals_obj, False)
    return pos_w, prev_w, nrm_w
