"""Scene graph + scene compiler — counterpart of ``mrt_tpu/engine/scene.py``.

``Scene``/``Model`` keep the JAX package's API (model list, lights, orbit
camera parameters, ``move_model``/``rotate_model``/``set_light_intensity``,
material overrides, dirty flag). ``Scene.compile(device)`` flattens every
model into one vertex/triangle pool in object space, per-instance 4x4
transforms, a material table and a packed texture atlas, as torch tensors
on ``device``; the flattening is the JAX package's NumPy code, so the
arrays are equal. A skinned model (``Model(skin=SkinData(...))``) also gets
its dense weights and rest pose on the device (``Scene.skin_bundle``) and
its vertex slice in ``SceneStatics.skin_slices``.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..assets import texture as tex
from ..assets.obj import MaterialDef, MeshData, load_obj
from ..core import types as T
from ..core.device import resolve as resolve_device
from ..skinning import lbs
from ..utils import math3d

# The repository's own asset folder, then the folders listed in MRT_ASSET_PATH
# (os.pathsep-separated), where the demo scene's OBJ files are installed.
ASSET_SEARCH_PATHS = [Path(__file__).resolve().parents[2] / "assets_local"] + [
    Path(p) for p in os.environ.get("MRT_ASSET_PATH", "").split(os.pathsep) if p]


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

    def forward(self, direction: float):
        rot = math3d.rotate_euler(self.rotation)
        local_forward = rot[:3, :3] @ np.array([0, 0, -1], np.float32)
        self.position = self.position + local_forward / np.linalg.norm(local_forward) * direction

    def strafe(self, direction: float):
        rot = math3d.rotate_euler(self.rotation)
        local_right = rot[:3, :3] @ np.array([1, 0, 0], np.float32)
        self.position = self.position + local_right / np.linalg.norm(local_right) * direction

    def rotate_y(self, angle: float):
        self.rotation = self.rotation + np.array([0, angle, 0], np.float32)

    def set_rotation_y(self, angle: float):
        self.rotation = np.array([self.rotation[0], angle, self.rotation[2]], np.float32)


def _apply_override(mat: MaterialDef, o: ModelMaterialOverride):
    if o.base_color is not None:
        mat.base_color = tuple(o.base_color)
    if o.refraction_index is not None:
        mat.refraction_index = max(o.refraction_index, 1.0)
    if o.opacity is not None:
        mat.opacity = float(np.clip(o.opacity, 0.0, 1.0))


_MESH_CACHE: dict = {}


def _resolve_mesh(name: str) -> MeshData:
    """OBJ from the asset search paths, else the procedural stand-ins of the
    JAX package. Cached by name, so models of one asset share one mesh (and
    one BLAS)."""
    if name not in _MESH_CACHE:
        _MESH_CACHE[name] = _resolve_mesh_uncached(name)
    return _MESH_CACHE[name]


def _resolve_mesh_uncached(name: str) -> MeshData:
    for root in ASSET_SEARCH_PATHS:
        for candidate in (root / f"{name}.usdz", root / name / f"{name}.usdz",
                          root / f"{name}.usda", root / name / f"{name}.usda",
                          root / f"{name}.glb", root / f"{name}.gltf",
                          root / name / f"{name}.glb", root / name / f"{name}.gltf"):
            if candidate.exists():
                raise NotImplementedError(
                    f"{candidate.name}: USD and glTF loaders are not ported yet (ROADMAP Slice D)")
        for candidate in (root / f"{name}.obj", root / name / f"{name}.obj"):
            if candidate.exists():
                return load_obj(candidate)
    from ..assets import procedural

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
    atlas: tex.TextureAtlas
    env_map: torch.Tensor  # (Ke,We,3) equirect HDR environment
    env_intensity: torch.Tensor  # () f32


@dataclasses.dataclass(frozen=True)
class SceneStatics:
    """Per-scene facts that select code paths."""

    n_vertices: int
    n_triangles: int
    n_instances: int
    n_resources: int
    n_lights: int
    any_map: tuple  # len N_MAP_TYPES of bool
    has_refraction: bool
    has_environment: bool = False
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
        self.env_map = np.zeros((1, 1, 3), np.float32)
        self.env_intensity = 1.0
        self.skin_bundle: tuple = ()  # per skinned model, SkinModelData (set by compile)

    # --- runtime API -------------------------------------------------------------
    def move_model(self, index: int, forward: float = 0.0, right: float = 0.0):
        if index >= len(self.models):
            return
        if forward != 0:
            self.models[index].forward(forward)
            self.is_dirty = True
        if right != 0:
            self.models[index].strafe(right)
            self.is_dirty = True

    def rotate_model(self, index: int, angle: float):
        if index >= len(self.models) or angle == 0:
            return
        self.models[index].rotate_y(angle)
        self.is_dirty = True

    def set_model_rotation(self, index: int, angle: float):
        if index >= len(self.models):
            return
        self.models[index].set_rotation_y(angle)
        self.is_dirty = True

    def set_light_intensity(self, intensity: float):
        self.lights = self.lights._replace(color=torch.full_like(self.lights.color, intensity))
        self.is_dirty = True

    def set_environment(self, env_map: np.ndarray, intensity: float = 1.0):
        """Attach an equirectangular HDR environment; re-compile afterwards."""
        self.env_map = np.asarray(env_map, np.float32)
        self.env_intensity = float(intensity)
        self.is_dirty = True

    def camera(self) -> T.Camera:
        return T.orbit_camera(self.width, self.height, self.camera_target, self.camera_azimuth,
                              self.camera_elevation, self.camera_distance,
                              self.camera_fov_degrees)

    # --- compiler ------------------------------------------------------------------
    def instance_transforms(self) -> np.ndarray:
        return np.stack([m.world_transform for m in self.models]).astype(np.float32)

    def compile(self, device=None) -> tuple[SceneData, SceneStatics]:
        """Flatten the models into SceneData on ``device`` (default: the
        card; raises when there is none, so CPU use needs ``"cpu"``)."""
        device = resolve_device(device)
        positions, normals, uvs, vert_inst = [], [], [], []
        indices, tri_res, tri_inst = [], [], []
        atlas_builder = tex.AtlasBuilder()
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
                res_id = atlas_builder.add_resource({
                    tex.MAP_BASECOLOR: mat.map_base_color,
                    tex.MAP_NORMAL: mat.map_normal,
                    tex.MAP_ROUGHNESS: mat.map_roughness,
                    tex.MAP_METALLIC: mat.map_metallic,
                    tex.MAP_AO: mat.map_ao,
                    tex.MAP_OPACITY: mat.map_opacity,
                    tex.MAP_EMISSION: mat.map_emission,
                })
                assert res_id == len(mats)
                mats.append(mat)
                indices.append(sub.indices + v_base)
                tri_res.append(np.full(sub.indices.shape[0], res_id, np.int32))
                tri_inst.append(np.full(sub.indices.shape[0], inst, np.int32))
            v_base += mesh.positions.shape[0]

        atlas = atlas_builder.build()
        has_np = atlas_builder.has_np
        n_res = len(mats)
        flags = [
            (has_np[i, tex.MAP_BASECOLOR] * T.MATERIAL_TEXTURE_BASECOLOR)
            | (has_np[i, tex.MAP_NORMAL] * T.MATERIAL_TEXTURE_NORMAL)
            | (has_np[i, tex.MAP_ROUGHNESS] * T.MATERIAL_TEXTURE_ROUGHNESS)
            | (has_np[i, tex.MAP_METALLIC] * T.MATERIAL_TEXTURE_METALLIC)
            | (has_np[i, tex.MAP_AO] * T.MATERIAL_TEXTURE_AO)
            | (has_np[i, tex.MAP_OPACITY] * T.MATERIAL_TEXTURE_OPACITY)
            | (has_np[i, tex.MAP_EMISSION] * T.MATERIAL_TEXTURE_EMISSION)
            for i in range(n_res)
        ]

        def f32(rows, shape):
            return torch.as_tensor(np.asarray(rows, np.float32).reshape(shape))

        materials = T.Materials(
            base_color=f32([m.base_color for m in mats], (n_res, 3)),
            specular=f32([m.specular for m in mats], (n_res, 3)),
            emission=f32([m.emission for m in mats], (n_res, 3)),
            specular_exponent=f32([m.specular_exponent for m in mats], (n_res,)),
            refraction_index=f32([m.refraction_index for m in mats], (n_res,)),
            opacity=f32([m.opacity for m in mats], (n_res,)),
            texture_flags=torch.as_tensor(np.asarray(flags, np.int32).reshape(n_res)),
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
            atlas=T.to_device(atlas, device),
            env_map=dev(self.env_map),
            env_intensity=torch.tensor(self.env_intensity, dtype=torch.float32, device=device),
        )
        mats_ior = np.asarray([m.refraction_index for m in mats], np.float32)
        mats_op = np.asarray([m.opacity for m in mats], np.float32)
        statics = SceneStatics(
            n_vertices=int(pos_np.shape[0]),
            n_triangles=int(idx_np.shape[0]),
            n_instances=len(self.models),
            n_resources=n_res,
            n_lights=int(self.lights.count),
            any_map=tuple(bool(b) for b in has_np.any(axis=0)),
            has_refraction=bool(((mats_ior > 1.01) | (mats_op < 0.999)).any()
                                or has_np.any(axis=0)[tex.MAP_OPACITY]),
            has_environment=bool(self.env_map.size > 3 or self.env_map.max() > 0),
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
