"""Carry the JAX package's state into the port.

Every function takes the JAX package's objects and reads their arrays with
``np.asarray`` (this module imports no JAX), so the port can render from the
very tables the JAX package built: ``Renderer.from_compiled(scene(js),
*compiled(jax_scene_data, jax_statics, jax_bvh, device))``. ``device``
defaults to the card and raises where there is none; CPU use passes
``device="cpu"``. Skinned state comes across too: the skin slices, the
BVH's skinned index tensors, each model's ``SkinData`` (its skeleton and
clip rebuilt as the port's own classes) and the scene's skin bundle. So does
the presenter's state: a frame's G-buffer, the denoiser's ``DenoiseState``
and the temporal upscale history.
"""

from __future__ import annotations

import numpy as np
import torch

from .assets.obj import MaterialDef, MeshData, SubmeshData
from .assets.texture import TextureAtlas
from .bvh.twolevel import TwoLevelBVH
from .core import types as T
from .core.device import resolve as resolve_device
from .engine.scene import (Model, ModelMaterialOverride, Scene, SceneData, SceneStatics, SkinData,
                           SkinModelData)
from .skinning import animation as anim
from .upscale.denoise import DenoiseState


def _t(a, device):
    return torch.as_tensor(np.array(a)).to(device)


def _nt(cls, src, device):
    return cls(*(_t(getattr(src, f), device) for f in cls._fields))


def scene_data(sd, device=None) -> SceneData:
    device = resolve_device(device)
    at = sd.atlas
    return SceneData(
        positions_obj=_t(sd.positions_obj, device),
        prev_positions_obj=_t(sd.prev_positions_obj, device),
        normals_obj=_t(sd.normals_obj, device),
        uvs=_t(sd.uvs, device),
        vertex_instance=_t(sd.vertex_instance, device),
        indices=_t(sd.indices, device),
        tri_resource=_t(sd.tri_resource, device),
        tri_instance=_t(sd.tri_instance, device),
        instance_transform=_t(sd.instance_transform, device),
        prev_instance_transform=_t(sd.prev_instance_transform, device),
        materials=T.Materials(*(_t(np.asarray(getattr(sd.materials, f)).astype(
            np.int32 if f == "texture_flags" else np.float32), device)
            for f in T.Materials._fields)),
        lights=_nt(T.Lights, sd.lights, device),
        atlas=_nt(TextureAtlas, at, device),
        env_map=_t(sd.env_map, device),
        env_intensity=_t(sd.env_intensity, device),
    )


def statics(st) -> SceneStatics:
    return SceneStatics(n_vertices=st.n_vertices, n_triangles=st.n_triangles,
                        n_instances=st.n_instances, n_resources=st.n_resources,
                        n_lights=st.n_lights, any_map=tuple(st.any_map),
                        has_refraction=st.has_refraction, has_environment=st.has_environment,
                        has_masks=st.has_masks,
                        skin_slices=tuple(tuple(int(x) for x in sl) for sl in st.skin_slices))


def bvh(b, device=None) -> TwoLevelBVH:
    device = resolve_device(device)
    if getattr(b, "leaf_clip", None) is not None:
        raise NotImplementedError("SBVH-clipped BVHs are not ported yet (ROADMAP Slice F)")
    return TwoLevelBVH(
        table=_t(b.table, device), node_child=_t(b.node_child, device),
        leaf_tri=_t(b.leaf_tri, device), root_bmin=_t(b.root_bmin, device),
        root_bmax=_t(b.root_bmax, device), flat_tri_base=_t(b.flat_tri_base, device),
        n_internal=b.n_internal, n_leaf=b.n_leaf, n_instances=b.n_instances,
        tlas_n=b.tlas_n, tlas_depth=b.tlas_depth, mesh_meta=tuple(b.mesh_meta),
        inst_mesh=tuple(b.inst_mesh), stack_bound=b.stack_bound,
        inst_masks=tuple(b.inst_masks), skin_indices=tuple(_t(x, device) for x in b.skin_indices))


def compiled(sd, st, b, device=None):
    """(SceneData, SceneStatics, TwoLevelBVH) for ``Renderer.from_compiled``."""
    return scene_data(sd, device), statics(st), bvh(b, device)


def gbuffer(gb: dict, device=None) -> dict:
    """A frame's G-buffer dict (diffuse_albedo, specular_albedo, normal,
    roughness)."""
    device = resolve_device(device)
    return {k: _t(v, device) for k, v in gb.items()}


def denoise_state(st, device=None) -> DenoiseState:
    """The denoiser's temporal state."""
    return _nt(DenoiseState, st, resolve_device(device))


def history(h, device=None) -> torch.Tensor:
    """The temporal upscaler's (H,W,4) output-size history."""
    return _t(h, resolve_device(device))


def _mesh(m) -> MeshData:
    return MeshData(
        positions=np.asarray(m.positions, np.float32), normals=np.asarray(m.normals, np.float32),
        uvs=np.asarray(m.uvs, np.float32),
        submeshes=[SubmeshData(indices=np.asarray(s.indices, np.int32),
                               material=MaterialDef(**vars(s.material))) for s in m.submeshes])


def _skin(sk) -> SkinData | None:
    if sk is None:
        return None
    skel, clip = sk.skeleton, sk.animation
    if skel is not None:
        skel = anim.Skeleton(joint_paths=list(skel.joint_paths),
                             rest_transforms=np.array(skel.rest_transforms, np.float32),
                             inverse_bind_transforms=np.array(skel.inverse_bind_transforms, np.float32),
                             parent_indices=np.array(skel.parent_indices, np.int32))
    if clip is not None:
        clip = anim.AnimationClip(joint_paths=list(clip.joint_paths), times=np.array(clip.times),
                                  translations=np.array(clip.translations),
                                  rotations=np.array(clip.rotations), scales=np.array(clip.scales))
    return SkinData(joint_indices=np.array(sk.joint_indices), joint_weights=np.array(sk.joint_weights),
                    rest_joints=np.array(sk.rest_joints), skeleton=skel, animation=clip,
                    geometry_bind=None if sk.geometry_bind is None else np.array(sk.geometry_bind),
                    current_time=float(sk.current_time))


def scene(js) -> Scene:
    """A port ``Scene`` with the same models (meshes shared where the JAX
    scene shares them, skins copied), lights, environment and camera
    parameters, and, once the JAX scene was compiled, its skin bundle (on
    the CPU; a ``Renderer`` moves it to its device)."""
    out = Scene(width=js.width, height=js.height)
    meshes: dict = {}
    models = []
    for m in js.models:
        if id(m.mesh) not in meshes:
            meshes[id(m.mesh)] = _mesh(m.mesh)
        o = m.material_override
        models.append(Model(
            m.name, position=np.asarray(m.position), rotation=np.asarray(m.rotation),
            scale=m.scale, mesh=meshes[id(m.mesh)], geometry_mask=m.geometry_mask,
            skin=_skin(getattr(m, "skin", None)),
            material_override=None if o is None else ModelMaterialOverride(
                o.base_color, o.refraction_index, o.opacity)))
    out.models = models
    out.skin_bundle = tuple(_nt(SkinModelData, sb, "cpu") for sb in getattr(js, "skin_bundle", ()))
    out.lights = _nt(T.Lights, js.lights, "cpu")
    out.env_map = np.asarray(js.env_map, np.float32)
    out.env_intensity = float(js.env_intensity)
    for k in ("camera_target", "camera_distance", "camera_azimuth", "camera_elevation",
              "camera_fov_degrees"):
        setattr(out, k, getattr(js, k))
    return out
