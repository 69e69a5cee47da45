"""Demo scene — counterpart of ``mrt_tpu/engine/appscene.py``: the skinned
robot, glass dragon, train, treefir, ground plane, two spheres, back plane.

The robot is the procedural stand-in (a rigged cylinder with a swing clip);
``train`` and ``treefir`` load from OBJ files found in the asset search
paths, and ``asset_models=False`` leaves them out, so the flagship scene
builds where those files are absent.
"""

from __future__ import annotations

import numpy as np

from ..skinning import animation as anim
from ..utils import math3d
from .scene import Model, ModelMaterialOverride, Scene, SkinData


def _attach_swing_rig(robot) -> None:
    """Build a chain Skeleton + procedural swing clip for the robot stand-in
    (the robot.usdz skeleton/animation analog, Model.swift:95-122)."""
    rest = robot.skin.rest_joints
    n_joints = rest.shape[0]
    local = np.zeros_like(rest)
    local[0] = rest[0]
    local[1:] = rest[1:] - rest[:-1]
    rest_transforms = np.stack([math3d.translate(local[j]) for j in range(n_joints)])
    inverse_bind = np.stack([math3d.translate(-rest[j]) for j in range(n_joints)])
    paths = [f"root/{'/'.join(f'joint{i}' for i in range(j + 1))}" for j in range(n_joints)]
    robot.skin.skeleton = anim.Skeleton(
        joint_paths=paths,
        rest_transforms=rest_transforms.astype(np.float32),
        inverse_bind_transforms=inverse_bind.astype(np.float32),
    )
    robot.skin.animation = anim.make_swing_clip(n_joints, rest)


def make_app_scene(width: int = 512, height: int = 512, include_robot: bool = True,
                   dragon_subdivisions: int | None = None, asset_models: bool = True) -> Scene:
    """dragon_subdivisions: override the dragon stand-in's tessellation
    (None = asset/default; 8 = ~1.31M tris)."""
    scene = Scene(width=width, height=height)
    models = []
    dragon_mesh = None
    if dragon_subdivisions is not None:
        from ..assets import procedural
        from ..assets.obj import MaterialDef

        dragon_mesh = procedural.blob(
            subdivisions=dragon_subdivisions, radius=0.28, seed=7,
            material=MaterialDef(name="Dragon", base_color=(1.0, 0.0, 0.0),
                                 specular=(0.2, 0.2, 0.2)))
    if include_robot:
        robot = Model("robot", position=[-0.5, 0.0, 1.0], rotation=[0, 0, 0], scale=0.01)
        stub = getattr(robot.mesh, "_skin_stub", None)
        if stub is not None:
            ji, jw, rest = stub
            # the procedural rig is human-scale already; compensate the
            # reference's 0.01 USDZ scale so the stand-in is visible
            robot.scale = 1.0
            robot.skin = SkinData(joint_indices=ji, joint_weights=jw, rest_joints=rest)
            _attach_swing_rig(robot)
        models.append(robot)
    models.append(Model("dragon", position=[0.3, 0.38, 2.5], rotation=[0, np.pi / 2 * 1.2, 0],
                        scale=1.2, material_override=ModelMaterialOverride.glass(), mesh=dragon_mesh))
    if asset_models:
        models += [Model("train", position=[-0.3, 0, 0.4], scale=0.5),
                   Model("treefir", position=[0.5, 0, -0.2], scale=0.7)]
    models += [
        Model("plane", position=[0, 0, 0], scale=10),
        Model("sphere", position=[-1.9, 0.0, 0.3], scale=1),
        Model("sphere", position=[2.9, 0.0, -0.5], scale=2),
        Model("plane-back", position=[0, 0, -1.5], scale=10),
    ]
    scene.models = models
    return scene
