"""Demo scene — counterpart of ``mrt_tpu/engine/appscene.py``: glass dragon,
train, treefir, ground plane, two spheres, back plane.

``train`` and ``treefir`` load from OBJ files found in the asset search
paths; ``asset_models=False`` leaves them out, so the flagship scene builds
where those files are absent. The skinned robot is not ported yet.
"""

from __future__ import annotations

import numpy as np

from .scene import Model, ModelMaterialOverride, Scene


def make_app_scene(width: int = 512, height: int = 512, include_robot: bool = True,
                   dragon_subdivisions: int | None = None, asset_models: bool = True) -> Scene:
    """dragon_subdivisions: override the dragon stand-in's tessellation
    (None = asset/default; 8 = ~1.31M tris)."""
    if include_robot:
        raise NotImplementedError("the skinned robot is not ported yet (ROADMAP Slice B); "
                                  "pass include_robot=False")
    scene = Scene(width=width, height=height)
    dragon_mesh = None
    if dragon_subdivisions is not None:
        from ..assets import procedural
        from ..assets.obj import MaterialDef

        dragon_mesh = procedural.blob(
            subdivisions=dragon_subdivisions, radius=0.28, seed=7,
            material=MaterialDef(name="Dragon", base_color=(1.0, 0.0, 0.0),
                                 specular=(0.2, 0.2, 0.2)))
    models = [Model("dragon", position=[0.3, 0.38, 2.5], rotation=[0, np.pi / 2 * 1.2, 0],
                    scale=1.2, material_override=ModelMaterialOverride.glass(), mesh=dragon_mesh)]
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
