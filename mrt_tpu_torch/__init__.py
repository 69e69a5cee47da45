"""mrt_tpu_torch — the PyTorch/CUDA port of the mrt_tpu progressive path tracer.

The same ``Scene``/``Model``/``Renderer`` API as ``mrt_tpu`` (the JAX
package, which stays the reference), skinned models and motion-adaptive
sampling included, running on an NVIDIA Hopper card with hand-written CUDA
kernels for BVH traversal and present::

    from mrt_tpu_torch import Model, Renderer, Scene, UPSCALER_OFF
    scene = Scene(width=512, height=512)
    scene.models = [Model("sphere", position=[0, 0.5, 0], scale=0.5),
                    Model("plane", scale=10)]
    r = Renderer(scene, output_width=512, output_height=512, device="cuda")
    r.upscaler_mode = UPSCALER_OFF
    r.draw()
    image = r.output_image()  # uint8 RGB

Across several ranks (one process each, ``torch.distributed`` set up by
``torchrun`` or ``dist.launch.launch``): ``DistributedRenderer`` shards the
image rows (dp) and the samples (sp), ``GeometryShardedRenderer`` the
triangles (gp).
"""

from .core import types
from .core.types import (Camera, FrameUniforms, Lights, Materials, RenderSettings, area_light,
                         orbit_camera, point_light, spot_light, sun_light)
from .dist.geometry import GeometryShardedRenderer
from .dist.sharding import DistributedRenderer, make_mesh
from .engine.appscene import make_app_scene
from .engine.renderer import (UPSCALER_DENOISED, UPSCALER_OFF, UPSCALER_SPATIAL,
                              UPSCALER_TEMPORAL, Renderer)
from .engine.scene import Model, ModelMaterialOverride, Scene, SkinData

__all__ = [
    "Camera", "DistributedRenderer", "FrameUniforms", "GeometryShardedRenderer", "Lights",
    "Materials", "Model", "ModelMaterialOverride", "RenderSettings", "Renderer", "Scene", "SkinData", "UPSCALER_DENOISED", "UPSCALER_OFF",
    "UPSCALER_SPATIAL", "UPSCALER_TEMPORAL", "area_light", "make_app_scene", "make_mesh", "orbit_camera",
    "point_light", "spot_light", "sun_light", "types",
]
