"""volumeraytracer_tpu — differentiable GRIN volume raytracer in JAX.

A from-scratch JAX/XLA framework with the capabilities of
PaulStahr/VolumeRaytracer (see SURVEY.md): rays marched through 2D/3D voxel
grids of refractive index, continuously bent by ∇log(n) (eikonal equation,
|v| = n), with absorption, sub-voxel opaque-surface termination, path
recording, scene preprocessing, a harmonic IOR-field solver, serialization
with CLI replay — plus new capabilities: a differentiable march (remat'd
scan), camera rendering, and mesh-sharded multi-device tracing.
"""

from .types import (
    Options,
    RayInstance,
    RaySceneInstance,
    RaytraceInstance,
    TraceResult,
)
from .models.scene import RaytraceScene, trace_rays_instance
from .models.optical_volume import OpticalVolume
from .models.harmonic import solve_harmonic, solveHarmonic
from .models.camera import (
    PinholeCamera,
    render_image,
    render_rays_image,
    render_transmittance,
)
from .models.optimize import (
    fit_field,
    fit_field_image,
    image_loss,
    load_ray_state,
    save_ray_state,
)
from .utils.serialization import (
    save_instance,
    load_instance,
    save_instance_binary,
    load_instance_binary,
    save_scene_instance,
    load_scene_instance,
    save_ray_instance,
    load_ray_instance,
)

__version__ = "0.1.0"

__all__ = [
    "Options",
    "OpticalVolume",
    "PinholeCamera",
    "RayInstance",
    "RaySceneInstance",
    "RaytraceInstance",
    "RaytraceScene",
    "TraceResult",
    "fit_field",
    "fit_field_image",
    "image_loss",
    "load_instance",
    "load_instance_binary",
    "load_ray_instance",
    "load_ray_state",
    "load_scene_instance",
    "render_image",
    "render_rays_image",
    "render_transmittance",
    "save_instance",
    "save_instance_binary",
    "save_ray_instance",
    "save_ray_state",
    "save_scene_instance",
    "solveHarmonic",
    "solve_harmonic",
    "trace_rays_instance",
    "__version__",
]
