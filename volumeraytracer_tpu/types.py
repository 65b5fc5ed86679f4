"""Core types, constants and pytree DTOs for the volume raytracer.

Reference parity (see SURVEY.md):
  * fixed-point constants mirror /root/reference/src/types.h:5-81 — we keep the
    *scales* (so physics constants match bit-for-bit where possible) but store
    data as jnp arrays (uint32 positions on the exact parity path, float32
    voxel-unit positions on the differentiable path).
  * ``Options`` mirrors /root/reference/src/types.h:83-91.
  * instance DTOs mirror RayTraceSceneInstance / RayTraceRayInstance /
    RaytraceInstance, /root/reference/src/image_util.h:43-266.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import jax
import numpy as np

# ---------------------------------------------------------------------------
# Fixed-point scale constants (reference: src/types.h, src/image_util.cpp,
# src/cuda_volume_raytracer.cu).  These are *scales*, not dtypes: the float
# path keeps the same physical constants so both paths integrate the same ODE.
# ---------------------------------------------------------------------------

#: one voxel in 16.16 fixed-point position units (pos_t), types.h:19
FIX_ONE = 0x10000
#: half a voxel, used by the ±0x8000 shifts of image_util.cpp:692-710
FIX_HALF = 0x8000
#: unit of the 8.8 fixed-point direction type (dir_t), types.h:44
DIR_UNIT_FIXED = 0x100
#: scale applied to log(ior) when building iorlog (image_util.cpp:534,611)
IORLOG_UNIT = float(0x420000)
#: divisor folded into the gradient-stamp weight (image_util.cpp:557,626)
DIFF_DIV = float(0x100)
#: step-length constant of the march (cuda_volume_raytracer.cu:346)
STEP_CONST = float(0x42000000)
#: working-direction prescale for float directions (cuda_volume_raytracer.cu:331)
DIR_PRESCALE_FLOAT = float(0x10000)
#: initial / maximum brightness (cuda_volume_raytracer.cu:333)
BRIGHTNESS_MAX = 0xFFFFFFFF
#: opacity-channel encoding offset: extra = (0x7FFFFFFF - translucency)/0x10000
#: (cuda_volume_raytracer.cu:654-658)
OPACITY_BIAS = 0x7FFFFFFF
OPACITY_SHIFT = 0x10000


@dataclasses.dataclass
class Options:
    """Runtime options (reference: src/types.h:83-91, negative loglevel is
    more verbose; ``max_cpu`` caps the native oracle's host threads)."""

    loglevel: int = 0
    #: dump every traced instance to a replay file (≙ ``_write_instance``,
    #: python_binding.cpp:21-34): ``True`` writes the reference's default
    #: ``debug_raytrace_instance.npz`` in the CWD, a string gives the path
    #: (.npz, or .vrt for the binary codec)
    write_instance: Any = False
    #: cap on host-side parallelism for native helpers (≙ ``_max_cpu``)
    max_cpu: int = 256
    #: steps executed per inner chunk between termination checks; mirrors the
    #: chunked scheduler shape of cuda_volume_raytracer.cu:798-946.
    chunk_steps: int = 256


def _pytree_dataclass(cls):
    """Register a dataclass as a jax pytree (fields are leaves)."""
    fields = [f.name for f in dataclasses.fields(cls)]

    def flatten(obj):
        return tuple(getattr(obj, n) for n in fields), None

    def unflatten(_, children):
        return cls(**dict(zip(fields, children)))

    jax.tree_util.register_pytree_node(cls, flatten, unflatten)
    return cls


@_pytree_dataclass
@dataclasses.dataclass
class TraceResult:
    """Outputs of a trace (≙ the out-params of RaytraceScene::trace_rays,
    image_util.cpp:645-772).

    ``end_iteration`` follows the reference bookkeeping exactly
    (budget - remaining, cuda_volume_raytracer.cu:953-956).  ``path`` is
    recorded forward in time, ``path[i, t]`` = position after ``t`` steps,
    back-filled with the end position (the reference stores the reversed
    ordering, cuda_volume_raytracer.cu:333,348-358).
    """

    end_position: jax.Array  # (N, dim) — uint32 (fixed) or float32 voxels
    end_direction: jax.Array  # (N, dim) float32, same units as the input
    end_iteration: jax.Array  # (N,) uint32
    remaining_light: jax.Array  # (N,) uint32
    path: Optional[jax.Array] = None  # (N, budget, dim) if requested
    #: (N,) float32 soft transmittance — only set by the XLA float march
    #: when ``soft_opacity_tau`` is given (the differentiable relaxation of
    #: the hard opaque-surface break, SURVEY.md §7)
    transmittance: Optional[jax.Array] = None


@dataclasses.dataclass
class RaySceneInstance:
    """Host-side scene DTO (≙ RayTraceSceneInstance, image_util.h:46-71)."""

    bounds: Tuple[int, ...]
    ior: np.ndarray  # float (dim-shaped); reference ior_t/float
    translucency: np.ndarray  # uint32, same shape

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, RaySceneInstance):
            return NotImplemented
        return (
            tuple(self.bounds) == tuple(other.bounds)
            and np.array_equal(self.ior, other.ior)
            and np.array_equal(self.translucency, other.translucency)
        )


@dataclasses.dataclass
class RayInstance:
    """Host-side ray-batch DTO (≙ RayTraceRayInstance, image_util.h:73-123)."""

    start_position: np.ndarray  # (N, dim) — uint32 pos_t or float voxels
    start_direction: np.ndarray  # (N, dim) float
    invscale: np.ndarray  # (dim,) float
    minimum_brightness: int = 0
    iterations: int = 1000000
    trace_path: bool = False
    normalize_length: bool = True

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, RayInstance):
            return NotImplemented
        return (
            np.array_equal(self.start_position, other.start_position)
            and np.array_equal(self.start_direction, other.start_direction)
            and np.array_equal(self.invscale, other.invscale)
            and self.minimum_brightness == other.minimum_brightness
            and self.iterations == other.iterations
            and self.trace_path == other.trace_path
            and self.normalize_length == other.normalize_length
        )


@dataclasses.dataclass
class RaytraceInstance:
    """Combined scene + rays DTO (≙ RaytraceInstance, image_util.h:197-266)."""

    scene: RaySceneInstance
    rays: RayInstance

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, RaytraceInstance):
            return NotImplemented
        return self.scene == other.scene and self.rays == other.rays
