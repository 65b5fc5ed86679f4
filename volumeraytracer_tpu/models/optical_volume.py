"""OpticalVolume — float voxel-unit API matching the reference CuPy layer.

JAX equivalent of ``volumeraytracer.volume_raytracer.OpticalVolume``
(/root/reference/src/volumeraytracer/volume_raytracer.py:246-320): float32
positions/directions in voxel units, gradient field built from
``np.gradient(log ior) * scale`` smoothed with the {14,47,162} stamp,
point-sampled (nearest) interpolation with clamp addressing, translucency as
the trailing channel(s), termination when that channel goes negative, step
``pos += dir / |dir|²``.  The iteration budget is per *call* and the caller
loops, exploiting "ray state is a checkpoint" (test_volume_raytracer.py:29-32).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import march as march_ops
from ..ops.fields import STAMP_2D, STAMP_3D
from ..ops.interp import interp_nearest
from ..types import TraceResult


def _smoothed_gradient(ior: jax.Array, scale: Sequence[float]) -> jax.Array:
    """∇log(ior)·scale per axis, smoothed perpendicular to each axis with the
    normalised {14,47,162} stamp via edge-padded rolls
    (volume_raytracer.py:272-292, stamp volume_raytracer.py:198-202)."""
    ndim = ior.ndim
    logf = jnp.log(jnp.asarray(ior, jnp.float32))
    grads = jnp.gradient(logf) if ndim > 1 else [jnp.gradient(logf)]
    if ndim == 2:
        stamp = np.asarray(STAMP_2D, np.float32)
    elif ndim == 3:
        stamp = np.asarray(STAMP_3D, np.float32)
    else:
        raise ValueError(f"dim must be 2 or 3, got {ndim}")
    stamp = stamp / stamp.sum()
    out = []
    for axis in range(ndim):
        g = grads[axis] * jnp.float32(scale[axis])
        padded = jnp.pad(g, 1, mode="edge")
        perp_axes = [a for a in range(ndim) if a != axis]
        acc = jnp.zeros_like(padded)
        for idx in np.ndindex(*stamp.shape):
            shift = [0] * ndim
            for pa, o in zip(perp_axes, idx):
                shift[pa] = int(o) - 1
            acc = acc + jnp.roll(padded, tuple(shift), axis=tuple(range(ndim))) * float(
                stamp[idx]
            )
        out.append(acc[tuple(slice(1, -1) for _ in range(ndim))])
    return jnp.stack(out, axis=-1)


class OpticalVolume:
    """Float voxel-unit optical volume (CuPy-API parity)."""

    def __init__(
        self,
        ior,
        translucency=None,
        scale: Union[float, Sequence[float]] = 1.0,
    ):
        self.ior = jnp.asarray(ior, jnp.float32)
        self.ndim = self.ior.ndim
        self.shape = tuple(int(s) for s in self.ior.shape)
        if translucency is None:
            translucency = jnp.ones(self.shape, jnp.float32)
        self.translucency = jnp.asarray(translucency, jnp.float32)
        if np.isscalar(scale):
            scale = [float(scale)] * self.ndim
        self.scale = tuple(float(s) for s in scale)
        self.gradient = None
        self.update()

    def update(self) -> None:
        """Rebuild the packed gradient texture after editing ``ior`` /
        ``translucency`` (≙ OpticalVolume.update, volume_raytracer.py:272-294).
        The translucency channel is duplicated in 2D so the packed field is
        4-channel-friendly (volume_raytracer.py:288-292)."""
        grad = _smoothed_gradient(self.ior, self.scale)
        chans = [grad, self.translucency[..., None]]
        if self.ndim == 2:
            chans.append(self.translucency[..., None])
        self.gradient = jnp.concatenate(chans, axis=-1)

    @staticmethod
    @functools.partial(jax.jit, static_argnames=("budget", "ndim"))
    def _trace(gradient, positions, directions, iterations, budget: int, ndim: int):
        # `iterations` is the (N,) per-ray budget array — the CuPy kernel
        # reads a per-ray uint32 (volume_raytracer.py:159); `budget` =
        # max(iterations) only bounds the static trip count.
        res = march_ops.march_float(
            gradient,
            None,
            positions,
            directions,
            budget,
            bend_scale=np.ones(ndim, np.float32),
            step_scale=np.ones(ndim, np.float32),
            chunk_steps=min(budget, 32),
            opaque_when_positive=False,
            nearest=True,
            per_ray_budget=iterations,
        )
        return res.end_position, res.end_direction, res.remaining_light, res.end_iteration

    def trace_rays(self, positions, directions, iterations, bounds=None):
        """March rays in place-style: returns (positions, directions,
        iterations) updated, like the CuPy kernel's in-place buffers
        (volume_raytracer.py:296-320).  ``iterations`` is the per-call budget
        (uint32 scalar or per-ray array); the returned value is the remaining
        budget (iter + 1 fixup semantics of the kernel)."""
        positions = jnp.asarray(positions, jnp.float32)
        directions = jnp.asarray(directions, jnp.float32)
        iterations = np.broadcast_to(
            np.asarray(iterations, np.uint32), positions.shape[:1]
        )
        budget = int(iterations.max())
        if bounds is not None:
            bounds = np.asarray(bounds, np.float32)
            if not np.array_equal(bounds, np.asarray(self.shape, np.float32)):
                raise ValueError(
                    f"bounds {bounds} must match volume shape {self.shape}"
                )
        pos, dirs, _, end_iter = self._trace(
            self.gradient, positions, directions, jnp.asarray(iterations),
            budget, self.ndim
        )
        remaining = jnp.asarray(iterations) - end_iter
        return pos, dirs, remaining

    def get_ior(self, position) -> jax.Array:
        """Point-sample the IOR texture (≙ evaluate_ior_kernel,
        volume_raytracer.py:259-270,178-190: point filter + clamp)."""
        pos = jnp.asarray(position, jnp.float32).reshape(-1, self.ndim)
        return interp_nearest(self.ior, pos)
