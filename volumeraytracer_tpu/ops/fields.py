"""Scene-field preprocessing: log-index, smoothed gradients, opacity packing.

JAX re-design of the reference preprocessing pipeline
(RaytraceScene ctor, /root/reference/src/image_util.cpp:430-643):

  1. ``ior_log = log(ior) * 0x420000``           (image_util.cpp:611)
  2. per-axis smoothed central-difference gradients with the
     {14,47,162} stamp, "valid" convolution shrinking by 2 per axis
     (calculate_differations, image_util.cpp:430-491; stamp weights
     image_util.cpp:421-427; divisor 0x100 image_util.cpp:557,626)
  3. translucency cropped by one voxel per side  (image_util.cpp:517-521)
  4. opacity channel ``extra = (0x7FFFFFFF - translucency) / 0x10000``
     (cuda_volume_raytracer.cu:654-658) — positive ⇒ opaque surface hit
  5. channel-interleaved packing → here a channels-last float32 array of
     shape ``(*[b-2 for b in bounds], dim+1)``.

Everything is pure jnp (shifted slices + adds) so the whole pipeline is
differentiable w.r.t. ``ior`` — the new capability that makes end-to-end
field optimisation possible.  XLA fuses the stamp taps into a handful of
fused elementwise passes (bandwidth-bound, done once per scene update).
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..types import DIFF_DIV, IORLOG_UNIT, OPACITY_BIAS, OPACITY_SHIFT

# Smoothing stamps perpendicular to the derivative axis
# (standart_3d_stamp/standart_2d_stamp, image_util.cpp:421-427).
# 3D: S[a, b] with derivative kernel [-1, 0, +1] along the diff axis.
STAMP_3D = np.array([[14.0, 47.0, 14.0], [47.0, 162.0, 47.0], [14.0, 47.0, 14.0]])
STAMP_2D = np.array([47.0, 162.0, 47.0])
# total |stamp| weights: 2 * sum(S);  3D: 812, 2D: 512 (the reference computes
# sum(|st|) over the full signed stencil, stamp_t_struct, image_util.cpp:379-397)
STAMP_WEIGHT_3D = 2.0 * float(STAMP_3D.sum())
STAMP_WEIGHT_2D = 2.0 * float(STAMP_2D.sum())


def ior_log(ior: jax.Array) -> jax.Array:
    """``log(ior) * 0x420000`` in float32 (image_util.cpp:611-614)."""
    ior = jnp.asarray(ior, jnp.float32)
    return jnp.log(ior) * jnp.float32(IORLOG_UNIT)


def _axis_diff(f: jax.Array, axis: int, dim: int) -> jax.Array:
    """Smoothed central difference of ``f`` along ``axis``, valid windows.

    output[i] = sum_{perp offsets p} S[p] * (f[i + 2 e_axis + p] - f[i + p])
                / (weight * 0x100)

    matching convolution::operator() with the reduced stencil of
    stamp_t_struct (image_util.cpp:261-296, 379-419).
    """
    if dim == 3:
        stamp, weight = STAMP_3D, STAMP_WEIGHT_3D
        perp_axes = [a for a in range(3) if a != axis]
        taps = [
            ((p, q), float(stamp[p, q]))
            for p, q in itertools.product(range(3), range(3))
            if stamp[p, q] != 0.0
        ]
    elif dim == 2:
        stamp, weight = STAMP_2D, STAMP_WEIGHT_2D
        perp_axes = [a for a in range(2) if a != axis]
        taps = [((p,), float(stamp[p])) for p in range(3) if stamp[p] != 0.0]
    else:
        raise ValueError(f"unsupported dim {dim}")

    out_shape = tuple(s - 2 for s in f.shape)

    def window(offsets):
        # offsets: full dim-length tuple of 0..2 start offsets
        slices = tuple(slice(o, o + n) for o, n in zip(offsets, out_shape))
        return f[slices]

    acc = jnp.zeros(out_shape, f.dtype)
    for perp_off, w in taps:
        off_hi = [0] * dim
        off_lo = [0] * dim
        off_hi[axis] = 2
        off_lo[axis] = 0
        for pa, po in zip(perp_axes, perp_off):
            off_hi[pa] = po
            off_lo[pa] = po
        acc = acc + jnp.float32(w) * (window(tuple(off_hi)) - window(tuple(off_lo)))
    return acc / jnp.float32(weight * DIFF_DIV)


def opacity_channel(translucency: jax.Array) -> jax.Array:
    """Encode translucency (uint32, 0xFFFFFFFF = fully transparent) as the
    opaque-surface channel: ``(0x7FFFFFFF - tr) / 0x10000`` as float32
    (cuda_volume_raytracer.cu:654-658).  > 0 ⇒ ray terminates."""
    tr = jnp.asarray(translucency)
    if jnp.issubdtype(tr.dtype, jnp.floating):
        # float translucency in [0, 1]: 1.0 transparent — same encoding after
        # scaling to the uint32 range, computed in float to avoid overflow.
        tr_f = tr.astype(jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
        val = (float(OPACITY_BIAS) - tr_f * float(0xFFFFFFFF)) / float(OPACITY_SHIFT)
        return val.astype(jnp.float32)
    # Integer path, exact without int64: write 0x7FFFFFFF - tr =
    # (0x7FFF - hi) * 0x10000 + (0xFFFF - lo) with hi/lo the 16-bit halves of
    # tr, then emulate the reference's truncating int64 division by 0x10000.
    tr_u = tr.astype(jnp.uint32)
    hi = (tr_u >> 16).astype(jnp.int32)
    lo = (tr_u & 0xFFFF).astype(jnp.int32)
    q = 0x7FFF - hi
    r = 0xFFFF - lo
    q = jnp.where((q < 0) & (r > 0), q + 1, q)  # trunc-toward-zero correction
    return q.astype(jnp.float32)


def crop1(x: jax.Array) -> jax.Array:
    """Crop one voxel from every side (crop_matrix use, image_util.cpp:517-521)."""
    return x[tuple(slice(1, -1) for _ in range(x.ndim))]


def build_packed_field(
    ior: jax.Array,
    translucency: Optional[jax.Array] = None,
) -> jax.Array:
    """Full preprocessing: returns the channels-last packed field of shape
    ``(*[b-2 for b in bounds], dim+1)`` float32 with channels
    ``[diff_0, ..., diff_{dim-1}, opacity]`` — the channels-last equivalent of
    the interleaved ``diff_interleaved`` buffer (cuda_volume_raytracer.cu:
    644-720).  Differentiable w.r.t. ``ior``."""
    ior = jnp.asarray(ior, jnp.float32)
    dim = ior.ndim
    if dim not in (2, 3):
        raise ValueError(f"dim must be 2 or 3, got {dim}")
    logf = ior_log(ior)
    diffs = [_axis_diff(logf, a, dim) for a in range(dim)]
    if translucency is None:
        translucency = jnp.full(ior.shape, np.uint32(0xFFFFFFFF), jnp.uint32)
    extra = crop1(opacity_channel(jnp.asarray(translucency)))
    return jnp.stack(diffs + [extra], axis=-1)


def cropped_translucency(translucency: jax.Array) -> jax.Array:
    """uint32 absorption grid used by the march's brightness update
    (cuda_volume_raytracer.cu:337-341); cropped like the diff grid."""
    tr = jnp.asarray(translucency)
    if jnp.issubdtype(tr.dtype, jnp.floating):
        tr = (tr.astype(jnp.float32) * float(0xFFFFFFFF)).astype(jnp.uint32)
    return crop1(tr.astype(jnp.uint32))
