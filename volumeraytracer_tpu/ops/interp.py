"""Multilinear interpolation over voxel grids.

JAX equivalents of the reference's two interpolators:
  * the in-kernel fixed-point interpolation of the packed field
    (``interpolatef``, /root/reference/src/cuda_volume_raytracer.cu:111-214):
    corner weights from the low 16 bits of the 16.16 position, 2^dim corner
    gather, lerp tree;
  * the host-side generic N-D interpolator (``interpolator<T>``,
    /root/reference/src/image_util.h:338-431) used to normalise ``|v| = n``
    and to verify endpoints in the tests.

The 2^dim corner reads become one batched gather from the flattened field,
which XLA lowers to a gather kernel on the device.
"""

from __future__ import annotations

import itertools
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..types import FIX_ONE


def _flat_strides(shape: Sequence[int]) -> np.ndarray:
    """Row-major strides (minor axis last), matching get_index
    (cuda_volume_raytracer.cu:111-113, image_util.h:318-336)."""
    strides = np.ones(len(shape), dtype=np.int32)
    for i in range(len(shape) - 2, -1, -1):
        strides[i] = strides[i + 1] * shape[i + 1]
    return strides


def gather_corners(field_flat: jax.Array, base_idx: jax.Array, spatial_shape) -> jax.Array:
    """Gather the 2^dim corner values around integer corner ``base_idx``.

    field_flat: (prod(spatial), C); base_idx: (..., dim) int32 voxel coords.
    Returns (..., 2^dim, C).
    """
    dim = base_idx.shape[-1]
    strides = jnp.asarray(_flat_strides(spatial_shape))
    offsets = jnp.asarray(
        [
            sum(int(strides_i) * o for strides_i, o in zip(_flat_strides(spatial_shape), off))
            for off in itertools.product((0, 1), repeat=dim)
        ],
        jnp.int32,
    )  # (2^dim,)
    flat_base = jnp.sum(base_idx.astype(jnp.int32) * strides, axis=-1)  # (...)
    idx = flat_base[..., None] + offsets  # (..., 2^dim)
    return jnp.take(field_flat, idx, axis=0)  # (..., 2^dim, C)


def interp_linear(field: jax.Array, pos_vox: jax.Array) -> jax.Array:
    """Multilinear interpolation of a channels-last field at float voxel
    positions (corner-anchored: corners are ``floor(pos)`` and ``floor+1``,
    fractional weights ``pos - floor(pos)``), matching ``interpolatef``
    semantics in float (cuda_volume_raytracer.cu:130-166).

    field: (*spatial, C) or (*spatial,); pos_vox: (..., dim) float32.
    Out-of-range corners are clamped (callers guarantee in-bounds positions on
    the parity path; clamping matches the CuPy texture's clamp addressing,
    volume_raytracer.py:236-238).
    Returns (..., C) (or (...,) for channel-less fields).
    """
    squeeze = field.ndim == pos_vox.shape[-1]
    if squeeze:
        field = field[..., None]
    dim = pos_vox.shape[-1]
    spatial = field.shape[:-1]
    base = jnp.floor(pos_vox)
    frac = (pos_vox - base).astype(field.dtype if jnp.issubdtype(field.dtype, jnp.floating) else jnp.float32)
    base_i = jnp.clip(
        base.astype(jnp.int32),
        0,
        jnp.asarray([s - 2 for s in spatial], jnp.int32),
    )
    field_flat = field.reshape((-1,) + field.shape[-1:])
    corners = gather_corners(field_flat, base_i, spatial)  # (..., 2^dim, C)
    if not jnp.issubdtype(corners.dtype, jnp.floating):
        corners = corners.astype(jnp.float32)
    w = _weights_product(frac)  # (..., 2^dim)
    out = jnp.sum(corners * w[..., None], axis=-2)
    return out[..., 0] if squeeze else out


def _weights_product(frac: jax.Array) -> jax.Array:
    """Corner weights ordered like itertools.product((0,1), repeat=dim)
    (axis 0 = slowest toggling bit)."""
    dim = frac.shape[-1]
    ws = jnp.ones(frac.shape[:-1] + (1,), frac.dtype)
    for a in range(dim):
        fa = frac[..., a][..., None]  # (..., 1)
        # existing corners each split into (bit_a=0, bit_a=1); because axis a
        # is slower than all later axes, append along a new leading block:
        ws = jnp.concatenate([ws * (1.0 - fa), ws * fa], axis=-1)
    # ws now has 2^dim entries but in bit-reversed block order: the first
    # processed axis ended up toggling fastest.  Reorder to product() order.
    order = np.empty(2**dim, dtype=np.int32)
    for j, bits in enumerate(itertools.product((0, 1), repeat=dim)):
        # bits[a] is the offset of axis a for product-order corner j; in ws
        # the index is sum_a bits[a] << a  (axis a contributes bit a counted
        # from the *first* concat = least significant)
        order[j] = sum(b << a for a, b in enumerate(bits))
    return ws[..., jnp.asarray(order)]


def interp_fixed(field: jax.Array, pos_fix: jax.Array) -> jax.Array:
    """Interpolate a channels-last float field at 16.16 fixed-point positions,
    bit-matching the reference weight construction (multr = pos & 0xFFFF,
    multl = 0x10000 - multr, cuda_volume_raytracer.cu:145-153; final scale
    1/0x10000^dim)."""
    dim = pos_fix.shape[-1]
    base_i = (pos_fix >> 16).astype(jnp.int32)
    frac = (pos_fix & 0xFFFF).astype(jnp.float32) / jnp.float32(FIX_ONE)
    spatial = field.shape[:-1]
    field_flat = field.reshape((-1,) + field.shape[-1:])
    corners = gather_corners(field_flat, base_i, spatial)
    w = _weights_product(frac)
    return jnp.sum(corners * w[..., None], axis=-2)


def interp_nearest(field: jax.Array, pos_vox: jax.Array) -> jax.Array:
    """Nearest-neighbour (point) sampling with clamp addressing — the CuPy
    texture semantics (cudaFilterModePoint + cudaAddressModeClamp,
    volume_raytracer.py:236-238).  CUDA point filtering selects
    ``floor(pos)`` of the unnormalised coordinate."""
    squeeze = field.ndim == pos_vox.shape[-1]
    if squeeze:
        field = field[..., None]
    spatial = field.shape[:-1]
    idx = jnp.clip(
        jnp.floor(pos_vox).astype(jnp.int32),
        0,
        jnp.asarray([s - 1 for s in spatial], jnp.int32),
    )
    strides = jnp.asarray(_flat_strides(spatial))
    flat = jnp.sum(idx * strides, axis=-1)
    out = jnp.take(field.reshape((-1,) + field.shape[-1:]), flat, axis=0)
    return out[..., 0] if squeeze else out


def interpolate_host(values: np.ndarray, bounds: Sequence[int], pos_fix: np.ndarray) -> np.ndarray:
    """Host-side exact interpolator (≙ interpolator<T>, image_util.h:338-431):
    int64 arithmetic with exact rounding (divRoundClosest) for integer fields,
    float64 for float fields.  ``pos_fix`` is (..., dim) uint32 16.16.

    Used by tests (image_util_test.h) and by scene ray preprocessing parity
    checks; numpy-only, not jittable.
    """
    values = np.asarray(values).reshape(tuple(bounds))
    pos_fix = np.asarray(pos_fix, np.uint64)
    dim = pos_fix.shape[-1]
    base = (pos_fix >> np.uint64(16)).astype(np.int64)
    frac = (pos_fix & np.uint64(0xFFFF)).astype(np.int64)
    is_int = np.issubdtype(values.dtype, np.integer)
    acc_dtype = np.int64 if is_int else np.float64
    acc = np.zeros(pos_fix.shape[:-1], acc_dtype)
    for bits in itertools.product((0, 1), repeat=dim):
        w = np.ones(pos_fix.shape[:-1], acc_dtype)
        for a, b in enumerate(bits):
            wa = frac[..., a] if b else (FIX_ONE - frac[..., a])
            w = w * wa.astype(acc_dtype)
        idx = tuple(base[..., a] + bits[a] for a in range(dim))
        acc = acc + values[idx].astype(acc_dtype) * w
    denom = acc_dtype(FIX_ONE) ** dim if not is_int else np.int64(FIX_ONE) ** dim
    if is_int:
        # divRoundClosest for possibly-negative numerators (util.h)
        half = denom // 2
        return np.where(acc >= 0, (acc + half) // denom, -((-acc + half) // denom))
    return acc / denom
