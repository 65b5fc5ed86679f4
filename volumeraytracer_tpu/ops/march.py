"""Batched eikonal ray-march cores (pure jnp / XLA).

This is the JAX re-design of the reference hot loop ``trace_ray_function``
(/root/reference/src/cuda_volume_raytracer.cu:317-374).  Per step:

    brightness -= (0xFFFFFFFF - translucency[voxel])       # absorption
    interp      = multilinear(packed_field, pos)           # dim+1 channels
    if interp[dim] > 0: break                              # opaque surface
    dir        += interp[:dim] * invscale                  # bend: += ∇log n
    pos        += round(dir * invscale * 0x42000000 / |dir|²)

Design notes (a re-design, not a port):
  * One CUDA thread per ray becomes one array element per ray: the whole ray
    batch advances in lock-step with per-ray alive masks (predication
    replaces the reference's per-ray ``break``; see SURVEY.md §7 "ray
    divergence"), and XLA compiles each step into fused device kernels.
  * The march runs in chunks of ``chunk_steps`` fixed-trip-count inner steps
    under an outer ``lax.while_loop`` that exits when every ray is finished —
    mirroring the chunked scheduler shape of the reference
    (cuda_volume_raytracer.cu:798-946) but on one device's vector lanes.
  * Two state layouts:
      - fixed path: uint32 16.16 positions, bit-faithful integer wrap
        semantics (the reference's pos_t math) — the parity/regression path;
      - float path: float32 voxel-unit positions, fully differentiable —
        the training/rendering path.
  * The differentiable variant replaces while_loop with a fixed-length
    ``lax.scan`` over remat'd chunks (O(sqrt N) memory via jax.checkpoint),
    because reverse-mode AD cannot run through a dynamic while_loop.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..types import (
    BRIGHTNESS_MAX,
    DIR_PRESCALE_FLOAT,
    FIX_ONE,
    STEP_CONST,
    TraceResult,
)
from .interp import interp_fixed, interp_linear, interp_nearest

#: valid values of the ``kernel`` argument of the float-march entry points
KERNELS = ("auto", "xla", "native")


def resolve_kernel(kernel: str) -> str:
    """Resolve a float-march ``kernel`` choice to what runs: ``"xla"`` (the
    march in this module, compiled for the default JAX backend — what
    ``"auto"`` means on every backend) or ``"native"`` (the scalar C++
    oracle on the host).  Anything else raises; no choice falls back to
    another implementation."""
    if kernel not in KERNELS:
        raise ValueError(
            f"unknown kernel {kernel!r}; valid choices: {', '.join(KERNELS)}"
        )
    return "native" if kernel == "native" else "xla"


class MarchState(NamedTuple):
    pos: jax.Array  # (N, dim) uint32 (fixed) or float32 voxels
    direction: jax.Array  # (N, dim) float32 working direction
    remaining: jax.Array  # (N,) uint32 remaining iteration budget
    brightness: jax.Array  # (N,) uint32
    alive: jax.Array  # (N,) bool
    #: (N,) float32 soft transmittance (only when soft_opacity_tau is set)
    trans: Optional[jax.Array] = None


# ---------------------------------------------------------------------------
# fixed-point path — bit-faithful to the reference integer kernel
# ---------------------------------------------------------------------------


def _fixed_step(
    state: MarchState,
    packed: jax.Array,
    translucency: Optional[jax.Array],
    bounds: np.ndarray,
    invscale: jax.Array,
    minimum_brightness: jax.Array,
) -> MarchState:
    """One predicated step of the uint32 16.16 march (≙ .cu:335-349)."""
    pos, direction, remaining, brightness, alive, _ = state
    dim = pos.shape[-1]

    # loop condition: iterations-- > 0 && (pos >> 16) < bounds - 1
    # (uint wrap makes negative positions huge, failing the check — same here)
    inbounds = jnp.all((pos >> 16) < jnp.asarray(bounds - 1, jnp.uint32), axis=-1)
    cond = alive & (remaining > 0) & inbounds

    if translucency is not None:
        vox = (pos >> 16).astype(jnp.int32)
        strides = _strides(bounds)
        tr = jnp.take(
            translucency.reshape(-1), jnp.sum(vox * strides, axis=-1), axis=0
        )
        absorb = jnp.minimum(brightness, jnp.uint32(BRIGHTNESS_MAX) - tr)
        new_brightness = brightness - absorb
        brightness = jnp.where(cond, new_brightness, brightness)
        dark = brightness < minimum_brightness
    else:
        dark = jnp.zeros_like(alive)

    interp = interp_fixed(packed, pos)  # (N, dim+1) float32
    opaque = interp[..., dim] > 0.0
    step_ok = cond & ~dark & ~opaque
    # In the reference, `iterations--` fires on every condition evaluation and
    # the trailing `++iterations` compensates the terminating one
    # (.cu:335,350-351): net effect, the budget decrements once per *executed
    # step* — break-terminated bodies do not consume budget.
    remaining = jnp.where(step_ok, remaining - 1, remaining)

    new_dir = direction + interp[..., :dim] * invscale
    ilen = jnp.float32(STEP_CONST) / jnp.sum(new_dir * new_dir, axis=-1, keepdims=True)
    delta = jnp.round(new_dir * invscale * ilen).astype(jnp.int32)
    new_pos = pos + delta.astype(jnp.uint32)  # uint32 wrap ≙ reference

    direction = jnp.where(step_ok[..., None], new_dir, direction)
    pos = jnp.where(step_ok[..., None], new_pos, pos)
    alive = step_ok
    return MarchState(pos, direction, remaining, brightness, alive)


# ---------------------------------------------------------------------------
# float path — differentiable, voxel units
# ---------------------------------------------------------------------------


def _float_step(
    state: MarchState,
    packed: jax.Array,
    translucency: Optional[jax.Array],
    bounds: np.ndarray,
    bend_scale: jax.Array,
    step_scale: jax.Array,
    minimum_brightness: jax.Array,
    opaque_when_positive: bool,
    nearest: bool,
    soft_tau: float = 0.0,
) -> MarchState:
    """One predicated step in float voxel units.

    Unifies the two reference variants:
      * C++ float instantiation: bend_scale = invscale, step_scale =
        invscale * 0x42000000 / 0x10000, linear interp, opaque if chan > 0
        (.cu:335-349 with pos_t → voxels);
      * CuPy kernel: bend_scale = 1, step_scale = 1, nearest sampling,
        opaque if chan < 0 (volume_raytracer.py:159-171).

    ``soft_tau > 0`` enables the soft-termination relaxation (SURVEY.md §7
    "sub-voxel surface termination"): the hard break on the opacity channel
    (≙ .cu:342-343) stays, but a float32 transmittance is carried alongside,
    multiplied per evaluated step by the sigmoid survival probability
    ``σ(−interp[dim]/τ)`` (sign flipped for the CuPy convention).  Its value
    is ≈1 for transparent media (opacity ≈ −0x8000 ⇒ σ ≈ 1) and collapses
    smoothly through a wall, giving the opacity/translucency field a nonzero,
    FD-verifiable gradient that the discrete break cannot.
    """
    pos, direction, remaining, brightness, alive, trans = state
    dim = pos.shape[-1]

    if nearest:
        # CuPy bounds test: 0 < pos < bound (volume_raytracer.py:163)
        inbounds = jnp.all((pos > 0.0) & (pos < jnp.asarray(bounds, jnp.float32)), axis=-1)
    else:
        inbounds = jnp.all(
            (pos >= 0.0) & (jnp.floor(pos) < jnp.asarray(bounds - 1, jnp.float32)),
            axis=-1,
        )
    cond = alive & (remaining > 0) & inbounds

    if translucency is not None:
        vox = jnp.clip(
            jnp.floor(pos).astype(jnp.int32), 0, jnp.asarray(bounds - 1, jnp.int32)
        )
        strides = _strides(bounds)
        tr = jnp.take(
            translucency.reshape(-1), jnp.sum(vox * strides, axis=-1), axis=0
        )
        absorb = jnp.minimum(brightness, jnp.uint32(BRIGHTNESS_MAX) - tr)
        new_brightness = brightness - absorb
        brightness = jnp.where(cond, new_brightness, brightness)
        dark = brightness < minimum_brightness
    else:
        dark = jnp.zeros_like(alive)

    if nearest:
        interp = interp_nearest(packed, pos)
    else:
        interp = interp_linear(packed, pos)
    if opaque_when_positive:
        opaque = interp[..., dim] > 0.0
    else:
        opaque = interp[..., dim] < 0.0
    step_ok = cond & ~dark & ~opaque
    # budget consumed once per executed step (see _fixed_step comment)
    remaining = jnp.where(step_ok, remaining - 1, remaining)

    if soft_tau > 0.0:
        sgn = -1.0 if opaque_when_positive else 1.0
        survive = jax.nn.sigmoid(interp[..., dim] * (sgn / soft_tau))
        trans = jnp.where(cond, trans * survive, trans)

    new_dir = direction + interp[..., :dim] * bend_scale
    ilen = 1.0 / jnp.sum(new_dir * new_dir, axis=-1, keepdims=True)
    new_pos = pos + new_dir * step_scale * ilen

    direction = jnp.where(step_ok[..., None], new_dir, direction)
    pos = jnp.where(step_ok[..., None], new_pos, pos)
    alive = step_ok
    return MarchState(pos, direction, remaining, brightness, alive, trans)


def _strides(bounds: np.ndarray) -> jax.Array:
    strides = np.ones(len(bounds), np.int32)
    for i in range(len(bounds) - 2, -1, -1):
        strides[i] = strides[i + 1] * bounds[i + 1]
    return jnp.asarray(strides)


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------


def _run_while(step_fn, state: MarchState, budget: int, chunk_steps: int) -> MarchState:
    """Forward-only driver: outer while("any ray alive"), inner fixed-size
    chunk — the divergence mitigation from SURVEY.md §7 (a tile marches until
    all of its rays finish, in chunk_steps granules)."""
    chunk_steps = max(1, min(chunk_steps, budget))

    def chunk(state):
        return jax.lax.fori_loop(0, chunk_steps, lambda _, s: step_fn(s), state)

    def cond(state):
        return jnp.any(state.alive)

    return jax.lax.while_loop(cond, chunk, state)


def _run_scan(step_fn, state: MarchState, budget: int, chunk_steps: int, record_path: bool):
    """Differentiable driver: fixed-length scan of remat'd chunks.

    Memory is O(num_chunks + chunk_steps) residuals instead of O(budget)
    ("sqrt remat"); the per-chunk recompute implements the reference's
    path-checkpoint idea (ray state is a restart point, SURVEY.md §5)."""
    chunk_steps = max(1, min(chunk_steps, budget))
    num_chunks = -(-budget // chunk_steps)

    if record_path:

        def inner(state, _):
            state = step_fn(state)
            return state, state.pos

        @jax.checkpoint
        def chunk(state, _):
            state, path = jax.lax.scan(inner, state, None, length=chunk_steps)
            return state, path

        state, path = jax.lax.scan(chunk, state, None, length=num_chunks)
        # (num_chunks, chunk_steps, N, dim) → (N, total, dim)
        path = path.reshape((-1,) + path.shape[2:]).swapaxes(0, 1)
        return state, path

    @jax.checkpoint
    def chunk(state, _):
        return jax.lax.scan(lambda s, _: (step_fn(s), None), state, None, length=chunk_steps)[0], None

    state, _ = jax.lax.scan(chunk, state, None, length=num_chunks)
    return state, None


def _init_remaining(
    lane: jax.Array,
    budget: int,
    per_ray_budget,
    consume_start_slot: bool,
) -> jax.Array:
    """Per-ray remaining-iteration init.  The reference carries the budget
    per RAY (``raydata_t::iterations``, cuda_volume_raytracer.cu:103-109; the
    CuPy kernel reads a per-ray uint32, volume_raytracer.py:159); the scalar
    ``budget`` is only the static trip-count bound.  C++ semantics consume
    one slot for the start path entry (.cu:333)."""
    if per_ray_budget is None:
        rem = lane + jnp.uint32(budget - 1 if consume_start_slot else budget)
    else:
        rem = jnp.asarray(per_ray_budget, jnp.uint32)
        rem = jnp.broadcast_to(rem, lane.shape) + lane
        if consume_start_slot:
            rem = jnp.maximum(rem, jnp.uint32(1)) - jnp.uint32(1)
    return rem


def march_fixed(
    packed: jax.Array,
    translucency: Optional[jax.Array],
    start_position: jax.Array,
    start_direction: jax.Array,
    budget: int,
    *,
    invscale,
    minimum_brightness: int = 0,
    chunk_steps: int = 256,
    record_path: bool = False,
    dir_prescale: float = DIR_PRESCALE_FLOAT,
    per_ray_budget: Optional[jax.Array] = None,
) -> TraceResult:
    """Reference-faithful fixed-point march over the *cropped/diff* grid.

    start_position: (N, dim) uint32 16.16 positions already shifted into the
    diff grid (the caller applies the −0x10000 net shift of
    image_util.cpp:692-710); start_direction: (N, dim) float in the float
    DirType convention (working dir = direction * 0x10000, .cu:331).
    ``per_ray_budget``: optional (N,) per-ray iteration budgets (≙
    raydata_t::iterations); ``budget`` must be ≥ their max (trip count).
    """
    bounds = np.asarray(packed.shape[:-1], np.int64)
    n, dim = start_position.shape
    invscale = jnp.broadcast_to(jnp.asarray(invscale, jnp.float32), (dim,))
    minb = jnp.uint32(minimum_brightness)

    # state vectors are derived from the positions (zeros_like) so they carry
    # the same sharding/varying-axis types under shard_map
    lane = jnp.zeros_like(start_position[..., 0], dtype=jnp.uint32)
    state = MarchState(
        pos=start_position.astype(jnp.uint32),
        direction=start_direction.astype(jnp.float32) * jnp.float32(dir_prescale),
        # path[--iterations] consumes one budget slot before the loop (.cu:333)
        remaining=_init_remaining(lane, budget, per_ray_budget, True),
        brightness=lane + jnp.uint32(BRIGHTNESS_MAX),
        alive=lane == 0,
    )
    step_fn = functools.partial(
        _fixed_step,
        packed=packed,
        translucency=translucency,
        bounds=bounds,
        invscale=invscale,
        minimum_brightness=minb,
    )

    if record_path:
        state, path = _run_scan(step_fn, state, budget, chunk_steps, True)
        # prepend the start position (path[--iterations] records it, .cu:333)
        path = jnp.concatenate([start_position[:, None].astype(jnp.uint32), path], axis=1)
    else:
        state, path = _run_while(step_fn, state, budget, chunk_steps), None

    return _finish(state, budget, dir_prescale, path, per_ray_budget)


def march_float(
    packed: jax.Array,
    translucency: Optional[jax.Array],
    start_position: jax.Array,
    start_direction: jax.Array,
    budget: int,
    *,
    bend_scale,
    step_scale,
    minimum_brightness: int = 0,
    chunk_steps: int = 256,
    record_path: bool = False,
    differentiable: bool = False,
    opaque_when_positive: bool = True,
    nearest: bool = False,
    dir_prescale: float = 1.0,
    per_ray_budget: Optional[jax.Array] = None,
    soft_opacity_tau: Optional[float] = None,
) -> TraceResult:
    """Float voxel-unit march (differentiable when requested).

    start_position: (N, dim) float32 voxels in the packed-field frame;
    start_direction: (N, dim) float32 *working* direction (already |v| = n
    normalised by the caller), optionally prescaled by ``dir_prescale``.
    ``per_ray_budget``: optional (N,) per-ray iteration budgets (≙ the CuPy
    kernel's per-ray uint32, volume_raytracer.py:159); ``budget`` must be ≥
    their max (it only bounds the static trip count).

    ``soft_opacity_tau``: enable the soft-termination relaxation — the result
    carries a differentiable ``transmittance`` (see ``_float_step``), through
    which opacity/translucency fields receive gradient (the hard break's
    gradient is zero a.e.).  τ is in opacity-channel units (the channel is
    ``(0x7FFFFFFF − translucency)/0x10000`` ∈ [−0x8000, 0x8000); τ ≈ 0x100
    gives a ~1/256-of-range transition band).
    """
    bounds = np.asarray(packed.shape[:-1], np.int64)
    n, dim = start_position.shape
    lane = jnp.zeros_like(start_position[..., 0], dtype=jnp.uint32)
    soft = soft_opacity_tau is not None and soft_opacity_tau > 0.0
    state = MarchState(
        pos=start_position.astype(jnp.float32),
        direction=start_direction.astype(jnp.float32) * jnp.float32(dir_prescale),
        # reference-C++ semantics (opaque_when_positive) consume one budget
        # slot for the start-position path entry (.cu:333); the CuPy kernel
        # does not (volume_raytracer.py:163 uses the full budget).
        remaining=_init_remaining(lane, budget, per_ray_budget, opaque_when_positive),
        brightness=lane + jnp.uint32(BRIGHTNESS_MAX),
        alive=lane == 0,
        trans=jnp.ones_like(start_position[..., 0], dtype=jnp.float32)
        if soft
        else None,
    )
    step_fn = functools.partial(
        _float_step,
        packed=packed,
        translucency=translucency,
        bounds=bounds,
        bend_scale=jnp.broadcast_to(jnp.asarray(bend_scale, jnp.float32), (dim,)),
        step_scale=jnp.broadcast_to(jnp.asarray(step_scale, jnp.float32), (dim,)),
        minimum_brightness=jnp.uint32(minimum_brightness),
        opaque_when_positive=opaque_when_positive,
        nearest=nearest,
        soft_tau=float(soft_opacity_tau) if soft else 0.0,
    )
    if differentiable or record_path:
        state, path = _run_scan(step_fn, state, budget, chunk_steps, record_path)
        if record_path:
            path = jnp.concatenate([start_position[:, None].astype(jnp.float32), path], axis=1)
    else:
        state, path = _run_while(step_fn, state, budget, chunk_steps), None
    return _finish(state, budget, dir_prescale, path, per_ray_budget)


def _finish(
    state: MarchState, budget: int, dir_prescale: float, path,
    per_ray_budget=None,
) -> TraceResult:
    # ++iterations; end_iteration = budget - remaining (.cu:350-352, 953-956).
    # Rays still alive at driver exit have consumed their whole budget.
    end_remaining = jnp.where(state.alive, jnp.uint32(0), state.remaining)
    if per_ray_budget is None:
        budget_arr = jnp.uint32(budget)
    else:
        budget_arr = jnp.asarray(per_ray_budget, jnp.uint32)
    end_iteration = budget_arr - end_remaining
    return TraceResult(
        end_position=state.pos,
        end_direction=state.direction / jnp.float32(dir_prescale),
        end_iteration=end_iteration,
        remaining_light=state.brightness,
        path=path,
        transmittance=state.trans,
    )
