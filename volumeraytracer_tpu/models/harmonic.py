"""Harmonic-field solver — damped Jacobi iteration of an edge-weighted graph
Laplacian on an N-D grid.

JAX equivalent of ``solveHarmonic``
(/root/reference/src/solve_harmonic.cpp:17-117): neighbour edge weight
``1/(1 + Δd²)`` with Δd the difference of ``derivative_divisor`` across the
edge, Dirichlet mask ``is_fixed``, damped update

    v ← (Σ_nbr w·v_nbr + S·v) / (2S),   S = Σ_nbr w

(i.e. averaging the Jacobi update with the current value — the reference's
``erg += add_middle; erg /= div_sum * 2`` damping), with an L2 early-exit on
the squared update difference.

Instead of the reference's OpenMP sweep over flat indices, each sweep is a
stack of axis-shifted multiplies — pure VPU work that XLA fuses into a few
passes; the iteration is a ``lax.while_loop`` with the residual in the carry.
Used to synthesize smooth IOR fields with boundary constraints
(BASELINE config 3).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np


def _shift(x: jax.Array, axis: int, offset: int) -> jax.Array:
    """x shifted by ``offset`` along ``axis``, zero-padded (out-of-grid
    neighbours contribute nothing, like the reference's bounds checks)."""
    pad = [(0, 0)] * x.ndim
    if offset > 0:
        pad[axis] = (offset, 0)
        sl = tuple(
            slice(0, -offset) if a == axis else slice(None) for a in range(x.ndim)
        )
    else:
        pad[axis] = (0, -offset)
        sl = tuple(
            slice(-offset, None) if a == axis else slice(None) for a in range(x.ndim)
        )
    return jnp.pad(x[sl], pad)


@functools.partial(jax.jit, static_argnames=("max_iterations",))
def _solve(values, derivative_divisor, is_fixed, max_iterations: int, max_error):
    ndim = values.ndim

    # Edge weights per axis/direction: w_lo[i] couples i with i - e_a
    weights_lo = []
    weights_hi = []
    free = ~is_fixed
    for a in range(ndim):
        d_lo = derivative_divisor - _shift(derivative_divisor, a, 1)
        d_hi = derivative_divisor - _shift(derivative_divisor, a, -1)
        w_lo = 1.0 / (1.0 + d_lo * d_lo)
        w_hi = 1.0 / (1.0 + d_hi * d_hi)
        # zero out edges leaving the grid (position 0 / bound-1 per axis)
        idx = jnp.arange(values.shape[a])
        shape = [1] * ndim
        shape[a] = values.shape[a]
        mask_lo = (idx > 0).reshape(shape)
        mask_hi = (idx < values.shape[a] - 1).reshape(shape)
        weights_lo.append(jnp.where(mask_lo, w_lo, 0.0))
        weights_hi.append(jnp.where(mask_hi, w_hi, 0.0))

    div_sum = sum(w for w in weights_lo) + sum(w for w in weights_hi)
    div_sum = jnp.where(free, div_sum, 0.0)
    safe_div = jnp.where(div_sum > 0, div_sum, 1.0)

    def body(carry):
        v, it, err = carry
        acc = jnp.zeros_like(v)
        for a in range(ndim):
            acc = acc + weights_lo[a] * _shift(v, a, 1)
            acc = acc + weights_hi[a] * _shift(v, a, -1)
        add_middle = div_sum * v
        new_v = (acc + add_middle) / (2.0 * safe_div)
        new_v = jnp.where(free & (div_sum > 0), new_v, v)
        # reference error: Σ (erg - add_middle)²  (solve_harmonic.cpp:101-104)
        err_term = jnp.where(free & (div_sum > 0), new_v - add_middle, 0.0)
        return new_v, it + 1, jnp.sum(err_term * err_term)

    def cond(carry):
        _, it, err = carry
        return (it < max_iterations) & (err >= max_error)

    v0 = values
    # run at least one sweep (the reference checks the error after the sweep)
    v, it, err = body((v0, jnp.int32(0), jnp.float32(0.0)))
    v, it, err = jax.lax.while_loop(cond, lambda c: body(c), (v, it, err))
    return v, it, err


def solve_harmonic(
    values,
    derivative_divisor=None,
    is_fixed=None,
    max_iterations: int = 1000,
    max_error: float = 1e-8,
    return_info: bool = False,
):
    """Solve for a harmonic field with Dirichlet constraints.

    values: initial field; fixed entries hold their value.
    derivative_divisor: per-voxel scalar controlling edge weights
      ``1/(1+Δd²)`` (uniform ⇒ standard Laplace smoothing).
    is_fixed: boolean mask of Dirichlet nodes.
    """
    values = jnp.asarray(values, jnp.float32)
    if derivative_divisor is None:
        derivative_divisor = jnp.zeros_like(values)
    else:
        derivative_divisor = jnp.asarray(derivative_divisor, jnp.float32)
    if is_fixed is None:
        is_fixed = jnp.zeros(values.shape, bool)
    else:
        is_fixed = jnp.asarray(is_fixed, bool)
    if values.shape != derivative_divisor.shape or values.shape != is_fixed.shape:
        raise ValueError("Wrong input dimensions")
    v, it, err = _solve(values, derivative_divisor, is_fixed, max_iterations, jnp.float32(max_error))
    if return_info:
        return v, {"iterations": int(it), "error": float(err)}
    return v


def solveHarmonic(values, derivative_divisor, is_fixed, bounds, max_iterations, max_error):
    """Reference-signature shim (≙ example.solveHarmonic,
    solve_harmonic.cpp:121-125): flat lists + bounds, returns a flat array."""
    bounds = tuple(int(b) for b in bounds)
    # the reference indexes with axis-0 fastest (index % bounds[0], /= ...,
    # solve_harmonic.cpp:46-48) — i.e. column-major w.r.t. bounds; reshape
    # accordingly (Fortran order) so neighbour topology matches.
    v = np.asarray(values, np.float64).reshape(bounds, order="F")
    d = np.asarray(derivative_divisor, np.float64).reshape(bounds, order="F")
    f = np.asarray(is_fixed, bool).reshape(bounds, order="F")
    out = solve_harmonic(v, d, f, int(max_iterations), float(max_error))
    return np.asarray(out, np.float64).reshape(-1, order="F")
