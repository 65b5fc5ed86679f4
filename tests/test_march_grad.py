"""The differentiable XLA march: its gradient does not depend on the remat
chunk length, and it matches central finite differences for the index
field (3-D and 2-D) and for the soft-termination opacity field."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from volumeraytracer_tpu.ops import march as march_ops
from volumeraytracer_tpu.ops.fields import build_packed_field
from volumeraytracer_tpu.parallel.shard import endpoint_render
from volumeraytracer_tpu.types import FIX_ONE, STEP_CONST

INV = 2.0
BEND = INV / float(FIX_ONE)
STEP = INV * (STEP_CONST / float(FIX_ONE) / float(FIX_ONE))
BUDGET = 150


def _lens(shape, amp=0.4):
    axes = [np.linspace(-1, 1, s, dtype=np.float32) for s in shape]
    grids = np.meshgrid(*axes, indexing="ij")
    r2 = sum(g * g for g in grids)
    return (1.0 + amp * np.exp(-3.0 * r2)).astype(np.float32)


def _rays(dim, n_rays, hi, seed=0):
    rng = np.random.default_rng(seed)
    pos = np.stack([np.full(n_rays, 1.5, np.float32)] + [
        rng.uniform(3.0, hi, n_rays).astype(np.float32) for _ in range(dim - 1)], -1)
    dirs = np.stack([np.full(n_rays, 16.0, np.float32)] + [
        rng.uniform(-2.0, 2.0, n_rays).astype(np.float32) for _ in range(dim - 1)], -1)
    return jnp.asarray(pos), jnp.asarray(dirs)


def _value_and_grads(chunk_steps):
    packed = build_packed_field(jnp.asarray(_lens((28, 28, 28))))
    pos, dirs = _rays(3, 16, 22.0)
    rng = np.random.default_rng(4)
    wp = jnp.asarray(rng.normal(size=pos.shape).astype(np.float32))
    wd = jnp.asarray(rng.normal(size=dirs.shape).astype(np.float32))

    def loss(packed, pos, dirs):
        r = march_ops.march_float(
            packed, None, pos, dirs, BUDGET, bend_scale=BEND, step_scale=STEP,
            chunk_steps=chunk_steps, differentiable=True,
        )
        return jnp.sum(r.end_position * wp) + jnp.sum(r.end_direction * wd)

    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2)))(packed, pos, dirs)


@pytest.mark.parametrize("chunk_steps", [1, 7, 64, BUDGET])
def test_grad_independent_of_chunk_steps(chunk_steps):
    """Remat chunking only changes what is recomputed, never the result
    (7 does not divide the budget: the trailing steps are dead no-ops)."""
    v_ref, g_ref = _value_and_grads(16)
    v, g = _value_and_grads(chunk_steps)
    np.testing.assert_allclose(float(v), float(v_ref), rtol=1e-6)
    for a, b in zip(g, g_ref):
        b = np.asarray(b)
        np.testing.assert_allclose(np.asarray(a), b, rtol=0,
                                   atol=1e-5 * np.abs(b).max())


def _smooth_direction(shape, seed):
    """A smooth random field direction (noise would excite the gradient
    stencil's high frequencies and drown the difference quotient)."""
    v = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    for axis in range(len(shape)):
        for _ in range(4):
            v = 0.5 * v + 0.25 * (np.roll(v, 1, axis) + np.roll(v, -1, axis))
    return v / np.abs(v).max()


def _directional_check(loss, x, v, eps, rtol):
    x = jnp.asarray(x)
    g = np.asarray(jax.grad(loss)(x))
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    fd = (float(loss(x + eps * v)) - float(loss(x - eps * v))) / (2 * eps)
    np.testing.assert_allclose(float(np.sum(g * v)), fd, rtol=rtol)


@pytest.mark.parametrize("dim", [2, 3])
def test_ior_grad_matches_finite_differences(dim):
    shape = (24,) * dim
    pos, dirs = _rays(dim, 8, 18.0, seed=5)

    def loss(ior):
        end, _ = endpoint_render(ior, pos, dirs, 120, INV, 16)
        return jnp.sum(end[:, 1:])

    _directional_check(loss, _lens(shape), _smooth_direction(shape, dim),
                       eps=1e-2, rtol=2e-2)


def test_soft_opacity_grad_matches_finite_differences():
    """Soft termination gives the (float) translucency field a gradient
    through the transmittance; a semi-transparent wall (tr = 0.51, opacity
    channel just below its zero crossing) decays the beam smoothly to a few
    per cent."""
    n = 20
    ior = jnp.ones((n, n, n), jnp.float32)
    tr = np.ones((n, n, n), np.float32)
    tr[8:12] = 0.51
    pos = jnp.asarray([[3.0, 9.5, 10.0], [3.0, 10.5, 9.0]], jnp.float32)
    dirs = jnp.asarray([[4.0, 0.0, 0.0], [4.0, 0.2, 0.1]], jnp.float32)

    def loss(t):
        _, _, trans = endpoint_render(
            ior, pos, dirs, 256, 1.0, 16, soft_opacity_tau=256.0,
            translucency=t, return_transmittance=True,
        )
        return jnp.sum(trans)

    # perturb the wall around the beams, where the transmittance is decided
    v = np.zeros_like(tr)
    v[8:12, 7:13, 7:13] = 0.5 + np.abs(_smooth_direction((4, 6, 6), 7))
    _directional_check(loss, tr, v, eps=1e-4, rtol=2e-2)
