"""Multi-device sharding tests on the virtual 8-device CPU mesh (conftest.py)
— the mesh analogue of the reference's multi-GPU chunk scheduler tests
(which don't exist; the scheduler is only exercised implicitly — here we
assert sharded == single-device results exactly)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from volumeraytracer_tpu.ops.fields import build_packed_field
from volumeraytracer_tpu.parallel import (
    make_mesh,
    make_train_step,
    trace_rays_sharded,
)
from volumeraytracer_tpu.parallel.shard import endpoint_render
from volumeraytracer_tpu.types import FIX_ONE, STEP_CONST


def _ramp_scene(n=64):
    ior = np.ones((n, 8, 8), np.float32)
    for i in range(4, n - 4):
        ior[i] = 1.0 + (i - 4) / (n - 8)
    ior[n - 4 :] = 2.0
    return jnp.asarray(ior)


def test_sharded_matches_single():
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"
    ior = _ramp_scene()
    packed = build_packed_field(ior)
    rng = np.random.default_rng(0)
    n_rays = 37  # deliberately not divisible by 8 (padding path)
    pos = np.stack(
        [
            np.full(n_rays, 1.5),
            rng.uniform(2.0, 5.0, n_rays),
            rng.uniform(2.0, 5.0, n_rays),
        ],
        axis=-1,
    ).astype(np.float32)
    dirs = np.tile(np.array([[16.0, 0.0, 0.0]], np.float32), (n_rays, 1))

    inv = 2.0
    bend = inv / float(FIX_ONE)
    step = inv * (STEP_CONST / float(FIX_ONE) / float(FIX_ONE))

    from volumeraytracer_tpu.ops import march as march_ops

    ref = march_ops.march_float(
        packed, None, jnp.asarray(pos), jnp.asarray(dirs), 2000,
        bend_scale=bend, step_scale=step, chunk_steps=128,
    )
    mesh = make_mesh()
    res = trace_rays_sharded(
        mesh, packed, jnp.asarray(pos), jnp.asarray(dirs), 2000,
        bend_scale=bend, step_scale=step, chunk_steps=128,
    )
    np.testing.assert_allclose(
        np.asarray(res.end_position), np.asarray(ref.end_position), rtol=1e-6
    )
    np.testing.assert_array_equal(
        np.asarray(res.end_iteration), np.asarray(ref.end_iteration)
    )


def test_sharded_train_step_runs_and_descends():
    ior = _ramp_scene(32)
    mesh = make_mesh()
    n_rays = 16
    rng = np.random.default_rng(1)
    pos = np.stack(
        [
            np.full(n_rays, 1.5),
            rng.uniform(2.0, 5.0, n_rays),
            rng.uniform(2.0, 5.0, n_rays),
        ],
        axis=-1,
    ).astype(np.float32)
    dirs = np.tile(np.array([[16.0, 0.0, 0.0]], np.float32), (n_rays, 1))

    # target endpoints from a perturbed field: the step should reduce loss
    target, _ = endpoint_render(
        ior * 1.01, jnp.asarray(pos), jnp.asarray(dirs), 128, 2.0, 32
    )
    step = make_train_step(mesh, budget=128, chunk_steps=32, lr=1e-4)
    f = ior
    f1, loss0 = step(f, jnp.asarray(pos), jnp.asarray(dirs), target)
    f2, loss1 = step(f1, jnp.asarray(pos), jnp.asarray(dirs), target)
    assert np.isfinite(float(loss0)) and np.isfinite(float(loss1))
    assert float(loss1) < float(loss0)

    # gradient accumulation (2 micro-batches/shard, one psum per step) is a
    # pure reassociation of the loss sum: same update, same loss
    step_acc = make_train_step(mesh, budget=128, chunk_steps=32, lr=1e-4,
                               accum_steps=2)
    f1a, loss0a = step_acc(f, jnp.asarray(pos), jnp.asarray(dirs), target)
    np.testing.assert_allclose(float(loss0a), float(loss0), rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(f1a), np.asarray(f1), rtol=1e-6, atol=1e-7
    )
