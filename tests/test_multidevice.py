"""The multi-device training steps on four virtual CPU devices equal the
one-device step: the replicated-field step (with and without gradient
accumulation) and the brick-sharded steps (4 bricks; 2 rays × 2 bricks)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from volumeraytracer_tpu.parallel import bricks
from volumeraytracer_tpu.parallel.shard import (
    endpoint_render,
    make_mesh,
    make_train_step,
    replicate,
    shard_batch,
)

BUDGET, CHUNK, K_STEPS, INV = 64, 16, 8, 2.0


def _inputs(grid=34, n_rays=64):
    ax = np.linspace(-1, 1, grid, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    ior = jnp.asarray(1.0 + 0.5 * np.exp(-4.0 * (x * x + y * y + z * z)))
    rng = np.random.default_rng(0)
    pos = np.stack([np.full(n_rays, 2.0), rng.uniform(4, grid - 4, n_rays),
                    rng.uniform(4, grid - 4, n_rays)], -1).astype(np.float32)
    dirs = np.tile(np.array([[16.0, 0.0, 0.0]], np.float32), (n_rays, 1))
    pos, dirs = jnp.asarray(pos), jnp.asarray(dirs)
    target, _ = endpoint_render(ior * 1.01, pos, dirs, BUDGET, INV, CHUNK)
    return ior, pos, dirs, target


@pytest.fixture(scope="module")
def reference():
    """Inputs, the one-device step's loss and gradient, and an lr that keeps
    lr·g at O(1) so (ior − new)/lr recovers g in f32."""
    ior, pos, dirs, target = _inputs()

    def loss(f):
        end, _ = endpoint_render(f, pos, dirs, BUDGET, INV, CHUNK)
        return jnp.sum((end - target) ** 2) / pos.shape[0]

    g = np.asarray(jax.grad(loss)(ior))
    lr = 1.0 / float(np.abs(g).max())
    step = make_train_step(make_mesh(jax.devices()[:1]), budget=BUDGET,
                           invscale=INV, chunk_steps=CHUNK, lr=lr)
    new, loss1 = step(ior, pos, dirs, target)
    g1 = (np.asarray(ior) - np.asarray(new)) / lr
    np.testing.assert_allclose(g1, g, rtol=0, atol=1e-5)
    return (ior, pos, dirs, target), float(loss1), g1, lr


def _assert_grad(g, g1):
    np.testing.assert_allclose(g, g1, rtol=0, atol=1e-5 * np.abs(g1).max())


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_four_device_train_step_matches_one(reference, accum_steps):
    (ior, pos, dirs, target), loss1, g1, lr = reference
    mesh = make_mesh(jax.devices()[:4])
    step = make_train_step(mesh, budget=BUDGET, invscale=INV, chunk_steps=CHUNK,
                           lr=lr, accum_steps=accum_steps)
    new, loss = step(replicate(mesh, ior), *(shard_batch(mesh, a)
                                             for a in (pos, dirs, target)))
    np.testing.assert_allclose(float(loss), loss1, rtol=1e-6)
    _assert_grad((np.asarray(ior) - np.asarray(new)) / lr, g1)


def test_four_brick_train_step_matches_one(reference):
    (ior, pos, dirs, target), loss1, g1, lr = reference
    mesh = make_mesh(jax.devices()[:4], axis="bricks")
    slabs, _ = bricks.build_ior_slabs(ior, 4)
    slabs = bricks.shard_slabs(mesh, slabs)
    step = bricks.make_brick_train_step(mesh, ior.shape[0] - 2, budget=BUDGET,
                                        invscale=INV, k_steps=K_STEPS, lr=lr)
    new, loss = step(slabs, pos, dirs, target)
    np.testing.assert_allclose(float(loss), loss1, rtol=1e-6)
    g = (np.asarray(slabs) - np.asarray(new)) / lr
    _assert_grad(bricks.assemble_ior(g, ior.shape[0]), g1)


def test_rays_by_bricks_train_step_matches_one(reference):
    (ior, pos, dirs, target), loss1, g1, lr = reference
    mesh = bricks.make_mesh2d(2, 2, jax.devices()[:4])
    slabs, _ = bricks.build_ior_slabs(ior, 2)
    slabs = jax.device_put(slabs, NamedSharding(mesh, P("bricks")))
    rays = NamedSharding(mesh, P("rays"))
    step = bricks.make_brick_train_step2d(
        mesh, ior.shape[0] - 2, n_rays_total=pos.shape[0], budget=BUDGET,
        invscale=INV, k_steps=K_STEPS, lr=lr)
    new, loss = step(slabs, *(jax.device_put(a, rays) for a in (pos, dirs, target)))
    np.testing.assert_allclose(float(loss), loss1, rtol=1e-6)
    g = (np.asarray(slabs) - np.asarray(new)) / lr
    _assert_grad(bricks.assemble_ior(g, ior.shape[0]), g1)
