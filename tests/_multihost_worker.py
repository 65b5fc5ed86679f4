"""Worker for tests/test_multihost.py — one *process* of a 2-process CPU
run (2 hosts × 2 virtual devices).  Exercises the real multi-host entry
points: ``init_distributed`` (≙ init(), cuda_volume_raytracer.cu:82-101,
generalised), ``make_host_mesh`` (hosts × local devices), and one
``make_brick_train_step2d`` step over the (rays, bricks) mesh with the rays
axis crossing processes — gloo-backed CPU collectives.

Usage: _multihost_worker.py <coordinator_address> <num_processes> <process_id>
Prints one line ``MH <process_id> <loss> <mesh_shape>`` on success.
"""
import sys

import numpy as np


def main():
    coord, num, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

    from volumeraytracer_tpu.parallel.shard import init_distributed, make_host_mesh

    info = init_distributed(
        coordinator_address=coord, num_processes=num, process_id=pid
    )
    assert info["process_count"] == num, info
    assert info["global_devices"] == num * info["local_devices"], info

    import jax
    import jax.numpy as jnp
    from volumeraytracer_tpu.parallel.bricks import (
        build_ior_slabs, make_brick_train_step2d, shard_slabs,
    )
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = make_host_mesh(("rays", "bricks"))
    assert mesh.shape["rays"] == num, mesh.shape

    n = 18
    ax = np.linspace(-1, 1, n, dtype=np.float32)
    x, y, z = np.meshgrid(ax, np.linspace(-1, 1, 10), np.linspace(-1, 1, 10),
                          indexing="ij")
    ior = jnp.asarray(1.0 + 0.1 * np.exp(-2 * (x * x + y * y + z * z)),
                      jnp.float32)
    x_packed = n - 2
    num_b = mesh.shape["bricks"]
    slabs, _ = build_ior_slabs(ior, num_b)
    slabs = shard_slabs(mesh, slabs)

    n_rays = 8
    rng = np.random.default_rng(0)
    pos = np.stack([
        np.full(n_rays, 1.5, np.float32),
        rng.uniform(2.0, 7.0, n_rays).astype(np.float32),
        rng.uniform(2.0, 7.0, n_rays).astype(np.float32),
    ], axis=-1)
    dirs = np.tile(np.array([[16.0, 0.0, 0.0]], np.float32), (n_rays, 1))
    target = jnp.asarray(pos + np.array([2.0, 0, 0], np.float32))

    spec = NamedSharding(mesh, P("rays"))
    pos_s = jax.device_put(jnp.asarray(pos), spec)
    dirs_s = jax.device_put(jnp.asarray(dirs), spec)
    tgt_s = jax.device_put(target, spec)

    step = make_brick_train_step2d(
        mesh, x_packed, n_rays, budget=32, invscale=2.0, k_steps=8, lr=1e-3
    )
    new_slabs, loss = step(slabs, pos_s, dirs_s, tgt_s)
    loss = float(loss)
    assert np.isfinite(loss) and loss > 0, loss
    assert new_slabs.shape == slabs.shape
    print(f"MH {pid} {loss:.8e} {mesh.devices.shape}", flush=True)


if __name__ == "__main__":
    main()
