"""Rays/s vs device-count scaling harness (BASELINE config 5 measurement).

Protocol extends the reference's rays/wall-clock benchmark
(/root/reference/src/performance_test.h:59-76) across mesh sizes: a fixed ray
population is traced to budget exhaustion on 1, 2, 4, ... devices with the
ray batch data-parallel over the mesh, and scaling efficiency is reported as

    eff(n) = (rays_per_s(n) / rays_per_s(1)) / n        (target ≥ 0.85)

Two layouts are measured when enough devices exist:
  * ``dp``      — rays sharded, field replicated (parallel/shard.py);
  * ``rays×bricks`` — 2-D mesh, rays sharded over half the devices and the
    field X-slabs over the other axis (parallel/bricks.py) — demonstrates
    that rays/s still scales while the field is sharded.

On the CI/CPU virtual mesh this validates *structure* (collectives, shapes,
exactness); wall-clock efficiency is only meaningful on several GPUs, where
it runs unchanged:

    python benchmarks/scaling_harness.py

Writes benchmarks/scaling_<backend>.json.
"""

import json
import time

import numpy as np

import jax
import jax.numpy as jnp

from volumeraytracer_tpu.ops.fields import build_packed_field
from volumeraytracer_tpu.parallel import bricks, make_mesh, trace_rays_sharded
from volumeraytracer_tpu.types import FIX_ONE, STEP_CONST

GRID = (128, 64, 64)
N_RAYS = 16384
BUDGET = 256


def scene():
    ax = [np.linspace(-1.0, 1.0, n, dtype=np.float32) for n in GRID]
    x, y, z = np.meshgrid(*ax, indexing="ij")
    return jnp.asarray(1.0 + 0.4 * np.exp(-3.0 * (x * x + y * y + z * z)))


def rays(n):
    side = int(np.sqrt(n))
    ys = np.linspace(4.0, GRID[1] - 5.0, side, dtype=np.float32)
    zs = np.linspace(4.0, GRID[2] - 5.0, side, dtype=np.float32)
    yy, zz = np.meshgrid(ys, zs, indexing="ij")
    pos = np.stack([np.full(side * side, 1.5, np.float32), yy.ravel(), zz.ravel()], -1)
    dirs = np.tile(np.array([[16.0, 0.0, 0.0]], np.float32), (side * side, 1))
    return jnp.asarray(pos), jnp.asarray(dirs)


def bench(fn, *args, reps=3):
    out = jax.block_until_ready(fn(*args))  # compile
    np.asarray(jax.tree.leaves(out)[0])
    t0 = time.perf_counter()
    for _ in range(reps):
        out = jax.block_until_ready(fn(*args))
        np.asarray(jax.tree.leaves(out)[0])
    return (time.perf_counter() - t0) / reps


def main():
    ior = scene()
    packed = build_packed_field(ior)
    pos, dirs = rays(N_RAYS)
    pos_p = pos - 1.0
    inv = 2.0
    bend = inv / float(FIX_ONE)
    step = inv * (STEP_CONST / float(FIX_ONE) / float(FIX_ONE))

    ndev = len(jax.devices())
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= ndev]
    report = {
        "backend": jax.default_backend(),
        "n_devices": ndev,
        "n_rays": N_RAYS,
        "budget": BUDGET,
        "dp": {},
        "rays_x_bricks": {},
    }

    base = None
    for n in sizes:
        mesh = make_mesh(jax.devices()[:n])
        dt = bench(
            lambda: trace_rays_sharded(
                mesh, packed, pos_p, dirs, BUDGET,
                bend_scale=bend, step_scale=step, chunk_steps=64,
            )
        )
        rps = N_RAYS / dt
        base = rps if n == 1 else base
        eff = rps / base / n
        report["dp"][str(n)] = {"rays_per_s": round(rps, 1), "efficiency": round(eff, 4)}
        print(f"dp {n:2d} dev: {rps/1e6:8.3f} Mrays/s  eff {eff:.2%}")

    # 2-D layout: rays × 2 bricks
    for n in sizes:
        if n < 2 or n * 0 + 2 > ndev or n > ndev:
            continue
        n_r = n // 2
        if n_r < 1:
            continue
        mesh2 = bricks.make_mesh2d(n_r, 2)
        dt = bench(
            lambda: bricks.trace_rays_bricked2d(
                mesh2, packed, pos_p, dirs, BUDGET,
                bend_scale=bend, step_scale=step, k_steps=32,
            )
        )
        rps = N_RAYS / dt
        eff = rps / base / n if base else float("nan")
        report["rays_x_bricks"][str(n)] = {
            "rays_per_s": round(rps, 1), "efficiency": round(eff, 4),
        }
        print(f"{n_r}x2  {n:2d} dev: {rps/1e6:8.3f} Mrays/s  eff {eff:.2%}")

    out = f"benchmarks/scaling_{jax.default_backend()}.json"
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print("wrote", out)


if __name__ == "__main__":
    main()
