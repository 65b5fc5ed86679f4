"""Replay / debug CLI — the equivalent of the reference's
``raytracer_test`` binary (/root/reference/src/raytrace_test.cpp:33-114):

  vrt-replay scene.npz rays.npz   # trace a serialized scene + ray instance
  vrt-replay instance.npz         # trace a combined instance
  vrt-replay                      # built-in 100³ benchmark scene
  vrt-replay --bench              # reference-style [R/s] throughput print

Instances are the debug dumps written by the bindings when
``Options.write_instance`` is set (≙ debug_raytrace_instance,
python_binding.cpp:21-34) — capture a failing case anywhere, replay it here
under full logging.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from .models.scene import RaytraceScene, trace_rays_instance
from .types import Options, RayInstance, RaySceneInstance, RaytraceInstance
from .utils import serialization
from .utils.logging import get_logger


def _builtin_instance(n: int = 100) -> RaytraceInstance:
    """Built-in ramp scene (≙ raytrace_test.cpp:78-96: 100³ volume, linear
    x-ramp IOR 1→2, rays launched from the x=1 face)."""
    ior = np.ones((n, n, n), np.float32)
    for i in range(n):
        ior[i] = 1.0 + i / (n - 1)
    translucency = np.full((n, n, n), 0xFFFFFFFF, np.uint32)
    k = 16
    ys, zs = np.meshgrid(
        np.linspace(8, n - 8, k, dtype=np.float64),
        np.linspace(8, n - 8, k, dtype=np.float64),
        indexing="ij",
    )
    m = ys.size
    start_pos = np.stack(
        [np.full(m, 0x18000, np.uint32),
         (ys.ravel() * 0x10000).astype(np.uint32),
         (zs.ravel() * 0x10000).astype(np.uint32)],
        axis=-1,
    )
    start_dir = np.tile(np.array([[16.0, 0.0, 0.0]], np.float32), (m, 1))
    return RaytraceInstance(
        RaySceneInstance((n, n, n), ior, translucency),
        RayInstance(start_pos, start_dir, np.full(3, 2.0, np.float32),
                    iterations=1_000_000),
    )


def _load(path: str):
    if path.endswith(".vrt"):
        return serialization.load_instance_binary(path)
    return serialization.load_instance(path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="vrt-replay", description=__doc__)
    ap.add_argument("files", nargs="*", help="instance.npz | scene.npz rays.npz")
    ap.add_argument("--mode", choices=["fixed", "float"], default="fixed")
    ap.add_argument("--loglevel", type=int, default=0,
                    help="negative = more verbose (reference convention)")
    ap.add_argument("--bench", action="store_true",
                    help="print reference-style Rays per time = ... [R/s]")
    args = ap.parse_args(argv)

    log = get_logger(args.loglevel)
    opt = Options(loglevel=args.loglevel)

    if len(args.files) == 2:
        scene_inst = serialization.load_scene_instance(args.files[0])
        ray_inst = serialization.load_ray_instance(args.files[1])
        inst = RaytraceInstance(scene_inst, ray_inst)
    elif len(args.files) == 1:
        inst = _load(args.files[0])
    else:
        inst = _builtin_instance()

    log.info("scene bounds=%s rays=%d iterations=%d",
             inst.scene.bounds, len(inst.rays.start_position),
             inst.rays.iterations)

    t0 = time.perf_counter()
    res = trace_rays_instance(inst.scene, inst.rays, opt, mode=args.mode)
    end_pos = np.asarray(res.end_position)
    dt = time.perf_counter() - t0

    end_iter = np.asarray(res.end_iteration)
    log.info("end_iteration: min=%d max=%d mean=%.1f",
             end_iter.min(), end_iter.max(), end_iter.mean())
    if args.loglevel < -1:
        for i in range(min(len(end_pos), 16)):
            log.debug("ray %d -> pos %s dir %s iters %d", i, end_pos[i],
                      np.asarray(res.end_direction)[i], end_iter[i])
    if args.bench:
        # ≙ performance_test.h:76 output format
        print(f"Rays per time = {len(end_pos) / dt:.1f} [R/s]")
    else:
        print(f"traced {len(end_pos)} rays in {dt:.3f}s; "
              f"mean end iteration {end_iter.mean():.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
