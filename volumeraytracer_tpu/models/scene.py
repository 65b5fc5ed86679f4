"""RaytraceScene — build-once / trace-many scene API.

JAX equivalent of ``RaytraceScene<Ior, IorLog, Diff>``
(/root/reference/src/image_util.h:132-195, image_util.cpp:430-772) and of the
binding entry points (python_binding.cpp:10-52, java_binding.cpp:84-169):
the scene preprocessing (log-index → smoothed gradients → opacity packing)
runs once at construction and is jit-cached; ``trace_rays`` dispatches the
batched march.

Two tracing modes:
  * ``mode="fixed"``  — uint32 16.16 positions, bit-faithful reference
    semantics (the parity/regression path; ≙ TraceRaysCu<float> with pos_t);
  * ``mode="float"``  — float32 voxel positions, same physics constants,
    differentiable (the training and rendering path).

Both modes run the XLA march (ops/march.py) on the default JAX device;
``kernel="native"`` sends a plain float march to the scalar C++ oracle.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import march as march_ops
from ..ops.fields import build_packed_field, cropped_translucency
from ..ops.interp import interp_fixed, interp_linear
from ..types import (
    BRIGHTNESS_MAX,
    DIR_PRESCALE_FLOAT,
    DIR_UNIT_FIXED,
    FIX_HALF,
    FIX_ONE,
    STEP_CONST,
    Options,
    RayInstance,
    RaySceneInstance,
    RaytraceInstance,
    TraceResult,
)
from ..utils.logging import get_logger


class RaytraceScene:
    """Preprocessed optical scene over a refractive-index voxel grid."""

    def __init__(
        self,
        ior: Union[np.ndarray, jax.Array],
        translucency: Optional[Union[np.ndarray, jax.Array]] = None,
        options: Optional[Options] = None,
    ):
        ior = jnp.asarray(ior, jnp.float32)
        if ior.ndim not in (2, 3):
            raise ValueError(f"dimension must be 2 or 3, got {ior.ndim}")
        if translucency is not None:
            translucency = jnp.asarray(translucency)
            if translucency.shape != ior.shape:
                # ≙ "imagesizes doesn't match" (image_util.cpp:513-516)
                raise ValueError(
                    f"imagesizes doesn't match: ior {ior.shape} vs "
                    f"translucency {translucency.shape}"
                )
        if not bool(jnp.all(ior > 0)):
            # ≙ "refraction-index underflow" (image_util.cpp:607-610)
            raise ValueError("refraction-index underflow: ior must be > 0")
        self.options = options or Options()
        self._log = get_logger(self.options.loglevel)
        self.bounds = tuple(int(s) for s in ior.shape)
        self.dim = ior.ndim
        self.ior = ior
        self._translucency_raw = translucency
        # packed diff field on the cropped grid (bounds - 2 per axis)
        self.packed = build_packed_field(ior, translucency)
        self.translucency_cropped = (
            cropped_translucency(translucency) if translucency is not None else None
        )
        self.diff_bounds = tuple(int(s) for s in self.packed.shape[:-1])
        if self.options.loglevel < -1:
            # field statistics (≙ image_util.cpp:562-573 at loglevel < -1)
            self._log.info(
                "scene %s: ior [%g, %g], diff field [%g, %g] on %s",
                self.bounds, float(ior.min()), float(ior.max()),
                float(self.packed[..., : self.dim].min()),
                float(self.packed[..., : self.dim].max()),
                self.diff_bounds,
            )

    @classmethod
    def from_instance(cls, inst: RaySceneInstance, options: Optional[Options] = None):
        """≙ RaytraceScene(RayTraceSceneInstanceRef) (image_util.cpp:493-496)."""
        ior = np.asarray(inst.ior, np.float32).reshape(inst.bounds)
        tr = np.asarray(inst.translucency, np.uint32).reshape(inst.bounds)
        return cls(ior, tr, options)

    # -- ray pre/post processing ------------------------------------------

    def _validate_fixed(self, start_position: np.ndarray) -> None:
        """Bounds-validate 16.16 start positions (image_util.cpp:686-691):
        every coordinate must lie in [1, bound) voxels."""
        pos = np.asarray(start_position, np.uint64)
        bounds = np.asarray(self.bounds, np.uint64)
        bad = (pos < FIX_ONE) | (pos + 1 >= bounds * FIX_ONE)
        if bad.any():
            i = int(np.argwhere(bad.any(axis=-1))[0, 0])
            raise ValueError(
                f"ray {i}: {start_position[i] / FIX_ONE} is not in 0 to {self.bounds}"
            )

    def trace_rays(
        self,
        start_position,
        start_direction,
        *,
        invscale=None,
        iterations: int = 1_000_000,
        minimum_brightness: int = 0,
        trace_path: bool = False,
        normalize_length: bool = True,
        mode: str = "fixed",
        differentiable: bool = False,
        chunk_steps: Optional[int] = None,
        kernel: str = "auto",
        dir_fixed: bool = False,
        soft_opacity_tau: Optional[float] = None,
    ) -> TraceResult:
        """Trace a batch of rays (≙ RaytraceScene::trace_rays,
        image_util.cpp:645-772).

        start_position: (N, dim) — uint32 16.16 (mode="fixed") or float32
          voxel units (mode="float"), in the *uncropped* grid frame.
        start_direction: (N, dim) float; reference float-direction convention
          (speed s ⇒ |Δpos| ≈ s · invscale² · 0x42000000/0x100000000 voxels
          per step at n = 1).  With ``dir_fixed=True`` (mode="fixed" only):
          int16 **8.8 fixed-point** values (≙ DirType = dir_t,
          /root/reference/src/types.h:44-50) — quantized at entry/exit with
          the reference's 1/256 tolerance contract.
        invscale: per-axis float scale (≙ RayTraceRayInstance::_invscale).
        soft_opacity_tau: (mode="float" only) enable the soft-termination
          relaxation — the result carries a differentiable ``transmittance``
          through which the opacity/translucency field receives gradient
          (the hard opaque break of the reference kernel,
          cuda_volume_raytracer.cu:342-343, has zero gradient a.e.).
        kernel: "auto" or "xla" run the XLA march; "native" (mode="float"
          only) runs the scalar C++ oracle.  Any other value raises.
        """
        if invscale is None:
            invscale = np.ones(self.dim, np.float32)
        invscale = np.broadcast_to(np.asarray(invscale, np.float32), (self.dim,))
        chunk_steps = chunk_steps or self.options.chunk_steps
        kernel = march_ops.resolve_kernel(kernel)

        # explicit input validation (≙ the reference's per-ray checks,
        # image_util.cpp:686-691) — fail with a clear message instead of a
        # downstream reshape error.  np.shape is tracer-safe (trace_rays may
        # be called under jit for the differentiable path).
        sp_shape = np.shape(start_position)
        sd_shape = np.shape(start_direction)
        if sp_shape[-1:] != (self.dim,) or sd_shape[-1:] != (self.dim,):
            raise ValueError(
                f"start_position/start_direction must have trailing dim "
                f"{self.dim} (scene bounds {self.bounds}); got "
                f"{sp_shape} and {sd_shape}"
            )
        if sp_shape != sd_shape:
            raise ValueError(
                f"start_position {sp_shape} and start_direction {sd_shape} "
                "must have the same shape"
            )

        if self.options.write_instance:
            # capture-and-replay debug dump (≙ the pybind binding's
            # unconditional debug_raytrace_instance, python_binding.cpp:21-34,
            # and the JNI on-flag dump, java_binding.cpp:119-124); replay with
            # `vrt-replay <path>` (cli.py ≙ raytrace_test.cpp)
            self._dump_instance(
                start_position, start_direction, invscale, iterations,
                minimum_brightness, trace_path, normalize_length,
            )
        if self.options.loglevel < 0:
            self._log.info(
                "trace_rays: %d rays, mode=%s kernel=%s budget=%d",
                np.asarray(start_position).reshape(-1, self.dim).shape[0],
                mode, kernel, iterations,
            )
        if self.options.loglevel < -2:
            # per-ray input dump (≙ image_util.cpp:747-751 at loglevel < -2)
            self._log.debug("start_position=%s", np.asarray(start_position))
            self._log.debug("start_direction=%s", np.asarray(start_direction))

        if soft_opacity_tau is not None and mode != "float":
            raise ValueError("soft_opacity_tau requires mode='float'")
        if kernel == "native" and mode != "float":
            raise ValueError("kernel='native' requires mode='float'")
        if mode == "fixed":
            start_position = np.asarray(start_position, np.uint32).reshape(-1, self.dim)
            self._validate_fixed(start_position)
            if dir_fixed:
                return self._trace_fixed_dir_quantized(
                    start_position,
                    np.asarray(start_direction).reshape(-1, self.dim),
                    tuple(invscale.tolist()),
                    iterations,
                    minimum_brightness,
                    trace_path,
                    normalize_length,
                    chunk_steps,
                )
            return self._trace_fixed(
                jnp.asarray(start_position),
                jnp.asarray(np.asarray(start_direction, np.float32)).reshape(-1, self.dim),
                tuple(invscale.tolist()),
                iterations,
                minimum_brightness,
                trace_path,
                normalize_length,
                chunk_steps,
            )
        elif mode == "float":
            if dir_fixed:
                raise ValueError("dir_fixed requires mode='fixed'")
            pos = jnp.asarray(start_position, jnp.float32).reshape(-1, self.dim)
            dirs = jnp.asarray(start_direction, jnp.float32).reshape(-1, self.dim)
            if kernel == "native":
                return self._trace_float_native(
                    pos, dirs, tuple(invscale.tolist()), iterations,
                    minimum_brightness, trace_path, normalize_length,
                    differentiable,
                )
            return self._trace_float(
                pos,
                dirs,
                tuple(invscale.tolist()),
                iterations,
                minimum_brightness,
                trace_path,
                normalize_length,
                chunk_steps,
                differentiable,
                None if soft_opacity_tau is None else float(soft_opacity_tau),
            )
        raise ValueError(f"unknown mode {mode!r}")

    # cache jitted closures per (static-args) signature
    @functools.lru_cache(maxsize=None)
    def _fixed_fn(self, invscale, iterations, minimum_brightness, trace_path, normalize_length, chunk_steps):
        dim = self.dim

        def fn(packed, translucency, ior, start_position, start_direction):
            # preprocessing (image_util.cpp:692-710): shift −0x8000, sample
            # IOR there, scale direction by it (|v| = n init), shift −0x8000
            # again — net −1 voxel into the cropped diff frame.
            if normalize_length:
                pos = start_position - jnp.uint32(FIX_HALF)
                ior_here = interp_fixed(ior[..., None], pos)[..., 0]
                dirs = start_direction * ior_here[..., None]
                pos = pos - jnp.uint32(FIX_HALF)
            else:
                pos = start_position - jnp.uint32(FIX_ONE)
                dirs = start_direction
            res = march_ops.march_fixed(
                packed,
                translucency,
                pos,
                dirs,
                iterations,
                invscale=jnp.asarray(invscale, jnp.float32),
                minimum_brightness=minimum_brightness,
                chunk_steps=chunk_steps,
                record_path=trace_path,
            )
            # postprocessing: shift back +0x10000 (image_util.cpp:770-771)
            return TraceResult(
                end_position=res.end_position + jnp.uint32(FIX_ONE),
                end_direction=res.end_direction,
                end_iteration=res.end_iteration,
                remaining_light=res.remaining_light,
                path=None if res.path is None else res.path + jnp.uint32(FIX_ONE),
            )

        return jax.jit(fn)

    def _trace_fixed(self, pos, dirs, invscale, iterations, minimum_brightness, trace_path, normalize_length, chunk_steps):
        fn = self._fixed_fn(invscale, iterations, minimum_brightness, trace_path, normalize_length, chunk_steps)
        return fn(self.packed, self.translucency_cropped, self.ior, pos, dirs)

    def _trace_fixed_dir_quantized(self, pos, dirs, invscale, iterations,
                                   minimum_brightness, trace_path,
                                   normalize_length, chunk_steps):
        """Fixed march with int16 8.8 quantized directions (≙ DirType=dir_t).

        Mirrors the reference exactly (1/256 tolerance contract,
        /root/reference/src/types.h:44-50):
          * |v|=n init is *integer*: ``divRoundClosest(dir · ior_16.16,
            0x10000)`` with round-half-away-from-zero and an int16 overflow
            check ("Normalize length failed", image_util.cpp:700-707) — done
            host-side like the reference's OpenMP loop;
          * the working direction is stored · 0x100 — the same physical
            magnitude as the float path's value · 0x10000
            (cuda_volume_raytracer.cu:330-332);
          * the end direction is divided back by 0x100 and rounded to the
            nearest int16 (__float2int_rn2 + dir_t cast, .cu:360-363).
        """
        d = np.asarray(dirs)
        if not np.issubdtype(d.dtype, np.integer):
            # accept float inputs by exact 8.8 quantization at entry
            d = np.round(np.asarray(d, np.float64) * DIR_UNIT_FIXED)
        d = d.astype(np.int64)
        if d.max() > 0x7FFF or d.min() < -0x8000:
            raise ValueError("start_direction exceeds dir_t (int16 8.8) range")
        if normalize_length:
            p1 = pos.astype(np.uint32) - np.uint32(FIX_HALF)
            ior_here = np.asarray(
                interp_fixed(self.ior[..., None], jnp.asarray(p1))[..., 0],
                np.float64,
            )
            ior16 = np.round(ior_here * FIX_ONE).astype(np.int64)
            num = d * ior16[:, None]
            # divRoundClosest: round half away from zero (image_util.h:35-38)
            tmp = np.sign(num) * ((np.abs(num) + FIX_ONE // 2) // FIX_ONE)
            if tmp.max() > 0x7FFF or tmp.min() < -0x8000:
                raise ValueError(
                    f"Normalize length failed: -32768<={int(tmp.max())}<=32767"
                )
            d = tmp
        # stored/0x100 is exact in f32 (|stored| < 2^15); the march's
        # dir_prescale 0x10000 then yields working = stored · 0x100 exactly
        dirs_f = jnp.asarray(d.astype(np.float32) / np.float32(DIR_UNIT_FIXED))
        fn = self._fixed_fn(
            invscale, iterations, minimum_brightness, trace_path,
            False, chunk_steps,  # normalization already applied above
        )
        # both reference variants net-shift −0x10000 (−0x8000 twice when
        # normalizing, image_util.cpp:692-710; −0x10000 otherwise) — the
        # normalize_length=False closure applies exactly that
        res = fn(self.packed, self.translucency_cropped, self.ior, jnp.asarray(pos), dirs_f)
        stored = (
            jnp.round(res.end_direction * DIR_UNIT_FIXED)
            .astype(jnp.int32)
            .astype(jnp.int16)
        )
        return TraceResult(
            end_position=res.end_position,
            end_direction=stored,
            end_iteration=res.end_iteration,
            remaining_light=res.remaining_light,
            path=res.path,
        )

    @functools.lru_cache(maxsize=None)
    def _float_fn(self, invscale, iterations, minimum_brightness, trace_path, normalize_length, chunk_steps, differentiable, soft_opacity_tau=None):
        dim = self.dim
        inv = np.asarray(invscale, np.float32)
        # float-path constants (see ops/march.py): working dir = raw float
        # direction (dir_prescale 1), so
        #   bend_scale = invscale / 0x10000
        #   step_scale = invscale * 0x42000000 / 0x10000²   (voxels)
        bend_scale = inv / float(FIX_ONE)
        step_scale = inv * (STEP_CONST / float(FIX_ONE) / float(FIX_ONE))

        def fn(packed, translucency, ior, start_position, start_direction):
            if normalize_length:
                pos = start_position - 0.5
                ior_here = interp_linear(ior, pos)
                dirs = start_direction * ior_here[..., None]
                pos = pos - 0.5
            else:
                pos = start_position - 1.0
                dirs = start_direction
            res = march_ops.march_float(
                packed,
                translucency,
                pos,
                dirs,
                iterations,
                bend_scale=bend_scale,
                step_scale=step_scale,
                minimum_brightness=minimum_brightness,
                chunk_steps=chunk_steps,
                record_path=trace_path,
                differentiable=differentiable,
                opaque_when_positive=True,
                soft_opacity_tau=soft_opacity_tau,
            )
            return TraceResult(
                end_position=res.end_position + 1.0,
                end_direction=res.end_direction,
                end_iteration=res.end_iteration,
                remaining_light=res.remaining_light,
                path=None if res.path is None else res.path + 1.0,
                transmittance=res.transmittance,
            )

        return jax.jit(fn)

    def _trace_float(self, pos, dirs, invscale, iterations, minimum_brightness, trace_path, normalize_length, chunk_steps, differentiable, soft_opacity_tau=None):
        fn = self._float_fn(invscale, iterations, minimum_brightness, trace_path, normalize_length, chunk_steps, differentiable, soft_opacity_tau)
        return fn(self.packed, self.translucency_cropped, self.ior, pos, dirs)

    def _trace_float_native(self, pos, dirs, invscale, iterations,
                            minimum_brightness, trace_path, normalize_length,
                            differentiable):
        """Float forward via the scalar C++ host oracle (native/vrt_native.cpp)
        — the analogue of the reference's CPU worker pool
        (cuda_volume_raytracer.cu:376-394,809), with host parallelism capped
        by ``Options.max_cpu`` (≙ ``_max_cpu``, types.h:89, .cu:389)."""
        from .. import native

        if trace_path or differentiable:
            raise ValueError(
                "kernel='native' is a forward-only oracle "
                "(no trace_path/differentiable)"
            )
        inv = np.asarray(invscale, np.float32)
        bend_scale = inv / float(FIX_ONE)
        step_scale = inv * (STEP_CONST / float(FIX_ONE) / float(FIX_ONE))
        if normalize_length:
            p = pos - 0.5
            dirs = dirs * interp_linear(self.ior, p)[..., None]
            p = p - 0.5
        else:
            p = pos - 1.0
        tr = self.translucency_cropped
        end_pos, end_dir, iters, light = native.march_float(
            np.asarray(self.packed), np.asarray(p), np.asarray(dirs),
            iterations, bend_scale, step_scale,
            nthreads=int(self.options.max_cpu),
            translucency=None if tr is None else np.asarray(tr),
            minimum_brightness=minimum_brightness,
        )
        return TraceResult(
            end_position=jnp.asarray(end_pos + 1.0),
            end_direction=jnp.asarray(end_dir),
            end_iteration=jnp.asarray(iters),
            remaining_light=jnp.asarray(light),
            path=None,
        )

    def _dump_instance(self, start_position, start_direction, invscale,
                       iterations, minimum_brightness, trace_path,
                       normalize_length) -> str:
        """Write a replayable combined instance (scene + this ray batch).

        ``Options.write_instance`` may be ``True`` (default path
        ``debug_raytrace_instance.npz`` in the CWD, the reference's filename,
        python_binding.cpp:29) or a string path.  Returns the path written.
        """
        from ..utils import serialization

        tr = self._translucency_raw
        tr = (
            np.full(self.bounds, BRIGHTNESS_MAX, np.uint32)
            if tr is None
            else np.asarray(tr, np.uint32)
        )
        inst = RaytraceInstance(
            RaySceneInstance(self.bounds, np.asarray(self.ior), tr),
            RayInstance(
                np.asarray(start_position).reshape(-1, self.dim),
                np.asarray(start_direction, np.float32).reshape(-1, self.dim),
                np.asarray(invscale, np.float32),
                minimum_brightness=minimum_brightness,
                iterations=iterations,
                trace_path=trace_path,
                normalize_length=normalize_length,
            ),
        )
        path = self.options.write_instance
        if not isinstance(path, str):
            path = "debug_raytrace_instance.npz"
        if path.endswith(".vrt"):
            serialization.save_instance_binary(path, inst)
        else:
            serialization.save_instance(path, inst)
        self._log.info("wrote replay instance to %s", path)
        return path

    # -- probes ------------------------------------------------------------

    def get_ior(self, position) -> jax.Array:
        """Interpolated IOR at float voxel positions (≙ OpticalVolume.get_ior,
        volume_raytracer.py:259-270, but multilinear)."""
        pos = jnp.asarray(position, jnp.float32).reshape(-1, self.dim)
        return interp_linear(self.ior, pos)


def trace_rays_instance(scene_inst: RaySceneInstance, ray_inst: RayInstance, options: Optional[Options] = None, mode: str = "fixed") -> TraceResult:
    """Free-function replay entry (≙ trace_rays<...>(RaytraceInstanceRef),
    image_util.cpp:780-813,864-891; used by the CLI, ≙ raytrace_test.cpp)."""
    scene = RaytraceScene.from_instance(scene_inst, options)
    return scene.trace_rays(
        ray_inst.start_position,
        ray_inst.start_direction,
        invscale=ray_inst.invscale,
        iterations=ray_inst.iterations,
        minimum_brightness=ray_inst.minimum_brightness,
        trace_path=ray_inst.trace_path,
        normalize_length=ray_inst.normalize_length,
        mode=mode,
    )
