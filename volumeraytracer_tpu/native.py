"""ctypes loader for the native host library (native/libvrt_native.so).

The native layer is this package's analogue of the reference's host
build of the kernel (-DNCUDA, /root/reference/Makefile:57-58): an
independent scalar C++ implementation of the same march semantics used as
a cross-implementation oracle, plus OpenMP harmonic sweeps and AoS/SoA ray
marshalling.  Built on demand with ``make -C native`` (g++ is assumed; no
pip deps).  All entry points degrade gracefully when the library is
unavailable — callers check ``available()``.
"""

from __future__ import annotations

import ctypes
import fcntl
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_SO = _NATIVE_DIR / "libvrt_native.so"
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    """Bring the library up to date with its sources (``make`` rebuilds
    only what changed).  Several processes (test workers) may ask at once:
    the first to take the lock builds, the others wait and then find the
    finished file."""
    try:
        with open(_NATIVE_DIR / ".build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            subprocess.run(
                ["make", "-C", str(_NATIVE_DIR)],
                check=True, capture_output=True, timeout=120,
            )
        return _SO.exists()
    except (OSError, subprocess.SubprocessError):
        return False


def load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _build():
        return None
    try:
        lib = ctypes.CDLL(str(_SO))
    except OSError:
        return None
    u32p = ctypes.POINTER(ctypes.c_uint32)
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.vrt_march_float.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        f32p, f32p, u32p, ctypes.c_int,
        ctypes.c_uint32, f32p, f32p, ctypes.c_int,
    ]
    lib.vrt_march_float.restype = None
    lib.vrt_march_float_ex.argtypes = [
        f32p, ctypes.POINTER(ctypes.c_int), ctypes.c_int, u32p,
        ctypes.c_uint32, f32p, f32p, u32p, u32p, u32p, ctypes.c_int,
        ctypes.c_uint32, f32p, f32p, ctypes.c_int,
    ]
    lib.vrt_march_float_ex.restype = None
    lib.vrt_solve_harmonic.argtypes = [
        f64p, f64p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int64,
        ctypes.c_int, ctypes.c_double, ctypes.c_int,
    ]
    lib.vrt_solve_harmonic.restype = ctypes.c_int
    # scene-level C API (the second-language binding; native/vrt_native.h)
    lib.vrt_scene_new.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, u32p,
    ]
    lib.vrt_scene_new.restype = ctypes.c_void_p
    lib.vrt_scene_trace.argtypes = [
        ctypes.c_void_p, f32p, f32p, u32p, ctypes.c_int,
        ctypes.c_uint32, f32p, ctypes.c_int, ctypes.c_int,
    ]
    lib.vrt_scene_trace.restype = None
    lib.vrt_scene_bounds.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
    ]
    lib.vrt_scene_bounds.restype = None
    lib.vrt_scene_free.argtypes = [ctypes.c_void_p]
    lib.vrt_scene_free.restype = None
    # options by integer key (≙ java_binding.cpp:322-381)
    lib.vrt_options_new.argtypes = []
    lib.vrt_options_new.restype = ctypes.c_void_p
    lib.vrt_options_free.argtypes = [ctypes.c_void_p]
    lib.vrt_options_free.restype = None
    lib.vrt_options_set.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64]
    lib.vrt_options_set.restype = ctypes.c_int
    lib.vrt_options_get.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.vrt_options_get.restype = ctypes.c_int64
    lib.vrt_scene_new_opt.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, u32p, ctypes.c_void_p,
    ]
    lib.vrt_scene_new_opt.restype = ctypes.c_void_p
    _lib = lib
    return _lib


#: option keys of the C ABI (vrt_native.h; ≙ the reference's integer keys
#: over JNI, java_binding.cpp:322-381)
OPT_LOGLEVEL = 0
OPT_MINIMUM_DEVICE = 1
OPT_MAX_CPU = 2


def available() -> bool:
    return load() is not None


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def march_float(
    packed: np.ndarray,
    start_position: np.ndarray,
    start_direction: np.ndarray,
    budget: int,
    bend_scale,
    step_scale,
    nthreads: int = 0,
    *,
    translucency: Optional[np.ndarray] = None,
    minimum_brightness: int = 0,
    per_ray_budget: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Scalar C++ oracle march over a 2-D or 3-D packed field.  Returns
    (end_pos, end_dir, end_iteration, remaining_light); same semantics as
    ops.march.march_float (``translucency`` on the packed grid)."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable (g++/make failed?)")
    packed = np.ascontiguousarray(packed, np.float32)
    dim = packed.ndim - 1
    if dim not in (2, 3) or packed.shape[-1] != dim + 1:
        raise ValueError(f"packed field must be (X, Y[, Z], dim+1), got {packed.shape}")
    dims = np.asarray(packed.shape[:-1], np.int32)
    pos = np.ascontiguousarray(start_position, np.float32).copy()
    dirs = np.ascontiguousarray(start_direction, np.float32).copy()
    n = pos.shape[0]
    if pos.shape != (n, dim) or dirs.shape != pos.shape:
        raise ValueError(f"rays must be (N, {dim}); got {pos.shape} and {dirs.shape}")
    iters = np.zeros(n, np.uint32)
    light = np.zeros(n, np.uint32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    tr = None
    if translucency is not None:
        tr = np.ascontiguousarray(translucency, np.uint32)
        if tr.shape != packed.shape[:-1]:
            raise ValueError(f"translucency {tr.shape} is not on the packed "
                             f"grid {packed.shape[:-1]}")
    budgets = None
    if per_ray_budget is not None:
        budgets = np.ascontiguousarray(
            np.broadcast_to(np.asarray(per_ray_budget, np.uint32), (n,)))
    bend = np.ascontiguousarray(np.broadcast_to(np.asarray(bend_scale, np.float32), (dim,)))
    step = np.ascontiguousarray(np.broadcast_to(np.asarray(step_scale, np.float32), (dim,)))
    lib.vrt_march_float_ex(
        _f32p(packed), dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), dim,
        None if tr is None else tr.ctypes.data_as(u32p),
        np.uint32(minimum_brightness),
        _f32p(pos), _f32p(dirs), iters.ctypes.data_as(u32p),
        light.ctypes.data_as(u32p),
        None if budgets is None else budgets.ctypes.data_as(u32p),
        n, np.uint32(budget), _f32p(bend), _f32p(step), nthreads,
    )
    return pos, dirs, iters, light


class NativeScene:
    """Build-once/trace-many handle over the scene-level C API — the
    framework's second-language binding surface (≙ the reference JNI
    new_instance/trace_rays/delete_instance, java_binding.cpp:179-304),
    exercised here through ctypes exactly as a C/Java/Rust host would."""

    def __init__(self, ior: np.ndarray, translucency: Optional[np.ndarray] = None,
                 options: Optional[dict] = None):
        """``options``: optional {key: value} with keys from OPT_* (or the
        string aliases "loglevel" / "minimum_device" / "max_cpu") — threaded
        through the C ABI's keyed options block (vrt_options_set)."""
        lib = load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        ior = np.ascontiguousarray(ior, np.float32)
        assert ior.ndim == 3
        trp = None
        if translucency is not None:
            self._tr = np.ascontiguousarray(translucency, np.uint32)
            trp = self._tr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
        self._ior = ior  # keep alive during the C call
        opt_h = None
        if options:
            names = {"loglevel": OPT_LOGLEVEL,
                     "minimum_device": OPT_MINIMUM_DEVICE,
                     "max_cpu": OPT_MAX_CPU}
            opt_h = lib.vrt_options_new()
            for k, v in options.items():
                key = names.get(k, -1) if isinstance(k, str) else int(k)
                if lib.vrt_options_set(opt_h, key, int(v)) != 0:
                    lib.vrt_options_free(opt_h)
                    raise ValueError(f"unknown option key {k!r}")
        self._h = lib.vrt_scene_new_opt(
            _f32p(ior), *(int(s) for s in ior.shape), trp, opt_h
        )
        if opt_h:
            lib.vrt_options_free(opt_h)
        if not self._h:
            raise ValueError("vrt_scene_new rejected the scene "
                             "(bounds < 3 or non-positive ior)")

    def trace_rays(self, pos, dirs, budget: int, invscale=2.0,
                   normalize_length: bool = True, nthreads: int = 0):
        """In-place-style trace; returns (end_pos, end_dir, iters)."""
        pos = np.ascontiguousarray(pos, np.float32).copy()
        dirs = np.ascontiguousarray(dirs, np.float32).copy()
        n = pos.shape[0]
        iters = np.zeros(n, np.uint32)
        inv = np.ascontiguousarray(
            np.broadcast_to(np.asarray(invscale, np.float32), (3,))
        )
        self._lib.vrt_scene_trace(
            self._h, _f32p(pos), _f32p(dirs),
            iters.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), n,
            np.uint32(budget), _f32p(inv), int(normalize_length), nthreads,
        )
        return pos, dirs, iters

    def bounds(self):
        out = (ctypes.c_int * 3)()
        self._lib.vrt_scene_bounds(self._h, out)
        return tuple(out)

    def close(self):
        if getattr(self, "_h", None):
            self._lib.vrt_scene_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def solve_harmonic(
    values: np.ndarray,
    derivative_divisor: Optional[np.ndarray] = None,
    is_fixed: Optional[np.ndarray] = None,
    max_iterations: int = 1000,
    max_error: float = 1e-8,
    nthreads: int = 0,
) -> Tuple[np.ndarray, int]:
    """Native damped-Jacobi harmonic solve; returns (field, iterations)."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    v = np.ascontiguousarray(values, np.float64).copy()
    d = (np.zeros_like(v) if derivative_divisor is None
         else np.ascontiguousarray(derivative_divisor, np.float64))
    f = (np.zeros(v.shape, np.uint8) if is_fixed is None
         else np.ascontiguousarray(is_fixed, np.uint8))
    dims = np.asarray(v.shape, np.int64)
    it = lib.vrt_solve_harmonic(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        d.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        v.ndim, v.size, max_iterations, max_error, nthreads,
    )
    return v, it
