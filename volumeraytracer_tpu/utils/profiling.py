"""Profiling/tracing subsystem (SURVEY.md §5 aux table, item A1).

The reference's only profiling tools are a wall-clock harness
(/root/reference/src/performance_test.h:59-76), nvcc ``--ptxas-options=-v``
register dumps (Makefile:61,64) and per-ray path recording.  The equivalents
here:

  * :func:`trace` — ``jax.profiler`` device traces viewable in
    TensorBoard/XProf (the hardware-counter analogue of ptxas -v);
  * :func:`annotate` — named trace regions, so marches/preprocessing show up
    as labeled spans;
  * :func:`cost_report` — XLA's per-executable cost analysis (FLOPs, bytes
    accessed, peak memory) for any jittable, the compile-time "occupancy
    dump" of a compiled program;
  * :func:`benchmark` — the reference's rays-per-wall-clock protocol as a
    reusable helper (compile excluded, result synchronised).

Path recording (the reference's de-facto introspection tool, .cu:333,348)
lives on the march itself: ``trace_rays(..., trace_path=True)``.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import jax
import numpy as np


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False):
    """Record a ``jax.profiler`` device trace to ``log_dir`` for the scope.

    View with TensorBoard (profile plugin) or XProf.  Works on GPU and CPU.
    """
    jax.profiler.start_trace(log_dir, create_perfetto_link=create_perfetto_link)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named span context manager; regions appear in profiler traces."""
    return jax.profiler.TraceAnnotation(name)


def cost_report(fn: Callable, *args, static_argnames=(), **kwargs) -> Dict[str, Any]:
    """Compile ``fn`` (jitted) for the given arguments and return XLA's cost
    analysis: estimated FLOPs, transcendentals, bytes accessed, plus the
    compiler's memory footprint analysis when available.

    This is ahead-of-time (no execution) — the analogue of the
    reference's ptxas register/occupancy dumps.
    """
    jitted = jax.jit(fn, static_argnames=static_argnames)
    lowered = jitted.lower(*args, **kwargs)
    compiled = lowered.compile()
    out: Dict[str, Any] = {}
    try:
        ca = compiled.cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0] if ca else {}
        out["cost"] = {
            k: float(v)
            for k, v in dict(ca or {}).items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)
        }
    except Exception:  # pragma: no cover - backend-dependent
        out["cost"] = {}
    try:
        ma = compiled.memory_analysis()
        for key in (
            "temp_size_in_bytes",
            "argument_size_in_bytes",
            "output_size_in_bytes",
            "generated_code_size_in_bytes",
        ):
            v = getattr(ma, key, None)
            if v is not None:
                out.setdefault("memory", {})[key] = int(v)
    except Exception:  # pragma: no cover - backend-dependent
        pass
    return out


def benchmark(
    fn: Callable,
    *args,
    reps: int = 3,
    warmup: int = 1,
    rays: Optional[int] = None,
    steps: Optional[int] = None,
) -> Dict[str, float]:
    """Wall-clock protocol of the reference perf harness
    (performance_test.h:59-76): run ``fn(*args)`` ``reps`` times after
    ``warmup`` compile/warm calls, synchronising on the result, and report
    seconds per call (+ rays/s and steps/s when the workload size is given).
    """

    def sync(out):
        out = jax.block_until_ready(out)
        np.asarray(jax.tree.leaves(out)[0])
        return out

    for _ in range(warmup):
        sync(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        sync(fn(*args))
    dt = (time.perf_counter() - t0) / reps
    rep: Dict[str, float] = {"seconds_per_call": dt}
    if rays:
        rep["rays_per_s"] = rays / dt
    if steps:
        rep["steps_per_s"] = steps / dt
    return rep


#: the checkout's compile-cache directory (listed in .gitignore)
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_persistent_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is changed here.  Otherwise the cache goes to the fixed
    directory ``<checkout>/.jax_cache`` (a fixed path, because the path is
    part of each entry's key).  Call before the first compile."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)
