"""Profiling subsystem (SURVEY.md §5 A1): cost reports, trace capture,
wall-clock benchmark helper."""

import glob
import os
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp

from volumeraytracer_tpu.ops.fields import build_packed_field
from volumeraytracer_tpu.ops import march as march_ops
from volumeraytracer_tpu.utils import profiling


def _march(packed, pos, dirs):
    return march_ops.march_float(
        packed, None, pos, dirs, 32,
        bend_scale=2.0 / 65536.0, step_scale=2.0 * (0x42000000 / 65536.0**2),
        chunk_steps=16,
    ).end_position


def _inputs():
    ior = jnp.asarray(np.full((12, 12, 12), 1.2, np.float32))
    packed = build_packed_field(ior)
    pos = jnp.asarray(np.full((8, 3), 2.0, np.float32))
    dirs = jnp.asarray(np.tile([[16.0, 0, 0]], (8, 1)).astype(np.float32))
    return packed, pos, dirs


def test_cost_report_has_flops_and_memory():
    packed, pos, dirs = _inputs()
    rep = profiling.cost_report(_march, packed, pos, dirs)
    assert "cost" in rep
    assert rep["cost"].get("flops", 0) > 0
    assert rep.get("memory", {}).get("output_size_in_bytes", 0) > 0


def test_trace_writes_profile(tmp_path):
    packed, pos, dirs = _inputs()
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("march"):
            np.asarray(_march(packed, pos, dirs))
    files = glob.glob(os.path.join(str(tmp_path), "**", "*"), recursive=True)
    assert any(os.path.isfile(f) for f in files), files


def test_benchmark_reports_rates():
    packed, pos, dirs = _inputs()
    rep = profiling.benchmark(_march, packed, pos, dirs, reps=2, rays=8, steps=8 * 32)
    assert rep["seconds_per_call"] > 0
    assert rep["rays_per_s"] > 0 and rep["steps_per_s"] == rep["rays_per_s"] * 32


def test_persistent_cache_follows_env(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself and the
    helper changes no setting."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert profiling.enable_persistent_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_persistent_cache_defaults_to_checkout(monkeypatch):
    """Without it, the cache goes to the fixed, gitignored
    <checkout>/.jax_cache."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = Path(__file__).resolve().parents[1]
    before = jax.config.jax_compilation_cache_dir
    try:
        path = profiling.enable_persistent_cache()
        assert path == str(root / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert ".jax_cache/" in (root / ".gitignore").read_text().split()
