"""Native C++ oracle vs the JAX paths — the cross-implementation parity
check the reference gets from its dual CUDA/-DNCUDA builds (SURVEY.md §4)."""

import numpy as np
import pytest

import jax.numpy as jnp

from volumeraytracer_tpu import native
from volumeraytracer_tpu.models.harmonic import solve_harmonic as solve_jax
from volumeraytracer_tpu.ops import march as march_ops
from volumeraytracer_tpu.ops.fields import build_packed_field
from volumeraytracer_tpu.types import FIX_ONE, STEP_CONST

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library not built (no g++?)"
)


def test_native_march_matches_jnp():
    n = 32
    ax = np.linspace(-1, 1, n, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    ior = (1.0 + 0.3 * np.exp(-3.0 * (x * x + y * y + z * z))).astype(np.float32)
    packed = np.asarray(build_packed_field(jnp.asarray(ior)))

    rng = np.random.default_rng(0)
    m = 64
    pos = np.stack(
        [np.full(m, 1.5), rng.uniform(3, 26, m), rng.uniform(3, 26, m)], axis=-1
    ).astype(np.float32)
    dirs = np.stack(
        [np.full(m, 16.0), rng.uniform(-2, 2, m), rng.uniform(-2, 2, m)], axis=-1
    ).astype(np.float32)

    inv = 2.0
    bend = inv / float(FIX_ONE)
    step = inv * (STEP_CONST / float(FIX_ONE) / float(FIX_ONE))
    budget = 256

    ref = march_ops.march_float(
        jnp.asarray(packed), None, jnp.asarray(pos), jnp.asarray(dirs), budget,
        bend_scale=bend, step_scale=step, chunk_steps=64,
    )
    epos, edir, eiter, _ = native.march_float(packed, pos, dirs, budget, bend, step)

    np.testing.assert_array_equal(eiter, np.asarray(ref.end_iteration))
    np.testing.assert_allclose(epos, np.asarray(ref.end_position), atol=2e-4)
    np.testing.assert_allclose(edir, np.asarray(ref.end_direction), rtol=1e-5, atol=1e-5)


def test_native_harmonic_matches_jax():
    vals = np.ones((12, 12), np.float64)
    fixed = np.zeros_like(vals, bool)
    vals[0], fixed[0] = 1.0, True
    vals[-1], fixed[-1] = 3.0, True
    ref = np.asarray(solve_jax(vals, is_fixed=fixed, max_iterations=5000, max_error=1e-14))
    out, it = native.solve_harmonic(vals, is_fixed=fixed, max_iterations=5000, max_error=1e-14)
    assert it > 10
    np.testing.assert_allclose(out, ref, atol=1e-4)


@pytest.mark.skipif(not native.available(), reason="native lib unavailable")
def test_native_scene_binding_matches_python_scene():
    """The scene-level C ABI (the second-language binding,
    native/vrt_native.h) must reproduce the Python RaytraceScene float
    path end-to-end: preprocessing + |v|=n init + march + shifts."""
    from volumeraytracer_tpu import RaytraceScene

    rng = np.random.default_rng(3)
    ior = (1.0 + 0.3 * rng.random((24, 12, 12))).astype(np.float32)
    pos = np.array([[2.0, 5.0, 5.0], [1.5, 7.0, 4.0]], np.float32)
    dirs = np.array([[16.0, 0.5, -0.25], [16.0, 0.0, 0.0]], np.float32)

    sc = RaytraceScene(ior)
    ref = sc.trace_rays(pos, dirs, invscale=[2.0] * 3, iterations=2000,
                        mode="float")

    ns = native.NativeScene(ior)
    assert ns.bounds() == ior.shape
    epos, edir, iters = ns.trace_rays(pos, dirs, budget=2000,
                                      invscale=[2.0] * 3)
    ns.close()

    np.testing.assert_allclose(
        epos, np.asarray(ref.end_position), rtol=1e-4, atol=2e-3)
    np.testing.assert_allclose(
        edir, np.asarray(ref.end_direction), rtol=1e-4, atol=2e-3)
    np.testing.assert_array_equal(iters, np.asarray(ref.end_iteration))


@pytest.mark.skipif(not native.available(), reason="native lib unavailable")
def test_native_scene_binding_opacity_and_errors():
    ior = np.full((8, 8, 8), 1.2, np.float32)
    tr = np.full((8, 8, 8), 0xFFFFFFFF, np.uint32)
    tr[5] = 0  # opaque plane
    ns = native.NativeScene(ior, tr)
    pos = np.array([[1.5, 4.0, 4.0]], np.float32)
    dirs = np.array([[8.0, 0.0, 0.0]], np.float32)
    epos, _, iters = ns.trace_rays(pos, dirs, budget=100000, invscale=[2.0] * 3)
    ns.close()
    assert epos[0, 0] < 5.5  # stopped at the opaque plane, not the far wall
    assert 0 < iters[0] < 100000

    with pytest.raises(ValueError):
        native.NativeScene(np.zeros((4, 4, 4), np.float32))  # ior <= 0
    with pytest.raises(ValueError):
        native.NativeScene(np.ones((2, 4, 4), np.float32))  # bounds < 3


def test_native_options_by_key():
    """Keyed options over the C ABI (≙ the reference's JNI option get/set by
    integer key, java_binding.cpp:322-381): defaults, set/get round-trip,
    unknown-key rejection, and scene construction with an options block."""
    if not native.available():
        pytest.skip("native library unavailable")
    lib = native.load()
    h = lib.vrt_options_new()
    try:
        assert lib.vrt_options_get(h, native.OPT_MINIMUM_DEVICE) == 0x80
        assert lib.vrt_options_get(h, native.OPT_MAX_CPU) == 256
        assert lib.vrt_options_set(h, native.OPT_LOGLEVEL, -2) == 0
        assert lib.vrt_options_get(h, native.OPT_LOGLEVEL) == -2
        assert lib.vrt_options_set(h, 99, 1) == -1
        assert lib.vrt_options_get(h, 99) == -(2**63)
    finally:
        lib.vrt_options_free(h)

    ior = np.ones((16, 8, 8), np.float32)
    ns = native.NativeScene(ior, options={"max_cpu": 2, "loglevel": 0})
    p, d, it = ns.trace_rays(
        np.array([[2.0, 4.0, 4.0]], np.float32),
        np.array([[16.0, 0.0, 0.0]], np.float32), 1000,
    )
    assert float(p[0, 0]) > 10.0  # marched through the constant volume
    ns.close()
    with pytest.raises(ValueError):
        native.NativeScene(ior, options={"bogus": 1})
