"""Kernel dispatch contract: ``ops.march.resolve_kernel`` is the one place a
float-march ``kernel`` choice is resolved.  ``"auto"`` and ``"xla"`` run the
XLA march on every backend, ``"native"`` runs the scalar C++ oracle, and any
other value raises — nothing falls back to another kernel."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from volumeraytracer_tpu.models.scene import RaytraceScene
from volumeraytracer_tpu.ops.march import KERNELS, resolve_kernel
from volumeraytracer_tpu.parallel.shard import endpoint_render
from volumeraytracer_tpu.types import Options


def _scene3d(n=16):
    ax = np.linspace(-1, 1, n, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    return RaytraceScene(1.0 + 0.2 * np.exp(-2 * (x * x + y * y + z * z)))


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_resolve_kernel(monkeypatch, backend, kernel):
    """The choice does not depend on the backend JAX runs on."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert resolve_kernel(kernel) == ("native" if kernel == "native" else "xla")


@pytest.mark.parametrize("kernel", ["pallas", "cuda"])
@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_invalid_kernel_raises(monkeypatch, backend, kernel):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    with pytest.raises(ValueError, match="valid choices: auto, xla, native"):
        resolve_kernel(kernel)


def test_unknown_kernel_raises():
    s = _scene3d()
    with pytest.raises(ValueError, match="unknown kernel"):
        s.trace_rays(
            np.zeros((1, 3), np.float32) + 4.0,
            np.ones((1, 3), np.float32),
            iterations=4, mode="float", kernel="cuda",
        )


@pytest.mark.parametrize("mode", ["fixed", "float"])
def test_pallas_kernel_raises_in_trace_rays(mode):
    s = _scene3d()
    pos = np.full((1, 3), 4.0, np.float32)
    if mode == "fixed":
        pos = (pos * 0x10000).astype(np.uint32)
    with pytest.raises(ValueError, match="unknown kernel 'pallas'"):
        s.trace_rays(pos, np.ones((1, 3), np.float32), iterations=4,
                     mode=mode, kernel="pallas")


@pytest.mark.parametrize("kernel", ["pallas", "native"])
def test_endpoint_render_refuses_kernel(kernel):
    """The differentiable render runs only the XLA march: "pallas" is no
    kernel at all, and the forward-only oracle has no gradient."""
    ior = jnp.ones((12, 8, 8), jnp.float32)
    pos = jnp.full((2, 3), 3.0, jnp.float32)
    with pytest.raises(ValueError):
        endpoint_render(ior, pos, pos, 8, 2.0, 4, kernel=kernel)


def test_native_kernel_requires_float_mode():
    s = _scene3d()
    with pytest.raises(ValueError, match="requires mode='float'"):
        s.trace_rays(np.full((1, 3), 0x40000, np.uint32),
                     np.ones((1, 3), np.float32), iterations=4,
                     mode="fixed", kernel="native")


def test_native_kernel_matches_xla():
    """kernel='native' (the C++ host oracle with Options.max_cpu threads)
    agrees with the XLA float march on endpoints."""
    from volumeraytracer_tpu import native as native_mod

    if not native_mod.available():
        pytest.skip("native library unavailable")
    s = _scene3d()
    s.options = Options(max_cpu=2)
    pos = np.array([[2.0, 8.0, 8.0], [2.0, 6.0, 9.0]], np.float32)
    dirs = np.array([[16.0, 0.0, 0.0], [16.0, 1.0, -1.0]], np.float32)
    kw = dict(iterations=64, mode="float", invscale=[2.0] * 3)
    a = s.trace_rays(pos, dirs, kernel="native", **kw)
    b = s.trace_rays(pos, dirs, kernel="xla", **kw)
    np.testing.assert_allclose(
        np.asarray(a.end_position), np.asarray(b.end_position), atol=1e-3
    )
    np.testing.assert_array_equal(
        np.asarray(a.end_iteration), np.asarray(b.end_iteration)
    )


def test_native_kernel_with_translucency_matches_xla():
    """The oracle path also carries absorption and the brightness floor."""
    n = 16
    tr = np.full((n, n, n), 0xFFFFFFFF - int(0xFFFFFFFF / 300), np.uint32)
    s = RaytraceScene(np.full((n, n, n), 1.3, np.float32), tr)
    pos = np.array([[2.0, 8.0, 8.0], [2.0, 6.0, 9.0]], np.float32)
    dirs = np.array([[16.0, 0.0, 0.0], [16.0, 1.0, -1.0]], np.float32)
    kw = dict(iterations=400, mode="float", invscale=[2.0] * 3,
              minimum_brightness=int(0.6 * 0xFFFFFFFF))
    a = s.trace_rays(pos, dirs, kernel="native", **kw)
    b = s.trace_rays(pos, dirs, kernel="xla", **kw)
    assert (np.asarray(b.end_iteration) < 400).all()
    np.testing.assert_array_equal(np.asarray(a.end_iteration), np.asarray(b.end_iteration))
    np.testing.assert_array_equal(np.asarray(a.remaining_light), np.asarray(b.remaining_light))
    np.testing.assert_allclose(np.asarray(a.end_position), np.asarray(b.end_position), atol=1e-3)
