"""The XLA float march against the scalar C++ oracle (native/vrt_native.cpp)
— the cross-implementation parity check the reference gets from its dual
CUDA/-DNCUDA builds (SURVEY.md §4), over the scenes the march has to get
right: a GRIN lens, an index ramp, an opaque wall, an absorbing slab with a
brightness floor, a 2-D ramp, and per-ray budgets."""

import numpy as np
import pytest

import jax.numpy as jnp

from volumeraytracer_tpu import native
from volumeraytracer_tpu.ops import march as march_ops
from volumeraytracer_tpu.ops.fields import build_packed_field, cropped_translucency
from volumeraytracer_tpu.types import FIX_ONE, STEP_CONST

INV = 2.0
BEND = INV / float(FIX_ONE)
STEP = INV * (STEP_CONST / float(FIX_ONE) / float(FIX_ONE))


@pytest.fixture(scope="module", autouse=True)
def _oracle():
    if not native.available():
        pytest.fail("the C++ oracle did not build (make -C native)")


def _lens(n=40):
    ax = np.linspace(-1, 1, n, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    return 1.0 + 0.4 * np.exp(-3.0 * (x * x + y * y + z * z)).astype(np.float32)


def _ramp(shape):
    ior = np.ones(shape, np.float32)
    ramp = 1.0 + np.arange(shape[0], dtype=np.float32) / (shape[0] - 1)
    return ior * ramp.reshape((-1,) + (1,) * (len(shape) - 1))


def scene(name):
    """(ior, translucency or None, minimum_brightness)"""
    if name == "lens":
        return _lens(), None, 0
    if name == "ramp":
        return _ramp((40, 24, 24)), None, 0
    if name == "wall":  # opaque plane ~7.5 voxels from the ray starts
        tr = np.full((40,) * 3, 0xFFFFFFFF, np.uint32)
        tr[9] = 0
        return _lens(), tr, 0
    if name == "slab":  # lose ~1/400 of full brightness per step
        tr = np.full((32,) * 3, 0xFFFFFFFF - int(0xFFFFFFFF / 400), np.uint32)
        return np.full((32,) * 3, 1.2, np.float32), tr, int(0.5 * 0xFFFFFFFF)
    if name == "ramp2d":
        return _ramp((48, 32)), None, 0
    raise KeyError(name)


def rays(dim, n_rays=70, hi=20.0, seed=0):
    rng = np.random.default_rng(seed)
    cols = [np.full(n_rays, 1.5, np.float32)]
    cols += [rng.uniform(3.0, hi, n_rays).astype(np.float32) for _ in range(dim - 1)]
    dcols = [np.full(n_rays, 16.0, np.float32)]
    dcols += [rng.uniform(-2.0, 2.0, n_rays).astype(np.float32) for _ in range(dim - 1)]
    return np.stack(cols, -1), np.stack(dcols, -1)


def compare(name, budget, per_ray_budget=None):
    ior, tr, minb = scene(name)
    packed = build_packed_field(jnp.asarray(ior), None if tr is None else jnp.asarray(tr))
    trc = None if tr is None else cropped_translucency(jnp.asarray(tr))
    pos, dirs = rays(ior.ndim)
    ref = march_ops.march_float(
        packed, trc, jnp.asarray(pos), jnp.asarray(dirs), budget,
        bend_scale=BEND, step_scale=STEP, chunk_steps=64,
        minimum_brightness=minb, per_ray_budget=per_ray_budget,
    )
    epos, edir, eiter, light = native.march_float(
        np.asarray(packed), pos, dirs, budget, BEND, STEP,
        translucency=None if trc is None else np.asarray(trc),
        minimum_brightness=minb, per_ray_budget=per_ray_budget,
    )
    np.testing.assert_array_equal(eiter, np.asarray(ref.end_iteration))
    np.testing.assert_array_equal(light, np.asarray(ref.remaining_light))
    np.testing.assert_allclose(epos, np.asarray(ref.end_position), atol=2e-4)
    np.testing.assert_allclose(edir, np.asarray(ref.end_direction), rtol=1e-5, atol=1e-5)
    return eiter


@pytest.mark.parametrize("budget", [64, 300])
@pytest.mark.parametrize("name", ["lens", "ramp", "wall", "slab", "ramp2d"])
def test_xla_march_matches_oracle(name, budget):
    eiter = compare(name, budget)
    if name in ("wall", "slab") and budget == 300:
        # the wall (~220 steps away) and the dark exit (~200 steps) fire
        # mid-budget: termination parity is exercised
        assert (eiter < budget).any()


@pytest.mark.parametrize("name", ["lens", "ramp", "wall", "slab", "ramp2d"])
def test_per_ray_budgets_match_oracle(name):
    budgets = np.random.default_rng(1).integers(1, 300, 70).astype(np.uint32)
    eiter = compare(name, int(budgets.max()), per_ray_budget=budgets)
    assert (eiter <= budgets).all()
