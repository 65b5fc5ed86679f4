"""Smoke test of the main path on one GPU, at the size the benchmark uses.

    python chip_smoke.py           # phases 1-6 on one GPU
    python chip_smoke.py --four    # only the four-GPU phase (needs 4 GPUs)

Phases (each comparison names its reference, tolerance and reason):
  1. device: JAX's devices and the card's name and power limit;
  2. the reference's regression scene (1000×10×10 index ramp, two rays,
     10⁶-step budget) in fixed and float mode: the 46718 ± 100 step anchor,
     the momentum invariant, and the float path against the C++ oracle;
  3. forward march at 256³ with 131,072 rays and a 512-step budget, a
     1,024-ray subset against the C++ oracle and the CPU backend;
  4. three SGD steps of ``make_train_step`` at that size on a one-GPU mesh,
     and the field gradient of a 4,096-ray subset against the CPU backend;
  5. a 512×512 camera render of a 128³ density volume, a 64×64 crop
     against the CPU backend;
  6. forward and fwd+bwd milliseconds per call at 256³.
With ``--four``: ``make_train_step`` over four GPUs (``accum_steps=2``) and
the brick-sharded steps (4 bricks; 2 rays × 2 bricks) against the one-GPU
step.  The last line is a JSON object ``{"ok": true, "device": {...}}``; any
failed check exits non-zero before it is printed.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

import jax
import jax.numpy as jnp

import bench
from volumeraytracer_tpu import native
from volumeraytracer_tpu.models.camera import PinholeCamera, render_rays_image
from volumeraytracer_tpu.models.scene import RaytraceScene
from volumeraytracer_tpu.ops.fields import build_packed_field
from volumeraytracer_tpu.ops.interp import interpolate_host
from volumeraytracer_tpu.parallel import bricks
from volumeraytracer_tpu.parallel.shard import (
    endpoint_render,
    make_mesh,
    make_train_step,
    replicate,
    shard_batch,
)
from volumeraytracer_tpu.types import FIX_ONE
from volumeraytracer_tpu.utils.profiling import enable_persistent_cache

INV = bench.INVSCALE


def log(msg):
    print(msg, flush=True)


def check_close(name, got, want, *, atol, rtol=0.0, reason):
    """Assert |got − want| ≤ atol + rtol·|want| elementwise; print the margin."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {want.shape}")
    err = np.abs(got - want)
    bound = atol + rtol * np.abs(want)
    log(f"  {name}: max|Δ| {err.max():.3e} (tolerance atol {atol:.1e} "
        f"rtol {rtol:.1e}: {reason})")
    if not (err <= bound).all():
        i = np.unravel_index(np.argmax(err - bound), err.shape)
        raise AssertionError(f"{name}: |Δ| {err[i]:.3e} > {bound[i]:.3e} at {i}")


def check_equal(name, got, want, reason):
    got, want = np.asarray(got), np.asarray(want)
    n_bad = int((got != want).sum())
    log(f"  {name}: {n_bad} of {got.size} differ (tolerance: exact; {reason})")
    if n_bad:
        raise AssertionError(f"{name}: {n_bad} entries differ")


def on_cpu(fn, *args):
    """Run ``fn`` with every array placed on the CPU backend."""
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        return jax.tree.map(np.asarray, fn(*jax.device_put(args, cpu)))


def subset(n, k):
    """``k`` ray indices spread evenly over ``n``."""
    return np.linspace(0, n - 1, k).astype(np.int64)


# ---------------------------------------------------------------------------
# phase 2: the reference's regression scene
# ---------------------------------------------------------------------------

RAMP_BOUNDS = (1000, 10, 10)


def ramp_instance():
    """The reference scaling test's scene and rays
    (cuda_volume_raytracer_test.h:11-73): n = 1 over the first 10 layers,
    2 over the last 10, a linear ramp between; two counter-propagating rays
    at speed 0x10."""
    ior = np.empty(RAMP_BOUNDS, np.float32)
    ior[:10], ior[-10:] = 1.0, 2.0
    i = np.arange(10, RAMP_BOUNDS[0] - 10, dtype=np.float32)
    ior[10:-10] = (1.0 + i / np.float32(RAMP_BOUNDS[0] - 21))[:, None, None]
    pos = np.array([[0x10000, 0x40000, 0x40000],
                    [0x10000 * RAMP_BOUNDS[0] - 0x30000, 0x40000, 0x40000]],
                   np.uint32)
    dirs = np.array([[16.0, 0, 0], [-16.0, 0, 0]], np.float32)
    return ior, pos, dirs


def phase_regression():
    ior, pos_fix, dirs = ramp_instance()
    scene = RaytraceScene(ior)
    kw = dict(invscale=[INV] * 3, iterations=1_000_000)
    results = {}
    for mode, pos in (("fixed", pos_fix), ("float", pos_fix / FIX_ONE)):
        res = jax.tree.map(np.asarray, scene.trace_rays(pos, dirs, mode=mode, **kw))
        end = res.end_position
        end_fix = end if mode == "fixed" else np.round(end * FIX_ONE)
        n_end = interpolate_host(ior.astype(np.float64), RAMP_BOUNDS,
                                 end_fix.astype(np.uint32))
        n_start = interpolate_host(ior.astype(np.float64), RAMP_BOUNDS, pos_fix)
        speed = np.linalg.norm(res.end_direction, axis=-1)
        # same tolerances as tests/test_scaling.py: f32 direction after ~46k
        # bend additions; the float path adds the interp error of a float
        # position on top
        check_close(f"{mode}: |v_end|/|v_start| vs n(end)/n(start)",
                    speed / np.linalg.norm(dirs, axis=-1) / n_start, n_end / n_start,
                    atol=3e-5 if mode == "fixed" else 1e-4,
                    reason="reference 1e-5 plus f32 drift over 46k steps")
        check_close(f"{mode}: end_iteration vs the 46718 anchor",
                    res.end_iteration, np.full(2, 46718), atol=100,
                    reason="cuda_volume_raytracer_test.h:51-52")
        results[mode] = res
    build_native()
    ref = jax.tree.map(np.asarray, scene.trace_rays(
        pos_fix / FIX_ONE, dirs, mode="float", kernel="native", **kw))
    got = results["float"]
    check_close("float vs C++ oracle: end position", got.end_position,
                ref.end_position, atol=1e-2,
                reason="46k f32 steps; contraction and summation order differ")
    check_close("float vs C++ oracle: end_iteration", got.end_iteration,
                ref.end_iteration, atol=1,
                reason="the exit step may move by one when the end position "
                       "differs by rounding at the volume face")


def build_native():
    """Build the C++ oracle from the committed sources (fails loudly)."""
    if native.load() is not None:
        return
    out = subprocess.run(["make", "-C", str(Path(native.__file__).parent.parent / "native")],
                         capture_output=True, text=True)
    raise RuntimeError(f"the C++ oracle did not build:\n{out.stdout}\n{out.stderr}")


# ---------------------------------------------------------------------------
# phases 3-5 at the benchmark's size
# ---------------------------------------------------------------------------


def phase_forward(grid=bench.GRID, n_rays=bench.N_RAYS, budget=bench.BUDGET,
                  n_sub=1024):
    ior = bench.build_field(grid)
    pos, dirs = bench.build_rays(n_rays, grid)
    scene = RaytraceScene(ior)
    kw = dict(invscale=[INV] * 3, iterations=budget, mode="float")
    res = jax.tree.map(np.asarray, scene.trace_rays(pos, dirs, **kw))
    if res.end_position.shape != (n_rays, 3) or not np.isfinite(res.end_position).all():
        raise AssertionError(f"bad forward output {res.end_position.shape}")
    idx = subset(n_rays, n_sub)
    p, d = np.asarray(pos)[idx], np.asarray(dirs)[idx]
    build_native()
    refs = {
        "C++ oracle": jax.tree.map(np.asarray, scene.trace_rays(p, d, kernel="native", **kw)),
        "CPU backend": on_cpu(lambda f, p, d: RaytraceScene(f).trace_rays(p, d, **kw),
                              ior, p, d),
    }
    for name, ref in refs.items():
        check_close(f"forward vs {name}: end position", res.end_position[idx],
                    ref.end_position, atol=1e-3,
                    reason=f"{budget} f32 steps of ~0.03 voxel; rounding of "
                           "contracted multiply-adds accumulates")
        check_close(f"forward vs {name}: end direction", res.end_direction[idx],
                    ref.end_direction, atol=1e-3, rtol=1e-5,
                    reason="same accumulation, |v| ≈ 16-24")
        check_equal(f"forward vs {name}: end_iteration", res.end_iteration[idx],
                    ref.end_iteration, "every step is counted alike")
    return lambda: scene.trace_rays(pos, dirs, **kw)


def loss_and_grad(budget, chunk_steps):
    def loss(f, p, d, t):
        end, _ = endpoint_render(f, p, d, budget, INV, chunk_steps)
        return jnp.sum((end - t) ** 2) / p.shape[0]

    return jax.jit(jax.value_and_grad(loss))


def train_inputs(grid, n_rays, budget, chunk_steps):
    ior = bench.build_field(grid)
    pos, dirs = bench.build_rays(n_rays, grid)
    # target endpoints of a 1% denser field: a loss the step can reduce
    target, _ = jax.jit(endpoint_render, static_argnums=(3, 4, 5))(
        ior * 1.01, pos, dirs, budget, INV, chunk_steps)
    return ior, pos, dirs, target


def phase_train(grid=bench.GRID, n_rays=bench.N_RAYS, budget=bench.BUDGET,
                chunk_steps=bench.CHUNK_STEPS, n_sub=4096, steps=3):
    ior, pos, dirs, target = train_inputs(grid, n_rays, budget, chunk_steps)
    vg = loss_and_grad(budget, chunk_steps)
    loss0, g0 = vg(ior, pos, dirs, target)
    # a step that moves the index by at most 2e-3: small against the 1%
    # perturbation the target comes from, so the loss has to fall
    lr = 2e-3 / float(jnp.abs(g0).max())
    step = make_train_step(make_mesh(jax.devices()[:1]), budget=budget,
                           invscale=INV, chunk_steps=chunk_steps, lr=lr)
    f, losses = ior, []
    for _ in range(steps):
        f, loss = step(f, pos, dirs, target)
        losses.append(float(loss))
    log(f"  SGD losses (lr {lr:.4g}): {losses}")
    if not np.isfinite(losses).all() or np.any(np.diff(losses) > 0):
        raise AssertionError(f"loss not finite and non-increasing: {losses}")
    check_close("train step loss vs value_and_grad", losses[0], float(loss0),
                atol=0.0, rtol=1e-5, reason="same program, mesh of one")

    idx = subset(n_rays, n_sub)
    args = (ior,) + tuple(jnp.asarray(np.asarray(a)[idx]) for a in (pos, dirs, target))
    val, g = jax.tree.map(np.asarray, vg(*args))
    val_c, g_c = on_cpu(vg, *args)
    check_close("train loss vs CPU backend", val, val_c, atol=0.0, rtol=1e-4,
                reason="f32 sum over rays in another order")
    scale = float(np.abs(g_c).max())
    check_close("field gradient vs CPU backend", g, g_c, atol=1e-3 * scale,
                reason="atomic scatter-add sums in a run-dependent order, and "
                       "trajectories differ by rounding; 1e-3 of max|g|")
    return lambda: step(ior, pos, dirs, target)


def phase_render(grid=128, width=512, crop=64, budget=1024):
    """BASELINE config 2: a 128³ density volume seen by a 512×512 pinhole
    camera, emission-absorption accumulated to the image plane."""
    ax = np.linspace(-1.0, 1.0, grid - 2, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    sigma = jnp.asarray(0.05 * np.exp(-4.0 * (x * x + y * y + z * z)))
    ior = jnp.ones((grid,) * 3, jnp.float32)
    packed = build_packed_field(ior)
    cam = PinholeCamera(origin=(1.5, grid / 2, grid / 2), forward=(1, 0, 0),
                        up=(0, 0, 1), width=width, height=width, fov=0.4,
                        speed=4.0)
    pos, dirs = cam.rays()

    def render(packed, ior, sigma, p, d):
        return render_rays_image(packed, ior, p, d, budget=budget,
                                 sigma=sigma, emission=sigma)["image"]

    img = np.asarray(jax.jit(render)(packed, ior, sigma, pos, dirs))
    img = img.reshape(width, width)
    if not np.isfinite(img).all() or img.max() <= 0:
        raise AssertionError("render image is not finite and positive")
    r0 = (width - crop) // 2
    rows = np.arange(r0, r0 + crop)
    idx = (rows[:, None] * width + rows[None, :]).ravel()
    ref = on_cpu(jax.jit(render), packed, ior, sigma,
                 np.asarray(pos)[idx], np.asarray(dirs)[idx]).reshape(crop, crop)
    check_close("render crop vs CPU backend", img[r0:r0 + crop, r0:r0 + crop],
                ref, atol=1e-6, rtol=1e-4,
                reason="f32 sums of ~1000 segments in another order")


def phase_timings(card, forward, train, reps=3):
    def ms(fn):
        jax.block_until_ready(fn())
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / reps * 1e3

    log(f"  forward: {ms(forward):.3f} ms per call, {bench.N_RAYS} rays x "
        f"{bench.BUDGET} steps at {bench.GRID}^3 ({card})")
    log(f"  fwd+bwd: {ms(train):.3f} ms per SGD step, same size ({card})")


# ---------------------------------------------------------------------------
# --four: the multi-GPU training paths against the one-GPU step
# ---------------------------------------------------------------------------


def phase_four(grid=bench.GRID, n_rays=bench.N_RAYS, budget=bench.BUDGET,
               chunk_steps=bench.CHUNK_STEPS, k_steps=32):
    devs = jax.devices()
    if len(devs) < 4:
        raise AssertionError(f"--four needs 4 devices, found {len(devs)}")
    devs = devs[:4]
    ior, pos, dirs, target = train_inputs(grid, n_rays, budget, chunk_steps)
    loss_ref, g_ref = jax.tree.map(
        np.asarray, loss_and_grad(budget, chunk_steps)(ior, pos, dirs, target))
    scale = float(np.abs(g_ref).max())
    lr = 1.0 / scale  # keeps lr·g at O(1) so ior − new recovers g in f32
    f0 = np.asarray(ior)
    tol = dict(atol=1e-3 * scale,
               reason="psum and atomic scatter-add reorder the f32 sums; "
                      "1e-3 of max|g|")

    def grad_of(new):
        return (f0 - np.asarray(new)) / lr

    mesh1 = make_mesh(devs[:1])
    new1, loss1 = make_train_step(mesh1, budget=budget, invscale=INV,
                                  chunk_steps=chunk_steps, lr=lr)(ior, pos, dirs, target)
    check_close("1-GPU step loss vs value_and_grad", float(loss1), loss_ref,
                atol=0.0, rtol=1e-5, reason="same program, one device")
    g1 = grad_of(new1)

    mesh4 = make_mesh(devs)
    new4, loss4 = make_train_step(
        mesh4, budget=budget, invscale=INV, chunk_steps=chunk_steps, lr=lr,
        accum_steps=2,
    )(replicate(mesh4, ior), *(shard_batch(mesh4, a) for a in (pos, dirs, target)))
    check_close("4-GPU accum_steps=2 loss vs 1-GPU", float(loss4), float(loss1),
                atol=0.0, rtol=1e-5, reason="psum of 8 partial sums")
    check_close("4-GPU accum_steps=2 gradient vs 1-GPU", grad_of(new4), g1, **tol)

    x_packed = grid - 2

    def brick_grad(new_slabs, slabs):
        g = (np.asarray(slabs) - np.asarray(new_slabs)) / lr
        return bricks.assemble_ior(g, grid), g

    bmesh = make_mesh(devs, axis="bricks")
    slabs, _ = bricks.build_ior_slabs(ior, 4)
    slabs = bricks.shard_slabs(bmesh, slabs)
    new_b, loss_b = bricks.make_brick_train_step(
        bmesh, x_packed, budget=budget, invscale=INV, k_steps=k_steps, lr=lr,
    )(slabs, pos, dirs, target)
    check_close("4-brick loss vs 1-GPU", float(loss_b), float(loss1), atol=0.0,
                rtol=1e-5, reason="brick-local sums combined by psum")
    g_b, g_slabs = brick_grad(new_b, slabs)
    check_close("4-brick gradient vs 1-GPU", g_b, g1, **tol)
    ov = bricks.IOR_OVERLAP
    for d in range(3):
        check_equal(f"brick faces {d}/{d + 1}: overlap gradients",
                    g_slabs[d, -ov:], g_slabs[d + 1, :ov],
                    "the halo exchange gives both copies one sum")

    mesh2 = bricks.make_mesh2d(2, 2, devs)
    slabs2, _ = bricks.build_ior_slabs(ior, 2)
    slabs2 = jax.device_put(
        slabs2, jax.sharding.NamedSharding(mesh2, jax.sharding.PartitionSpec("bricks")))
    rays = jax.sharding.NamedSharding(mesh2, jax.sharding.PartitionSpec("rays"))
    new2, loss2 = bricks.make_brick_train_step2d(
        mesh2, x_packed, n_rays_total=n_rays, budget=budget, invscale=INV,
        k_steps=k_steps, lr=lr,
    )(slabs2, *(jax.device_put(a, rays) for a in (pos, dirs, target)))
    check_close("2x2 rays-by-bricks loss vs 1-GPU", float(loss2), float(loss1),
                atol=0.0, rtol=1e-5, reason="psum over rays of brick sums")
    g2, _ = brick_grad(new2, slabs2)
    check_close("2x2 rays-by-bricks gradient vs 1-GPU", g2, g1, **tol)


# ---------------------------------------------------------------------------


def result_line(devices) -> str:
    """The contract's last line."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devices)}})


def run(phases):
    for name, fn in phases:
        log(f"[{name}]")
        t0 = time.perf_counter()
        fn()
        log(f"  ok in {time.perf_counter() - t0:.1f} s")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU phase")
    args = ap.parse_args(argv)

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX's default device is {devices[0]})",
              file=sys.stderr)
        return 1
    card = bench.card_line()
    log(f"[device] {devices}; kind {devices[0].device_kind}")
    log(card)
    log(f"compile cache: {enable_persistent_cache()}")

    if args.four:
        run([("four GPUs", phase_four)])
    else:
        timed = {}
        run([
            ("regression scene", phase_regression),
            ("forward at 256^3", lambda: timed.setdefault("fwd", phase_forward())),
            ("training at 256^3", lambda: timed.setdefault("train", phase_train())),
            ("render 128^3, 512x512", phase_render),
            ("timings", lambda: phase_timings(card, timed["fwd"], timed["train"])),
        ])
    log(card)
    print(result_line(devices))
    return 0


if __name__ == "__main__":
    sys.exit(main())
