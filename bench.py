"""Benchmark: one SGD step of the GRIN field fit at 256³, one JSON line.

Protocol (the reference's perf harness shape — a fixed ray population traced
to budget exhaustion, rays per time, /root/reference/src/performance_test.h:
59-76 — applied to a full training step): 131,072 rays from a camera bundle,
a 512-step budget, and per step the field preprocessing, the |v|=n init, the
forward march, its adjoint, the gradient scatter into the field and the SGD
update, all in one jitted call (``kernel="auto"``: the XLA march).

    python bench.py                # time the step on the GPU
    python bench.py --trace DIR    # also trace a few steps and summarise them

It runs only on a GPU and fails on any other platform.
"""

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

import jax
import jax.numpy as jnp

GRID = 256
N_RAYS = 131072
BUDGET = 512
CHUNK_STEPS = 64
INVSCALE = 2.0
LR = 1e-6


def build_field(n=GRID):
    """Smooth analytic GRIN field (lens bump) — config-3 style."""
    ax = np.linspace(-1.0, 1.0, n, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    r2 = x * x + y * y + z * z
    return jnp.asarray(1.0 + 0.5 * np.exp(-4.0 * r2, dtype=np.float32))


def build_rays(n_rays=N_RAYS, grid=GRID):
    """Dense coherent camera bundle entering at x=2: an (n/side × side)
    lattice over the y-z face, side = the power of two nearest √n."""
    side = 1 << (int(np.log2(n_rays)) // 2)
    rows = n_rays // side
    if rows * side != n_rays:
        raise ValueError(f"n_rays={n_rays} is not a multiple of {side}")
    ys = np.linspace(8.0, grid - 8.0, rows, dtype=np.float32)
    zs = np.linspace(8.0, grid - 8.0, side, dtype=np.float32)
    yy, zz = np.meshgrid(ys, zs, indexing="ij")
    pos = np.stack(
        [np.full(n_rays, 2.0, np.float32), yy.ravel(), zz.ravel()], axis=-1
    )
    dirs = np.tile(np.array([[16.0, 0.0, 0.0]], np.float32), (n_rays, 1))
    return jnp.asarray(pos), jnp.asarray(dirs)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


def require_gpu() -> dict:
    """Fail unless JAX's default device is a GPU; return what it reports."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"no GPU: JAX's default device is {dev.platform} ({dev})")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def make_sgd_step(budget=BUDGET, chunk_steps=CHUNK_STEPS):
    """loss = Σ (end_y) over rays; one jitted value_and_grad + SGD update."""
    from volumeraytracer_tpu.parallel.shard import endpoint_render

    def loss_fn(f, p, d):
        end_pos, _ = endpoint_render(f, p, d, budget, INVSCALE, chunk_steps,
                                     kernel="auto")
        return jnp.sum(end_pos[:, 1])

    @jax.jit
    def step(f, p, d):
        loss, g = jax.value_and_grad(loss_fn)(f, p, d)
        return f - LR * g, loss

    return step


def make_forward(budget=BUDGET, chunk_steps=CHUNK_STEPS):
    """The forward-only march (while_loop driver) over a packed field."""
    from volumeraytracer_tpu.ops.march import march_float
    from volumeraytracer_tpu.types import FIX_ONE, STEP_CONST

    @jax.jit
    def forward(packed, p, d):
        return march_float(packed, None, p, d, budget,
                           bend_scale=INVSCALE / FIX_ONE,
                           step_scale=INVSCALE * STEP_CONST / FIX_ONE / FIX_ONE,
                           chunk_steps=chunk_steps).end_position

    return forward


def time_steps(step, f, p, d, reps=3):
    """Mean seconds per step after one warm-up (compile) call."""
    jax.block_until_ready(step(f, p, d))
    t0 = time.perf_counter()
    for _ in range(reps):
        f, loss = step(f, p, d)
    jax.block_until_ready((f, loss))
    return (time.perf_counter() - t0) / reps


def _norm(name):
    return re.sub(r"[.\-]", "_", name)


def hlo_kernels(hlo_text) -> dict:
    """Kernel name → what its HLO fusion holds: the element count of its
    (first) output and whether it gathers or scatters."""
    comps, cur = {}, None
    for line in hlo_text.splitlines():
        head = re.match(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$", line)
        if head:
            cur = comps.setdefault(head.group(1), [])
        elif cur is not None:
            cur.append(line)
    info = {}
    for body in comps.values():
        for line in body:
            m = re.match(r"\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*\(?\w+\[([\d,]*)\]"
                         r".*?calls=%?([\w.\-]+)", line)
            if m:
                text = "\n".join(comps.get(m.group(3), []))
                info[_norm(m.group(1))] = {
                    "elements": int(np.prod([int(d) for d in m.group(2).split(",") if d])),
                    "gather": " gather(" in text,
                    "scatter": " scatter(" in text,
                }
    return info


def summarize_trace(log_dir, n_calls, budget=BUDGET, hlo_text=None,
                    field_elements=None) -> dict:
    """Reduce a ``jax.profiler`` trace of ``n_calls`` calls to the device
    metrics PERF.md reads: kernels launched per march step, device busy and
    idle share of the window, the idle gaps between kernels, and (given the
    compiled HLO) the kernel time in gather fusions, scatter fusions and
    dense field-sized fusions (output ≥ ``field_elements``)."""
    from jax.profiler import ProfileData

    (path,) = sorted(Path(log_dir).rglob("*.xplane.pb"))[-1:]
    data = ProfileData.from_file(str(path))
    planes = [pl for pl in data.planes if pl.name.startswith("/device:GPU")]
    if not planes:
        raise RuntimeError(f"no GPU plane in {path}")
    lines = {}
    for line in planes[0].lines:
        lines[line.name] = [(e.start_ns, e.end_ns, e.name) for e in line.events]
    kernels = sorted(
        ev for name, evs in lines.items() if "Stream" in name for ev in evs
    )
    if not kernels:
        raise RuntimeError(f"no kernel events; lines: {sorted(lines)}")
    busy, gaps, cur_s, cur_e = 0.0, [], kernels[0][0], kernels[0][1]
    for s, e, _ in kernels[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append(s - cur_e)
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = kernels[-1][1] - kernels[0][0]
    by_name = {}
    for s, e, name in kernels:
        t, c = by_name.get(name, (0.0, 0))
        by_name[name] = (t + (e - s), c + 1)
    total = sum(t for t, _ in by_name.values())
    info = hlo_kernels(hlo_text) if hlo_text else {}

    def share(pred):
        return sum(t for n, (t, _) in by_name.items()
                   if pred(info.get(_norm(n), {}))) / total

    gaps = np.asarray(gaps or [0.0])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    out = {
        "calls": n_calls,
        "ms_per_call": window / 1e6 / n_calls,
        "kernels_per_march_step": len(kernels) / (n_calls * budget),
        "busy_share": busy / window,
        "idle_share": 1.0 - busy / window,
        "gaps": {"count": int(gaps.size), "median_us": float(np.median(gaps)) / 1e3,
                 "p90_us": float(np.percentile(gaps, 90)) / 1e3,
                 "total_ms": float(gaps.sum()) / 1e6},
        "top_kernels": [dict(name=n[:80], ms=t / 1e6, count=c,
                             **info.get(_norm(n), {})) for n, (t, c) in top],
    }
    if info:
        big = field_elements or 0
        out["kernel_time_share"] = {
            "gather": share(lambda k: k.get("gather", False)),
            "scatter": share(lambda k: k.get("scatter", False)),
            "dense_field_sized": share(
                lambda k: not k.get("gather") and not k.get("scatter")
                and k.get("elements", 0) >= big > 0),
        }
    return out


def trace_calls(log_dir, fn, args, n=2, **kw) -> dict:
    """Trace ``n`` calls of the jitted ``fn`` (already warm) and summarise."""
    jax.profiler.start_trace(str(log_dir))
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    jax.profiler.stop_trace()
    hlo = fn.lower(*args).compile().as_text()
    return summarize_trace(log_dir, n, hlo_text=hlo, **kw)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", metavar="DIR",
                    help="trace 2 steps into DIR and write DIR/summary.json")
    args = ap.parse_args(argv)

    from volumeraytracer_tpu.utils.profiling import enable_persistent_cache

    device = require_gpu()
    device["card"] = card_line()
    enable_persistent_cache()

    ior = build_field()
    pos, dirs = build_rays()
    n_rays = int(pos.shape[0])
    step = make_sgd_step()
    dt = time_steps(step, ior, pos, dirs)

    out = {
        "metric": f"Mrays/s fwd+bwd SGD step, {GRID}^3 grid, {BUDGET}-step budget",
        "value": n_rays / dt / 1e6,
        "unit": "Mrays/s",
        "device": device,
        "detail": {"seconds_per_step": dt, "steps_per_s": n_rays * BUDGET / dt,
                   "n_rays": n_rays, "budget": BUDGET, "kernel": "xla"},
    }
    if args.trace:
        from volumeraytracer_tpu.ops.fields import build_packed_field

        packed = build_packed_field(ior)
        field = int(np.prod(packed.shape))
        fwd = make_forward()
        jax.block_until_ready(fwd(packed, pos, dirs))
        summary = {
            "device": device,
            "forward": trace_calls(Path(args.trace) / "forward", fwd,
                                   (packed, pos, dirs), field_elements=field),
            "train_step": trace_calls(Path(args.trace) / "train", step,
                                      (ior, pos, dirs), field_elements=field),
        }
        (Path(args.trace) / "summary.json").write_text(json.dumps(summary, indent=1))
        out["trace"] = {k: {m: v[m] for m in ("ms_per_call", "kernels_per_march_step",
                                              "idle_share", "kernel_time_share")}
                        for k, v in summary.items() if k != "device"}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
