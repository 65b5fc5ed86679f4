"""Mesh layer: multi-device ray tracing and field optimisation.

JAX replacement for the reference's heterogeneous scheduler
(``trace_rays_cu_impl``, /root/reference/src/cuda_volume_raytracer.cu:774-972,
which farms 0x8000-ray chunks over GPUs with OpenMP and replicates the field
to every device, .cu:680-685):

  * the ray batch is sharded over the ``'rays'`` mesh axis (data parallel —
    rays are embarrassingly parallel, SURVEY.md §2 parallelism table);
  * the packed field is **replicated** over the mesh (the direct analogue of
    the per-GPU field copies) — brick-sharding with halo exchange lives in
    ``parallel/bricks.py``;
  * gradients of the field coming out of per-shard backward marches are
    combined with ``psum`` (the reference has no backward pass at all; XLA
    lowers the collective to NCCL on GPUs).

Everything is built on ``jax.sharding.Mesh`` + ``shard_map`` so the same
code runs on one device, the GPUs of one host, or several hosts; the tests
run it on a virtual CPU mesh.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import march as march_ops
from ..ops.fields import build_packed_field
from ..ops.interp import interp_linear
from ..types import FIX_ONE, STEP_CONST, TraceResult


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    **kwargs,
) -> dict:
    """Multi-host entry point (≙ ``init()`` device discovery,
    cuda_volume_raytracer.cu:82-101, generalised to a multi-host slice).

    On a multi-host deployment call this once per process before any other
    jax API, exactly like ``jax.distributed.initialize`` (all arguments are
    forwarded; give the coordinator address, process count and process id —
    nothing detects them).  Single-process callers (tests, one host) may
    call it with no arguments — it is then a no-op discovery.

    Returns a summary dict: process index/count and local/global device
    counts — the information the reference prints from ``init()``.
    """
    multi = (
        coordinator_address is not None
        or (num_processes is not None and num_processes > 1)
    )
    if multi:
        # NB: nothing may touch the XLA backend before initialize —
        # jax.process_count()/jax.devices() would pin a single-process
        # backend; make re-init idempotent instead of probing
        try:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
                **kwargs,
            )
        except RuntimeError as e:
            if "already" not in str(e):
                raise
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }


def make_mesh(devices: Optional[Sequence[jax.Device]] = None, axis: str = "rays") -> Mesh:
    """1-D device mesh over all (or the given) devices — the analogue of
    ``init()`` device discovery (cuda_volume_raytracer.cu:82-101)."""
    devices = list(devices) if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def make_host_mesh(axes: Tuple[str, str] = ("rays", "bricks")) -> Mesh:
    """(hosts × local-devices) mesh for a multi-host run: the first axis
    spans processes, the second the devices within each host — so ray
    data-parallelism crosses hosts while the bricks axis' per-window psum
    stays inside one host, where the GPUs reach each other all to all over
    NVLink (SURVEY.md §5 comm table)."""
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    nproc = jax.process_count()
    local = len(devs) // nproc
    return Mesh(np.asarray(devs).reshape(nproc, local), axes)


def pad_rays(n: int, num_shards: int) -> int:
    """Rays per shard after padding to an even split (padded rays get a zero
    iteration budget so they are dead on arrival)."""
    return -(-n // num_shards)


def trace_rays_sharded(
    mesh: Mesh,
    packed: jax.Array,
    start_position: jax.Array,
    start_direction: jax.Array,
    budget: int,
    *,
    bend_scale,
    step_scale,
    chunk_steps: int = 256,
    axis: str = "rays",
) -> TraceResult:
    """Forward float march with rays sharded over ``mesh[axis]`` and the
    field replicated.  Pads the batch to a multiple of the mesh size.

    Each shard runs the same predicated while_loop as the single-chip path;
    there is **no cross-shard sync during the march** (matching the
    reference's independent GPU chunks) — shards that finish early simply
    idle until the jitted program joins.
    """
    n, dim = start_position.shape
    num = mesh.shape[axis]
    per = pad_rays(n, num)
    pad = per * num - n
    pos = jnp.pad(start_position.astype(jnp.float32), ((0, pad), (0, 0)))
    dirs = jnp.pad(
        start_direction.astype(jnp.float32),
        ((0, pad), (0, 0)),
        constant_values=1.0,  # non-zero so 1/|v|² is finite for padded rays
    )

    bend = jnp.broadcast_to(jnp.asarray(bend_scale, jnp.float32), (dim,))
    step = jnp.broadcast_to(jnp.asarray(step_scale, jnp.float32), (dim,))

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis)),
        out_specs=TraceResult(
            end_position=P(axis),
            end_direction=P(axis),
            end_iteration=P(axis),
            remaining_light=P(axis),
            path=None,
        ),
    )
    def shard_fn(packed_rep, pos_s, dirs_s):
        return march_ops.march_float(
            packed_rep,
            None,
            pos_s,
            dirs_s,
            budget,
            bend_scale=bend,
            step_scale=step,
            chunk_steps=chunk_steps,
        )

    res = shard_fn(packed, pos, dirs)
    if pad:
        res = TraceResult(
            end_position=res.end_position[:n],
            end_direction=res.end_direction[:n],
            end_iteration=res.end_iteration[:n],
            remaining_light=res.remaining_light[:n],
            path=None,
        )
    return res


# ---------------------------------------------------------------------------
# end-to-end sharded training step (the flagship "model": a differentiable
# renderer optimising the IOR field to match target per-pixel observations)
# ---------------------------------------------------------------------------


def endpoint_render(
    ior, positions, directions, budget: int, invscale: float, chunk_steps: int,
    kernel: str = "auto",
    soft_opacity_tau: Optional[float] = None,
    translucency=None,
    return_transmittance: bool = False,
):
    """Differentiable forward: preprocess the field, |v|=n-init the rays,
    march, return per-ray endpoints (the reference's output contract —
    endpoints + remaining light, SURVEY.md §0).

    The march is the XLA scan of remat'd chunks (ops/march.py); its adjoint
    is what JAX derives from it, scatter-adding into the field gradient.
    ``kernel`` is resolved by ``ops.march.resolve_kernel``; the forward-only
    ``"native"`` oracle has no gradient and is refused."""
    if march_ops.resolve_kernel(kernel) != "xla":
        raise ValueError("endpoint_render is differentiable: kernel='native' "
                         "(forward-only) cannot run it")
    from ..ops.fields import cropped_translucency

    packed = build_packed_field(ior, translucency)
    trc = None if translucency is None else cropped_translucency(translucency)
    dim = positions.shape[-1]
    inv = jnp.full((dim,), invscale, jnp.float32)
    pos = positions - 0.5
    n0 = interp_linear(ior, pos)
    dirs = directions * n0[..., None]
    pos = pos - 0.5
    soft = soft_opacity_tau is not None and soft_opacity_tau > 0.0
    res = march_ops.march_float(
        packed,
        trc,
        pos,
        dirs,
        budget,
        bend_scale=inv / float(FIX_ONE),
        step_scale=inv * (STEP_CONST / float(FIX_ONE) / float(FIX_ONE)),
        chunk_steps=chunk_steps,
        differentiable=True,
        soft_opacity_tau=soft_opacity_tau if soft else None,
    )
    if return_transmittance:
        return res.end_position + 1.0, res.end_direction, res.transmittance
    return res.end_position + 1.0, res.end_direction


def make_train_step(
    mesh: Mesh,
    budget: int = 256,
    invscale: float = 2.0,
    chunk_steps: int = 64,
    lr: float = 1e-3,
    axis: str = "rays",
    accum_steps: int = 1,
):
    """Build a jitted sharded training step:

        loss(ior) = mean ‖endpoint(ior, rays) − target‖²
        ior ← ior − lr · ∇loss          (SGD here; the optax path lives in
                                         models/optimize.py)

    Rays/targets sharded over ``axis``, field replicated, field gradient
    psum'd over the mesh — the voxel-grad all-reduce of BASELINE config 4.

    ``accum_steps > 1`` enables gradient accumulation: each shard's ray batch
    is split into ``accum_steps`` micro-batches marched sequentially with the
    field gradient accumulated LOCALLY, and the cross-device ``psum`` fires
    once per optimizer step instead of once per micro-batch — the
    communication-amortisation knob: the all-reduce cost is paid
    1/accum_steps as often per marched ray.  The per-shard batch size must be
    divisible by ``accum_steps``.
    """

    def per_shard_grad(ior, pos_s, dirs_s, target_s, count):
        def micro_grad(p, d, t):
            def loss_fn(f):
                end_pos, _ = endpoint_render(f, p, d, budget, invscale, chunk_steps)
                return jnp.sum((end_pos - t) ** 2) / count

            return jax.value_and_grad(loss_fn)(ior)

        if accum_steps == 1:
            return micro_grad(pos_s, dirs_s, target_s)

        n = pos_s.shape[0]
        assert n % accum_steps == 0, (
            f"per-shard batch {n} not divisible by accum_steps {accum_steps}"
        )
        m = n // accum_steps
        micros = (
            pos_s.reshape(accum_steps, m, -1),
            dirs_s.reshape(accum_steps, m, -1),
            target_s.reshape(accum_steps, m, -1),
        )

        def body(carry, micro):
            loss_acc, g_acc = carry
            loss, g = micro_grad(*micro)
            return (loss_acc + loss, jax.tree.map(jnp.add, g_acc, g)), None

        # the accumulators are device-varying (each shard sums its own
        # micro-batches)
        init = (jax.lax.pcast(jnp.float32(0.0), (axis,), to="varying"),
                jnp.zeros_like(ior))
        (loss, g), _ = jax.lax.scan(body, init, micros)
        return loss, g

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P(axis)),
        out_specs=(P(), P()),
    )
    def sharded_grad(ior, pos_s, dirs_s, target_s):
        count = jnp.float32(pos_s.shape[0] * jax.lax.psum(1, axis))
        # differentiate a device-varying copy of the field: the gradient of
        # the replicated input itself would come back already psum'd (the
        # transpose of the implicit pvary), once per micro-batch, and the
        # psum below would then count it mesh-size times
        ior = jax.lax.pcast(ior, (axis,), to="varying")
        loss, g = per_shard_grad(ior, pos_s, dirs_s, target_s, count)
        # voxel-gradient all-reduce (≙ BASELINE "voxel-grad all-reduce
        # overlapped with backward march"; XLA schedules the psum against
        # the remat'd backward chunks).  With accumulation this is the ONE
        # collective per optimizer step.
        return jax.lax.psum(loss, axis), jax.lax.psum(g, axis)

    @jax.jit
    def train_step(ior, positions, directions, targets):
        loss, g = sharded_grad(ior, positions, directions, targets)
        return ior - lr * g, loss

    return train_step


def replicate(mesh: Mesh, x: jax.Array) -> jax.Array:
    """Place ``x`` replicated over the mesh (≙ the reference's field copy to
    every device, .cu:680-685)."""
    return jax.device_put(x, NamedSharding(mesh, P()))


def shard_batch(mesh: Mesh, x: jax.Array, axis: str = "rays") -> jax.Array:
    """Shard the leading (ray) axis over the mesh."""
    return jax.device_put(x, NamedSharding(mesh, P(axis)))
