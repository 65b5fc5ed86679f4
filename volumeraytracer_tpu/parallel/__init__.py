"""Multi-chip parallelism: meshes, sharded tracing, sharded training steps.

Two layouts (SURVEY.md §2 parallelism table, BASELINE configs 4-5):
  * ``shard``  — rays data-parallel over the mesh, field replicated
    (the analogue of the reference's per-GPU field copies);
  * ``bricks`` — field brick-sharded into X-slabs with halo exchange,
    ray state replicated with exactly-once window handoff (new capability;
    the reference never shards the field).
"""

from . import bricks
from .bricks import (
    build_ior_slabs,
    build_packed_slabs,
    make_brick_train_step,
    make_brick_train_step2d,
    make_mesh2d,
    shard_slabs,
    trace_rays_bricked,
    trace_rays_bricked2d,
)
from .shard import (
    init_distributed,
    make_mesh,
    make_train_step,
    replicate,
    shard_batch,
    trace_rays_sharded,
)

__all__ = [
    "bricks",
    "build_ior_slabs",
    "build_packed_slabs",
    "init_distributed",
    "make_brick_train_step",
    "make_brick_train_step2d",
    "make_mesh",
    "make_mesh2d",
    "make_train_step",
    "replicate",
    "shard_batch",
    "shard_slabs",
    "trace_rays_bricked",
    "trace_rays_bricked2d",
    "trace_rays_sharded",
]
