"""Device mesh setup and the sharding planner.

Replaces the reference's orchestration layer (L4): the preprocessor Lambda
that sized the worker fleet from a memory budget and fanned out async invokes
(``app.py:77-155``, ``preprocessor.py:64-69``) becomes a host-side *planner*
that inspects scene size vs per-device memory and picks a mesh shape:

* ``dp`` (ray/tile axis)   — the reference's sample/pixel parallelism: rays
  sharded across chips, scene replicated, no per-ray collective.
* ``tp`` (scene axis)      — the reference's scene/geometry parallelism:
  triangles sharded, every chip intersects the whole ray wavefront against
  its shard, hits min-reduced over the device interconnect (the SNS/SQS
  design of W5, done for real).

No control plane is needed — SPMD replaces async Lambda invokes, and
``jax.distributed.initialize`` + the mesh replaces the SNS topic / SQS queue
fabric (``app.py:12-75``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXIS_RAYS = "dp"
AXIS_SCENE = "tp"

# Bytes per triangle across the FlatScene SoA arrays:
# 3x tri (a/e1/e2) + 3x normal + 3x tangent = 9 vec3 + 3 uv (vec2) = 33 f32
# + mat_id i32 + valid byte.
_BYTES_PER_TRI = 33 * 4 + 4 + 1


@dataclasses.dataclass(frozen=True)
class Plan:
    """Execution plan: mesh shape and whether the scene is sharded."""

    dp: int
    tp: int
    scene_sharded: bool
    # Shard the texture pack along tp too (texel gathers then ride a
    # one-hot psum across the scene axis — ptx.parallel.shard_scene).
    shard_textures: bool = False

    @property
    def n_devices(self) -> int:
        return self.dp * self.tp


def scene_bytes(n_tris: int, n_texels: int = 0) -> int:
    return n_tris * _BYTES_PER_TRI + n_texels * 16


def device_memory_bytes(device=None) -> int:
    """Memory one device lets the program use (``memory_stats()``'s
    ``bytes_limit``).  A device that reports none is refused: the planner
    needs a real budget, so pass ``memory_bytes`` to :func:`plan` there."""
    device = device or jax.devices()[0]
    stats = device.memory_stats() or {}
    if "bytes_limit" not in stats:
        raise ValueError(
            f"{device} reports no memory limit; pass memory_bytes to plan()"
        )
    return int(stats["bytes_limit"])


def plan(
    n_tris: int,
    n_devices: Optional[int] = None,
    n_texels: int = 0,
    memory_bytes: Optional[int] = None,
    scene_budget_fraction: float = 0.25,
    force_tp: Optional[int] = None,
) -> Plan:
    """Choose a mesh shape (the ``get_split_scene`` decision of
    ``preprocessor.py:64-69``, driven by device memory instead of Lambda
    memory — and, like the reference's partitioner, *texture-aware*: texel
    bytes dominate textured scenes, ``preprocessor.py:104-111``).

    ``memory_bytes`` is one device's memory, read from the device
    (:func:`device_memory_bytes`) when not given.  The scene is replicated
    while it fits in ``scene_budget_fraction`` of it (pure ray parallelism —
    fastest); otherwise the scene axis
    grows by powers of two until each shard fits.  Triangles always shard
    with tp; the texture pack stays replicated while it fits alone and flips
    to tp-sharded (``Plan.shard_textures``) only when it doesn't.
    """
    if n_devices is None:
        n_devices = jax.device_count()
    if memory_bytes is None:
        memory_bytes = device_memory_bytes()
    budget = memory_bytes * scene_budget_fraction
    if force_tp is not None:
        tp = force_tp
    else:
        tp = 1
        while (
            scene_bytes(n_tris // tp, 0) + n_texels * 16 > budget
            and tp < n_devices
        ):
            tp *= 2
    tp = min(tp, n_devices)
    needed = tp
    while n_devices % tp:
        tp += 1  # round up to the next divisor to keep the mesh rectangular
    if tp > needed and tp >= 2 * needed:
        # On non-power-of-two device counts the next divisor can be far from
        # the memory-driven need (worst case tp == n_devices: pure scene
        # sharding, the slowest mode) — surface it rather than run silent.
        import logging

        logging.getLogger(__name__).warning(
            "plan(): scene axis rounded from tp=%d to the next divisor %d of "
            "%d devices; consider a device count divisible by %d",
            needed, tp, n_devices, needed,
        )
    # Texture pack: replicate while it fits next to the triangle shard;
    # shard along tp only when textures alone bust the budget.
    shard_tex = tp > 1 and (
        scene_bytes(n_tris // tp, 0) + n_texels * 16 > budget
    )
    return Plan(
        dp=n_devices // tp, tp=tp, scene_sharded=tp > 1,
        shard_textures=shard_tex,
    )


def make_mesh(p: Plan, devices: Optional[Sequence] = None) -> Mesh:
    if devices is None:
        devices = jax.devices()[: p.n_devices]
    arr = np.asarray(devices).reshape(p.dp, p.tp)
    return Mesh(arr, (AXIS_RAYS, AXIS_SCENE))


def scene_shardings(mesh: Mesh, scene_sharded: bool, shard_bvh: bool = False,
                    shard_tex: bool = False):
    """Per-leaf PartitionSpecs for a FlatScene: triangle-indexed arrays split
    along the scene axis, the rest (materials, camera) replicated.

    ``shard_bvh`` additionally splits the BVH node arrays along the scene
    axis — only valid for scenes prepared by
    :func:`ptx.parallel.shard_scene.build_shard_scene`, whose per-shard node
    blocks hold *shard-local* leaf ranges.  A globally-built BVH must NEVER
    be sharded (its leaf ranges index the global triangle order) nor
    replicated over sharded triangles (round 1's wrong-image bug).

    ``shard_tex`` splits the texel pack along the scene axis — only valid
    for packs rebuilt by
    :func:`ptx.parallel.shard_scene.build_texture_shards` (whole-texture
    bins stacked to ``tp`` equal lengths; ``SceneStatic.tex_shard_len``
    carries the bin length the sampler needs)."""
    from ptx.scene.flatten import FlatScene

    tri_fields = {
        "tri_a", "tri_e1", "tri_e2", "tri_valid",
        "n0", "n1", "n2", "t0", "t1", "t2",
        "uv0", "uv1", "uv2", "mat_id", "tri_attrs",
    }
    bvh_fields = {"bvh_min", "bvh_max", "bvh_first", "bvh_count", "bvh_miss"}
    spec = {}
    for field in FlatScene._fields:
        if scene_sharded and field in tri_fields:
            spec[field] = P(AXIS_SCENE)
        elif scene_sharded and shard_bvh and field in bvh_fields:
            spec[field] = P(AXIS_SCENE)
        elif scene_sharded and shard_tex and field == "tex_texels":
            spec[field] = P(AXIS_SCENE)
        else:
            spec[field] = P()
    return FlatScene(**spec)


def shard_scene(fs, mesh: Mesh, scene_sharded: bool, shard_bvh: bool = False,
                shard_tex: bool = False):
    """Place a FlatScene on the mesh according to the plan.

    In multi-process (multi-host) runs every process holds the full
    host-side scene (same file loaded everywhere) and materializes only the
    shards its local devices own (``multihost.put_global``)."""
    specs = scene_shardings(mesh, scene_sharded, shard_bvh, shard_tex)
    if jax.process_count() > 1:
        from ptx.parallel.multihost import put_global

        return jax.tree.map(
            lambda x, s: put_global(x, NamedSharding(mesh, s)), fs, specs
        )
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), fs, specs
    )
