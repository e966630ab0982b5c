"""Distributed (multi-chip) rendering via shard_map over the device mesh.

The two parallelism strategies of the reference (SURVEY.md §2.5), done
inside one SPMD program:

* **Ray parallelism** (``dp`` axis) — the reference's sample/pixel
  parallelism (thread-pool scanline jobs / shared stage queues,
  ``core/renderer.cpp:357-401``): the pixel wavefront is sharded across
  chips; tiles are disjoint so no per-ray collective is needed.
* **Scene parallelism** (``tp`` axis) — the reference's primitive
  partitioning + per-ray min-distance reduce (provisioned over SNS/SQS but
  never wired at runtime, see SURVEY.md §2.1): triangle arrays are sharded;
  every chip intersects the whole (replicated-over-tp) ray wavefront against
  its shard, and the winning hit is resolved with a two-phase
  ``pmin`` reduce — distance first, then lowest chip index as the
  tie-break — followed by a masked ``psum`` that materializes the winner's
  hit payload everywhere.  This is W5 (``intersection_worker.cpp:69-147``)
  implemented for real.

Shadow (any-hit) queries OR-reduce across the scene axis exactly like the
reference's direct-lighting reduce (``intersection_worker.cpp:114-147``).

Gradients flow through everything (psum transposes cleanly), so the same
machinery serves the inverse-rendering data-parallel gradient all-reduce.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ptx import geometry
from ptx.config import RenderConfig
from ptx.integrator.wavefront import make_integrator
from ptx.kernels.intersect import Hit
from ptx.parallel import mesh as pmesh
from ptx.scene.flatten import FlatScene, SceneStatic


def sharded_closest(base_closest, axis: str = pmesh.AXIS_SCENE):
    """Wrap a local closest-hit backend with the cross-chip min reduce."""

    def closest(fs: FlatScene, orig, dirn) -> Hit:
        h: Hit = base_closest(fs, orig, dirn)
        t = jnp.where(h.hit, h.t, geometry.INF)
        # Phase 1: winning distance across scene shards.
        t_min = jax.lax.pmin(t, axis)
        # Phase 2: lowest chip index among (near-)winners as tie-break.
        ax = jax.lax.axis_index(axis)
        n_ax = jax.lax.axis_size(axis)
        cand = jnp.where(t == t_min, ax, n_ax)
        ax_win = jax.lax.pmin(cand, axis)
        win = (t == t_min) & (ax == ax_win)

        def pick(x):
            mask = win if x.ndim == 1 else win[..., None]
            return jax.lax.psum(jnp.where(mask, x, jnp.zeros_like(x)), axis)

        return Hit(
            hit=jax.lax.pmax(h.hit.astype(jnp.int32), axis) > 0,
            t=t_min,
            position=pick(h.position),
            normal=pick(h.normal),
            tangent=pick(h.tangent),
            uv=pick(h.uv),
            mat_id=pick(h.mat_id),
        )

    return closest


def ring_closest(base_closest, axis: str = pmesh.AXIS_SCENE):
    """Ring-scheduled scene-sharded closest hit.

    The ring-attention analog from SURVEY.md §5: instead of every chip
    holding the full ray wavefront (all-gather + psum reduce, as
    :func:`sharded_closest` does), each chip owns a *block of rays* and the
    blocks rotate around the scene-shard ring with ``ppermute``, carrying
    their running (min distance, best-hit payload) — exactly like ring
    attention carries the running softmax state past resident KV shards.
    After ``axis_size`` hops every ray has visited every shard and is back
    home.  Ray memory per chip is 1/tp of the reduce variant; per-hop
    payload rides the device interconnect.
    """

    def closest(fs: FlatScene, orig, dirn) -> Hit:
        n = jax.lax.axis_size(axis)
        right = [(i, (i + 1) % n) for i in range(n)]

        def local(o, d):
            h = base_closest(fs, o, d)
            return h._replace(t=jnp.where(h.hit, h.t, geometry.INF))

        def merge(best: Hit, new: Hit) -> Hit:
            closer = new.t < best.t

            def sel(a, b):
                mask = closer if a.ndim == 1 else closer[..., None]
                return jnp.where(mask, b, a)

            return Hit(
                hit=best.hit | new.hit,
                t=jnp.minimum(best.t, new.t),
                position=sel(best.position, new.position),
                normal=sel(best.normal, new.normal),
                tangent=sel(best.tangent, new.tangent),
                uv=sel(best.uv, new.uv),
                mat_id=sel(best.mat_id, new.mat_id),
            )

        def rotate(tree):
            return jax.tree.map(
                lambda x: jax.lax.ppermute(x, axis, right), tree
            )

        carry = (orig, dirn, local(orig, dirn))
        for _ in range(n - 1):
            o, d, best = rotate(carry)
            carry = (o, d, merge(best, local(o, d)))
        # One final hop brings each ray block home.
        _, _, best = rotate(carry)
        return best

    return closest


def ring_any_hit(base_any, axis: str = pmesh.AXIS_SCENE):
    """Ring-scheduled occlusion query (OR accumulates around the ring)."""

    def any_hit(fs: FlatScene, orig, dirn):
        n = jax.lax.axis_size(axis)
        right = [(i, (i + 1) % n) for i in range(n)]

        def rotate(tree):
            return jax.tree.map(
                lambda x: jax.lax.ppermute(x, axis, right), tree
            )

        carry = (orig, dirn, base_any(fs, orig, dirn).astype(jnp.int32))
        for _ in range(n - 1):
            o, d, hit = rotate(carry)
            carry = (o, d, hit | base_any(fs, o, d).astype(jnp.int32))
        _, _, hit = rotate(carry)
        return hit > 0

    return any_hit


def sharded_any_hit(base_any, axis: str = pmesh.AXIS_SCENE):
    """OR-reduce occlusion across scene shards (the direct-lighting reduce,
    ``intersection_worker.cpp:114-147``)."""

    def any_hit(fs: FlatScene, orig, dirn):
        local = base_any(fs, orig, dirn)
        return jax.lax.pmax(local.astype(jnp.int32), axis) > 0

    return any_hit


def launch_chunk(n_pixels: int, ray_ways: int) -> Optional[int]:
    """Pixels per shard_map launch of a one-sample pass, or ``None`` for
    whole-frame launches.  Frames past the per-device launch cap auto-chunk,
    the distributed mirror of ``ptx.render.resolve_rays_per_batch``: each
    chunk's per-device slice stays at or under MAX_RAYS_PER_LAUNCH."""
    from ptx.render import MAX_RAYS_PER_LAUNCH

    ways = max(ray_ways, 1)
    if n_pixels // ways <= MAX_RAYS_PER_LAUNCH:
        return None
    align = 128 * ways
    for m in range(MAX_RAYS_PER_LAUNCH * ways // align, 0, -1):
        if n_pixels % (align * m) == 0:
            return align * m
    return None


def make_distributed_sample_fn(
    static: SceneStatic,
    cfg: RenderConfig,
    mesh: Mesh,
    plan: pmesh.Plan,
    comm: str = "reduce",
    k: int = 1,
):
    """Jitted SPMD sample pass over the whole mesh: pixels sharded along
    ``dp``, scene optionally along ``tp``.

    With ``k == 1``: ``(fs, sample_id) -> (radiance [P,3], alpha [P])``.
    With ``k > 1``: ``(fs, sample0) -> (radiance [k,P,3], alpha [k,P])`` —
    samples ``sample0 .. sample0+k-1`` traced in ONE launch (the same
    sample-batching as the single-chip ``make_batched_sample_fn``; the
    launch-size cap applies to the per-chip wavefront, so dp-sharded frames
    batch more).

    ``comm`` picks the scene-axis exchange:
    * ``"reduce"`` — rays replicated over ``tp``; winning hits resolved by a
      pmin + masked-psum payload reduce (W5 done with XLA collectives).
    * ``"ring"``   — rays sharded over ``tp`` too; ray blocks ``ppermute``
      around the shard ring carrying their running best hit (the
      ring-attention schedule; 1/tp the ray memory, interconnect-bound).
    """
    from ptx.kernels import sorting
    from ptx.render import get_backend

    if plan.scene_sharded and static.n_bvh_nodes > 0 and not static.shard_local:
        # A globally-built BVH must never run under a scene-sharded plan:
        # its leaf ranges index the *global* triangle order, so each device
        # would silently intersect the wrong shard-local triangles (round
        # 1's wrong-image bug).  Build the scene with
        # ptx.parallel.shard_scene.build_shard_scene (or prepare_scene).
        raise ValueError(
            "scene-sharded plan with a globally-built BVH: prepare the "
            "scene with prepare_scene()/build_shard_scene() so every shard "
            "holds a self-contained BVH over its own triangles"
        )
    if static.tex_shard_len > 0 and comm == "ring":
        # The sharded-texel gather psums over the scene axis, which requires
        # every tp chip to hold the SAME rays; ring mode shards rays over tp.
        raise ValueError(
            "sharded textures (tex_shard_len > 0) require comm='reduce' "
            "(rays replicated over tp); ring mode shards rays over tp"
        )
    # The compacted bounce loop sorts the wavefront itself — skip the
    # per-call backend sorting wrapper then (mirrors make_integrator_for).
    chunk_active = sorting.resolve_compact(static, cfg)
    base_closest, base_any = get_backend(
        static, cfg, sort=False if chunk_active else None
    )
    if plan.scene_sharded and comm == "ring":
        closest = ring_closest(base_closest)
        any_hit = ring_any_hit(base_any)
    elif plan.scene_sharded:
        closest = sharded_closest(base_closest)
        any_hit = sharded_any_hit(base_any)
    else:
        closest, any_hit = base_closest, base_any
    # Survivor compaction under SPMD: the chunk/bounce trip counts are
    # data-dependent, and the scene-sharded closures psum/ppermute over
    # AXIS_SCENE — sync the live count over the WHOLE mesh so every chip
    # issues the identical collective sequence (strictly only the scene
    # axis must agree, but collective rendezvous is global in some runtimes
    # and a mesh-wide i32 pmax per bounce costs nothing; chips whose extra
    # chunks are all-dead do cheap no-op sweeps).
    live_sync = (
        (lambda v: jax.lax.pmax(v, (pmesh.AXIS_RAYS, pmesh.AXIS_SCENE)))
        if plan.scene_sharded else None
    )
    n_pixels = cfg.width * cfg.height
    lanes = n_pixels * k
    ray_ways = plan.dp * (plan.tp if comm == "ring" else 1)
    integrator = make_integrator(
        static, cfg, closest, any_hit, live_sync=live_sync
    )

    if lanes % ray_ways:
        raise ValueError(
            f"ray count {lanes} must divide the ray sharding ({ray_ways})"
        )

    fs_specs = pmesh.scene_shardings(
        mesh, plan.scene_sharded,
        shard_bvh=plan.scene_sharded and static.n_bvh_nodes > 0,
        shard_tex=plan.scene_sharded and static.tex_shard_len > 0,
    )
    if comm == "ring" and plan.scene_sharded:
        ids_spec = P((pmesh.AXIS_RAYS, pmesh.AXIS_SCENE))
    else:
        ids_spec = P(pmesh.AXIS_RAYS)

    inner = jax.shard_map(
        lambda fs, pix, smp: integrator(fs, pix, smp),
        mesh=mesh,
        in_specs=(fs_specs, ids_spec, ids_spec),
        out_specs=(ids_spec, ids_spec),
        check_vma=False,
    )

    if k == 1:
        chunk = launch_chunk(n_pixels, ray_ways)
        if chunk is None:

            @jax.jit
            def sample_pass(fs: FlatScene, sample_id):
                pixel_ids = jnp.arange(n_pixels, dtype=jnp.int32)
                sample_ids = jnp.full((n_pixels,), sample_id, jnp.int32)
                return inner(fs, pixel_ids, sample_ids)

            return sample_pass

        @jax.jit
        def chunk_pass(fs: FlatScene, start, sample_id):
            pixel_ids = start + jnp.arange(chunk, dtype=jnp.int32)
            sample_ids = jnp.full((chunk,), sample_id, jnp.int32)
            return inner(fs, pixel_ids, sample_ids)

        def sample_pass(fs: FlatScene, sample_id):
            parts = [
                chunk_pass(fs, jnp.int32(sck), sample_id)
                for sck in range(0, n_pixels, chunk)
            ]
            radiance = jnp.concatenate([p[0] for p in parts])
            alpha = jnp.concatenate([p[1] for p in parts])
            return radiance, alpha

        return sample_pass

    @jax.jit
    def batch_pass(fs: FlatScene, sample0):
        pixel_ids = jnp.tile(jnp.arange(n_pixels, dtype=jnp.int32), k)
        sample_ids = sample0 + jnp.repeat(
            jnp.arange(k, dtype=jnp.int32), n_pixels
        )
        radiance, alpha = inner(fs, pixel_ids, sample_ids)
        return radiance.reshape(k, n_pixels, 3), alpha.reshape(k, n_pixels)

    return batch_pass


def prepare_scene(
    fs: FlatScene,
    static: SceneStatic,
    cfg: RenderConfig,
    plan: pmesh.Plan,
    mesh: Mesh,
):
    """Accel-build + place a scene for the plan.

    * scene-sharded: split into shard-local chunks with *per-shard* BVHs
      (``ptx.parallel.shard_scene``) so every device's leaf ranges index its
      own triangles; node arrays shard along tp with the triangles.
    * replicated: a single global BVH (``ptx.render.ensure_accel``),
      replicated like the rest of the scene.

    Returns ``(fs_on_mesh, static_local)`` where ``static_local`` describes
    the per-device view inside ``shard_map``.
    """
    if plan.scene_sharded:
        from ptx.parallel.shard_scene import (
            build_shard_scene, build_texture_shards,
        )

        fs, static = build_shard_scene(fs, static, plan, cfg)
        if plan.shard_textures:
            # Texture bytes bust the per-chip budget: bin-pack whole
            # textures into tp shards; gathers psum across the scene axis
            # (sample_texture).  The reference's per-worker texture
            # residency (preprocessor.py:104-111, load_gltf.cpp:142-162).
            fs, static = build_texture_shards(fs, static, plan.tp)
        fs = pmesh.shard_scene(
            fs, mesh, True,
            shard_bvh=static.n_bvh_nodes > 0,
            shard_tex=static.tex_shard_len > 0,
        )
    else:
        from ptx.render import ensure_accel

        fs, static = ensure_accel(fs, static, cfg)
        fs = pmesh.shard_scene(fs, mesh, False)
    return fs, static


def render_distributed(
    fs: FlatScene,
    static: SceneStatic,
    cfg: RenderConfig,
    plan: Optional[pmesh.Plan] = None,
    mesh: Optional[Mesh] = None,
    progress=None,
    comm: str = "reduce",
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 5,
    metrics=None,
    preview_path: Optional[str] = None,
):
    """Multi-chip progressive render (same contract as ``ptx.render.render``,
    including checkpoint/resume — the accumulated mean + sample count is
    device-layout-independent, so a checkpoint written here resumes on any
    mesh shape, or single-chip).  Shares the launch strategy with the
    single-chip path: samples are fused into wide launches up to the
    per-device ray cap (``ptx.render.MAX_RAYS_PER_LAUNCH``)."""
    from ptx.render import progressive_render, resolve_samples_per_launch

    if plan is None:
        plan = pmesh.plan(
            static.n_tris_padded, n_texels=int(np.asarray(fs.tex_texels).shape[0])
        )
    if mesh is None:
        mesh = pmesh.make_mesh(plan)
    if plan.shard_textures and comm == "ring":
        raise ValueError(
            "plan shards textures but comm='ring' shards rays over tp; "
            "sharded-texel gathers need rays replicated over tp — use "
            "comm='reduce' (or force a plan with replicated textures)"
        )
    fs, static = prepare_scene(fs, static, cfg, plan, mesh)
    ray_ways = plan.dp * (plan.tp if comm == "ring" else 1)
    k = resolve_samples_per_launch(cfg, ways=ray_ways)
    fn = make_distributed_sample_fn(static, cfg, mesh, plan, comm, k=k)
    from ptx.parallel.multihost import replicator

    return progressive_render(
        fs, static, cfg,
        sample_fn=fn if k == 1 else None,
        batch_fn=fn if k > 1 else None,
        k=k,
        progress=progress,
        checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every,
        metrics=metrics,
        replicate=replicator(mesh),
        preview_path=preview_path,
    )
