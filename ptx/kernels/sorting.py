"""Ray sorting + dead-ray parking: wavefront compaction under SPMD.

The reference keeps its ray wavefront coherent for free — rays sit in
lock-free queues and any thread pops whatever is next
(``worker.cpp:58-68``), so stale/dead rays simply never re-enter a queue.
Under SPMD the wavefront is a fixed-shape SoA and both problems reappear:

* after the first bounce, consecutive lanes hold rays scattered all over the
  scene, so the lanes of one kernel block walk unrelated BVH paths
  (``ptx.kernels.traverse_pallas``) and the block runs as long as its
  slowest lane;
* terminated lanes still occupy blocks.

Both are solved with one permutation per intersection call:

* **sorting** — rays are ordered by a (coarse-morton(origin), direction
  octant) key, so each block covers a small spatial cell with a
  narrow direction cone;
* **parking** — the integrators move dead lanes to a point outside the scene
  AABB pointing away from it (``park``), so they (a) sort into contiguous
  all-dead blocks and (b) miss the root box, costing one node visit.

The wrapper is *exact*: it permutes inputs, runs the wrapped backend, and
applies the inverse permutation to every output — per-ray results are
bit-identical because a ray's closest hit does not depend on which block it
rides in.

No reference counterpart (the queues made this a non-problem there); this is
SURVEY.md §7 "hard part 2" (wavefront compaction under SPMD).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ptx.scene.flatten import SceneStatic

# Bits per axis of the coarse morton grid (primary key). 7 bits/axis = 21-bit
# cell id; the 3 direction-octant bits ride below it so rays in the same cell
# group by heading.
MORTON_BITS = 7


def resolve_compact(static: SceneStatic, cfg) -> bool:
    """Honour cfg.sort_rays: "off" disables sorting/parking/compaction
    entirely, "on" forces it, "auto" defers to the scene-size rule."""
    if cfg.sort_rays == "off":
        return False
    if cfg.sort_rays == "on":
        return True
    return should_compact(static)


# Padded triangle count above which parking/sorting/compaction is on: an
# untuned starting value, not yet measured on the H100.
COMPACT_MIN_TRIS = 2048


def should_compact(static: SceneStatic) -> bool:
    """Parking/sorting only pays on non-trivial scenes; for a cornell-class
    box the extra elementwise passes are pure overhead."""
    return static.n_tris_padded > COMPACT_MIN_TRIS


def _expand_bits(x):
    """Spread the low 10 bits of ``x`` so there are two zero bits between
    each (the classic 30-bit morton interleave constants)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def ray_keys(orig, dirn, lo, hi, bits: int = MORTON_BITS):
    """[R] int32 sort keys: coarse morton cell of the origin (primary),
    direction octant (secondary)."""
    lo = jnp.asarray(lo, jnp.float32)
    hi = jnp.asarray(hi, jnp.float32)
    extent = jnp.maximum(hi - lo, 1e-30)
    n_cells = jnp.float32(1 << bits)
    q = jnp.clip((orig - lo) / extent * n_cells, 0.0, n_cells - 1.0)
    q = q.astype(jnp.uint32)
    morton = (
        _expand_bits(q[:, 0])
        | (_expand_bits(q[:, 1]) << 1)
        | (_expand_bits(q[:, 2]) << 2)
    )
    octant = (
        (dirn[:, 0] >= 0).astype(jnp.uint32)
        | ((dirn[:, 1] >= 0).astype(jnp.uint32) << 1)
        | ((dirn[:, 2] >= 0).astype(jnp.uint32) << 2)
    )
    return ((morton << 3) | octant).astype(jnp.int32)


def park(orig, dirn, keep, static: SceneStatic):
    """Move lanes where ``keep`` is False outside the scene, pointing away.

    Parked rays cannot hit anything (all geometry is behind them), fail every
    AABB gate, and share one morton cell so sorting packs them into dead
    blocks. Callers must already mask those lanes' results (they do — every
    integrator contribution is gated on ``alive``/``hit``).
    """
    hi = jnp.asarray(static.aabb_hi, jnp.float32)
    lo = jnp.asarray(static.aabb_lo, jnp.float32)
    p_orig = hi + (hi - lo) + 1.0
    p_dir = jnp.array([0.57735027, 0.57735027, 0.57735027], jnp.float32)
    k = keep[..., None]
    return (
        jnp.where(k, orig, p_orig),
        jnp.where(k, dirn, p_dir),
    )


def _apply_perm_inverse(tree, perm, r):
    inv = jnp.zeros((r,), jnp.int32).at[perm].set(
        jnp.arange(r, dtype=jnp.int32)
    )
    return jax.tree.map(lambda x: x[inv], tree)


def make_sorting_backend(closest, any_hit, static: SceneStatic):
    """Wrap a (closest, any_hit) backend pair with per-call ray sorting."""
    lo, hi = static.aabb_lo, static.aabb_hi

    def closest_sorted(fs, orig, dirn):
        r = orig.shape[0]
        perm = jnp.argsort(ray_keys(orig, dirn, lo, hi))
        h = closest(fs, orig[perm], dirn[perm])
        return _apply_perm_inverse(h, perm, r)

    def any_sorted(fs, orig, dirn):
        r = orig.shape[0]
        perm = jnp.argsort(ray_keys(orig, dirn, lo, hi))
        hit = any_hit(fs, orig[perm], dirn[perm])
        return _apply_perm_inverse(hit, perm, r)

    return closest_sorted, any_sorted
