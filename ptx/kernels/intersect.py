"""Pure-JAX intersection backends (the semantics oracle).

The reference's hot loops are the KD-tree walk (``core/mesh.cpp:300-405``)
and the per-leaf triangle tests (``geometry/triangle.cpp:120-190``).  Here the
baseline backend is a *tiled brute-force* sweep: the ray wavefront [R] is
tested against triangle tiles [T] as an [R, T] elementwise block with the
running min carried across tiles.  It is O(rays x triangles): the oracle
the walks are tested against, and the CPU path for small scenes.

The XLA BVH walk (``ptx.accel.traverse``) and the GPU kernel walk
(``ptx.kernels.traverse_pallas``) plug in through the same signature:

    closest(orig [R,3], dirn [R,3]) -> (t [R], tri [R] i32, beta [R], gamma [R], hit [R] bool)
    any_hit(orig [R,3], dirn [R,3]) -> hit [R] bool

Misses are encoded as ``t = geometry.INF`` — the same sentinel the
cross-chip min-reduce uses in the scene-sharded mode (the reference's
``float::max`` miss marker, ``intersection_worker.cpp:98``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ptx import geometry
from ptx.scene.flatten import FlatScene


def _tile_bounds(n: int, tile: int) -> int:
    return -(-n // tile)


def brute_closest(fs: FlatScene, orig, dirn, tile: int = 512):
    """Closest hit of every ray against every (local) triangle.

    ``fs`` may hold a *shard* of the scene — padding/degenerate slots never
    hit (zero-area triangles fail the determinant test).
    """
    n = fs.tri_a.shape[0]
    tile = min(tile, n)
    n_tiles = _tile_bounds(n, tile)
    r = orig.shape[0]

    def body(i, carry):
        best_t, best_tri, best_b, best_g = carry
        # dynamic_slice clamps an out-of-range start (last tile of a
        # non-tile-multiple shard) — clamp the index math identically or
        # `start + arg` attributes hits to the wrong triangle.
        start = jnp.minimum(i * tile, n - tile)
        a = jax.lax.dynamic_slice_in_dim(fs.tri_a, start, tile)
        e1 = jax.lax.dynamic_slice_in_dim(fs.tri_e1, start, tile)
        e2 = jax.lax.dynamic_slice_in_dim(fs.tri_e2, start, tile)
        t, beta, gamma, ok = geometry.moller_trumbore(
            orig[:, None, :], dirn[:, None, :], a[None], e1[None], e2[None]
        )  # [R, T]
        arg = jnp.argmin(t, axis=1)
        tmin = jnp.take_along_axis(t, arg[:, None], axis=1)[:, 0]
        closer = tmin < best_t
        rowsel = lambda m: jnp.take_along_axis(m, arg[:, None], axis=1)[:, 0]
        best_tri = jnp.where(closer, start + arg.astype(jnp.int32), best_tri)
        best_b = jnp.where(closer, rowsel(beta), best_b)
        best_g = jnp.where(closer, rowsel(gamma), best_g)
        best_t = jnp.minimum(best_t, tmin)
        return best_t, best_tri, best_b, best_g

    init = (
        jnp.full((r,), geometry.INF),
        jnp.zeros((r,), jnp.int32),
        jnp.zeros((r,)),
        jnp.zeros((r,)),
    )
    best_t, best_tri, best_b, best_g = jax.lax.fori_loop(0, n_tiles, body, init)
    hit = best_t < geometry.INF
    return best_t, best_tri, best_b, best_g, hit


def brute_any(fs: FlatScene, orig, dirn, tile: int = 512):
    """Boolean occlusion query (shadow rays).  The reference runs a *full*
    closest-hit for this (``intersection_worker.cpp:58-62``); an any-hit
    reduce is strictly cheaper and gives the identical boolean."""
    n = fs.tri_a.shape[0]
    tile = min(tile, n)
    n_tiles = _tile_bounds(n, tile)
    r = orig.shape[0]

    def body(i, hit_any):
        start = i * tile
        a = jax.lax.dynamic_slice_in_dim(fs.tri_a, start, tile)
        e1 = jax.lax.dynamic_slice_in_dim(fs.tri_e1, start, tile)
        e2 = jax.lax.dynamic_slice_in_dim(fs.tri_e2, start, tile)
        _, _, _, ok = geometry.moller_trumbore(
            orig[:, None, :], dirn[:, None, :], a[None], e1[None], e2[None]
        )
        return hit_any | jnp.any(ok, axis=1)

    return jax.lax.fori_loop(0, n_tiles, body, jnp.zeros((r,), bool))


class Hit(NamedTuple):
    """Per-ray hit payload — the compact record the scene-sharded mode
    min-reduces across chips (the analog of ``models::intersect_result_min``,
    ``src/models/intersect_result.hpp:7-12``, widened with the shading
    attributes the reference's unwired cross-worker design would have
    re-derived locally)."""

    hit: jnp.ndarray  # [R] bool
    t: jnp.ndarray  # [R] distance, INF on miss (the min-reduce key)
    position: jnp.ndarray  # [R, 3]
    normal: jnp.ndarray  # [R, 3] interpolated shading normal (pre normal-map)
    tangent: jnp.ndarray  # [R, 3]
    uv: jnp.ndarray  # [R, 2]
    mat_id: jnp.ndarray  # [R] i32


def attrs_from_indices(fs: FlatScene, t, tri, beta, gamma, hit,
                       at=None, geom=None) -> Hit:
    """Resolve (triangle index, barycentrics) to the :class:`Hit` payload.
    ``at``: optionally the already-gathered ``tri_attrs`` rows; ``geom``:
    optional (a, e1, e2) override for the vertex columns (the
    split-geometry-gradient path)."""
    from ptx.integrator.wavefront import compute_hit_attrs

    position, n_interp, tangent, uv, mat_id = compute_hit_attrs(
        fs, tri, beta, gamma, at=at, geom=geom
    )
    return Hit(hit, t, position, n_interp, tangent, uv, mat_id)


def brute_closest_attrs(fs: FlatScene, orig, dirn, tile: int = 512):
    t, tri, beta, gamma, hit = brute_closest(fs, orig, dirn, tile)
    return attrs_from_indices(fs, t, tri, beta, gamma, hit)


def make_brute(tile: int = 512):
    """Return (closest, any_hit) callables with the integrator signature."""

    def closest(fs, orig, dirn):
        return brute_closest_attrs(fs, orig, dirn, tile)

    def any_hit(fs, orig, dirn):
        return brute_any(fs, orig, dirn, tile)

    return closest, any_hit
