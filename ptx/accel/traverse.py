"""Stackless BVH traversal (pure JAX).

The device-side counterpart of ``mesh::intersect``'s explicit-stack KD walk
(``core/mesh.cpp:300-405``), redesigned for SPMD: every ray carries just one
node register and follows hit -> ``node+1`` / miss -> ``bvh_miss[node]``
links, so the whole wavefront advances in a single batched ``while_loop``
(vmap turns the per-ray loop into lock-step masked execution — the lanes
that finish early idle).  The GPU kernel form of the same walk, one
block of lanes at a time, is ``ptx.kernels.traverse_pallas``.

Leaves are contiguous triangle ranges of at most ``leaf_size``; the leaf test
is a fixed-width vectorized Moller-Trumbore block with a count mask — the
same inner loop as the reference's per-leaf sweep (``mesh.cpp:381-391``)
minus the pointer chasing.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ptx import geometry
from ptx.scene.flatten import FlatScene, SceneStatic


def _make_traverse(leaf_size: int, any_hit: bool):
    def traverse_one(fs: FlatScene, orig, dirn):
        """Single-ray traversal; vmapped by the backend. Returns
        (t, tri, beta, gamma, hit)."""
        inv_d = 1.0 / dirn
        # Links only point forward in the depth-first layout: a ray visits
        # each node at most once, so the node count bounds the walk.
        max_steps = fs.bvh_min.shape[0]

        def cond(carry):
            node, best_t, *_ , steps = carry
            live = node >= 0
            if any_hit:
                live = live & (best_t >= geometry.INF)
            return live & (steps < max_steps)

        def body(carry):
            node, best_t, best_tri, best_b, best_g, steps = carry
            bb_min = fs.bvh_min[node]
            bb_max = fs.bvh_max[node]
            t0 = (bb_min - orig) * inv_d
            t1 = (bb_max - orig) * inv_d
            tmin = jnp.minimum(t0, t1)
            tmax = jnp.maximum(t0, t1)
            near = jnp.max(jnp.where(jnp.isnan(tmin), -jnp.inf, tmin))
            far = jnp.min(jnp.where(jnp.isnan(tmax), jnp.inf, tmax))
            box_hit = (far >= jnp.maximum(near, 0.0)) & (near < best_t)

            count = fs.bvh_count[node]
            is_leaf = count > 0

            def leaf_test(_):
                first = fs.bvh_first[node]
                idx = first + jnp.arange(leaf_size, dtype=jnp.int32)
                in_leaf = jnp.arange(leaf_size) < count
                a = fs.tri_a[idx]
                e1 = fs.tri_e1[idx]
                e2 = fs.tri_e2[idx]
                t, beta, gamma, ok = geometry.moller_trumbore(
                    orig[None, :], dirn[None, :], a, e1, e2
                )
                t = jnp.where(in_leaf & ok, t, geometry.INF)
                j = jnp.argmin(t)
                return t[j], idx[j], beta[j], gamma[j]

            lt, ltri, lb, lg = jax.lax.cond(
                is_leaf & box_hit,
                leaf_test,
                lambda _: (geometry.INF, jnp.int32(0), 0.0, 0.0),
                None,
            )
            closer = lt < best_t
            best_t = jnp.where(closer, lt, best_t)
            best_tri = jnp.where(closer, ltri, best_tri)
            best_b = jnp.where(closer, lb, best_b)
            best_g = jnp.where(closer, lg, best_g)

            # Interior hit falls through to node+1 (DFS left child); leaf or
            # miss jumps the escape link.
            descend = box_hit & ~is_leaf
            node = jnp.where(descend, node + 1, fs.bvh_miss[node])
            return node, best_t, best_tri, best_b, best_g, steps + 1

        init = (
            jnp.int32(0),
            geometry.INF,
            jnp.int32(0),
            jnp.float32(0.0),
            jnp.float32(0.0),
            jnp.int32(0),
        )
        _, best_t, best_tri, best_b, best_g, _ = jax.lax.while_loop(
            cond, body, init
        )
        hit = best_t < geometry.INF
        return best_t, best_tri, best_b, best_g, hit

    return traverse_one


def node_visits(fs: FlatScene, orig, dirn):
    """Per-ray count of BVH nodes visited — the debug oracle standing in for
    the reference's KD-tree depth visualization (``mesh.cpp:314-331``,
    ``renderer.hpp:33``): reads traversal cost directly instead of coloring
    nodes by pointer hash."""

    max_steps = fs.bvh_min.shape[0]

    def one(o, d):
        inv_d = 1.0 / d

        def cond(carry):
            node, steps = carry
            return (node >= 0) & (steps < max_steps)

        def body(carry):
            node, steps = carry
            t0 = (fs.bvh_min[node] - o) * inv_d
            t1 = (fs.bvh_max[node] - o) * inv_d
            tmin = jnp.minimum(t0, t1)
            tmax = jnp.maximum(t0, t1)
            near = jnp.max(jnp.where(jnp.isnan(tmin), -jnp.inf, tmin))
            far = jnp.min(jnp.where(jnp.isnan(tmax), jnp.inf, tmax))
            box_hit = (far >= jnp.maximum(near, 0.0))
            descend = box_hit & (fs.bvh_count[node] == 0)
            node = jnp.where(descend, node + 1, fs.bvh_miss[node])
            return node, steps + 1

        _, steps = jax.lax.while_loop(cond, body, (jnp.int32(0), jnp.int32(0)))
        return steps

    return jax.vmap(one)(orig, dirn)


def make_backend(leaf_size: int = 8):
    """(closest, any_hit) pair over the attached flattened BVH."""
    from ptx.kernels.intersect import attrs_from_indices

    closest_one = _make_traverse(leaf_size, any_hit=False)
    any_one = _make_traverse(leaf_size, any_hit=True)

    def closest(fs: FlatScene, orig, dirn):
        t, tri, beta, gamma, hit = jax.vmap(
            lambda o, d: closest_one(fs, o, d)
        )(orig, dirn)
        return attrs_from_indices(fs, t, tri, beta, gamma, hit)

    def any_hit(fs: FlatScene, orig, dirn):
        *_, hit = jax.vmap(lambda o, d: any_one(fs, o, d))(orig, dirn)
        return hit

    return closest, any_hit
