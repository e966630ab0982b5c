"""Batched ray/triangle/AABB primitives.

Data-parallel counterpart of the reference's ``geometry/`` module.  The
reference solves ray-triangle intersection with a Cramer's-rule 3x3 solve
(``geometry/triangle.cpp:120-190``); we use the algebraically identical
Moller-Trumbore form, which has fewer subterms and vectorizes as a handful
of fused multiply-adds per (ray, triangle) pair.  The epsilon-biased
"in favour of a successful hit" barycentric tests and the hit-iff-``t >= 0``
convention are preserved exactly.

All functions broadcast: pass ``orig``/``dirn`` of shape ``[R, 3]`` and
triangle arrays of shape ``[N, 3]`` with explicit ``[..., None, :]`` expansion
at the call site to get an ``[R, N]`` intersection matrix, or equal shapes for
pairwise tests.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ptx import math as pmath

# Sentinel "no hit" distance. The reference encodes misses as distance = -1
# and min-reduces with a has_hit() guard; an infinite miss distance lets us
# use a plain jnp.min / argmin instead (and cross-device min-reduces in the
# scene-sharded mode).
INF = jnp.float32(3.0e38)


class Triangles(NamedTuple):
    """SoA triangle soup in *world space* (transforms baked at load time).

    ``a`` is vertex 0, ``e1 = b - a``, ``e2 = c - a``.  Barycentrics follow
    the reference convention: ``alpha`` on ``a``, ``beta`` on ``b``, ``gamma``
    on ``c`` (``geometry/triangle.cpp:158-186``).
    """

    a: jnp.ndarray  # [N, 3]
    e1: jnp.ndarray  # [N, 3]
    e2: jnp.ndarray  # [N, 3]
    valid: jnp.ndarray  # [N] bool — False for padding slots


def moller_trumbore(orig, dirn, a, e1, e2, eps: float = pmath.EPS):
    """Batched Moller-Trumbore intersection.

    Parameters broadcast elementwise; returns ``(t, beta, gamma, hit)`` where
    ``t`` is the ray-parameter distance (``INF`` when no hit), and ``beta`` /
    ``gamma`` are the barycentric weights of vertices b and c.

    Semantics match the reference solve (``triangle.cpp:158-190``):
    * barycentric tests biased by ``eps`` in favour of a hit,
    * a hit requires ``t >= 0`` (``triangle.cpp:8-10``); grazing/parallel rays
      yield non-finite ``t`` and are rejected.
    """
    pvec = pmath.cross(dirn, e2)
    det = pmath.dot(e1, pvec)
    # Guard the divide so reverse-mode AD through degenerate (padding /
    # exactly-parallel) triangles stays NaN-free; the `ok &= ~degenerate`
    # below reproduces the unguarded forward outcome exactly (det == 0 used
    # to give non-finite t, rejected by isfinite).
    degenerate = det == 0.0
    inv_det = 1.0 / jnp.where(degenerate, 1.0, det)
    tvec = orig - a
    beta = pmath.dot(tvec, pvec) * inv_det
    qvec = pmath.cross(tvec, e1)
    gamma = pmath.dot(dirn, qvec) * inv_det
    t = pmath.dot(e2, qvec) * inv_det

    ok = (
        (beta >= -eps)
        & (beta <= 1.0 + eps)
        & (gamma >= -eps)
        & (beta + gamma <= 1.0 + eps)
        & (t >= 0.0)
        & jnp.isfinite(t)
        & ~degenerate
    )
    t = jnp.where(ok, t, INF)
    return t, beta, gamma, ok


def aabb_intersect(orig, dirn, box_min, box_max):
    """Slab test (reference ``geometry/aabb.cpp:40-68``).

    Returns ``(near, far, hit)``; ``hit`` is true when the ray segment
    ``[max(near, 0), far]`` is non-empty.  ``dirn`` need not avoid zeros —
    IEEE inf semantics give the correct open-slab behaviour, with the
    NaN-from-0*inf case resolved in favour of the other axes.
    """
    inv_d = 1.0 / dirn
    t0 = (box_min - orig) * inv_d
    t1 = (box_max - orig) * inv_d
    # NaNs (origin exactly on a slab with zero direction) must not poison the
    # reduce: replace with +/-inf so min/max ignore them.
    tmin = jnp.where(jnp.isnan(t0), -jnp.inf, jnp.minimum(t0, t1))
    tmax = jnp.where(jnp.isnan(t1), jnp.inf, jnp.maximum(t0, t1))
    tmax = jnp.where(jnp.isnan(tmax), jnp.inf, tmax)
    tmin = jnp.where(jnp.isnan(tmin), -jnp.inf, tmin)
    near = jnp.max(tmin, axis=-1)
    far = jnp.min(tmax, axis=-1)
    hit = (far >= jnp.maximum(near, 0.0)) & (far >= 0.0)
    return near, far, hit


def transform_ray(orig, dirn, basis, origin):
    """Apply an affine transform (3x3 ``basis`` + ``origin``) to a ray and
    re-normalize the direction — the reference's ``ray::transform``
    (``geometry/ray.cpp:10-15``) with the always-normalized-direction invariant
    of the ray constructor (``ray.cpp:6-8``)."""
    new_orig = pmath.apply_basis(orig, basis) + origin
    new_dir = pmath.normalize(pmath.apply_basis(dirn, basis))
    return new_orig, new_dir


def pad_triangles(a, e1, e2, multiple: int = 128):
    """Pad a triangle soup to ``multiple`` with degenerate (never-hit) slots.

    Static shapes keep XLA from recompiling per scene and keep the trailing
    dims tile-aligned for the Pallas kernels.
    """
    import numpy as np

    n = a.shape[0]
    n_pad = (-n) % multiple
    if n_pad:
        za = np.zeros((n_pad, 3), a.dtype)
        a = np.concatenate([a, za])
        e1 = np.concatenate([e1, za])
        e2 = np.concatenate([e2, za])
    valid = np.arange(n + n_pad) < n
    return a, e1, e2, valid
