"""Vector math, tonemapping and projection helpers.

Array counterpart of the reference's templated C++ math library
(``path_tracer_lib/path_tracer/math/``, ~3k LoC) and the small helpers in
``core/utils.hpp``.  Here every "vec3" is simply a trailing dimension of a
batched ``jnp`` array, so the whole library collapses into a handful of pure
functions that ``vmap``/XLA fuse into the surrounding kernels.

Conventions
-----------
* Vectors are arrays whose *last* axis is the component axis (``[..., 3]``).
* All functions are shape-polymorphic over leading (batch) axes.
* ``EPS`` mirrors ``math::epsilon = 1e-4`` (reference ``math/math.hpp:16``).
"""

from __future__ import annotations

import jax.numpy as jnp

# Reference: math/math.hpp:16 (`constexpr float epsilon = 1e-4F`).
EPS = 1e-4
PI = 3.14159265358979323846
INV_SQRT3 = 0.5773502691896258  # 1/sqrt(3), used by the cone-basis pick.


def dot(a, b):
    """Batched dot product over the trailing component axis."""
    return jnp.sum(a * b, axis=-1)


def vdot(a, b):
    """Like :func:`dot` but keeps the trailing axis (shape ``[..., 1]``)."""
    return jnp.sum(a * b, axis=-1, keepdims=True)


def cross(a, b):
    """Batched 3-D cross product (explicit form — avoids jnp.cross overhead)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return jnp.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], axis=-1
    )


def apply_basis(v, basis):
    """``v @ basis.T`` for ``[..., 3]`` vectors and a 3x3 ``basis``, written
    as explicit float32 multiply-adds: the same instructions for every
    element whatever the batch shape, where a matrix product would go to a
    GEMM routine chosen per shape (and possibly in TF32)."""
    return (v[..., 0:1] * basis[:, 0] + v[..., 1:2] * basis[:, 1]
            + v[..., 2:3] * basis[:, 2])


def length(a):
    return jnp.sqrt(jnp.sum(a * a, axis=-1))


def normalize(a, eps: float = 1e-20):
    """Normalize over the trailing axis; safe at zero length."""
    return a * jax_rsqrt(jnp.maximum(jnp.sum(a * a, axis=-1, keepdims=True), eps))


def jax_rsqrt(x):
    import jax.lax as lax

    return lax.rsqrt(x)


def lerp(a, b, t):
    """Linear interpolation ``a + (b - a) * t`` (reference ``math.inl``)."""
    return a + (b - a) * t


def saturate(x):
    return jnp.clip(x, 0.0, 1.0)


def reflect(incident, normal):
    """Mirror ``incident`` about ``normal`` (reference ``core/utils.hpp:39-41``)."""
    return incident - 2.0 * vdot(normal, incident) * normal


def tonemap_approx_aces(hdr):
    """ACES filmic approximation (reference ``core/utils.hpp:29-37``)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return saturate((hdr * (a * hdr + b)) / (hdr * (c * hdr + d) + e))


def equirectangular_proj(direction):
    """Direction -> equirectangular UV (reference ``core/utils.hpp:22-27``)."""
    u = jnp.arctan2(direction[..., 2], direction[..., 0]) * 0.1591 + 0.5
    v = jnp.arcsin(jnp.clip(direction[..., 1], -1.0, 1.0)) * 0.3183 + 0.5
    return jnp.stack([u, v], axis=-1)


def srgb_encode(linear):
    """Linear -> display, gamma 2.2 (reference ``image/image.cpp:145-147``)."""
    return jnp.power(jnp.maximum(linear, 0.0), 1.0 / 2.2)


def srgb_decode(encoded):
    """Display -> linear, gamma 2.2 (reference ``image/image.cpp:138-141``)."""
    return jnp.power(jnp.maximum(encoded, 0.0), 2.2)


def orthonormal_basis(normal):
    """Build (tangent, binormal) for ``normal`` using the reference's
    non-parallel-axis pick (``util/rand_cone_vec.cpp:20-33``): choose the first
    coordinate axis whose component of ``normal`` is below ``1/sqrt(3)``.
    """
    nx, ny, nz = jnp.abs(normal[..., 0]), jnp.abs(normal[..., 1]), jnp.abs(normal[..., 2])
    use_x = nx < INV_SQRT3
    use_y = jnp.logical_and(~use_x, ny < INV_SQRT3)
    ex = jnp.where(use_x, 1.0, 0.0)
    ey = jnp.where(use_y, 1.0, 0.0)
    ez = jnp.where(jnp.logical_or(use_x, use_y), 0.0, 1.0)
    axis = jnp.stack([ex, ey, ez], axis=-1)
    tangent = normalize(cross(normal, axis))
    binormal = cross(normal, tangent)
    return tangent, binormal
