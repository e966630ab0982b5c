"""Counter-based RNG and PBR importance sampling / BRDF terms.

Replaces two reference subsystems with SPMD-idiomatic equivalents:

* the thread-local ``std::mt19937`` uniform RNG (``core/utils.hpp:8-13``) becomes
  a *counter-based* stateless hash RNG (PCG4D).  Every uniform draw is keyed by
  ``(pixel_id, sample_id, bounce, purpose, seed)`` so the stream is identical
  regardless of how rays are sharded across chips — the property that makes
  distributed renders bit-reproducible and testable.
* the BRDF math of ``core/pbr.cpp`` (Schlick fresnel, cosine-hemisphere and GGX
  half-vector importance sampling with the reference's alpha = roughness^4
  convention, Smith geometry with k = (r+1)^2/8, and the NDF-based specular pdf)
  re-expressed as batched pure functions.

All functions broadcast over leading axes and fuse into the integrator under
``jit``; nothing here allocates state.
"""

from __future__ import annotations

import jax.numpy as jnp

from ptx import math as pmath

# Purpose salts for decorrelated streams per use-site (arbitrary constants).
P_AA_JITTER_X = 0x01
P_AA_JITTER_Y = 0x02
P_SUN_PHI = 0x03
P_SUN_THETA = 0x04
P_OPACITY = 0x05
P_LOBE = 0x06
P_BRDF_U = 0x07
P_BRDF_V = 0x08
P_RR = 0x09


def _pcg4d(v0, v1, v2, v3):
    """PCG4D hash (Jarzynski & Olano, "Hash Functions for GPU Rendering").

    uint32x4 -> uint32x4 with good avalanche; the standard shader-style
    counter RNG.  Inputs/outputs are uint32 arrays of a common shape.
    """
    v0 = v0 * jnp.uint32(1664525) + jnp.uint32(1013904223)
    v1 = v1 * jnp.uint32(1664525) + jnp.uint32(1013904223)
    v2 = v2 * jnp.uint32(1664525) + jnp.uint32(1013904223)
    v3 = v3 * jnp.uint32(1664525) + jnp.uint32(1013904223)
    v0 = v0 + v1 * v3
    v1 = v1 + v2 * v0
    v2 = v2 + v0 * v1
    v3 = v3 + v1 * v2
    v0 = v0 ^ (v0 >> 16)
    v1 = v1 ^ (v1 >> 16)
    v2 = v2 ^ (v2 >> 16)
    v3 = v3 ^ (v3 >> 16)
    v0 = v0 + v1 * v3
    v1 = v1 + v2 * v0
    v2 = v2 + v0 * v1
    v3 = v3 + v1 * v2
    return v0, v1, v2, v3


def uniform(pixel_id, sample_id, bounce, purpose, seed=0):
    """Deterministic uniform in [0, 1) keyed by the full ray coordinate.

    ``pixel_id``/``sample_id`` are int arrays (broadcast together);
    ``bounce``/``purpose``/``seed`` are python ints or scalar arrays.
    """
    a = jnp.asarray(pixel_id).astype(jnp.uint32)
    b = jnp.asarray(sample_id).astype(jnp.uint32)
    c = (jnp.asarray(bounce).astype(jnp.uint32) << 8) | jnp.uint32(purpose)
    d = jnp.uint32(seed) ^ jnp.uint32(0x9E3779B9)
    a, b, c, d = jnp.broadcast_arrays(a, b, c, jnp.broadcast_to(d, a.shape))
    h0, _, _, _ = _pcg4d(a, b, c, d)
    # 24 high-quality mantissa bits -> [0, 1).
    return (h0 >> 8).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))


# ---------------------------------------------------------------------------
# Sampling primitives
# ---------------------------------------------------------------------------


def cone_vec(u, cos_theta, axis):
    """Random vector in the cone of half-angle ``acos(cos_theta)`` around
    ``axis`` — exact re-statement of ``util::rand_cone_vec``
    (``util/rand_cone_vec.cpp:8-35``): uniform azimuth ``phi = 2*pi*u`` at polar
    angle ``theta``, rotated into a TBN basis built from a non-parallel axis.
    """
    phi = u * (2.0 * pmath.PI)
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - cos_theta * cos_theta, 0.0))
    lx = jnp.cos(phi) * sin_theta
    ly = jnp.sin(phi) * sin_theta
    lz = cos_theta
    tangent, binormal = pmath.orthonormal_basis(axis)
    return (
        tangent * lx[..., None] + binormal * ly[..., None] + axis * lz[..., None]
    )


def importance_diffuse(u1, u2, normal):
    """Cosine-weighted hemisphere direction about ``normal``.

    Matches ``importance_lambert`` (``core/pbr.cpp:71-77``):
    ``theta = acos(2*u1 - 1) / 2`` gives ``cos(theta) = sqrt(u1)`` by the
    half-angle identity — the standard cosine-weighted polar CDF — then a
    uniform-azimuth cone vector.  (sqrt form: fewer transcendentals, and the
    Pallas kernel path has no acos.)
    """
    return cone_vec(u2, jnp.sqrt(jnp.clip(u1, 0.0, 1.0)), normal)


def importance_specular(u1, u2, normal, outcoming, roughness):
    """GGX half-vector importance sample, reflected about the half vector.

    Matches ``importance_ggx`` (``core/pbr.cpp:79-91``) including the
    reference's ``alpha = roughness^4`` convention.
    """
    a = roughness * roughness
    a = a * a
    cos_theta = jnp.sqrt(
        jnp.clip((1.0 - u1) / (1.0 + (a - 1.0) * u1), 0.0, 1.0)
    )
    halfway = cone_vec(u2, cos_theta, normal)
    return pmath.reflect(-outcoming, halfway)


# ---------------------------------------------------------------------------
# BRDF terms
# ---------------------------------------------------------------------------


def fresnel(outcoming, incoming, ior):
    """Schlick fresnel with the halfway vector as the micro-normal
    (``core/pbr.cpp:14-26``)."""
    halfway = pmath.normalize(outcoming + incoming)
    cos_theta = pmath.dot(outcoming, halfway)
    f0 = (ior - 1.0) / (ior + 1.0)
    f0 = f0 * f0
    return pmath.lerp(f0, 1.0, jnp.power(jnp.maximum(1.0 - cos_theta, 0.0), 5.0))


def _smith_g1(normal, light_dir, k):
    cos_theta = pmath.dot(normal, light_dir)
    return cos_theta / jnp.maximum(pmath.lerp(k, 1.0, cos_theta), pmath.EPS)


def geometry_smith(normal, outcoming, incoming, roughness):
    """Smith geometric occlusion with ``k = (r + 1)^2 / 8``
    (``core/pbr.cpp:95-114``)."""
    r = roughness + 1.0
    k = (r * r) / 8.0
    return _smith_g1(normal, outcoming, k) * _smith_g1(normal, incoming, k)


def distribution_ggx(normal, outcoming, incoming, roughness):
    """GGX NDF *including* the reference's extra ``cos_theta_i`` factor
    (``core/pbr.cpp:125-143``), with ``alpha = roughness^4``."""
    a = roughness * roughness
    a = a * a
    halfway = pmath.normalize(outcoming + incoming)
    cos_phi = pmath.dot(normal, halfway)
    denom = pmath.lerp(1.0, a, cos_phi * cos_phi)
    cos_theta = pmath.dot(normal, incoming)
    return cos_theta * a / jnp.maximum(pmath.PI * denom * denom, pmath.EPS)


def pdf_diffuse(normal, incoming):
    """Cosine-weighted pdf ``cos(theta)/pi`` (``core/pbr.cpp:118-123``)."""
    return pmath.dot(normal, incoming) / pmath.PI


def pdf_specular(normal, outcoming, incoming, roughness):
    """``D * G / (4 (n.o)(n.i))`` (``core/pbr.cpp:170-184``)."""
    dist = distribution_ggx(normal, outcoming, incoming, roughness)
    geo = geometry_smith(normal, outcoming, incoming, roughness)
    n_dot_o = pmath.dot(normal, outcoming)
    n_dot_i = pmath.dot(normal, incoming)
    return (dist * geo) / jnp.maximum(4.0 * n_dot_o * n_dot_i, pmath.EPS)
