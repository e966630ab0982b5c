"""Pinhole camera ray generation.

Counterpart of ``scene::camera::get_ray`` (``scene/camera.cpp:10-21``) plus
the worker's NDC/jitter conventions (``worker.cpp:114-149``): vertical FOV,
aspect applied to x, NDC y flipped, direction normalized, then transformed by
the camera's world basis.  Vectorized over a whole wavefront of pixel ids.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ptx import math as pmath
from ptx import sampling
from ptx.scene.flatten import FlatScene


def generate_rays(
    fs: FlatScene,
    pixel_ids,
    sample_ids,
    width: int,
    height: int,
    seed: int = 0,
    first_sample_centered: bool = True,
    transparent_background: bool = False,
):
    """Build primary rays for flat ``pixel_ids`` (= y * width + x) and
    ``sample_ids``.

    Jitter semantics follow the wavefront worker (``worker.cpp:125-129``):
    sample 0 is unjittered unless the background is transparent (the
    consistent alpha mask needed for claim-blending).
    Returns ``(origins [R,3], directions [R,3])``.
    """
    x = (pixel_ids % width).astype(jnp.float32)
    y = (pixel_ids // width).astype(jnp.float32)

    jx = sampling.uniform(pixel_ids, sample_ids, 0, sampling.P_AA_JITTER_X, seed)
    jy = sampling.uniform(pixel_ids, sample_ids, 0, sampling.P_AA_JITTER_Y, seed)
    if first_sample_centered and not transparent_background:
        centered = sample_ids == 0
        jx = jnp.where(centered, 0.0, jx)
        jy = jnp.where(centered, 0.0, jy)

    ndc_x = ((x + jx) / width) * 2.0 - 1.0
    ndc_y = -(((y + jy) / height) * 2.0 - 1.0)
    ratio = width / height

    tan_half = fs.cam_tan_half_fov
    d_cam = jnp.stack(
        [
            tan_half * ndc_x * ratio,
            tan_half * ndc_y,
            -jnp.ones_like(ndc_x),
        ],
        axis=-1,
    )
    d_cam = pmath.normalize(d_cam)
    d_world = pmath.normalize(pmath.apply_basis(d_cam, fs.cam_basis))
    origins = jnp.broadcast_to(fs.cam_origin, d_world.shape)
    return origins, d_world
