"""Bilinear texture sampling over the flat texel pack.

Counterpart of ``image::image_texture::sample`` (``image/image_texture.cpp:
20-61``): bilinear filtering with wrap addressing and V flip, operating on a
single flat texel buffer with per-texture (offset, width, height) — a
gather-based design so a whole wavefront samples *different* textures in one
vectorized call (no per-material branching).

sRGB decode already happened at load (``gltf.decode_image``), so all texels
are linear.  Channel conventions (G = roughness, B = metallic, normal
``2t - 1``) live in the material accessors in this module, mirroring
``core/material.cpp``.
"""

from __future__ import annotations

import jax.numpy as jnp

from ptx import math as pmath
from ptx.scene.flatten import (
    FlatScene,
    SLOT_ALBEDO,
    SLOT_EMISSIVE,
    SLOT_METALLIC,
    SLOT_NORMAL,
    SLOT_OPACITY,
    SLOT_ROUGHNESS,
)


def sample_texture(fs: FlatScene, tex_idx, uv, static=None):
    """Bilinear sample.  ``tex_idx``: [R] i32 pack slots; ``uv``: [R, 2].
    Returns linear RGBA [R, 4].

    Within-texture index arithmetic is float32 with a single final int cast
    plus one int32 offset add; the float wrap is exact for any
    within-texture index below 2^24 (flatten.py guards per-texture size; the
    pack itself is int32-bounded).

    TEXTURE SHARDING: when ``static.tex_shard_len > 0`` the texel pack is
    split along the scene (tp) axis (whole textures per shard —
    ``ptx.parallel.shard_scene.build_texture_shards``), so this device holds
    only texels ``[axis_index * len, (axis_index + 1) * len)`` of the global
    pack.  ``tex_offset`` stays in *global* coordinates; each corner gather
    is masked to the local range and the bilinear result (all four corners
    of a sample live on one shard, because textures never straddle bins)
    rides ONE ``psum`` over the scene axis — the one-hot reduce that stands
    in for the reference's per-worker texture residency
    (``load_gltf.cpp:142-162``).  Requires rays replicated over tp (the
    "reduce" comm mode); only valid inside ``shard_map``.
    """
    w = fs.tex_width[tex_idx].astype(jnp.float32)
    h = fs.tex_height[tex_idx].astype(jnp.float32)

    # Pixel center with V flip (image_texture.cpp:31-32).
    cx = uv[..., 0] * w - 0.5
    cy = (1.0 - uv[..., 1]) * h - 0.5

    x0 = jnp.floor(cx)
    y0 = jnp.floor(cy)
    dx = cx - x0
    dy = cy - y0

    def fwrap(v, size):
        # float fmod into [0, size): v - size * floor(v / size).
        return v - size * jnp.floor(v / size)

    x0f = fwrap(x0, w)
    x1f = fwrap(x0 + 1.0, w)
    y0f = fwrap(y0, h)
    y1f = fwrap(y0 + 1.0, h)

    shard_len = getattr(static, "tex_shard_len", 0) if static is not None else 0
    if shard_len > 0:
        import jax
        from ptx.parallel.mesh import AXIS_SCENE

        base = jax.lax.axis_index(AXIS_SCENE) * shard_len
        # The stacked pack can exceed the 2^24 f32-exact range, so only the
        # *within-texture* index rides float (exact: one texture < 2^24
        # texels, guarded by build_texture_shards); the texture offset stays
        # int32 — one extra integer add, no integer mod.
        off_i = fs.tex_offset[tex_idx] - base

        def texel(xf, yf):
            local = off_i + (yf * w + xf).astype(jnp.int32)
            ok = (local >= 0) & (local < shard_len)
            v = fs.tex_texels[jnp.clip(local, 0, shard_len - 1)]
            return jnp.where(ok[..., None], v, 0.0)

    else:

        def texel(xf, yf):
            # Only the *within-texture* index rides float32 (exact: one
            # texture < 2^24 texels, guarded at flatten); the pack offset
            # stays int32, so the whole pack may exceed 2^24 texels (sponza's
            # real texture set is 68M texels).
            idx = fs.tex_offset[tex_idx] + (yf * w + xf).astype(jnp.int32)
            return fs.tex_texels[idx]

    tl = texel(x0f, y0f)
    tr = texel(x1f, y0f)
    bl = texel(x0f, y1f)
    br = texel(x1f, y1f)
    top = pmath.lerp(tl, tr, dx[..., None])
    bot = pmath.lerp(bl, br, dx[..., None])
    out = pmath.lerp(top, bot, dy[..., None])
    if shard_len > 0:
        out = jax.lax.psum(out, AXIS_SCENE)
    return out


# ---------------------------------------------------------------------------
# Material accessors (core/material.cpp semantics, vectorized over rays)
# ---------------------------------------------------------------------------


def material_lookup(fs: FlatScene, mat_id, uv, static=None):
    """Fetch all shading inputs for a wavefront of hits.

    ``mat_id``: [R] i32, ``uv``: [R, 2].  Returns a dict of per-ray material
    properties; slots with no texture hit the neutral dummy texels so the
    whole fetch is branch-free.

    Random texel gathers dominate textured shading, so the static facts recorded at flatten time (``SceneStatic.tex_slot_used`` /
    ``opacity_shares_albedo`` / ``metallic_shares_roughness``) prune the
    fetch plan: a slot whose every material points at the dummy texel is a
    multiply-by-one (skipped exactly), and glTF's packing (alpha in
    baseColor, one metallic-roughness map) lets one bilinear sample serve
    two slots. Results are bit-identical to the unpruned fetch.
    """
    used = static.tex_slot_used if static is not None else (True,) * 7
    share_op = static.opacity_shares_albedo if static is not None else False
    share_mr = static.metallic_shares_roughness if static is not None else False

    tex = fs.mat_tex[mat_id] if any(used) else None  # [R, 7]

    # ONE factor gather: all scalar material factors ride the packed
    # [M, 16] row instead of eight separate factor gathers.  Parameter
    # gradients flow through fs.mat_packed, which inject_params mirrors the
    # mat_* leaves into.
    row = fs.mat_packed[mat_id]  # [R, 16]

    alb_rgba = None
    if used[SLOT_ALBEDO] or (used[SLOT_OPACITY] and share_op):
        alb_rgba = sample_texture(fs, tex[..., SLOT_ALBEDO], uv, static)
    albedo = row[..., 0:3]
    if alb_rgba is not None and used[SLOT_ALBEDO]:
        albedo = albedo * alb_rgba[..., :3]

    opacity = row[..., 3]
    if used[SLOT_OPACITY]:
        if share_op:
            # Opacity slot is either the albedo texture or the white dummy
            # (flatten verified this for every material): reconstruct the
            # sample from the albedo fetch.
            op_a = jnp.where(
                tex[..., SLOT_OPACITY] == tex[..., SLOT_ALBEDO],
                alb_rgba[..., 3],
                1.0,
            )
        else:
            op_a = sample_texture(fs, tex[..., SLOT_OPACITY], uv, static)[..., 3]
        opacity = opacity * op_a

    # G channel = roughness, B = metallic (material.cpp:34-44).
    mr = None
    if used[SLOT_ROUGHNESS] or (used[SLOT_METALLIC] and share_mr):
        mr = sample_texture(fs, tex[..., SLOT_ROUGHNESS], uv, static)
    roughness = row[..., 4]
    if mr is not None and used[SLOT_ROUGHNESS]:
        roughness = roughness * mr[..., 1]
    metallic = row[..., 5]
    if used[SLOT_METALLIC]:
        mb = mr if share_mr else sample_texture(fs, tex[..., SLOT_METALLIC], uv, static)
        metallic = metallic * mb[..., 2]

    emissive = row[..., 6:9]
    if used[SLOT_EMISSIVE]:
        emissive = emissive * sample_texture(fs, tex[..., SLOT_EMISSIVE], uv, static)[..., :3]

    # Normal map decode 2t - 1 (material.cpp:6-11).
    if used[SLOT_NORMAL]:
        tangent_normal = sample_texture(fs, tex[..., SLOT_NORMAL], uv, static)[..., :3] * 2.0 - 1.0
    else:
        tangent_normal = jnp.broadcast_to(
            jnp.array([0.0, 0.0, 1.0], jnp.float32), uv.shape[:-1] + (3,)
        )

    return dict(
        albedo=albedo,
        opacity=opacity,
        roughness=roughness,
        metallic=metallic,
        emissive=emissive,
        tangent_normal=tangent_normal,
        ior=row[..., 9],
        shadow_catcher=row[..., 10],
    )
