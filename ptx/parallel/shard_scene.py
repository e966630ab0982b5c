"""Shard-local scene building for the scene-parallel (``tp``) axis.

The reference's scene parallelism assigns each worker a primitive subset and
the worker builds its own acceleration structures over *exactly that subset*
(``preprocessor.py:43-69``, ``load_gltf.cpp:95-105`` filtering by
``scene_work``, per-primitive KD build at ``load_gltf.cpp:250-251``).  The
SPMD analog: split the flattened triangle soup into ``tp`` contiguous chunks,
build a *per-shard* BVH over each chunk, and stack the shard-local arrays so
that after ``shard_map`` splits them along the scene axis, every device holds
a self-contained mini-scene — leaf ranges (``bvh_first``) index the device's
*local* triangle arrays.

This replaces round 1's broken layout (global BVH replicated over sharded
triangle arrays: leaf ranges indexed the wrong shard-local triangles,
silently rendering a wrong image for ``intersector="bvh"`` + ``tp > 1``).

Everything here is host-side numpy, run once at scene setup (the
preprocessor's role); device placement happens in
:func:`ptx.parallel.mesh.shard_scene`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from ptx.accel.bvh import TRI_FIELDS, build_bvh
from ptx.config import RenderConfig
from ptx.parallel.mesh import Plan
from ptx.scene.flatten import FlatScene, SceneStatic

# Fields attached by per-shard BVH builds (stacked along the scene axis).
BVH_FIELDS = ("bvh_min", "bvh_max", "bvh_first", "bvh_count", "bvh_miss")

_INF = np.float32(3.0e38)


def shard_ranges(n_tris: int, tp: int) -> List[Tuple[int, int]]:
    """Contiguous, balanced triangle ranges — the greedy equal-count split of
    the reference partitioner (``preprocessor.py:64-69`` count mode), at
    triangle rather than primitive granularity."""
    q = -(-n_tris // tp) if n_tris else 0
    return [(min(i * q, n_tris), min((i + 1) * q, n_tris)) for i in range(tp)]


def _empty_bvh():
    """A 1-node BVH that can never be entered: empty box (lo > hi) fails the
    slab test, and the root's escape link terminates traversal immediately."""
    return (
        np.full((1, 3), _INF, np.float32),     # bvh_min
        np.full((1, 3), -_INF, np.float32),    # bvh_max
        np.zeros(1, np.int32),                 # bvh_first
        np.zeros(1, np.int32),                 # bvh_count
        np.full(1, -1, np.int32),              # bvh_miss
    )


def _needs_bvh(static_local: SceneStatic, cfg: RenderConfig) -> bool:
    """Mirror of ``ptx.render.ensure_accel``'s decision, resolved against the
    *per-shard* view (what ``make_distributed_sample_fn`` will resolve with):
    both walks need nodes."""
    from ptx.render import resolve_intersector

    return resolve_intersector(static_local, cfg) in ("bvh", "pallas")


def build_shard_scene(
    fs: FlatScene,
    static: SceneStatic,
    plan: Plan,
    cfg: RenderConfig,
    pad_multiple: int = 256,
) -> Tuple[FlatScene, SceneStatic]:
    """Split the scene into ``plan.tp`` shard-local chunks (host-side).

    Returns ``(fs_stacked, static_local)``:

    * ``fs_stacked`` — triangle fields reshaped to ``[tp * per_shard_padded]``
      (shard i's chunk at offset ``i * per_shard_padded``) and, when the
      resolved backend wants one, per-shard BVH node arrays stacked to
      ``[tp * n_nodes_padded]``.  Place with
      ``mesh.shard_scene(..., shard_bvh=static_local.n_bvh_nodes > 0)``.
    * ``static_local`` — describes the *per-device* view seen inside
      ``shard_map``: ``n_tris_padded`` is the shard length, ``n_bvh_nodes``
      the padded per-shard node count.  Scene bounds stay global (ray
      sorting/parking span the whole scene).
    """
    tp = plan.tp
    if tp <= 1:
        raise ValueError("build_shard_scene requires a scene-sharded plan")

    host = jax_to_numpy(fs)
    n = static.n_tris
    ranges = shard_ranges(n, tp)
    counts = [stop - start for start, stop in ranges]
    per_pad = max(pad_multiple, -(-max(counts) // pad_multiple) * pad_multiple)

    want_bvh = _needs_bvh(
        dataclasses.replace(static, n_tris=max(counts), n_tris_padded=per_pad),
        cfg,
    )

    shard_tri: List[dict] = []
    shard_bvh: List[tuple] = []
    for (start, stop), count in zip(ranges, counts):
        fields = {}
        for f in TRI_FIELDS:
            src = getattr(host, f)
            out = np.zeros((per_pad,) + src.shape[1:], src.dtype)
            out[:count] = src[start:stop]
            fields[f] = out
        fields["tri_valid"] = np.arange(per_pad) < count

        if want_bvh and count > 0:
            sub_fs = host._replace(**fields)
            sub_static = dataclasses.replace(
                static, n_tris=count, n_tris_padded=per_pad, n_bvh_nodes=0
            )
            sub_fs, sub_static = build_bvh(
                sub_fs, sub_static, leaf_size=static.bvh_leaf_size or 8
            )
            fields = {f: np.asarray(getattr(sub_fs, f)) for f in TRI_FIELDS}
            shard_bvh.append(
                tuple(np.asarray(getattr(sub_fs, f)) for f in BVH_FIELDS)
            )
        elif want_bvh:
            shard_bvh.append(_empty_bvh())
        shard_tri.append(fields)

    stacked = {
        f: np.concatenate([s[f] for s in shard_tri], axis=0)
        for f in TRI_FIELDS
    }

    n_nodes = 0
    if want_bvh:
        n_nodes = max(b[0].shape[0] for b in shard_bvh)
        padded = []
        for bmn, bmx, first, cnt, miss in shard_bvh:
            k = bmn.shape[0]
            if k < n_nodes:
                # Tail nodes are unreachable (links never point past the
                # shard's real node set); empty boxes keep them inert even so.
                bmn = np.concatenate([bmn, np.full((n_nodes - k, 3), _INF, np.float32)])
                bmx = np.concatenate([bmx, np.full((n_nodes - k, 3), -_INF, np.float32)])
                first = np.concatenate([first, np.zeros(n_nodes - k, np.int32)])
                cnt = np.concatenate([cnt, np.zeros(n_nodes - k, np.int32)])
                miss = np.concatenate([miss, np.full(n_nodes - k, -1, np.int32)])
            padded.append((bmn, bmx, first, cnt, miss))
        for i, f in enumerate(BVH_FIELDS):
            stacked[f] = np.concatenate([p[i] for p in padded], axis=0)

    fs_stacked = host._replace(**stacked)
    static_local = dataclasses.replace(
        static,
        n_tris=max(counts),
        n_tris_padded=per_pad,
        n_bvh_nodes=n_nodes,
        shard_local=True,
    )
    return fs_stacked, static_local


def jax_to_numpy(fs: FlatScene) -> FlatScene:
    return FlatScene(*(np.asarray(x) for x in fs))


def texture_bins(sizes: List[int], tp: int) -> List[int]:
    """Greedy balanced bin assignment: textures (by texel count) land in the
    currently-lightest of ``tp`` bins, largest first — the equal-*bytes*
    split of the reference partitioner (``preprocessor.py:104-111`` budgets
    by texture byte length via ``head_object``).  Returns bin index per
    texture."""
    order = sorted(range(len(sizes)), key=lambda i: -sizes[i])
    totals = [0] * tp
    assign = [0] * len(sizes)
    for i in order:
        b = totals.index(min(totals))
        assign[i] = b
        totals[b] += sizes[i]
    return assign


def build_texture_shards(
    fs: FlatScene,
    static: SceneStatic,
    tp: int,
    pad_multiple: int = 8,
) -> Tuple[FlatScene, SceneStatic]:
    """Split the texel pack into ``tp`` whole-texture bins (host-side).

    The reference shards *texture bytes* across workers — the partitioner
    budgets by per-primitive texture size (``preprocessor.py:104-111``) and
    each worker downloads only its shard's textures
    (``load_gltf.cpp:142-162``).  The SPMD analog: bin-pack whole textures
    into ``tp`` balanced bins, rebuild the pack as ``[tp * per_shard, 4]``
    with bin ``b``'s textures contiguous at global offset ``b * per_shard``,
    and shard it along the scene axis.  ``tex_offset`` stays global, so
    addressing in :func:`ptx.scene.textures.sample_texture` is unchanged;
    sharded gathers mask to the local range and psum across tp.

    Whole-texture bins guarantee all four bilinear corners of any sample
    live on one shard (the lerp happens before the psum).  Returns
    ``(fs, static)`` with the rebuilt pack/offsets and
    ``static.tex_shard_len = per_shard``.
    """
    if tp <= 1:
        raise ValueError("build_texture_shards requires tp > 1")
    texels = np.asarray(fs.tex_texels)
    offsets = np.asarray(fs.tex_offset)
    widths = np.asarray(fs.tex_width)
    heights = np.asarray(fs.tex_height)
    sizes = (widths.astype(np.int64) * heights).tolist()

    assign = texture_bins(sizes, tp)
    bin_totals = [0] * tp
    for i, b in enumerate(assign):
        bin_totals[b] += sizes[i]
    per_shard = max(pad_multiple, -(-max(bin_totals) // pad_multiple) * pad_multiple)

    # Sharded addressing keeps the texture offset in int32 and only the
    # within-texture index in float32 (sample_texture), so the exactness
    # guard is per-texture, not per-pack; int32 bounds the stacked pack.
    if sizes and max(sizes) >= (1 << 24):
        # flatten() box-mips every texture below 2^24 at load
        # (ptx.scene.flatten.mip_to_limit), so this only fires on
        # hand-built FlatScenes that skipped it.
        raise ValueError(
            f"largest texture has {max(sizes)} texels (>= 2^24); float32 "
            "within-texture addressing would lose exactness — flatten() "
            "mips oversized textures, route loading through it"
        )
    if tp * per_shard >= (1 << 31):
        raise ValueError("stacked texel pack exceeds int32 addressing")

    new_texels = np.zeros((tp * per_shard, 4), np.float32)
    new_offsets = np.zeros_like(offsets)
    cursors = [b * per_shard for b in range(tp)]
    for i, b in enumerate(assign):
        new_offsets[i] = cursors[b]
        new_texels[cursors[b] : cursors[b] + sizes[i]] = texels[
            offsets[i] : offsets[i] + sizes[i]
        ]
        cursors[b] += sizes[i]

    fs = fs._replace(tex_texels=new_texels, tex_offset=new_offsets)
    static = dataclasses.replace(static, tex_shard_len=per_shard)
    return fs, static
