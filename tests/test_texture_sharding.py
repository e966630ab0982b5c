"""Texture sharding along the scene (tp) axis.

The reference partitions *texture bytes* across workers (the partitioner
budgets by per-primitive texture size via ``head_object``,
``preprocessor.py:104-111``) and each worker downloads only its shard's
textures (``load_gltf.cpp:142-162``).  The SPMD analog
(``ptx.parallel.shard_scene.build_texture_shards``): whole textures
bin-packed into tp balanced bins, the texel pack sharded along the scene
axis, and every bilinear gather masked to the local range + psum'd across
tp (``ptx.scene.textures.sample_texture``).  The invariant tested here:
sharded-pack renders match replicated-pack renders bit-for-bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ptx import render as R
from ptx.config import RenderConfig
from ptx.parallel import dist, mesh as pmesh
from ptx.parallel.shard_scene import build_texture_shards, texture_bins
from ptx.scene import textures
from ptx.scene.flatten import flatten
from ptx.scene.synthetic import make_textured_quads

# One device's memory for the planner (the CPU reports none).
MEM = 16 * 2**30

JACK = "/root/reference/path-tracer-core/scenes/jack-of-blades/jack-of-blades.gltf"


def textured_scene(n_textures=3):
    return flatten(make_textured_quads(n_textures))


def test_texture_bins_balanced():
    assign = texture_bins([100, 1, 1, 50, 49, 1], tp=2)
    totals = [0, 0]
    for s, b in zip([100, 1, 1, 50, 49, 1], assign):
        totals[b] += s
    assert abs(totals[0] - totals[1]) <= 2
    # Every texture lands in exactly one bin.
    assert set(assign) <= {0, 1}


def test_build_texture_shards_preserves_samples():
    """Offsets rewritten into the stacked layout must resolve every sample
    to the same texel values (static=None path: the global pack is just
    reordered/padded)."""
    fs, static = textured_scene()
    fs2, static2 = build_texture_shards(fs, static, tp=2)
    assert static2.tex_shard_len > 0
    assert fs2.tex_texels.shape[0] == 2 * static2.tex_shard_len
    uv = jnp.asarray(np.random.default_rng(0).uniform(0, 1, (64, 2)), jnp.float32)
    for t in range(int(np.asarray(fs.tex_offset).shape[0])):
        tex = jnp.full((64,), t, jnp.int32)
        a = textures.sample_texture(fs, tex, uv)
        b = textures.sample_texture(fs2, tex, uv)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_planner_flips_shard_textures_when_texels_dominate():
    # Tiny geometry + a texel pack far past the per-chip budget.
    p = pmesh.plan(n_tris=1024, n_devices=8, memory_bytes=MEM, n_texels=500_000_000)
    assert p.scene_sharded and p.shard_textures
    # Small pack stays replicated.
    p = pmesh.plan(n_tris=1024, n_devices=8, memory_bytes=MEM, n_texels=1000)
    assert not p.shard_textures


@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_textures_match_replicated(tp):
    fs, static = textured_scene()
    cfg = RenderConfig(width=16, height=16, samples=2, bounces=2,
                       intersector="brute", environment_factor=(0.0, 0.0, 0.0))
    plan_rep = pmesh.Plan(dp=8 // tp, tp=tp, scene_sharded=True,
                          shard_textures=False)
    plan_shd = pmesh.Plan(dp=8 // tp, tp=tp, scene_sharded=True,
                          shard_textures=True)
    mesh_dev = pmesh.make_mesh(plan_rep)
    rep = dist.render_distributed(fs, static, cfg, plan=plan_rep,
                                  mesh=mesh_dev)
    shd = dist.render_distributed(fs, static, cfg, plan=plan_shd,
                                  mesh=mesh_dev)
    np.testing.assert_array_equal(rep.color, shd.color)

    single = R.render(fs, static, cfg)
    np.testing.assert_allclose(shd.color, single.color, rtol=1e-5, atol=1e-6)


def test_ring_comm_with_sharded_textures_raises():
    fs, static = textured_scene()
    cfg = RenderConfig(width=16, height=16, samples=1, bounces=2,
                       intersector="brute")
    plan = pmesh.Plan(dp=4, tp=2, scene_sharded=True, shard_textures=True)
    with pytest.raises(ValueError, match="ring"):
        dist.render_distributed(fs, static, cfg, plan=plan,
                                mesh=pmesh.make_mesh(plan), comm="ring")


def test_jack_tp2_sharded_pack_bitmatch():
    """The real textured scene: jack-of-blades under tp=2 with the texel
    pack sharded matches the replicated-pack render bit-for-bit (VERDICT
    round-2 'done' criterion)."""
    fs, static = R.load_scene(JACK)
    cfg = RenderConfig(width=48, height=36, samples=1, bounces=2,
                       intersector="bvh")
    plan_rep = pmesh.Plan(dp=4, tp=2, scene_sharded=True, shard_textures=False)
    plan_shd = pmesh.Plan(dp=4, tp=2, scene_sharded=True, shard_textures=True)
    mesh_dev = pmesh.make_mesh(plan_rep)
    rep = dist.render_distributed(fs, static, cfg, plan=plan_rep, mesh=mesh_dev)
    shd = dist.render_distributed(fs, static, cfg, plan=plan_shd, mesh=mesh_dev)
    np.testing.assert_array_equal(rep.color, shd.color)


def test_oversized_texture_mips_and_round_trips_tp2():
    """VERDICT r4 #8: a 4096x4096 texture (2^24 texels — past exact float32
    addressing) must LOAD (box-mipped at flatten with a warning, matching
    the reference's stream-any-size behavior, load_gltf.cpp:142-162),
    render, and round-trip under tp=2 texture sharding."""
    from ptx.scene.flatten import TEXEL_LIMIT
    from ptx.scene.synthetic import make_textured_quads

    scene = make_textured_quads(2)
    # Blow up texture 0 to exactly 2^24 texels: a smooth gradient so the
    # mip keeps recognizable content.
    y = np.linspace(0.0, 1.0, 4096, dtype=np.float32)
    big = np.empty((4096, 4096, 4), np.float32)
    big[..., 0] = y[:, None]
    big[..., 1] = y[None, :]
    big[..., 2] = 0.25
    big[..., 3] = 1.0
    scene.images[0].pixels = big

    with pytest.warns(UserWarning, match="box-mipped"):
        fs, static = flatten(scene)
    sizes = np.asarray(fs.tex_width).astype(np.int64) * np.asarray(fs.tex_height)
    assert sizes.max() < TEXEL_LIMIT
    # Texture 0 is slot 2 (after the white + flat-normal builtins): mipped
    # one level to 2048x2048, the rest untouched.
    assert int(np.asarray(fs.tex_width)[2]) == 2048

    cfg = RenderConfig(width=16, height=16, samples=1, bounces=2,
                       intersector="brute", environment_factor=(0.0, 0.0, 0.0))
    single = R.render(fs, static, cfg)
    assert np.isfinite(np.asarray(single.color)).all()
    assert np.asarray(single.color).max() > 0

    plan_rep = pmesh.Plan(dp=4, tp=2, scene_sharded=True, shard_textures=False)
    plan_shd = pmesh.Plan(dp=4, tp=2, scene_sharded=True, shard_textures=True)
    mesh_dev = pmesh.make_mesh(plan_rep)
    rep = dist.render_distributed(fs, static, cfg, plan=plan_rep, mesh=mesh_dev)
    shd = dist.render_distributed(fs, static, cfg, plan=plan_shd, mesh=mesh_dev)
    np.testing.assert_array_equal(rep.color, shd.color)
    np.testing.assert_allclose(shd.color, single.color, rtol=1e-5, atol=1e-6)


def test_mip_box_filter_values():
    """One mip level is the exact 2x2 average; odd trailing row/col crops."""
    from ptx.scene.flatten import _mip_once

    px = np.arange(4 * 4 * 1, dtype=np.float32).reshape(4, 4, 1)
    m = _mip_once(px)
    assert m.shape == (2, 2, 1)
    np.testing.assert_allclose(m[0, 0, 0], (0 + 1 + 4 + 5) / 4.0)
    np.testing.assert_allclose(m[1, 1, 0], (10 + 11 + 14 + 15) / 4.0)
    # 5x3 -> crops to 4x2 -> 2x1
    odd = np.ones((5, 3, 4), np.float32)
    assert _mip_once(odd).shape == (2, 1, 4)
