"""sponza-new — the reference's default worker fixture
(``path-tracer-core/events/event.json:8-36``) and largest bundled asset.

The reference ships only sponza's glTF JSON + 38 MB of textures; the 11.9 MB
geometry buffer is downloaded from S3 at run time and is NOT in the repo, so
the scene cannot load as authored.  Structure-level coverage (partitioner,
planner, texture pack) runs on the REAL files; load/render coverage runs on
the deterministic stand-in geometry (``ptx.scene.standin``) wired into the
real material/texture/sun metadata.
"""

import numpy as np
import pytest

from ptx import render as R
from ptx.config import RenderConfig
from ptx.parallel import mesh as pmesh, partition
from ptx.scene.standin import SPONZA_DIR, sponza_standin

# One device's memory for the planner (the CPU reports none).
MEM = 16 * 2**30

SPONZA_GLTF = SPONZA_DIR + "/scene.gltf"
N_PRIMS = 24
N_TRIS = 262267
N_TEXELS = 68157458  # 65 x 1024^2 + 4^2 + 2 dummy slots


@pytest.fixture(scope="module")
def sponza(tmp_path_factory):
    path = sponza_standin(str(tmp_path_factory.mktemp("sponza")))
    cfg = _cfg()
    fs, static = R.load_scene(path, quirks=cfg.quirks, device=False)
    return path, fs, static


def _cfg(samples=1):
    return RenderConfig(width=16, height=16, samples=samples, bounces=2,
                        intersector="bvh")


def test_partitioner_on_real_sponza_budget_mode():
    """Memory-budget partitioning on sponza's real texture byte sizes
    (each primitive's cost includes its material's ~0.5-1 MB jpgs)."""
    split = partition.split_scene(
        SPONZA_GLTF, num_workers=None, memory_per_worker_gb=0.01
    )
    assert split.total_size_gb > 0.02  # real bytes: tens of MB of textures
    assigned = [
        (name, p)
        for s in split.split_work.values()
        for name, prims in s.work.items()
        for p in prims
    ]
    assert len(assigned) == N_PRIMS
    assert len(set(assigned)) == N_PRIMS  # disjoint
    assert len(split.split_work) > 1  # the 10 MB budget actually splits
    for s in split.split_work.values():
        # Greedy budget mode: every shard but the last stops near the budget.
        assert s.total_size_gb < 0.03


def test_partitioner_equal_count_on_real_sponza():
    split = partition.split_scene(SPONZA_GLTF, num_workers=4)
    sizes = [
        sum(len(v) for v in s.work.values())
        for s in split.split_work.values()
    ]
    assert sum(sizes) == N_PRIMS
    assert max(sizes) <= -(-N_PRIMS // 4) + 1

def test_planner_on_real_sponza_texel_count():
    # 1.09 GB of texels + 262k tris fit the 4 GB scene budget: replicate.
    p = pmesh.plan(N_TRIS, n_devices=8, memory_bytes=MEM, n_texels=N_TEXELS)
    assert p.tp == 1 and not p.shard_textures
    # A 4 GB chip (1 GB scene budget) cannot replicate 1.09 GB of texels:
    # the scene axis must grow and the texture pack must shard.
    p = pmesh.plan(N_TRIS, n_devices=8, n_texels=N_TEXELS,
                   memory_bytes=4 * 2**30)
    assert p.tp > 1 and p.shard_textures


def test_standin_load_counts_and_sun(sponza):
    _, fs, static = sponza
    assert static.n_tris == N_TRIS
    assert fs.tex_texels.shape[0] == N_TEXELS
    assert fs.mat_albedo.shape[0] == N_PRIMS  # one material per primitive
    assert static.has_sun  # KHR_lights_punctual directional "Sun"
    # Sun energy: color (1, .58, .19) x intensity 50 — the reference's
    # default sun ballpark (sun_light.hpp:8-11).
    np.testing.assert_allclose(
        np.asarray(fs.sun_energy), [50.0, 29.122492, 9.562191], rtol=1e-5
    )


def test_standin_renders_finite_and_deterministic(sponza):
    _, fs, static = sponza
    cfg = _cfg()
    a = R.render(fs, static, cfg)
    b = R.render(fs, static, cfg)
    assert np.isfinite(a.color).all()
    assert a.color.std() > 0  # not a flat image
    np.testing.assert_array_equal(a.color, b.color)


def test_sponza_tp2_sharded_pack_matches_replicated(sponza):
    """The full sponza-scale case the planner exists for: 262k tris + the
    real 68M-texel pack (1.09 GB — the thing that actually busts a 4 GB
    chip's scene budget, see test_planner_on_real_sponza_texel_count)
    sharded along tp=2, bit-matching the replicated-pack render."""
    from ptx.parallel import dist, mesh as pmesh

    _, fs, static = sponza
    cfg = RenderConfig(width=8, height=8, samples=1, bounces=2,
                       intersector="bvh")
    plan_rep = pmesh.Plan(dp=4, tp=2, scene_sharded=True,
                          shard_textures=False)
    plan_shd = pmesh.Plan(dp=4, tp=2, scene_sharded=True, shard_textures=True)
    mesh_dev = pmesh.make_mesh(plan_rep)
    rep = dist.render_distributed(fs, static, cfg, plan=plan_rep,
                                  mesh=mesh_dev)
    shd = dist.render_distributed(fs, static, cfg, plan=plan_shd,
                                  mesh=mesh_dev)
    np.testing.assert_array_equal(rep.color, shd.color)
    assert np.isfinite(rep.color).all()


def test_partition_cli_on_real_sponza():
    """`ptx partition` (the reference preprocessor's /preprocess response)
    against the real sponza glTF: valid JSON, 24 primitives, budget mode
    driven by the actual texture byte sizes."""
    import json
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, "-m", "ptx.cli", "partition", "--scene",
         SPONZA_GLTF, "--memory-per-worker-gb", "0.01", "--cpu"],
        capture_output=True, text=True, timeout=120,
        cwd="/root/repo",
    )
    assert out.returncode == 0, out.stderr[-2000:]
    doc = json.loads(out.stdout)
    total = sum(
        len(p)
        for w in doc["split_work"].values()
        for p in w["work"].values()
    )
    assert total == N_PRIMS
    assert doc["total_size"] > 0.02
    assert len(doc["split_work"]) > 1


def test_sponza_render_golden(sponza):
    """Golden lock on the many-material / 68M-texel configuration: the
    stand-in geometry is seeded-deterministic, so any drift in texture-pack
    addressing, material routing, or the sun path fails here.  Delete the
    .npy to regenerate after an intentional semantic change."""
    import os

    golden_path = os.path.join(
        os.path.dirname(__file__), "golden", "sponza_standin_16x16_s1_b2.npy"
    )
    _, fs, static = sponza
    res = R.render(fs, static, _cfg())
    if not os.path.exists(golden_path):
        np.save(golden_path, res.color)
        pytest.skip("golden image generated")
    golden = np.load(golden_path)
    np.testing.assert_allclose(res.color, golden, rtol=1e-4, atol=1e-5)


def test_materialize_regenerates_on_seed_change(tmp_path):
    """ADVICE r4 low: a cached .bin from seed A must not be served for
    seed B — the stamp file ties the cache to (seed, generator version)."""
    import json
    import os

    from ptx.scene import standin

    out = str(tmp_path / "scene")
    gltf = standin.materialize(out, seed=0)
    uri = json.load(open(gltf))["buffers"][0]["uri"]
    bin_path = os.path.join(out, uri)
    a = open(bin_path, "rb").read()

    # Same seed: cache hit (mtime unchanged).
    m0 = os.path.getmtime(bin_path)
    standin.materialize(out, seed=0)
    assert os.path.getmtime(bin_path) == m0

    # New seed: regenerated, different bytes.
    standin.materialize(out, seed=7)
    b = open(bin_path, "rb").read()
    assert a != b
    stamp = json.load(open(bin_path + ".gen.json"))
    assert stamp == {"seed": 7, "version": standin.GENERATOR_VERSION}
