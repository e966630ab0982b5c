"""Multi-device tests on the virtual 8-device CPU mesh.

The key invariant (SURVEY.md §7 capability #6): scene-sharded execution with
the per-ray min-distance reduce must produce images identical to
single-device execution.
"""

import jax
import numpy as np
import pytest

from ptx import render as R
from ptx.config import RenderConfig
from ptx.parallel import dist, mesh as pmesh, partition

# One device's memory for the planner (the CPU reports none).
MEM = 16 * 2**30

CORNELL = "/root/reference/path-tracer-core/scenes/cornell-box/cornell.gltf"


@pytest.fixture(scope="module")
def cornell():
    return R.load_scene(CORNELL)


def _cfg(**kw):
    base = dict(width=32, height=32, samples=2, bounces=3, intersector="brute")
    base.update(kw)
    return RenderConfig(**base)


def test_eight_devices_available():
    assert jax.device_count() >= 8


def test_plan_shapes():
    p = pmesh.plan(n_tris=1024, n_devices=8, memory_bytes=MEM)
    assert p.dp == 8 and p.tp == 1 and not p.scene_sharded
    # Huge scene forces scene sharding.
    p = pmesh.plan(n_tris=500_000_000, n_devices=8, memory_bytes=MEM)
    assert p.tp > 1 and p.dp * p.tp == 8
    # force_tp respected and kept rectangular.
    p = pmesh.plan(n_tris=1024, n_devices=8, memory_bytes=MEM, force_tp=4)
    assert p.tp == 4 and p.dp == 2


@pytest.mark.parametrize("dp,tp,comm", [
    (8, 1, "reduce"), (4, 2, "reduce"), (2, 4, "reduce"), (1, 8, "reduce"),
    (4, 2, "ring"), (2, 4, "ring"), (1, 8, "ring"),
])
def test_distributed_matches_single_device(cornell, dp, tp, comm):
    fs, static = cornell
    cfg = _cfg()
    single = R.render(fs, static, cfg)

    plan = pmesh.Plan(dp=dp, tp=tp, scene_sharded=tp > 1)
    meshdev = pmesh.make_mesh(plan)
    multi = dist.render_distributed(fs, static, cfg, plan=plan, mesh=meshdev,
                                    comm=comm)

    # Counter-based RNG keyed by absolute pixel/sample ids gives every
    # layout the same random numbers; the images then agree up to the float
    # rounding that a launch's shape can change.
    np.testing.assert_allclose(multi.color, single.color, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(multi.image[..., 3], single.image[..., 3])


def test_partitioner_equal_count():
    split = partition.split_scene(CORNELL, num_workers=2)
    shards = split.split_work
    assert len(shards) >= 2
    total = sum(len(v) for s in shards.values() for v in s.work.values())
    assert total == 7  # cornell: 5 mesh nodes, 7 primitives (Cube.003 has 3)
    # Shards are disjoint.
    seen = set()
    for s in shards.values():
        for mesh_name, prims in s.work.items():
            for p in prims:
                key = (mesh_name, p)
                assert key not in seen
                seen.add(key)


def test_partitioner_drives_partial_load():
    split = partition.split_scene(CORNELL, num_workers=2)
    from ptx.scene import gltf

    shard1 = split.split_work[1]
    part = gltf.load(CORNELL, scene_work=shard1.work)
    n_loaded = len(part.primitives)
    assert 0 < n_loaded < 7


def test_partitioner_memory_budget():
    # Tiny budget -> one primitive per worker.
    split = partition.split_scene(
        CORNELL, num_workers=None, memory_per_worker_gb=1e-12
    )
    assert len(split.split_work) == 7
    for s in split.split_work.values():
        assert sum(len(v) for v in s.work.values()) == 1


def test_union_of_shards_renders_identically(cornell):
    """Partial scenes loaded per shard, concatenated across the mesh axis,
    must render the same image as the full scene (the partitioner contract)."""
    fs_full, static_full = cornell
    cfg = _cfg(samples=1)
    full = R.render(fs_full, static_full, cfg)

    split = partition.split_scene(CORNELL, num_workers=2)
    parts = [
        R.load_scene(CORNELL, scene_work=split.split_work[k].work, pad_multiple=256)
        for k in sorted(split.split_work)
    ]
    import jax.numpy as jnp

    # Concatenate the triangle arrays of the two shards (materials/camera are
    # identical across shards).
    fs_a, st_a = parts[0]
    fs_b, st_b = parts[1]
    tri_fields = [
        "tri_a", "tri_e1", "tri_e2", "tri_valid",
        "n0", "n1", "n2", "t0", "t1", "t2", "uv0", "uv1", "uv2", "mat_id",
        "tri_attrs",
    ]
    merged = fs_a._replace(
        **{
            f: jnp.concatenate([getattr(fs_a, f), getattr(fs_b, f)])
            for f in tri_fields
        }
    )
    from ptx.scene.flatten import SceneStatic

    static_m = SceneStatic(
        n_tris=st_a.n_tris + st_b.n_tris,
        n_tris_padded=st_a.n_tris_padded + st_b.n_tris_padded,
        n_materials=static_full.n_materials,
        has_sun=static_full.has_sun,
        has_textures=static_full.has_textures,
    )
    res = R.render(merged, static_m, cfg)
    np.testing.assert_allclose(res.color, full.color, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("backend", ["brute", "bvh", "pallas"])
@pytest.mark.parametrize("tp,comm", [(2, "reduce"), (4, "reduce"), (2, "ring")])
def test_every_backend_matches_single_device_under_scene_sharding(
    backend, tp, comm, monkeypatch
):
    """The round-1 wrong-image bug: a globally-built BVH replicated over
    scene-sharded triangles made ``bvh`` + tp>1 silently render garbage
    (leaf ranges indexed the wrong shard-local triangles).  Every backend x
    comm x tp combination must now match the single-device render — shard
    preparation builds *per-shard* BVHs with shard-local leaf ranges
    (``ptx.parallel.shard_scene``).  Ref: the per-ray min reduce these
    shardings implement is ``intersection_worker.cpp:69-147``."""
    if backend == "pallas":
        # No GPU here: the kernel walk runs in the Pallas interpreter.
        import functools

        from ptx.kernels import traverse_pallas as tk

        monkeypatch.setattr(tk, "make_backend",
                            functools.partial(tk.make_backend, interpret=True))
    fs, static = R.load_scene("synthetic:3000")
    cfg = _cfg(width=16, height=16, samples=1, bounces=2,
               intersector=backend, sort_rays="off")
    if backend in ("bvh", "pallas"):
        fs_s, static_s = R.ensure_accel(fs, static, cfg)
    else:
        fs_s, static_s = fs, static
    single = R.render(fs_s, static_s, cfg)

    plan = pmesh.Plan(dp=8 // tp, tp=tp, scene_sharded=True)
    meshdev = pmesh.make_mesh(plan)
    multi = dist.render_distributed(fs, static, cfg, plan=plan,
                                    mesh=meshdev, comm=comm)
    np.testing.assert_allclose(
        np.asarray(single.color), np.asarray(multi.color), atol=1e-5
    )


@pytest.mark.parametrize("dp,tp,comm", [(8, 1, "reduce"), (4, 2, "reduce"),
                                        (2, 4, "ring")])
def test_distributed_sample_batching_matches_unbatched(cornell, dp, tp, comm):
    """Distributed launches share the single-chip launch strategy: k samples
    fused per launch must be bit-identical to one-launch-per-sample (the
    counter RNG is keyed by absolute sample ids)."""
    fs, static = cornell
    plan = pmesh.Plan(dp=dp, tp=tp, scene_sharded=tp > 1)
    meshdev = pmesh.make_mesh(plan)
    batched = dist.render_distributed(
        fs, static, _cfg(samples=4, samples_per_launch=4),
        plan=plan, mesh=meshdev, comm=comm)
    unbatched = dist.render_distributed(
        fs, static, _cfg(samples=4, samples_per_launch=1),
        plan=plan, mesh=meshdev, comm=comm)
    np.testing.assert_allclose(
        batched.color, unbatched.color, rtol=1e-6, atol=1e-7)


def test_cli_distributed_render(tmp_path):
    """The public distributed entry point (the reference's GET /preprocess
    fan-out, cloudformation/path-tracer-preprocessor.yaml:47-51) — CLI flags
    drive the planner + mesh render end-to-end on the CPU mesh."""
    from ptx.cli import main

    out = tmp_path / "dist.png"
    rc = main([
        "render", "--scene", CORNELL, "--out", str(out),
        "--width", "16", "--height", "16", "--samples", "2",
        "--bounces", "2", "--intersector", "brute",
        "--distributed", "--tp", "2", "--comm", "reduce", "--metrics",
    ])
    assert rc == 0
    assert out.exists()


@pytest.mark.parametrize("tp,comm", [(2, "reduce"), (4, "reduce"), (2, "ring")])
def test_chunked_compaction_under_scene_sharding(tp, comm):
    """Survivor compaction + scene-sharded collectives: the chunk/bounce
    trip counts are pmax-synced over the scene axis, so every chip issues
    the same psum sequence. Exercised with a scene big enough to trigger
    should_compact (> 4 triangle tiles) — images must still match the
    single-device render bit-for-bit."""
    fs, static = R.load_scene("synthetic:3000")
    from ptx.kernels import sorting

    assert sorting.should_compact(static)
    cfg = _cfg(width=16, height=16, samples=1, bounces=3)
    single = R.render(fs, static, cfg)

    plan = pmesh.Plan(dp=8 // tp, tp=tp, scene_sharded=True)
    meshdev = pmesh.make_mesh(plan)
    multi = dist.render_distributed(fs, static, cfg, plan=plan, mesh=meshdev,
                                    comm=comm)
    np.testing.assert_allclose(
        np.asarray(single.color), np.asarray(multi.color), atol=1e-5
    )


def test_distributed_auto_chunk_matches_whole_frame(monkeypatch):
    """Frames past the per-chip launch cap auto-chunk in distributed mode
    too (each chunk one shard_map launch); absolute-id RNG makes chunked
    renders bit-match whole-frame ones."""
    import ptx.render as render_mod

    fs, static = R.load_scene(CORNELL)
    cfg = _cfg(width=32, height=32, samples=2, bounces=2,
               intersector="brute")
    plan = pmesh.Plan(dp=2, tp=1, scene_sharded=False)
    meshdev = pmesh.make_mesh(plan)
    whole = dist.render_distributed(fs, static, cfg, plan=plan, mesh=meshdev)

    # 1024 pixels / dp=2 -> 512 rays/chip; cap 128 forces 4 chunks of 256.
    monkeypatch.setattr(render_mod, "MAX_RAYS_PER_LAUNCH", 128)
    chunked = dist.render_distributed(fs, static, cfg, plan=plan,
                                      mesh=meshdev)
    np.testing.assert_array_equal(chunked.color, whole.color)
    np.testing.assert_array_equal(chunked.alpha, whole.alpha)


def test_distributed_checkpoint_resume_and_preview(tmp_path):
    """Checkpoint/resume + the periodic preview PNG through
    render_distributed: a resumed distributed render must equal an
    uninterrupted one, and the preview must exist and match finalize() of
    the checkpointed state (single-chip tests cover the same contract;
    this pins the replicated-write path)."""
    import os

    from ptx.integrator import accumulate
    from ptx.io import checkpoint as ck
    from ptx.io.png import read_png

    fs, static = R.load_scene(CORNELL)
    plan = pmesh.Plan(dp=4, tp=1, scene_sharded=False)
    meshdev = pmesh.make_mesh(plan)

    def cfg(samples):
        return _cfg(width=16, height=16, samples=samples, bounces=2,
                    intersector="brute")

    full = dist.render_distributed(fs, static, cfg(4), plan=plan,
                                   mesh=meshdev)

    path = str(tmp_path / "dist.ckpt.npz")
    dist.render_distributed(fs, static, cfg(2), plan=plan, mesh=meshdev,
                            checkpoint_path=path, checkpoint_every=1)
    loaded = ck.load(path)
    assert loaded is not None and loaded.samples_done == 2
    img = read_png(path + ".preview.png")
    expect = np.asarray(
        accumulate.finalize(loaded.color, loaded.alpha)
    ).reshape(16, 16, 4)
    np.testing.assert_array_equal(img, expect)

    resumed = dist.render_distributed(fs, static, cfg(4), plan=plan,
                                      mesh=meshdev, checkpoint_path=path)
    np.testing.assert_allclose(resumed.color, full.color,
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n_pixels,ways,chunk", [
    (640 * 480, 1, 30720),   # one card: the single-device chunking
    (640 * 480, 4, 102400),  # 25,600 rays per card and launch
    (640 * 480, 2, 61440),
    (128 * 128, 4, None),    # under the cap: whole-frame launches
])
def test_launch_chunk_keeps_each_card_under_the_cap(n_pixels, ways, chunk):
    assert dist.launch_chunk(n_pixels, ways) == chunk
    if chunk is not None:
        assert n_pixels % chunk == 0 and chunk % (128 * ways) == 0
        assert chunk // ways <= R.MAX_RAYS_PER_LAUNCH
    if ways == 1:
        cfg = RenderConfig(width=n_pixels // 480, height=480)
        assert R.resolve_rays_per_batch(cfg) == chunk
