"""Sample-batched launches: k image samples fused into one wavefront launch
must reproduce one-launch-per-sample results exactly (the RNG is keyed by
absolute (pixel, sample) ids, so batching is a pure scheduling change)."""

import jax.numpy as jnp
import numpy as np
import pytest

from ptx import render as R
from ptx.config import RenderConfig
from ptx.diff import inverse

CORNELL = "/root/reference/path-tracer-core/scenes/cornell-box/cornell.gltf"


def _cfg(tb, k, samples=5):
    return RenderConfig(
        width=32, height=32, samples=samples, bounces=3,
        samples_per_launch=k, transparent_background=tb,
        intersector="brute",
    )


@pytest.mark.parametrize("tb", [False, True])
def test_batched_render_matches_per_sample(tb):
    """k=2 over 5 samples (two full batches + ragged tail) == k=1."""
    fs, static = R.load_scene(CORNELL, quirks=_cfg(tb, 1).quirks)
    r1 = R.render(fs, static, _cfg(tb, 1))
    r2 = R.render(fs, static, _cfg(tb, 2))
    np.testing.assert_allclose(r2.color, r1.color, atol=2e-6)
    np.testing.assert_allclose(r2.alpha, r1.alpha, atol=2e-6)


def test_resolve_samples_per_launch_auto():
    # The launch-size cap (render.MAX_RAYS_PER_LAUNCH): <= 2^15 rays/launch.
    cfg = RenderConfig(width=256, height=256, samples=16)
    assert R.resolve_samples_per_launch(cfg) == 1  # 64k-pixel frame: k=1
    cfg = RenderConfig(width=64, height=64, samples=64)
    assert R.resolve_samples_per_launch(cfg) == 8  # 2^15 / 4096
    cfg = RenderConfig(width=64, height=64, samples=4)
    assert R.resolve_samples_per_launch(cfg) == 4  # capped by samples
    cfg = RenderConfig(width=2048, height=2048, samples=16)
    assert R.resolve_samples_per_launch(cfg) == 1  # frame exceeds the cap
    cfg = RenderConfig(width=256, height=256, samples=16, rays_per_batch=8192)
    assert R.resolve_samples_per_launch(cfg) == 1  # chunked-frame mode


def test_resolve_rays_per_batch_auto_chunks_over_cap_frames():
    # Frames past the 32k-ray launch cap auto-chunk to the
    # largest 128-aligned divisor that fits (VERDICT r3 task 3).
    assert R.resolve_rays_per_batch(RenderConfig(width=64, height=64)) is None
    assert (
        R.resolve_rays_per_batch(RenderConfig(width=256, height=256)) == 32768
    )
    assert (
        R.resolve_rays_per_batch(RenderConfig(width=512, height=512)) == 32768
    )
    c = R.resolve_rays_per_batch(RenderConfig(width=1920, height=1080))
    assert c == 28800  # largest 128-multiple divisor of 1080p under 2^15
    # Explicit rays_per_batch always wins.
    assert (
        R.resolve_rays_per_batch(
            RenderConfig(width=256, height=256, rays_per_batch=8192)
        )
        == 8192
    )


def test_auto_chunked_render_matches_whole_frame():
    """Chunked launches bit-match a whole-frame launch (absolute-id RNG)."""
    import ptx.render as render_mod

    cfg = RenderConfig(width=32, height=32, samples=2, bounces=2,
                       intersector="brute")
    fs, static = R.load_scene(CORNELL, quirks=cfg.quirks)
    whole = R.render(fs, static, cfg)
    # Force the auto-chunk path by shrinking the cap below the frame size.
    orig = render_mod.MAX_RAYS_PER_LAUNCH
    render_mod.MAX_RAYS_PER_LAUNCH = 256
    try:
        assert R.resolve_rays_per_batch(cfg) == 256
        chunked = R.render(fs, static, cfg)
    finally:
        render_mod.MAX_RAYS_PER_LAUNCH = orig
    np.testing.assert_array_equal(chunked.color, whole.color)
    np.testing.assert_array_equal(chunked.alpha, whole.alpha)


def test_batched_loss_zero_at_truth_and_matches_scan():
    """The fused-sample batch loss is exactly the per-sample mean MSE."""
    import jax

    cfg = RenderConfig(width=16, height=16, samples=4, bounces=2,
                       intersector="brute")
    fs, static = R.load_scene(CORNELL, quirks=cfg.quirks)
    n_pixels = cfg.width * cfg.height
    sample_fn = R.make_sample_fn(static, cfg)
    target = jnp.zeros((n_pixels, 3))
    for s in range(cfg.samples):
        target = target + sample_fn(fs, jnp.int32(s))[0]
    target = target / cfg.samples

    loss_fn = inverse.make_batch_loss_fn(static, cfg, target, cfg.samples)
    params = {"mat_albedo": fs.mat_albedo, "mat_emissive": fs.mat_emissive}
    val, grads = jax.value_and_grad(loss_fn)(params, fs)
    assert float(val) < 1e-9
    for g in grads.values():
        assert bool(jnp.all(jnp.isfinite(g)))
