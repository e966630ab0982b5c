"""The Pallas BVH walk (``ptx.kernels.traverse_pallas``) against the brute
Möller-Trumbore oracle, in interpret mode: there is no GPU here, so the
compiled kernel is checked by ``chip_smoke.py`` on the card."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ptx import render as R
from ptx.accel.bvh import build_bvh
from ptx.config import RenderConfig
from ptx.kernels import intersect as brute
from ptx.kernels import sorting
from ptx.kernels import traverse_pallas as tk
from ptx.scene import camera as pcamera

SCENES = ["synthetic:2048", "arch:20000"]


@functools.lru_cache(maxsize=None)
def _scene(spec, leaf_size=8):
    fs, static = R.load_scene(spec, device=False)
    return build_bvh(R.to_device(fs), static, leaf_size=leaf_size)


def _camera_rays(fs, n=1000, w=64, h=48, sample=0):
    pix = jnp.arange(n, dtype=jnp.int32) * 37 % (w * h)
    smp = jnp.full_like(pix, sample)
    return pcamera.generate_rays(fs, pix, smp, w, h)


def _bounce_rays(fs, orig, dirn, seed=5):
    """Secondary rays: from the primary hits, random unit directions."""
    h = brute.brute_closest_attrs(fs, orig, dirn)
    d = np.random.default_rng(seed).normal(size=orig.shape).astype(np.float32)
    d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True))
    o = jnp.where(h.hit[:, None], h.position + d * 1e-3, orig)
    return o, d


def _assert_closest_matches(fs, static, orig, dirn):
    t, tri = tk.select(fs, orig, dirn, static.bvh_leaf_size, interpret=True)
    bt, btri, _, _, bhit = brute.brute_closest(fs, orig, dirn)
    hit = np.asarray(bhit)
    np.testing.assert_array_equal(np.asarray(t) < tk.INF, hit)
    np.testing.assert_array_equal(np.asarray(tri)[hit], np.asarray(btri)[hit])
    np.testing.assert_allclose(np.asarray(t)[hit], np.asarray(bt)[hit],
                               rtol=1e-5)


@pytest.mark.parametrize("spec", SCENES)
def test_kernel_closest_matches_brute(spec):
    fs, static = _scene(spec)
    orig, dirn = _camera_rays(fs)
    _assert_closest_matches(fs, static, orig, dirn)
    _assert_closest_matches(fs, static, *_bounce_rays(fs, orig, dirn))


@pytest.mark.parametrize("spec", SCENES)
def test_kernel_any_hit_matches_brute(spec):
    fs, static = _scene(spec)
    for orig, dirn in [_camera_rays(fs),
                       _bounce_rays(fs, *_camera_rays(fs))]:
        _, any_hit = tk.make_backend(static.bvh_leaf_size, interpret=True)
        np.testing.assert_array_equal(
            np.asarray(any_hit(fs, orig, dirn)),
            np.asarray(brute.brute_any(fs, orig, dirn)))


def test_kernel_hit_payload_matches_brute():
    """The XLA epilogue recomputes t and the barycentrics for the winner,
    so the Hit payload of every hit matches the brute backend's (a miss's
    attributes are never read)."""
    fs, static = _scene("arch:20000")
    orig, dirn = _camera_rays(fs)
    closest, _ = tk.make_backend(static.bvh_leaf_size, interpret=True)
    hk = closest(fs, orig, dirn)
    hb = brute.brute_closest_attrs(fs, orig, dirn)
    np.testing.assert_array_equal(np.asarray(hk.hit), np.asarray(hb.hit))
    m = np.asarray(hb.hit)
    assert (np.asarray(hk.t)[~m] >= tk.INF).all()
    for a, b in zip(jax.tree.leaves(hk), jax.tree.leaves(hb)):
        # Same winner; barycentrics differ by float32 rounding only.
        np.testing.assert_allclose(np.asarray(a)[m], np.asarray(b)[m],
                                   rtol=1e-5, atol=1e-5)


def test_kernel_ray_count_not_a_block_multiple():
    fs, static = _scene("synthetic:2048")
    orig, dirn = _camera_rays(fs, n=tk.BLOCK + 13)
    _assert_closest_matches(fs, static, orig, dirn)
    t, tri = tk.select(fs, orig, dirn, static.bvh_leaf_size, interpret=True)
    assert t.shape == tri.shape == (tk.BLOCK + 13,)


def test_kernel_parked_rays_never_hit():
    fs, static = _scene("arch:20000")
    orig, dirn = _camera_rays(fs, n=300)
    keep = jnp.arange(300) % 3 == 0
    p_orig, p_dirn = sorting.park(orig, dirn, keep, static)
    closest, any_hit = tk.make_backend(static.bvh_leaf_size, interpret=True)
    h = closest(fs, p_orig, p_dirn)
    assert not bool(jnp.any(h.hit & ~keep))
    assert not bool(jnp.any(any_hit(fs, p_orig, p_dirn) & ~keep))
    h0 = brute.brute_closest_attrs(fs, orig, dirn)
    np.testing.assert_array_equal(np.asarray(h.hit)[np.asarray(keep)],
                                  np.asarray(h0.hit)[np.asarray(keep)])


def test_kernel_one_triangle_leaves():
    fs, static = _scene("synthetic:2048", leaf_size=1)
    assert int(np.asarray(fs.bvh_count).max()) == 1
    _assert_closest_matches(fs, static, *_camera_rays(fs))


def test_kernel_empty_tree_misses_everything():
    """A shard holding no triangles carries a 1-node tree with an inverted
    box (``shard_scene._empty_bvh``): every ray misses, no read runs past
    the node array."""
    from ptx.parallel.shard_scene import BVH_FIELDS, _empty_bvh

    fs, static = _scene("synthetic:2048")
    fs = fs._replace(**dict(zip(BVH_FIELDS, map(jnp.asarray, _empty_bvh()))))
    orig, dirn = _camera_rays(fs, n=200)
    t, _ = tk.select(fs, orig, dirn, static.bvh_leaf_size, interpret=True)
    assert bool(jnp.all(t >= tk.INF))


@pytest.mark.parametrize("from_top", [False, True])
def test_kernel_walk_that_visits_every_node(from_top):
    """A stack of unit triangles along z, one per leaf: a ray down the
    stack crosses every box, and from one end the depth-first order meets
    the triangles far to near, so the closest hit sits in the last leaf the
    walk reaches.  The loop's bound (the node count) must let it get there;
    a ray inside every box but outside every triangle must miss."""
    fs, static = R.load_scene("synthetic:64", device=False)
    n = static.n_tris
    z = np.arange(fs.tri_a.shape[0], dtype=np.float32)
    valid = (z < n)[:, None]  # padding slots stay degenerate
    fs = fs._replace(tri_a=np.stack([0 * z, 0 * z, z], 1) * valid,
                     tri_e1=np.float32([1, 0, 0]) * valid,
                     tri_e2=np.float32([0, 1, 0]) * valid)
    fs, static = build_bvh(fs, static, leaf_size=1)
    assert static.n_bvh_nodes == 2 * n - 1
    fs = R.to_device(fs)
    z0, dz = (n + 1.0, -1.0) if from_top else (-1.0, 1.0)
    orig = jnp.array([[0.2, 0.2, z0], [0.9, 0.9, z0]], jnp.float32)
    dirn = jnp.array([[0.0, 0.0, dz]] * 2, jnp.float32)
    t, tri = tk.select(fs, orig, dirn, 1, interpret=True)
    np.testing.assert_array_equal(
        np.asarray(t), np.float32([2.0 if from_top else 1.0, tk.INF]))
    _assert_closest_matches(fs, static, orig, dirn)


def _interpret_backend(monkeypatch):
    """Route ``intersector="pallas"`` through the Pallas interpreter."""
    monkeypatch.setattr(tk, "make_backend",
                        functools.partial(tk.make_backend, interpret=True))


def test_kernel_render_matches_brute(monkeypatch):
    _interpret_backend(monkeypatch)
    fs, static = R.load_scene("arch:20000", device=False)
    base = dict(width=24, height=16, samples=1, bounces=2)
    a = R.render(fs, static, RenderConfig(intersector="brute", **base))
    b = R.render(fs, static, RenderConfig(intersector="pallas", **base))
    np.testing.assert_allclose(a.color, b.color, rtol=1e-4, atol=1e-5)


def test_kernel_vertex_grads_match_brute(monkeypatch):
    """Vertex gradients flow through the XLA recompute of the kernel's
    winner (the kernel itself is never differentiated) and match the brute
    backend's."""
    from ptx.diff import inverse

    _interpret_backend(monkeypatch)
    fs, static = _scene("arch:20000")
    target = jnp.zeros((16 * 12, 3))

    def grad_for(backend):
        cfg = RenderConfig(width=16, height=12, samples=1, bounces=2,
                           intersector=backend)
        loss_fn = inverse.make_loss_fn(static, cfg, target, ("tri_a",))
        return np.asarray(
            jax.grad(loss_fn)({"tri_a": fs.tri_a}, fs, jnp.int32(0))["tri_a"])

    gb, gk = grad_for("brute"), grad_for("pallas")
    assert np.isfinite(gk).all() and np.abs(gk).max() > 0
    np.testing.assert_allclose(gk, gb, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("platform,n_tris,expect", [
    ("gpu", 2048, "pallas"),
    ("gpu", 1 << 20, "pallas"),
    ("cpu", 2048, "brute"),
    ("cpu", 1 << 20, "bvh"),
])
def test_backend_choice_by_platform_and_size(platform, n_tris, expect):
    _, static = _scene("synthetic:2048")
    static = dataclasses.replace(static, n_tris_padded=n_tris)
    assert R.resolve_intersector(static, RenderConfig(),
                                 platform=platform) == expect
    # An explicit choice is honoured on any platform.
    assert R.resolve_intersector(static, RenderConfig(intersector="bvh"),
                                 platform=platform) == "bvh"


def test_backend_choice_refuses_unknown_platform():
    _, static = _scene("synthetic:2048")
    with pytest.raises(ValueError, match="no intersection backend"):
        R.resolve_intersector(static, RenderConfig(), platform="rocm")


@pytest.mark.gpu
def test_compiled_kernel_matches_brute_on_gpu(gpu):
    """The kernel as compiled for the card (no interpreter)."""
    fs, static = _scene("arch:20000")
    orig, dirn = _camera_rays(fs, n=4096, w=64, h=64)
    t, tri = jax.jit(lambda fs, o, d: tk.select(fs, o, d, 8))(fs, orig, dirn)
    bt, btri, _, _, bhit = brute.brute_closest(fs, orig, dirn)
    np.testing.assert_array_equal(np.asarray(t) < tk.INF, np.asarray(bhit))
