"""Ray sorting / parking: the wrapper must be an exact no-op on results."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ptx import render as R
from ptx.config import RenderConfig
from ptx.kernels import intersect as brute
from ptx.kernels import sorting
from ptx.scene import camera as pcamera



@pytest.fixture(scope="module")
def cornell():
    """A small in-repo scene with its BVH (the walk backends need one)."""
    from ptx.accel.bvh import build_bvh

    fs, static = R.load_scene("synthetic:2048", device=False)
    return build_bvh(R.to_device(fs), static)


def _rays(fs, n=32 * 32, w=32, h=32, shuffle=True):
    pix = jnp.arange(n, dtype=jnp.int32)
    smp = jnp.zeros_like(pix)
    orig, dirn = pcamera.generate_rays(fs, pix, smp, w, h)
    if shuffle:
        perm = np.random.default_rng(3).permutation(n)
        orig, dirn = orig[perm], dirn[perm]
    return orig, dirn


def test_keys_group_by_cell_then_octant(cornell):
    _, static = cornell
    lo, hi = static.aabb_lo, static.aabb_hi
    orig = jnp.array([[0.1, 0.1, 0.1], [0.1, 0.1, 0.1], [2.0, 2.0, 2.0]])
    dirn = jnp.array([[1.0, 1.0, 1.0], [-1.0, 1.0, 1.0], [1.0, 1.0, 1.0]])
    k = np.asarray(sorting.ray_keys(orig, dirn, lo, hi))
    # Same cell, different octant -> adjacent keys; far cell -> far key.
    assert k[0] != k[1]
    assert abs(int(k[0]) - int(k[1])) < 8
    assert abs(int(k[2]) - int(k[0])) >= 8


def test_sorted_backend_bit_exact(cornell):
    fs, static = cornell
    orig, dirn = _rays(fs)
    closest, any_hit = brute.make_brute()
    s_closest, s_any = sorting.make_sorting_backend(closest, any_hit, static)
    h0 = closest(fs, orig, dirn)
    h1 = s_closest(fs, orig, dirn)
    for a, b in zip(jax.tree.leaves(h0), jax.tree.leaves(h1)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(
        np.asarray(any_hit(fs, orig, dirn)), np.asarray(s_any(fs, orig, dirn))
    )


def test_sorted_pallas_bit_exact(cornell):
    from ptx.kernels import traverse_pallas as tk

    fs, static = cornell
    orig, dirn = _rays(fs)
    closest, any_hit = tk.make_backend(static.bvh_leaf_size, interpret=True)
    s_closest, s_any = sorting.make_sorting_backend(closest, any_hit, static)
    h0 = closest(fs, orig, dirn)
    h1 = s_closest(fs, orig, dirn)
    for a, b in zip(jax.tree.leaves(h0), jax.tree.leaves(h1)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(
        np.asarray(any_hit(fs, orig, dirn)), np.asarray(s_any(fs, orig, dirn))
    )


def test_parked_rays_never_hit(cornell):
    fs, static = cornell
    orig, dirn = _rays(fs, shuffle=False)
    keep = jnp.arange(orig.shape[0]) % 3 == 0
    p_orig, p_dirn = sorting.park(orig, dirn, keep, static)
    closest, any_hit = brute.make_brute()
    h = closest(fs, p_orig, p_dirn)
    assert not bool(jnp.any(h.hit & ~keep))
    assert not bool(jnp.any(any_hit(fs, p_orig, p_dirn) & ~keep))
    # Kept lanes are untouched.
    h0 = closest(fs, orig, dirn)
    np.testing.assert_array_equal(
        np.asarray(h.hit)[np.asarray(keep)], np.asarray(h0.hit)[np.asarray(keep)]
    )


def test_render_matches_with_sorting_on_and_off(cornell):
    """End-to-end: the full integrator produces identical images with
    sort_rays on vs off (parking + sorting are exact)."""
    fs, static = cornell
    base = dict(width=16, height=16, samples=2, bounces=3,
                intersector="brute")
    img_off = R.render(fs, static, RenderConfig(sort_rays="off", **base))
    img_on = R.render(fs, static, RenderConfig(sort_rays="on", **base))
    np.testing.assert_array_equal(
        np.asarray(img_off.color), np.asarray(img_on.color)
    )
    np.testing.assert_array_equal(
        np.asarray(img_off.alpha), np.asarray(img_on.alpha)
    )
