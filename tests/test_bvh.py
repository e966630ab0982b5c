"""BVH build + traversal correctness: must exactly match brute force."""

import jax.numpy as jnp
import numpy as np
import pytest

from ptx import geometry
from ptx import render as R
from ptx.accel.bvh import build_bvh
from ptx.accel import traverse
from ptx.config import RenderConfig
from ptx.kernels import intersect as brute
from ptx.scene.flatten import FlatScene, SceneStatic



def _random_scene(n_tris=333, seed=0, pad=512):
    """Random triangle soup packed into a minimal FlatScene."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-5, 5, (n_tris, 3)).astype(np.float32)
    a = centers + rng.normal(0, 0.4, (n_tris, 3)).astype(np.float32)
    b = centers + rng.normal(0, 0.4, (n_tris, 3)).astype(np.float32)
    c = centers + rng.normal(0, 0.4, (n_tris, 3)).astype(np.float32)
    fs, static = R.load_scene("synthetic:64")  # template arrays
    npad = max(pad, -(-n_tris // pad) * pad)
    z3 = np.zeros((npad, 3), np.float32)

    def padv(x):
        out = z3.copy()
        out[:n_tris] = x
        return jnp.asarray(out)

    fs = fs._replace(
        tri_a=padv(a), tri_e1=padv(b - a), tri_e2=padv(c - a),
        tri_valid=jnp.asarray(np.arange(npad) < n_tris),
        n0=padv(np.cross(b - a, c - a)),
        n1=padv(np.cross(b - a, c - a)),
        n2=padv(np.cross(b - a, c - a)),
        t0=padv(b - a), t1=padv(b - a), t2=padv(b - a),
        uv0=jnp.zeros((npad, 2)), uv1=jnp.zeros((npad, 2)),
        uv2=jnp.zeros((npad, 2)),
        mat_id=jnp.zeros(npad, jnp.int32),
    )
    # The packed per-triangle row (ptx.scene.flatten) for the new soup.
    attrs = np.zeros((npad, 40), np.float32)
    for col, f in ((0, "n0"), (3, "n1"), (6, "n2"), (9, "t0"), (12, "t1"),
                   (15, "t2"), (25, "tri_a"), (28, "tri_e1"), (31, "tri_e2")):
        attrs[:, col:col + 3] = np.asarray(getattr(fs, f))
    fs = fs._replace(tri_attrs=jnp.asarray(attrs))
    import dataclasses

    static = dataclasses.replace(
        static, n_tris=n_tris, n_tris_padded=npad, n_bvh_nodes=0
    )
    return fs, static


def _random_rays(n=256, seed=1):
    rng = np.random.default_rng(seed)
    orig = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    dirn = rng.normal(size=(n, 3)).astype(np.float32)
    dirn /= np.linalg.norm(dirn, axis=-1, keepdims=True)
    return jnp.asarray(orig), jnp.asarray(dirn)


def test_bvh_structure():
    fs, static = _random_scene()
    fs, static = build_bvh(fs, static)
    assert static.n_bvh_nodes > 1
    n = static.n_bvh_nodes
    assert fs.bvh_min.shape == (n, 3)
    # Every leaf range is within the valid triangle prefix.
    count = np.asarray(fs.bvh_count)
    first = np.asarray(fs.bvh_first)
    leaves = count > 0
    assert (first[leaves] + count[leaves] <= static.n_tris).all()
    assert count.max() <= static.bvh_leaf_size
    # Leaves partition all triangles.
    assert count[leaves].sum() == static.n_tris
    # Root bbox covers all triangle bounds.
    tri_min = np.asarray(fs.tri_a)[: static.n_tris].min(axis=0)
    assert (np.asarray(fs.bvh_min)[0] <= tri_min + 1e-5).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bvh_matches_brute_closest(seed):
    fs, static = _random_scene(seed=seed)
    fs, static = build_bvh(fs, static)
    orig, dirn = _random_rays(seed=seed + 10)

    closest, any_hit = traverse.make_backend(static.bvh_leaf_size)
    hb = closest(fs, orig, dirn)
    hr = brute.brute_closest_attrs(fs, orig, dirn)

    np.testing.assert_array_equal(np.asarray(hb.hit), np.asarray(hr.hit))
    m = np.asarray(hr.hit)
    np.testing.assert_allclose(
        np.asarray(hb.t)[m], np.asarray(hr.t)[m], rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(hb.position)[m], np.asarray(hr.position)[m],
        rtol=1e-4, atol=1e-5,
    )
    # any-hit agrees with "there exists a hit".
    ah = any_hit(fs, orig, dirn)
    np.testing.assert_array_equal(np.asarray(ah), m)


def test_bvh_render_matches_brute_render():
    fs, static = R.load_scene("arch:20000")
    cfg_b = RenderConfig(width=32, height=32, samples=2, bounces=3,
                         intersector="brute")
    cfg_v = RenderConfig(width=32, height=32, samples=2, bounces=3,
                         intersector="bvh")
    a = R.render(fs, static, cfg_b)
    b = R.render(fs, static, cfg_v)
    # Same RNG stream + same winning hits -> identical images up to reduce
    # order in the min (ties broken differently only on exact-equal t).
    np.testing.assert_allclose(a.color, b.color, rtol=1e-4, atol=1e-5)


def test_native_and_numpy_builders_agree():
    """The C++ binned-SAH builder (the default via backend='auto') must
    produce the same tree as the numpy reference implementation: identical
    node boxes, leaf ranges, escape links, and triangle ordering."""
    from ptx.accel import native
    from ptx.accel.bvh import build_bvh

    if not native.available():
        pytest.skip("native builder not built on this machine")

    fs, static = R.load_scene("synthetic:5000", device=False)
    a, sa = build_bvh(fs, static, backend="native")
    b, sb = build_bvh(fs, static, backend="numpy")
    assert sa.n_bvh_nodes == sb.n_bvh_nodes
    for f in ("bvh_min", "bvh_max", "bvh_first", "bvh_count", "bvh_miss"):
        np.testing.assert_array_equal(
            np.asarray(getattr(a, f)), np.asarray(getattr(b, f)), err_msg=f
        )
    np.testing.assert_array_equal(np.asarray(a.tri_a), np.asarray(b.tri_a))


@pytest.mark.parametrize("spec", ["synthetic:2048", "arch:20000"])
def test_refit_reproduces_build_boxes(spec):
    """Refit on unmoved geometry gives the builder's (padded) boxes."""
    import jax

    from ptx.accel.bvh import refit_bvh

    fs, static = build_bvh(*R.load_scene(spec, device=False))
    r = jax.jit(refit_bvh)(R.to_device(fs))
    for f in ("bvh_min", "bvh_max"):
        np.testing.assert_allclose(np.asarray(getattr(r, f)),
                                   np.asarray(getattr(fs, f)), atol=1e-6)


def test_refit_keeps_walk_exact_after_geometry_moves():
    """Geometry params move triangles out of their build-time boxes;
    inject_params refits the tree, and the XLA walk again renders what the
    brute oracle renders."""
    _check_refit_render("bvh")


def test_refit_keeps_kernel_walk_exact_after_geometry_moves(monkeypatch):
    """The same with the Pallas walk, in the Pallas interpreter."""
    import functools

    from ptx.kernels import traverse_pallas as tk

    monkeypatch.setattr(tk, "make_backend",
                        functools.partial(tk.make_backend, interpret=True))
    _check_refit_render("pallas")


def _check_refit_render(intersector):
    from ptx.diff import inverse

    fs, static = R.ensure_accel(*R.load_scene("arch:20000", device=False),
                                RenderConfig(intersector=intersector),
                                device=True)
    # Lift every other triangle by 0.3 m: far outside its leaf box.
    lift = jnp.where((jnp.arange(fs.tri_a.shape[0]) % 2 == 0)[:, None],
                     jnp.array([0.0, 0.3, 0.0]), 0.0)
    params = {"tri_a": fs.tri_a + lift}
    moved = inverse.inject_params(fs, params, static)
    stale = fs._replace(**{k: getattr(moved, k) for k in
                           ("tri_a", "tri_attrs")})
    base = dict(width=24, height=16, samples=1, bounces=2)
    want = R.render(moved, static, RenderConfig(intersector="brute", **base))
    got = R.render(moved, static, RenderConfig(intersector=intersector,
                                               **base))
    np.testing.assert_allclose(got.color, want.color, rtol=1e-4, atol=1e-5)
    # Without the refit the walk misses moved triangles.
    old = R.render(stale, static, RenderConfig(intersector=intersector,
                                               **base))
    assert not np.allclose(old.color, want.color, rtol=1e-4, atol=1e-5)
