"""The fast custom_vjp differentiable path (``ptx.diff.fast``) must match
the general differentiable scan exactly: identical primal radiance and
identical material/light/texture gradients — on scenes exercising every
recorded trace channel (hits, sun NEE shadow results, textures)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ptx import render as R
from ptx.config import RenderConfig
from ptx.diff.fast import FAST_SAFE_FIELDS, make_fast_diff_integrator
from ptx.integrator.wavefront import make_integrator
from ptx.scene.flatten import flatten
from ptx.scene.gltf import SunData
from ptx.scene.synthetic import make_textured_quads

CORNELL = "/root/reference/path-tracer-core/scenes/cornell-box/cornell.gltf"


def sunny_textured_scene():
    scene = make_textured_quads(2)
    d = np.array([0.3, 0.8, 0.5], np.float32)
    scene = dataclasses.replace(
        scene,
        sun=SunData(direction=d / np.linalg.norm(d),
                    energy=np.array([40.0, 30.0, 20.0], np.float32)),
    )
    fs, static = flatten(scene)
    return R.to_device(fs), static


def _integrators(fs, static, cfg):
    closest, any_hit = R.get_backend(static, cfg)
    fast = make_fast_diff_integrator(static, cfg, closest, any_hit)
    slow = make_integrator(static, cfg, closest, any_hit, differentiable=True)
    n = cfg.width * cfg.height
    pix = jnp.arange(n, dtype=jnp.int32)
    smp = jnp.zeros((n,), jnp.int32)
    return fast, slow, pix, smp


@pytest.mark.parametrize("scene", ["cornell", "sunny_textured"])
def test_fast_primal_matches_general(scene):
    if scene == "cornell":
        fs, static = R.load_scene(CORNELL)
    else:
        fs, static = sunny_textured_scene()
    cfg = RenderConfig(width=16, height=16, samples=1, bounces=3,
                       intersector="brute")
    fast, slow, pix, smp = _integrators(fs, static, cfg)
    rf, af = jax.jit(fast)(fs, pix, smp)
    rs, as_ = jax.jit(slow)(fs, pix, smp)
    # The fast primal runs the recording step under another jit schedule;
    # parity is float-rounding-level, not bit-exact.
    np.testing.assert_allclose(np.asarray(rf), np.asarray(rs),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(af), np.asarray(as_), atol=1e-6)


@pytest.mark.parametrize("field", [
    "mat_albedo", "mat_emissive", "mat_roughness", "sun_energy", "tex_texels",
])
def test_fast_gradients_match_general(field):
    fs, static = sunny_textured_scene()
    cfg = RenderConfig(width=16, height=16, samples=1, bounces=3,
                       intersector="brute")
    fast, slow, pix, smp = _integrators(fs, static, cfg)
    target = jnp.zeros((cfg.width * cfg.height, 3))

    from ptx.diff.inverse import inject_params

    def loss(integ, params):
        radiance, _ = integ(inject_params(fs, params), pix, smp)
        return jnp.mean((radiance - target) ** 2)

    params = {field: getattr(fs, field)}
    gf = jax.jit(jax.grad(lambda p: loss(fast, p)))(params)[field]
    gs = jax.jit(jax.grad(lambda p: loss(slow, p)))(params)[field]
    assert np.isfinite(np.asarray(gf)).all()
    assert float(jnp.abs(gs).max()) > 0  # the scene exercises this param
    np.testing.assert_allclose(
        np.asarray(gf), np.asarray(gs), rtol=1e-5, atol=1e-7
    )


def test_fast_safe_fields_is_shading_only():
    # Geometry/camera leaves must never be declared fast-safe: the recorded
    # hits detach them.
    assert "tri_a" not in FAST_SAFE_FIELDS
    assert "cam_origin" not in FAST_SAFE_FIELDS


def test_inverse_routes_geometry_to_general_path():
    """make_loss_fn with a geometry param must keep the vertex gradient
    path alive: the general integrator's backward flows through
    Möller-Trumbore, while the fast path's recorded hits detach it to
    exactly zero.  (Config note: interior vertex gradients need curved
    in-frame geometry — cornell's sphere at >=16x16, bounces 3; on flat
    axis-aligned walls the detached estimator's vertex gradient is
    legitimately zero.)"""
    fs, static = R.load_scene(CORNELL)
    cfg = RenderConfig(width=16, height=16, samples=1, bounces=3,
                       intersector="brute")
    from ptx.diff import inverse

    target = jnp.zeros((cfg.width * cfg.height, 3))
    loss_fn = inverse.make_loss_fn(static, cfg, target, ("tri_a",))
    g = jax.grad(loss_fn)({"tri_a": fs.tri_a}, fs, jnp.int32(0))["tri_a"]
    assert float(jnp.abs(g).sum()) > 0

    # The fast path on the same loss is structurally zero for geometry.
    fast, _, pix, smp = _integrators(fs, static, cfg)

    def fast_loss(p):
        radiance, _ = fast(fs._replace(**p), pix, smp)
        return jnp.mean((radiance - target) ** 2)

    gf = jax.grad(fast_loss)({"tri_a": fs.tri_a})["tri_a"]
    assert float(jnp.abs(gf).sum()) == 0.0
