"""Gradient correctness (finite difference vs autodiff) and inverse rendering."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ptx import render as R
from ptx.config import RenderConfig
from ptx.diff import inverse

CORNELL = "/root/reference/path-tracer-core/scenes/cornell-box/cornell.gltf"
JACK = "/root/reference/path-tracer-core/scenes/jack-of-blades/jack-of-blades.gltf"


@pytest.fixture(scope="module")
def cornell():
    return R.load_scene(CORNELL)


def _cfg(**kw):
    # bounces=2 keeps Russian roulette inactive (rr only starts below
    # bounces-2), so the loss is smooth in the material parameters and finite
    # differences are exact.
    base = dict(width=24, height=24, samples=1, bounces=2, intersector="brute")
    base.update(kw)
    return RenderConfig(**base)


def test_grad_matches_finite_difference_albedo(cornell):
    fs, static = cornell
    cfg = _cfg()
    n_pixels = cfg.width * cfg.height
    target = jnp.zeros((n_pixels, 3))

    loss_fn = jax.jit(
        inverse.make_loss_fn(static, cfg, target, ("mat_albedo",))
    )
    params = {"mat_albedo": fs.mat_albedo}
    grad = jax.jit(jax.grad(loss_fn))(params, fs, jnp.int32(0))["mat_albedo"]

    eps = 1e-3
    # Check several (material, channel) entries incl. the red wall.
    for mi, ci in [(0, 0), (1, 0), (1, 1), (3, 2)]:
        delta = jnp.zeros_like(fs.mat_albedo).at[mi, ci].set(eps)
        lp = loss_fn({"mat_albedo": fs.mat_albedo + delta}, fs, jnp.int32(0))
        lm = loss_fn({"mat_albedo": fs.mat_albedo - delta}, fs, jnp.int32(0))
        fd = (lp - lm) / (2 * eps)
        ad = grad[mi, ci]
        np.testing.assert_allclose(ad, fd, rtol=2e-2, atol=1e-6)


def test_grad_matches_finite_difference_emissive(cornell):
    fs, static = cornell
    cfg = _cfg()
    n_pixels = cfg.width * cfg.height
    target = jnp.full((n_pixels, 3), 0.5)

    loss_fn = jax.jit(
        inverse.make_loss_fn(static, cfg, target, ("mat_emissive",))
    )
    params = {"mat_emissive": fs.mat_emissive}
    grad = jax.jit(jax.grad(loss_fn))(params, fs, jnp.int32(0))["mat_emissive"]
    # The light material's emissive must have a nonzero gradient.
    assert float(jnp.abs(grad[3]).sum()) > 0.0

    eps = 1e-3
    delta = jnp.zeros_like(fs.mat_emissive).at[3, 0].set(eps)
    lp = loss_fn({"mat_emissive": fs.mat_emissive + delta}, fs, jnp.int32(0))
    lm = loss_fn({"mat_emissive": fs.mat_emissive - delta}, fs, jnp.int32(0))
    fd = (lp - lm) / (2 * eps)
    np.testing.assert_allclose(grad[3, 0], fd, rtol=2e-2, atol=1e-6)


def test_inverse_recovers_albedo(cornell):
    """Perturb the albedos; gradient descent must recover them near-exactly
    (the deterministic counter RNG makes the loss optimum the true params)."""
    fs, static = cornell
    cfg = _cfg(samples=2)
    n_pixels = cfg.width * cfg.height

    sample_fn = R.make_sample_fn(static, cfg)
    target = jnp.zeros((n_pixels, 3))
    for s in range(cfg.samples):
        radiance, _ = sample_fn(fs, jnp.int32(s))
        target = target + radiance
    target = target / cfg.samples

    init = {"mat_albedo": jnp.full_like(fs.mat_albedo, 0.5)}
    params, history = inverse.optimize(
        fs, static, cfg, target, init, steps=100, lr=0.1,
        param_clip={"mat_albedo": (0.0, 1.0)},
    )
    assert history[-1] < 1e-4
    # All identifiable materials (the light's albedo is unobservable behind
    # its own emission) recover to within 2e-2.
    got = np.asarray(params["mat_albedo"])
    true = np.asarray(fs.mat_albedo)
    for mi in (0, 1, 2, 4):
        np.testing.assert_allclose(got[mi], true[mi], atol=2e-2)


def test_grad_through_scene_sharding(cornell):
    """Gradients must flow through the shard_map psum-min reduce."""
    from ptx.parallel import dist, mesh as pmesh
    from jax.sharding import PartitionSpec as P

    fs, static = cornell
    cfg = _cfg()
    plan = pmesh.Plan(dp=2, tp=4, scene_sharded=True)
    meshdev = pmesh.make_mesh(plan)
    from ptx.render import get_backend

    base_closest, base_any = get_backend(static, cfg)
    closest = dist.sharded_closest(base_closest)
    any_hit = dist.sharded_any_hit(base_any)
    from ptx.integrator.wavefront import make_integrator

    integrator = make_integrator(static, cfg, closest, any_hit, differentiable=True)
    n_pixels = cfg.width * cfg.height
    fs_specs = pmesh.scene_shardings(meshdev, True)

    inner = jax.shard_map(
        integrator,
        mesh=meshdev,
        in_specs=(fs_specs, P(pmesh.AXIS_RAYS), P(pmesh.AXIS_RAYS)),
        out_specs=(P(pmesh.AXIS_RAYS), P(pmesh.AXIS_RAYS)),
        check_vma=False,
    )

    def loss(albedo):
        fs2 = fs._replace(mat_albedo=albedo)
        pixel_ids = jnp.arange(n_pixels, dtype=jnp.int32)
        sample_ids = jnp.zeros((n_pixels,), jnp.int32)
        radiance, _ = inner(fs2, pixel_ids, sample_ids)
        return jnp.mean(radiance**2)

    g_sharded = jax.jit(jax.grad(loss))(fs.mat_albedo)

    # Same loss single-device.
    from ptx.kernels.intersect import make_brute

    integrator_s = make_integrator(static, cfg, *make_brute(), differentiable=True)

    def loss_s(albedo):
        fs2 = fs._replace(mat_albedo=albedo)
        pixel_ids = jnp.arange(n_pixels, dtype=jnp.int32)
        sample_ids = jnp.zeros((n_pixels,), jnp.int32)
        radiance, _ = integrator_s(fs2, pixel_ids, sample_ids)
        return jnp.mean(radiance**2)

    g_single = jax.jit(jax.grad(loss_s))(fs.mat_albedo)
    np.testing.assert_allclose(g_sharded, g_single, rtol=1e-4, atol=1e-7)


def test_vertex_grads_cornell_flat_and_fd_agrees(cornell):
    """d loss / d vertex positions on cornell: a closed box of FLAT diffuse
    faces with no sun, no textures, and matched cosine importance sampling
    is almost-everywhere FLAT in a uniform translation — diffuse throughput
    reduces to the (constant) albedo, rays never escape to the environment,
    and emissive factors don't depend on the hit point.  Both AD and a
    symmetric FD must agree on (near-)zero; round 4 found the previous
    version of this test passing VACUOUSLY on exactly this flatness while a
    stale-geometry bug produced a fake -1324 FD."""
    fs, static = cornell
    cfg = _cfg()
    target = jnp.zeros((cfg.width * cfg.height, 3))
    loss_fn = inverse.make_loss_fn(static, cfg, target, ("tri_a",))
    params = {"tri_a": fs.tri_a}
    g = jax.grad(loss_fn)(params, fs, jnp.int32(0))["tri_a"]
    assert np.isfinite(np.asarray(g)).all()

    eps = 1e-3
    dirn = jnp.zeros_like(fs.tri_a).at[:, 1].set(1.0)
    lp = loss_fn({"tri_a": fs.tri_a + eps * dirn}, fs, jnp.int32(0))
    lm = loss_fn({"tri_a": fs.tri_a - eps * dirn}, fs, jnp.int32(0))
    fd = float((lp - lm) / (2 * eps))
    ad = float(jnp.sum(g * dirn))
    np.testing.assert_allclose(ad, fd, rtol=0.08, atol=1e-4)


def test_vertex_grads_jack_nonzero_and_fd_sane():
    """d loss / d vertex positions where they are genuinely nonzero (SURVEY
    capability #8): jack-of-blades has a sun (NEE direct light depends on
    the shadow-ray origin and shading normal) and textures (uv moves with
    the hit point).  AD is the detached-sampling interior-point gradient —
    silhouette terms are excluded BY DESIGN (SURVEY hard part 3) while a
    symmetric FD includes them, so the check is sign + magnitude-band, not
    exact equality."""
    fs, static = R.load_scene(JACK)
    cfg = _cfg(width=16, height=12)
    target = jnp.zeros((cfg.width * cfg.height, 3))
    loss_fn = inverse.make_loss_fn(static, cfg, target, ("tri_a",))
    g = jax.grad(loss_fn)({"tri_a": fs.tri_a}, fs, jnp.int32(0))["tri_a"]
    assert np.isfinite(np.asarray(g)).all()
    assert float(jnp.abs(g).max()) > 1.0  # gradients genuinely flow

    eps = 1e-3
    dirn = jnp.zeros_like(fs.tri_a).at[:, 1].set(1.0)
    lp = loss_fn({"tri_a": fs.tri_a + eps * dirn}, fs, jnp.int32(0))
    lm = loss_fn({"tri_a": fs.tri_a - eps * dirn}, fs, jnp.int32(0))
    fd = float((lp - lm) / (2 * eps))
    ad = float(jnp.sum(g * dirn))
    assert abs(fd) > 1.0 and abs(ad) > 1.0
    assert np.sign(ad) == np.sign(fd)
    assert 0.25 < ad / fd < 4.0


def test_invert_cli_smoke():
    """The README's `ptx invert` quick-start path: a few optimization steps
    on a tiny config must run to completion and report a decreasing loss."""
    import re
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, "-m", "ptx.cli", "invert", "--scene", CORNELL,
         "--width", "8", "--height", "8", "--samples", "1", "--bounces",
         "2", "--steps", "4", "--lr", "0.1", "--cpu",
         "--intersector", "brute"],
        capture_output=True, text=True, timeout=420, cwd="/root/repo",
    )
    assert out.returncode == 0, out.stderr[-2000:]
    text = out.stdout + out.stderr
    losses = [float(m) for m in re.findall(r"loss[ =:]+([0-9.eE+-]+)", text)]
    assert len(losses) >= 2, text[-1500:]
    assert losses[-1] <= losses[0]


@pytest.mark.parametrize("fields", [("mat_albedo",), ("tri_a",)])
def test_chunked_value_and_grad_matches_unchunked(cornell, fields):
    """VERDICT r4 #1: the chunked vjp (lax.scan over pixel chunks, one
    chunk's residuals live at a time) must reproduce the monolithic
    jax.value_and_grad of make_batch_loss_fn exactly — both for the fast
    custom_vjp material path and the general differentiable scan that flows
    through the Moller-Trumbore vjp."""
    fs, static = cornell
    cfg = _cfg(width=16, height=16, samples=2)
    n_pixels = cfg.width * cfg.height
    rng = np.random.default_rng(3)
    target = jnp.asarray(rng.uniform(0, 1, (n_pixels, 3)), jnp.float32)

    params = {f: getattr(fs, f) for f in fields}
    ref_loss = inverse.make_batch_loss_fn(
        static, cfg, target, cfg.samples, param_fields=fields
    )
    v_ref, g_ref = jax.jit(jax.value_and_grad(ref_loss))(params, fs)

    # Force real chunking: 64-pixel chunks -> 4 chunks x 2 fused samples.
    vg = jax.jit(inverse.make_batch_value_and_grad_fn(
        static, cfg, target, cfg.samples, param_fields=fields,
        max_chunk_rays=128,
    ))
    v_chk, g_chk = vg(params, fs)

    np.testing.assert_allclose(float(v_chk), float(v_ref), rtol=1e-6)
    for f in fields:
        np.testing.assert_allclose(
            np.asarray(g_chk[f]), np.asarray(g_ref[f]), rtol=1e-5, atol=1e-7
        )

    # And the single-chunk path (cap >= frame) is the trivial case.
    vg1 = jax.jit(inverse.make_batch_value_and_grad_fn(
        static, cfg, target, cfg.samples, param_fields=fields,
    ))
    v1, g1 = vg1(params, fs)
    np.testing.assert_allclose(float(v1), float(v_ref), rtol=1e-6)
    for f in fields:
        # sum-then-scale vs mean: float32 reassociation, not a logic delta
        np.testing.assert_allclose(
            np.asarray(g1[f]), np.asarray(g_ref[f]), rtol=1e-6, atol=1e-7
        )


def test_chunked_vjp_sample_groups_checkpoint(cornell):
    """Sample groups past the chunk cap re-materialise (jax.checkpoint)
    instead of accumulating residuals; the math must stay exact — the
    objective is MSE of the 4-sample mean, not mean of per-group MSEs."""
    fs, static = cornell
    cfg = _cfg(width=8, height=8, samples=4)
    n_pixels = cfg.width * cfg.height
    target = jnp.zeros((n_pixels, 3))
    params = {"mat_albedo": fs.mat_albedo}

    ref_loss = inverse.make_batch_loss_fn(
        static, cfg, target, cfg.samples, param_fields=("mat_albedo",)
    )
    v_ref, g_ref = jax.jit(jax.value_and_grad(ref_loss))(params, fs)
    # cap of 128 rays: chunk = 64 px x 2 samples -> 2 groups per chunk.
    vg = jax.jit(inverse.make_batch_value_and_grad_fn(
        static, cfg, target, cfg.samples, param_fields=("mat_albedo",),
        max_chunk_rays=128,
    ))
    v, g = vg(params, fs)
    np.testing.assert_allclose(float(v), float(v_ref), rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(g["mat_albedo"]), np.asarray(g_ref["mat_albedo"]),
        rtol=1e-5, atol=1e-7,
    )


def test_staged_width_scan_exact(cornell):
    """The staged-width differentiable scan (AD-safe survivor compaction:
    sort live-first, run later bounces at a static narrow width, cond
    fallback to full width) must be BIT-identical to the plain scan — dead
    lanes are strict no-ops, so narrow == full whenever alive fits the
    capacity, and the fallback covers the rest."""
    from ptx.integrator.wavefront import make_integrator
    from ptx.kernels.intersect import make_brute

    fs, static = cornell
    cfg = _cfg(width=32, height=32, samples=1, bounces=4)
    closest, any_hit = make_brute()
    plain = jax.jit(make_integrator(
        static, cfg, closest, any_hit, differentiable=True,
        remat_shade=False,
    ))
    # 1024 rays: stage capacities 256 exercise BOTH branches across the
    # spans (cornell keeps >256 alive into iter 2 -> fallback; the 6+
    # span is mostly dead -> narrow).
    staged = jax.jit(make_integrator(
        static, cfg, closest, any_hit, differentiable=True,
        remat_shade=False, stages=[(2, 256), (3, 256)],
    ))
    pix = jnp.arange(1024, dtype=jnp.int32)
    smp = jnp.zeros_like(pix)
    r0, a0 = plain(fs, pix, smp)
    r1, a1 = staged(fs, pix, smp)
    np.testing.assert_array_equal(np.asarray(r0), np.asarray(r1))
    np.testing.assert_array_equal(np.asarray(a0), np.asarray(a1))

    # Gradients through the staged scan match the plain scan too.
    def loss(albedo, integ):
        fs2 = fs._replace(mat_albedo=albedo)
        r, _ = integ(fs2, pix, smp)
        return jnp.sum(r ** 2)

    g0 = jax.jit(jax.grad(lambda a: loss(a, plain)))(fs.mat_albedo)
    g1 = jax.jit(jax.grad(lambda a: loss(a, staged)))(fs.mat_albedo)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g0),
                               rtol=1e-6, atol=1e-8)


def test_invert_cli_geometry_params_smoke():
    """`ptx invert --params tri_a` routes vertex positions through the
    general differentiable scan end-to-end (plumbing smoke: cornell's
    vertex gradient is structurally ~zero, so only completion + the MAE
    report are asserted)."""
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, "-m", "ptx.cli", "invert", "--scene", CORNELL,
         "--width", "8", "--height", "8", "--samples", "1", "--bounces",
         "2", "--steps", "2", "--lr", "0.05", "--cpu",
         "--intersector", "brute", "--params", "tri_a"],
        capture_output=True, text=True, timeout=420, cwd="/root/repo",
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "tri_a MAE" in out.stdout
