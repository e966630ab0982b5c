"""Fast differentiable integrator: recorded-trace forward, shading-only vjp.

The default differentiable scan (``make_integrator(differentiable=True)``)
pays for generality: its primal runs the XLA shading path so reverse-mode
can trace every op, including gradients w.r.t. *geometry* (vertex
positions flow through the Möller-Trumbore vjp).  But the dominant
inverse-rendering workload optimizes materials / lights / textures
(``shading_worker.cpp``'s inputs, not its geometry), and for those
parameters the trace results are constants.  This module exploits that:

* **forward** — the production bounce step (trace, then shade), saving each
  bounce's trace results ``(h, d_sun, sun_exists, shadow_hit)``
  (~19 f32/ray/bounce);
* **backward** — a ``jax.vjp`` of the *shading-only* scan
  (``wavefront.make_shade_fn``) evaluated at the recorded hits: pure
  elementwise algebra, no traversal anywhere in the backward graph.

The primal and the replay run the same shading function, so the custom_vjp
primal and the linearization point agree.

Gradients w.r.t. geometry (``tri_*``/vertex attributes) are NOT produced
by this path — the recorded hits detach them (zeros).  ``ptx.diff.inverse``
routes parameter sets containing geometry to the general integrator.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ptx.config import RenderConfig
from ptx.integrator.wavefront import (
    RayState, make_shade_fn, make_trace_fn,
)
from ptx.kernels.intersect import Hit
from ptx.scene import camera as pcamera
from ptx.scene.flatten import FlatScene, SceneStatic

# fs leaves whose gradients survive the recorded-trace backward: everything
# shading reads directly.  Geometry/BVH/camera-ray leaves are detached.
FAST_SAFE_FIELDS = frozenset({
    "mat_albedo", "mat_opacity", "mat_roughness", "mat_metallic",
    "mat_emissive", "mat_ior", "mat_shadow_catcher", "mat_packed",
    "sun_energy", "tex_texels",
})


def _float0(x):
    return np.zeros(x.shape, jax.dtypes.float0)


def make_fast_diff_integrator(
    static: SceneStatic,
    cfg: RenderConfig,
    closest,
    any_hit,
):
    """``(fs, pixel_ids, sample_ids) -> (radiance, alpha)`` with a
    custom_vjp: production-speed forward, shading-only backward."""
    q = cfg.quirks
    extra = cfg.opacity_extra_iters if static.has_translucent else 0
    max_iters = cfg.bounces + extra
    shade = make_shade_fn(static, cfg)
    trace = make_trace_fn(static, cfg, closest, any_hit, do_compact=False)

    def init_state(fs, pixel_ids, sample_ids):
        orig, dirn = pcamera.generate_rays(
            fs, pixel_ids, sample_ids, cfg.width, cfg.height, cfg.seed,
            q.first_sample_centered, cfg.transparent_background,
        )
        r = pixel_ids.shape[0]
        return RayState(
            orig=orig, dirn=dirn,
            radiance=jnp.zeros((r, 3)), throughput=jnp.ones((r, 3)),
            alpha=jnp.zeros((r,)), alive=jnp.ones((r,), bool),
            bounce=jnp.full((r,), cfg.bounces, jnp.int32),
            pixel_ids=pixel_ids.astype(jnp.int32),
            sample_ids=sample_ids.astype(jnp.int32),
        )

    def _primal(fs, pixel_ids, sample_ids):
        r = pixel_ids.shape[0]
        state = init_state(fs, pixel_ids, sample_ids)

        def step_rec(fs, it, s):
            tr = trace(fs, it, s)
            return shade(fs, it, s, *tr), tr

        # Record buffers [max_iters, ...]; iterations never run stay zero —
        # shade is the identity on dead lanes for any hit payload, so the
        # backward replay is exact regardless.
        rec0 = (
            Hit(
                hit=jnp.zeros((max_iters, r), bool),
                t=jnp.zeros((max_iters, r)),
                position=jnp.zeros((max_iters, r, 3)),
                normal=jnp.zeros((max_iters, r, 3)),
                tangent=jnp.zeros((max_iters, r, 3)),
                uv=jnp.zeros((max_iters, r, 2)),
                mat_id=jnp.zeros((max_iters, r), jnp.int32),
            ),
            jnp.zeros((max_iters, r, 3)),
            jnp.zeros((max_iters, r), bool),
            jnp.zeros((max_iters, r), bool),
        )

        def cond(carry):
            it, s, _ = carry
            return (it < max_iters) & jnp.any(s.alive)

        def body(carry):
            it, s, recs = carry
            s2, rec = step_rec(fs, it, s)
            recs = jax.tree.map(
                lambda buf, v: jax.lax.dynamic_update_index_in_dim(
                    buf, v.astype(buf.dtype), it, 0
                ),
                recs, rec,
            )
            return it + 1, s2, recs

        n_ran, state, recs = jax.lax.while_loop(
            cond, body, (jnp.int32(0), state, rec0)
        )
        return (state.radiance, state.alpha), (recs, n_ran)

    def _replay(fs, pixel_ids, sample_ids, recs, n_ran):
        """The shading-only scan at recorded trace results — the function
        whose vjp is the backward pass.  Iterations the forward never ran
        (every lane dead) are cond-skipped, mirroring the forward's early
        exit — this is what keeps the +opacity_extra_iters headroom free in
        backward too."""
        state = init_state(fs, pixel_ids, sample_ids)

        def body(s, xs):
            it, rec = xs
            s2 = jax.lax.cond(
                it < n_ran,
                jax.checkpoint(
                    lambda ss, rr: shade(fs, it, ss, *rr), prevent_cse=False
                ),
                lambda ss, rr: ss,
                s, rec,
            )
            return s2, None

        state, _ = jax.lax.scan(
            body, state, (jnp.arange(max_iters, dtype=jnp.int32), recs)
        )
        return state.radiance, state.alpha

    @jax.custom_vjp
    def integrate(fs, pixel_ids, sample_ids):
        return _primal(fs, pixel_ids, sample_ids)[0]

    def fwd(fs, pixel_ids, sample_ids):
        out, (recs, n_ran) = _primal(fs, pixel_ids, sample_ids)
        return out, (fs, pixel_ids, sample_ids, recs, n_ran)

    def bwd(res, ct):
        fs, pixel_ids, sample_ids, recs, n_ran = res
        _, vjp_fn = jax.vjp(
            lambda fs_: _replay(fs_, pixel_ids, sample_ids, recs, n_ran), fs
        )
        (dfs,) = vjp_fn(ct)
        return dfs, _float0(pixel_ids), _float0(sample_ids)

    integrate.defvjp(fwd, bwd)
    return integrate
