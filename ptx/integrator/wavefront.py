"""The wavefront path-tracing integrator.

This is the SPMD re-design of the reference's entire worker runtime: the four
ray stages flowing through lock-free queues with dedicated thread groups
(``worker.cpp:46-92``, ``intersection_worker.cpp``, ``shading_worker.cpp``,
``accumulation_worker.cpp``) collapse into *one fused jitted loop over the
ray wavefront as data*:

    state [R lanes] --lax.while_loop over bounce iterations-->
        intersect -> NEE shadow query -> shade/sample -> mask-or-terminate

There are no queues: a "stage transition" is a masked lane update, the
cross-worker min-distance reduce point (W5, ``intersection_worker.cpp:78-110``)
is the pluggable ``closest`` callable (locally a brute reduce or BVH walk;
in the scene-sharded mode a psum-min across devices), and "accumulation" is a
segment-mean performed by the caller (``ptx.integrator.accumulate``).

Shading follows ``shading_worker.cpp:10-201`` term for term — every quirk
(emissive x10, stochastic opacity passthrough that does *not* consume a
bounce, backface cull, shadow-catcher first-bounce logic, roughness floor,
fresnel-vs-metallic lobe selection, NEE with pdf = 1 sun sampling clamped to
the light energy, throughput clamp, Russian roulette after 2 bounces) is
reproduced and switchable via ``config.Quirks``.

Sampled directions and all Monte-Carlo decisions are wrapped in
``stop_gradient`` (detached sampling), so the radiance estimate remains
differentiable w.r.t. material/light parameters — the capability the
reference lacks (SURVEY.md §7 capability #8).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from ptx import geometry
from ptx import math as pmath
from ptx import sampling
from ptx.config import RenderConfig
from ptx.kernels import sorting
from ptx.scene import camera as pcamera
from ptx.scene import textures
from ptx.scene.flatten import FlatScene, SceneStatic


class RayState(NamedTuple):
    """The wavefront packet — SoA analog of ``models::cloud_ray``
    (``src/models/cloud_ray.hpp:25-58``)."""

    orig: jnp.ndarray  # [R, 3]
    dirn: jnp.ndarray  # [R, 3]
    radiance: jnp.ndarray  # [R, 3] accumulated color
    throughput: jnp.ndarray  # [R, 3] `scale`
    alpha: jnp.ndarray  # [R]
    alive: jnp.ndarray  # [R] bool
    bounce: jnp.ndarray  # [R] i32, counts down from cfg.bounces
    pixel_ids: jnp.ndarray  # [R] i32
    sample_ids: jnp.ndarray  # [R] i32


def compute_hit_attrs(fs: FlatScene, tri, beta, gamma, at=None, geom=None):
    """Barycentric attribute interpolation at hit points — the flat-array
    version of ``distributed_scene::intersect``'s attribute block
    (``src/scene/intersect.cpp:112-150``).  Normals/tangents were baked with
    the normal matrix at flatten time; interpolate *then* normalize, matching
    the reference order.

    Everything comes from the packed ``tri_attrs`` row when flatten built it
    (ONE [R, 40] gather, including the vertex data for the position); values
    are identical either way.  Pass ``at`` when the caller already gathered
    the rows, and ``geom=(a, e1, e2)`` to override the vertex columns."""
    alpha_w = 1.0 - beta - gamma
    w0, w1, w2 = alpha_w[..., None], beta[..., None], gamma[..., None]
    if at is None and fs.tri_attrs.shape[0] == fs.tri_a.shape[0]:
        at = fs.tri_attrs[tri]  # [R, 40]
    if at is not None:
        n0, n1, n2 = at[..., 0:3], at[..., 3:6], at[..., 6:9]
        t0, t1, t2 = at[..., 9:12], at[..., 12:15], at[..., 15:18]
        uv0, uv1, uv2 = at[..., 18:20], at[..., 20:22], at[..., 22:24]
        mat_id = at[..., 24].astype(jnp.int32)
        a, e1, e2 = at[..., 25:28], at[..., 28:31], at[..., 31:34]
    else:
        n0, n1, n2 = fs.n0[tri], fs.n1[tri], fs.n2[tri]
        t0, t1, t2 = fs.t0[tri], fs.t1[tri], fs.t2[tri]
        uv0, uv1, uv2 = fs.uv0[tri], fs.uv1[tri], fs.uv2[tri]
        mat_id = fs.mat_id[tri]
        a, e1, e2 = fs.tri_a[tri], fs.tri_e1[tri], fs.tri_e2[tri]
    if geom is not None:
        a, e1, e2 = geom
    position = a + e1 * beta[..., None] + e2 * gamma[..., None]
    normal = pmath.normalize(n0 * w0 + n1 * w1 + n2 * w2)
    tangent = pmath.normalize(t0 * w0 + t1 * w1 + t2 * w2)
    uv = uv0 * w0 + uv1 * w1 + uv2 * w2
    return position, normal, tangent, uv, mat_id


def _env_radiance(fs: FlatScene, static: SceneStatic, cfg: RenderConfig, dirn):
    """Environment contribution on miss (``shading_worker.cpp:28-37``)."""
    env_factor = jnp.asarray(cfg.environment_factor, jnp.float32)
    if static.env_tex >= 0:
        uv = pmath.equirectangular_proj(dirn)
        tex = jnp.full(dirn.shape[:-1], static.env_tex, jnp.int32)
        return textures.sample_texture(fs, tex, uv, static)[..., :3] * env_factor
    return jnp.broadcast_to(env_factor, dirn.shape)


def _brdf_and_pdfs(normal, outcoming, incoming, albedo, metallic, roughness):
    """Shared BRDF block used by both NEE and indirect sampling
    (``shading_worker.cpp:118-139`` == ``:155-172``)."""
    diffuse_pdf = sampling.pdf_diffuse(normal, incoming)
    diffuse_brdf = diffuse_pdf[..., None] * albedo
    specular_pdf = sampling.pdf_specular(normal, outcoming, incoming, roughness)
    specular_brdf = jnp.broadcast_to(specular_pdf[..., None], albedo.shape)
    fres = pmath.lerp(jnp.full_like(albedo, 0.04), albedo, metallic[..., None])
    halfway = pmath.normalize(outcoming + incoming)
    cos_theta = pmath.dot(outcoming, halfway)
    fres = pmath.lerp(
        fres, jnp.ones_like(fres), jnp.power(jnp.maximum(1.0 - cos_theta, 0.0), 5.0)[..., None]
    )
    diffuse_brdf = diffuse_brdf * (1.0 - metallic[..., None])
    brdf = pmath.lerp(diffuse_brdf, specular_brdf, fres)
    return brdf, diffuse_pdf, specular_pdf


# Lanes per compaction chunk: small enough that a nearly-dead wavefront
# costs a fraction of a full-width pass, big enough to fill the device.
# An untuned starting value, not yet measured on the H100.
CHUNK = 8192
# Live-lane count below which the per-iteration re-sort is skipped (the
# compaction is already certified and the coherence value of sorting a
# tiny straggler set is less than the full-width argsort it costs).
# An untuned starting value, not yet measured on the H100.
SKIP_SORT_MAX = 4096


def _chunked_forward(step_fn, fs, state: RayState, max_iters: int,
                     static: SceneStatic, live_sync: Callable = None):
    """Forward bounce loop with survivor compaction.

    Each iteration sorts the wavefront dead-last (fused with the morton
    coherence key, ``ptx.kernels.sorting``) and pushes only the first
    ceil(live / CHUNK) chunks through the step — the SPMD-shaped version of
    the reference's queues simply not containing dead rays.  Exact: the
    counter-based RNG is keyed by (pixel, sample, bounce), so lane
    permutation cannot change any sample, and untouched chunks hold only
    dead lanes whose state is final.

    ``live_sync`` (SPMD use): when the step contains collectives (the
    scene-sharded closest/any reduces), every chip on that axis must run the
    same number of chunk steps — pass ``lambda n: lax.pmax(n, axis)`` so
    trip counts agree; chips whose extra chunks are all-dead do cheap no-op
    sweeps (parked lanes miss the root box).
    """
    R = state.orig.shape[0]
    chunk = CHUNK if (R % CHUNK == 0) else R
    n_chunks = R // chunk
    slot0 = jnp.arange(R, dtype=jnp.int32)
    dead_key = jnp.int32(1 << 30)

    def count_live(s):
        live = jnp.sum(s.alive.astype(jnp.int32))
        # Synced over the scene axis when the step contains collectives, so
        # the loop trip counts below stay uniform across chips.
        return live_sync(live) if live_sync is not None else live

    def outer_cond(carry):
        it, s, _, live, _ = carry
        return (it < max_iters) & (live > 0)

    def outer_body(carry):
        it, s, slot, live, in_c0 = carry

        def do_sort(args):
            ss, sl = args
            key = sorting.ray_keys(
                ss.orig, ss.dirn, static.aabb_lo, static.aabb_hi
            )
            perm = jnp.argsort(jnp.where(ss.alive, key, dead_key))
            return jax.tree.map(lambda x: x[perm], ss), sl[perm]

        # Straggler fast path: once every live lane fits in chunk 0 (post-
        # sort), lanes only die IN PLACE there — re-sorting each iteration
        # is overhead (a full-width argsort + 9-field permutation gathers).
        # ``in_c0`` certifies the containment, so skipping is exact; it
        # derives from the synced live count, so trip counts stay uniform
        # under SPMD.  The skip only engages below SKIP_SORT_MAX live lanes:
        # the sort ALSO buys morton coherence for the intersector, which can
        # be worth more than the sort while the live set is big.
        s, slot = jax.lax.cond(in_c0, lambda a: a, do_sort, (s, slot))
        in_c0 = in_c0 | (live <= min(chunk, SKIP_SORT_MAX))
        n_live = jnp.minimum((live + chunk - 1) // chunk, n_chunks)

        def chunk_body(cc):
            ci, st = cc
            off = ci * chunk
            sub = jax.tree.map(
                lambda x: jax.lax.dynamic_slice_in_dim(x, off, chunk, axis=0),
                st,
            )
            sub = step_fn(fs, it, sub)
            st = jax.tree.map(
                lambda x, y: jax.lax.dynamic_update_slice_in_dim(
                    x, y, off, axis=0
                ),
                st, sub,
            )
            return ci + 1, st

        _, s = jax.lax.while_loop(
            lambda cc: cc[0] < n_live, chunk_body, (jnp.int32(0), s)
        )
        return it + 1, s, slot, count_live(s), in_c0

    _, state, slot, _, _ = jax.lax.while_loop(
        outer_cond, outer_body,
        (jnp.int32(0), state, slot0, count_live(state), jnp.bool_(False)),
    )
    # Undo the accumulated permutation for the two outputs the caller reads.
    radiance = jnp.zeros_like(state.radiance).at[slot].set(state.radiance)
    alpha = jnp.zeros_like(state.alpha).at[slot].set(state.alpha)
    return radiance, alpha


def make_trace_fn(
    static: SceneStatic,
    cfg: RenderConfig,
    closest: Callable,
    any_hit: Callable,
    do_compact: bool = None,
):
    """Build the per-bounce *trace* stage ``(fs, it, state) -> (hit, d_sun,
    sun_exists, shadow_hit)`` — the two intersection sweeps of one bounce
    (the reference's INTERSECT and DIRECT_LIGHTING stages).  Factored out of
    :func:`make_integrator` so the fast differentiable path
    (``ptx.diff.fast``) can run it forward-only and record its results."""
    if do_compact is None:
        do_compact = sorting.resolve_compact(static, cfg)

    def trace(fs: FlatScene, it, state: RayState):
        """The two intersection sweeps of one bounce: closest hit + NEE
        shadow query (the reference's INTERSECT and DIRECT_LIGHTING stages).
        Split from :func:`shade` so the differentiable scan can save these
        results as residuals — ``jax.checkpoint`` around the shading then
        remats only cheap elementwise algebra, never the traversal sweeps (which
        material/light gradients do not depend on)."""
        R = state.orig.shape[0]
        pix, smp = state.pixel_ids, state.sample_ids
        u = lambda purpose: sampling.uniform(pix, smp, it, purpose, cfg.seed)

        # Park dead lanes outside the scene so they sort into all-dead blocks
        # and fail every tile gate (their results are alive-masked in shade).
        if do_compact:
            q_orig, q_dirn = sorting.park(
                state.orig, state.dirn, state.alive, static
            )
        else:
            q_orig, q_dirn = state.orig, state.dirn
        h = closest(fs, q_orig, q_dirn)

        # --- NEE shadow ray (intersection_worker.cpp:22-40) ----------------
        # Cone-sampled sun direction; "exists" uses the *interpolated* normal
        # (pre normal-map), as the intersect stage does.
        if static.has_sun:
            cos_theta = jnp.cos(
                u(sampling.P_SUN_THETA) * fs.sun_angular_radius
            )
            d_sun = sampling.cone_vec(
                u(sampling.P_SUN_PHI),
                cos_theta,
                jnp.broadcast_to(fs.sun_dir, state.dirn.shape),
            )
            d_sun = jax.lax.stop_gradient(d_sun)
            sun_exists = pmath.dot(h.normal, d_sun) > 0.0
            shadow_org = h.position + d_sun * pmath.EPS
            # Only lanes that are alive with an up-facing sun consume the
            # occlusion result — park the rest (see the closest-hit park).
            alive_hit = state.alive & h.hit
            if do_compact:
                s_org, s_dir = sorting.park(
                    shadow_org, d_sun, alive_hit & sun_exists, static
                )
            else:
                s_org, s_dir = shadow_org, d_sun
            shadow_hit = any_hit(fs, s_org, s_dir)
        else:
            d_sun = jnp.zeros_like(state.dirn)
            sun_exists = jnp.zeros((R,), bool)
            shadow_hit = jnp.zeros((R,), bool)
        return h, d_sun, sun_exists, shadow_hit

    return trace


def make_shade_fn(static: SceneStatic, cfg: RenderConfig):
    """Build the per-bounce *shading* stage ``(fs, it, state, hit, d_sun,
    sun_exists, shadow_hit) -> RayState`` — pure elementwise algebra, every
    ``shading_worker.cpp`` quirk, no traversal.  The seam between this and
    :func:`make_trace_fn` is where the differentiable paths cut: material/
    light/texture gradients flow through shading only, so the trace results
    can be saved (general path: checkpoint residuals; fast path: recorded
    buffers) and the backward graph never re-runs a sweep."""
    q = cfg.quirks

    def shade(fs: FlatScene, it, state: RayState, h, d_sun, sun_exists,
              shadow_hit) -> RayState:
        R = state.orig.shape[0]
        pix, smp = state.pixel_ids, state.sample_ids
        u = lambda purpose: sampling.uniform(pix, smp, it, purpose, cfg.seed)

        hit = h.hit & state.alive
        position, n_interp, tangent, uv, mat_id = (
            h.position, h.normal, h.tangent, h.uv, h.mat_id
        )

        # --- miss: environment, terminate (shading_worker.cpp:27-41) -------
        env = _env_radiance(fs, static, cfg, state.dirn)
        miss = state.alive & ~hit
        radiance = jnp.where(
            miss[..., None], state.radiance + state.throughput * env, state.radiance
        )
        alpha = jnp.where(
            miss, 0.0 if cfg.transparent_background else 1.0, state.alpha
        )
        alive = state.alive & hit
        alpha = jnp.where(hit, 1.0, alpha)

        # --- material fetch (shading_worker.cpp:44-50) ---------------------
        mat = textures.material_lookup(fs, mat_id, uv, static)
        emissive = mat["emissive"] * q.emissive_scale
        radiance = jnp.where(
            alive[..., None], radiance + state.throughput * emissive, radiance
        )

        # --- stochastic opacity passthrough (shading_worker.cpp:54-63) ----
        # Does NOT consume a bounce; ray continues straight through.
        translucent = jnp.abs(mat["opacity"] - 1.0) > pmath.EPS
        passthrough = alive & translucent & (u(sampling.P_OPACITY) > mat["opacity"])

        # --- shading normal via TBN + normal map (intersect.cpp:71-77) ----
        binormal = pmath.cross(n_interp, tangent)
        tn = mat["tangent_normal"]
        n_shade = pmath.normalize(
            tangent * tn[..., 0:1] + binormal * tn[..., 1:2] + n_interp * tn[..., 2:3]
        )
        outcoming = -state.dirn

        # --- backface cull (shading_worker.cpp:68-72) ----------------------
        backface = alive & ~passthrough & (pmath.dot(n_shade, outcoming) <= 0.0)

        # --- shadow catcher, first bounce (shading_worker.cpp:74-105) ------
        is_catcher = mat["shadow_catcher"] > 0.5
        first_bounce = state.bounce == cfg.bounces
        catcher_now = alive & ~passthrough & ~backface & is_catcher & first_bounce
        catcher_lit = (
            catcher_now
            & sun_exists
            & (pmath.dot(n_shade, d_sun) > 0.0)
            & ~shadow_hit
            if static.has_sun
            else jnp.zeros((R,), bool)
        )
        catcher_shadowed = catcher_now & ~catcher_lit
        # Shadowed catcher: overwrite color with zero, alpha 1, terminate.
        radiance = jnp.where(catcher_shadowed[..., None], 0.0, radiance)
        alpha = jnp.where(catcher_shadowed, 1.0, alpha)
        # Lit catcher: treat as fully transparent (same-bounce passthrough).
        passthrough = passthrough | catcher_lit

        # --- lobe selection (shading_worker.cpp:107-110) -------------------
        roughness = jnp.maximum(mat["roughness"], q.roughness_floor)
        mirror = pmath.reflect(-outcoming, n_shade)
        spec_prob = sampling.fresnel(outcoming, mirror, mat["ior"])
        spec_prob = jnp.maximum(spec_prob, mat["metallic"])
        spec_prob = jax.lax.stop_gradient(spec_prob)
        specular_sample = u(sampling.P_LOBE) < spec_prob

        shading = alive & ~passthrough & ~backface & ~catcher_shadowed

        # --- NEE contribution (shading_worker.cpp:112-147) -----------------
        if static.has_sun:
            nee_ok = (
                shading & sun_exists & (pmath.dot(n_shade, d_sun) > 0.0) & ~shadow_hit
            )
            brdf, _, _ = _brdf_and_pdfs(
                n_shade, outcoming, d_sun, mat["albedo"], mat["metallic"], roughness
            )
            # pdf = lerp(1, 1, spec_prob) = 1 (100% chance of hitting the sun).
            direct_in = jnp.broadcast_to(fs.sun_energy, brdf.shape)
            direct_out = brdf * direct_in
            if q.clamp_direct_to_light:
                direct_out = jnp.clip(direct_out, 0.0, direct_in)
            radiance = jnp.where(
                nee_ok[..., None], radiance + state.throughput * direct_out, radiance
            )

        # --- indirect bounce (shading_worker.cpp:149-199) ------------------
        u1, u2 = u(sampling.P_BRDF_U), u(sampling.P_BRDF_V)
        d_spec = sampling.importance_specular(u1, u2, n_shade, outcoming, roughness)
        d_diff = sampling.importance_diffuse(u1, u2, n_shade)
        d_new = jnp.where(specular_sample[..., None], d_spec, d_diff)
        d_new = jax.lax.stop_gradient(d_new)

        up_facing = pmath.dot(n_shade, d_new) > 0.0
        brdf_i, diffuse_pdf, specular_pdf = _brdf_and_pdfs(
            n_shade, outcoming, d_new, mat["albedo"], mat["metallic"], roughness
        )
        pdf = pmath.lerp(diffuse_pdf, specular_pdf, spec_prob)
        factor = brdf_i / jnp.maximum(pdf, pmath.EPS)[..., None]
        if q.indirect_clamp_to_incoming:
            # Monolithic-renderer convention: out <= in per level
            # (renderer.cpp:616-620) == per-bounce factor clamped to 1.
            new_throughput = state.throughput * jnp.clip(factor, 0.0, 1.0)
        else:
            # Wavefront-worker convention (shading_worker.cpp:173-175).
            new_throughput = jnp.clip(
                state.throughput * factor, 0.0, q.throughput_clamp
            )

        # Russian roulette after rr_after_bounces completed bounces
        # (shading_worker.cpp:182-190): survive with p = max component,
        # compensate by 1/p (reference divides by p even when p > 1).
        rr_active = state.bounce < (cfg.bounces - q.rr_after_bounces)
        p_survive = jnp.max(new_throughput, axis=-1)
        rr_kill = rr_active & (u(sampling.P_RR) > p_survive)
        new_throughput = jnp.where(
            (rr_active & ~rr_kill)[..., None],
            new_throughput / jnp.maximum(p_survive, pmath.EPS)[..., None],
            new_throughput,
        )

        new_bounce = state.bounce - 1
        continues = shading & up_facing & ~rr_kill & (new_bounce > 0)
        terminated_here = shading & (~up_facing | rr_kill | (new_bounce <= 0))

        # --- merge lane updates -------------------------------------------
        cont_or_pass = passthrough | continues
        next_orig = jnp.where(
            passthrough[..., None],
            position + state.dirn * pmath.EPS,
            jnp.where(continues[..., None], position + d_new * pmath.EPS, state.orig),
        )
        next_dirn = jnp.where(continues[..., None], d_new, state.dirn)
        next_throughput = jnp.where(
            continues[..., None], new_throughput, state.throughput
        )
        next_bounce = jnp.where(continues, new_bounce, state.bounce)
        next_alive = alive & cont_or_pass & ~backface & ~terminated_here

        return RayState(
            orig=next_orig,
            dirn=next_dirn,
            radiance=radiance,
            throughput=next_throughput,
            alpha=alpha,
            alive=next_alive,
            bounce=next_bounce,
            pixel_ids=pix,
            sample_ids=smp,
        )

    return shade


def make_integrator(
    static: SceneStatic,
    cfg: RenderConfig,
    closest: Callable,
    any_hit: Callable,
    differentiable: bool = False,
    chunked: bool = True,
    live_sync: Callable = None,
    remat_shade: bool = True,
    stages=None,
):
    """Build the jittable integrator ``(fs, pixel_ids, sample_ids) ->
    (radiance [R,3], alpha [R])``.

    ``closest(fs, orig, dirn) -> (hit, position, n_interp, tangent, uv,
    mat_id)`` returns *hit attributes* (not triangle indices) so backends are
    free to resolve the winning hit however they like — a local tile/BVH/
    kernel walk, or the scene-sharded psum-min payload reduce (the
    reference's cross-worker min-distance exchange, W5).  ``any_hit`` returns
    the occlusion boolean.  Swap backends without touching the shading math.
    """
    q = cfg.quirks
    # Opacity passthrough does not consume a bounce; extra loop headroom is
    # only needed when some material can actually pass rays through.
    extra = cfg.opacity_extra_iters if static.has_translucent else 0
    max_iters = cfg.bounces + extra
    do_compact = sorting.resolve_compact(static, cfg)
    trace = make_trace_fn(static, cfg, closest, any_hit, do_compact)
    shade = make_shade_fn(static, cfg)

    def step(fs: FlatScene, it, state: RayState) -> RayState:
        return shade(fs, it, state, *trace(fs, it, state))

    def integrate(fs: FlatScene, pixel_ids, sample_ids):
        orig, dirn = pcamera.generate_rays(
            fs,
            pixel_ids,
            sample_ids,
            cfg.width,
            cfg.height,
            cfg.seed,
            q.first_sample_centered,
            cfg.transparent_background,
        )
        r = pixel_ids.shape[0]
        state = RayState(
            orig=orig,
            dirn=dirn,
            radiance=jnp.zeros((r, 3)),
            throughput=jnp.ones((r, 3)),
            alpha=jnp.zeros((r,)),
            alive=jnp.ones((r,), bool),
            bounce=jnp.full((r,), cfg.bounces, jnp.int32),
            pixel_ids=pixel_ids.astype(jnp.int32),
            sample_ids=sample_ids.astype(jnp.int32),
        )

        if differentiable:
            # Reverse-mode AD needs a static trip count: a scan over
            # max_iters.  The bounce is split at the trace/shade seam: the
            # two traversal sweeps (closest hit + shadow query — the
            # expensive part, and one material/light gradients never flow
            # *into*) run outside jax.checkpoint so their results are saved
            # as per-step residuals (~19 f32/ray/step), while the shading
            # algebra inside the checkpoint remats during backward — cheap
            # elementwise work.  Before the split, remat re-ran both sweeps per
            # step, doubling the dominant cost of the backward pass.
            def body(s, it):
                # Scalar-predicate cond: XLA skips the whole step once every
                # lane is dead (e.g. opacity-headroom iterations on scenes
                # where nothing passes through) — lax.cond is reverse-mode
                # differentiable, so the scan stays AD-safe.
                # (Permuting lanes live-first before the sweeps, to recover
                # the production forward's compaction, costs ~18 per-field
                # permutation gathers per iteration; not yet measured on the
                # H100.)
                def live(ss):
                    tr = trace(fs, it, ss)
                    if not remat_shade:
                        # Chunked-vjp callers bound residual memory already
                        # (inverse.make_batch_value_and_grad_fn), so saving
                        # the shade intermediates beats re-running the
                        # shade forward during backward.
                        return shade(fs, it, ss, *tr)
                    return jax.checkpoint(
                        lambda ss2, tr2: shade(fs, it, ss2, *tr2),
                        prevent_cse=False,
                    )(ss, tr)

                return jax.lax.cond(jnp.any(s.alive), live, lambda ss: ss, s), None

            def scan_iters(s, it0, it1):
                if it1 <= it0:
                    return s
                s, _ = jax.lax.scan(
                    body, s, jnp.arange(it0, it1, dtype=jnp.int32)
                )
                return s

            def staged(s, it0, it1, width):
                """Run iterations [it0, it1) at a NARROW static width.

                AD-safe survivor compaction: reverse mode forbids dynamic
                shapes, but a *static* capacity with a cond fallback is
                exact — sort lanes live-first (stable permutation), run the
                scan on the first ``width`` lanes only, and reattach the
                untouched tail (dead lanes are strict no-ops in the body,
                so narrow == full bit-for-bit whenever alive <= width; if
                alive exceeds the capacity the fallback branch runs the
                full-width scan instead, so the result is ALWAYS exact).
                Per-STAGE sorting amortizes the permutation gathers over
                all the stage's iterations."""
                def narrow(ss):
                    perm = jnp.argsort(~ss.alive, stable=True)
                    sp = jax.tree.map(lambda x: x[perm], ss)
                    head = jax.tree.map(lambda x: x[:width], sp)
                    tail = jax.tree.map(lambda x: x[width:], sp)
                    head = scan_iters(head, it0, it1)
                    sp = jax.tree.map(
                        lambda h, t: jnp.concatenate([h, t]), head, tail
                    )
                    inv = jnp.argsort(perm)
                    return jax.tree.map(lambda x: x[inv], sp)

                n_alive = jnp.sum(s.alive.astype(jnp.int32))
                # cond's vjp allocates residual buffers for BOTH branches,
                # and the full-width fallback scan alone carries the plain
                # program's residual volume.  Checkpoint the fallback (rare
                # path: pay recompute only when capacity is actually
                # exceeded).
                fallback = jax.checkpoint(
                    lambda ss: scan_iters(ss, it0, it1), prevent_cse=False
                )
                return jax.lax.cond(n_alive <= width, narrow, fallback, s)

            if stages:
                # stages: ascending [(start_iter, width), ...] — iterations
                # before the first stage run full-width, each stage's span
                # runs at its capacity, exact by the cond fallback.
                cur = 0
                for i, (start_it, width) in enumerate(stages):
                    start_it = max(cur, min(start_it, max_iters))
                    state = scan_iters(state, cur, start_it)
                    end_it = (stages[i + 1][0] if i + 1 < len(stages)
                              else max_iters)
                    end_it = min(end_it, max_iters)
                    if start_it < end_it and width < r:
                        state = staged(state, start_it, end_it, width)
                    else:
                        state = scan_iters(state, start_it, end_it)
                    cur = end_it
                state = scan_iters(state, cur, max_iters)
            else:
                state = scan_iters(state, 0, max_iters)
        elif chunked and do_compact:
            # Survivor-compacted loop (sorted dead-last, live chunks only).
            return _chunked_forward(
                step, fs, state, max_iters, static, live_sync
            )
        else:
            # Forward-only: while_loop exits as soon as every lane is dead
            # (the terminator thread's `completed == X*Y*samples` spin,
            # worker.cpp:70-78, as a loop condition).  Under scene sharding
            # the liveness must be agreed over the scene axis (live_sync):
            # with rays sharded per chip (ring mode), per-chip exits would
            # desynchronize the ppermute/psum sequence and deadlock.
            def any_alive(s):
                n = jnp.sum(s.alive.astype(jnp.int32))
                return (live_sync(n) if live_sync is not None else n) > 0

            def cond(carry):
                it, s = carry
                return (it < max_iters) & any_alive(s)

            def wbody(carry):
                it, s = carry
                return it + 1, step(fs, it, s)

            _, state = jax.lax.while_loop(cond, wbody, (jnp.int32(0), state))
        return state.radiance, state.alpha

    return integrate
