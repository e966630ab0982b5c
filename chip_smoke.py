#!/usr/bin/env python3
"""On-card smoke run of ptx's render and inverse paths.

    python chip_smoke.py           # one GPU: every phase below
    python chip_smoke.py --four    # four GPUs: the distributed phase only

Phases (one process, the CLI called in-process through ``ptx.cli.main``):

1. device: a GPU must be JAX's device (no CPU fallback); prints the card and
   the intersector each scene resolves to, which must be the measured choice;
2. kernels: the BVH walk kernel compiled for the card at the real width
   (307,200 camera rays of ``arch:300000`` at 640x480 plus one bounce of
   secondary rays) against the brute Möller-Trumbore oracle, and again after
   lifting triangles out of their boxes and refitting the tree;
3. render: ``ptx.cli render`` of ``arch:300000`` at 640x480, 8 spp, 10
   bounces, against the same render through the XLA walk, plus paths/s;
4. inverse: ``ptx.cli invert`` with the material params and with ``tri_a``
   (through the refit BVH); the loss must fall.

The last line of standard output is one JSON object naming the device; it is
printed only when every phase passed.  Any failure exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

MAIN_SCENE = "arch:300000"
SMALL_SCENE = "synthetic:8192"
WIDTH, HEIGHT = 640, 480
OUT_DIR = "smoke_out"

# Kernel vs brute oracle, float32: the same hit mask; the same triangle
# except at near-ties (two triangles whose t differ by rounding), at most
# TRI_MISMATCH_MAX of the rays; t within T_REL_MAX relative error (taken
# against at least 1 cm: a ray leaving a surface can hit at t ~ 0).
TRI_MISMATCH_MAX = 1e-4
T_REL_MAX = 1e-5
# Kernel render vs XLA-walk render, linear HDR.  Both walks answer every
# query of the render alike (checked query by query on the H100), but the
# two executables recompute the hit attributes in different fusions, and
# last-bit differences send a few paths another way: one sample's radiance
# over the spp in a few pixels.  Readings on the H100 at 640x480x8 spp
# (two compiles): mean-abs 3.3e-9 and 1.2e-5, max-abs 1.9e-6 and 0.26,
# pixels off by more than 1e-3: 0 and 2.7e-4 of the frame.
RENDER_MEAN_ABS_MAX = 1e-4
RENDER_MAX_ABS_MAX = 1.0
RENDER_FRAC_PX_MAX = 1e-3
# Distributed vs one-card render of the same job, linear HDR: another
# executable again, so the same few-path band.  Readings on four H100s at
# 640x480x4 spp: dp4 bit-identical; tp4-reduce and tp4-ring mean-abs
# 2.4e-12, max-abs 7.2e-7, no pixel off by 1e-3.  (While the camera's 3x3
# product was a matrix product, whose GEMM routine XLA picks per shape, dp4
# and tp4-ring read mean-abs 1.4e-5, max-abs 0.517.)
DIST_MEAN_ABS_MAX = 1e-4
DIST_MAX_ABS_MAX = 1.0
DIST_FRAC_PX_MAX = 1e-3

# Vertex lift for the refit check: far past a leaf box's EPS padding.
REFIT_LIFT = 0.3

# The intersector each scene resolves to on the GPU: the measured winner.
EXPECTED_INTERSECTOR = {MAIN_SCENE: "pallas", SMALL_SCENE: "pallas"}


def card_info() -> str:
    """``name, power.limit`` of every card, read without touching JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def phase_device(platform: str = "gpu", count: int = 1):
    import jax

    devs = jax.devices()
    if devs[0].platform != platform:
        raise RuntimeError(
            f"JAX runs on {devs[0].platform!r}, not {platform!r}")
    if len(devs) < count:
        raise RuntimeError(f"{len(devs)} devices, need {count}")
    print(f"device: {devs[0].device_kind} x{len(devs)} ({platform})")
    return devs


def phase_resolution(scenes=(MAIN_SCENE, SMALL_SCENE), platform="gpu",
                     expected=EXPECTED_INTERSECTOR):
    from ptx import render as R
    from ptx.config import RenderConfig

    for spec in scenes:
        _, static = R.load_scene(spec, device=False)
        name = R.resolve_intersector(static, RenderConfig(), platform)
        print(f"resolved {spec} ({static.n_tris} tris): intersector={name} "
              f"shader=xla")
        if name != expected[spec]:
            raise RuntimeError(
                f"{spec}: resolved {name!r}, measured winner "
                f"{expected[spec]!r}")


def _secondary_rays(orig, dirn, hit, seed=7):
    """One bounce: from each primary hit, a random direction into the
    hemisphere of the geometric normal (misses keep their ray)."""
    import jax
    import jax.numpy as jnp

    d = jax.random.normal(jax.random.PRNGKey(seed), orig.shape)
    d = d / jnp.linalg.norm(d, axis=1, keepdims=True)
    facing = jnp.sum(d * hit.normal, axis=1, keepdims=True)
    d = jnp.where(facing < 0, -d, d)
    o = jnp.where(hit.hit[:, None], hit.position + d * 1e-4, orig)
    return o, jnp.where(hit.hit[:, None], d, dirn)


def agreement(fs, leaf_size, orig, dirn, label, interpret=False):
    """Kernel against the brute oracle on one ray set: the walk's selection
    (closest and any-hit) and the production ``closest`` payload, whose XLA
    recompute may drop a hit the kernel selected."""
    import jax
    import numpy as np

    from ptx.kernels import intersect as brute
    from ptx.kernels import traverse_pallas as tk

    def closest(fs, o, d):
        return tk.select(fs, o, d, leaf_size, interpret=interpret)

    def any_hit(fs, o, d):
        return tk.select(fs, o, d, leaf_size, any_hit=True,
                         interpret=interpret)[0] < tk.INF

    def payload(fs, o, d):
        h = tk.closest(fs, o, d, leaf_size, interpret=interpret)
        return h.hit, h.t

    compiled = jax.jit(closest).lower(fs, orig, dirn).compile()
    print(f"[{label}] kernel memory_analysis: {compiled.memory_analysis()}")
    t, tri = compiled(fs, orig, dirn)
    occluded = jax.jit(any_hit)(fs, orig, dirn)
    phit, pt = jax.jit(payload)(fs, orig, dirn)
    bt, btri, _, _, bhit = jax.jit(brute.brute_closest)(fs, orig, dirn)
    bany = jax.jit(brute.brute_any)(fs, orig, dirn)
    t, tri, phit, pt, bt, btri, bhit, occluded, bany = map(
        np.asarray, (t, tri, phit, pt, bt, btri, bhit, occluded, bany))
    hit = t < tk.INF
    n = hit.size
    # The oracle's own any-hit and closest-hit reductions compile to
    # different fusions and can round an edge-grazing ray apart; the
    # occlusion answer of such a ray is open, and only the rays on which
    # the two agree decide the kernel's any-hit.
    settled = bany == bhit

    def t_err(t, hit):
        both = bhit & hit
        return float(np.max(np.abs(t[both] - bt[both])
                            / np.maximum(bt[both], 1e-2), initial=0.0))

    res = {
        "rays": int(n),
        "hit_mask_mismatch": int((hit != bhit).sum()),
        "any_hit_mismatch": int((occluded != bany)[settled].sum()),
        "brute_any_vs_closest": int((~settled).sum()),
        "kernel_any_vs_closest": int((occluded != hit).sum()),
        "tri_mismatch_frac": float((tri[bhit] != btri[bhit]).sum() / n),
        "t_max_rel_err": t_err(t, hit),
        "payload_hit_mismatch": int((phit != bhit).sum()),
        "payload_t_max_rel_err": t_err(pt, phit),
    }
    print(f"[{label}] vs brute: {json.dumps(res)}")
    return res


def compare_with_brute(fs, leaf_size, orig, dirn, label, interpret=False):
    """:func:`agreement`, raising past the tolerance."""
    res = agreement(fs, leaf_size, orig, dirn, label, interpret)
    if (res["hit_mask_mismatch"] or res["any_hit_mismatch"]
            or res["payload_hit_mismatch"]
            or res["tri_mismatch_frac"] > TRI_MISMATCH_MAX
            or max(res["t_max_rel_err"], res["payload_t_max_rel_err"])
            > T_REL_MAX):
        raise RuntimeError(f"{label}: kernel disagrees with brute: {res}")
    return res


def check_refit(fs, static, orig, dirn, interpret=False, lift=REFIT_LIFT):
    """Lift every other triangle by ``lift`` m, out of its leaf box, through
    ``inverse.inject_params`` (which refits the tree).  The kernel on the
    refit tree must match brute on the moved scene; on the build-time boxes
    it must not, or the lift left the refit untested."""
    import jax
    import jax.numpy as jnp

    from ptx.diff import inverse

    up = jnp.where((jnp.arange(fs.tri_a.shape[0]) % 2 == 0)[:, None],
                   jnp.array([0.0, lift, 0.0]), 0.0)
    moved = jax.jit(lambda fs, a: inverse.inject_params(
        fs, {"tri_a": a}, static))(fs, fs.tri_a + up)
    stale = moved._replace(bvh_min=fs.bvh_min, bvh_max=fs.bvh_max)
    old = agreement(stale, static.bvh_leaf_size, orig, dirn,
                    "moved, build-time boxes", interpret)
    if not (old["hit_mask_mismatch"] or old["tri_mismatch_frac"]):
        raise RuntimeError("the lift changed no ray's answer on the "
                           "build-time boxes: the refit went untested")
    return compare_with_brute(moved, static.bvh_leaf_size, orig, dirn,
                              "moved, refit boxes", interpret)


def phase_kernels(scene=MAIN_SCENE, width=WIDTH, height=HEIGHT,
                  interpret=False):
    import jax.numpy as jnp

    from ptx import render as R
    from ptx.config import RenderConfig
    from ptx.kernels import intersect as brute
    from ptx.scene import camera as pcamera

    fs, static = R.load_scene(scene, device=False)
    fs, static = R.ensure_accel(fs, static, RenderConfig(intersector="pallas"),
                                device=True)
    pix = jnp.arange(width * height, dtype=jnp.int32)
    orig, dirn = pcamera.generate_rays(fs, pix, jnp.zeros_like(pix),
                                       width, height)
    out = [compare_with_brute(fs, static.bvh_leaf_size, orig, dirn,
                              "primary", interpret)]
    h = brute.brute_closest_attrs(fs, orig, dirn)
    o2, d2 = _secondary_rays(orig, dirn, h)
    out.append(compare_with_brute(fs, static.bvh_leaf_size, o2, d2,
                                  "secondary", interpret))
    out.append(check_refit(fs, static, orig, dirn, interpret))
    return out


def _cli(argv):
    """Run ``ptx.cli.main`` in-process; returns (stdout, stderr) and
    raises on a non-zero return code."""
    from ptx.cli import main

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    if rc != 0:
        raise RuntimeError(f"ptx {' '.join(argv)} -> rc {rc}")
    return out.getvalue(), err.getvalue()


def _cli_render(scene, width, height, samples, bounces, out_png,
                intersector="auto"):
    """``ptx.cli render`` to a PNG; returns the linear HDR mean [H, W, 3]
    from the final checkpoint the same call writes."""
    from ptx.io import checkpoint as ckpt

    ck = os.path.splitext(out_png)[0] + ".ckpt.npz"
    for stale in (ck, out_png):
        if os.path.exists(stale):
            os.remove(stale)
    t0 = time.perf_counter()
    _, err = _cli(["render", "--scene", scene, "--width", str(width),
                   "--height", str(height), "--samples", str(samples),
                   "--bounces", str(bounces), "--metrics",
                   "--intersector", intersector, "--out", out_png,
                   "--checkpoint", ck, "--checkpoint-every", str(samples)])
    wall = time.perf_counter() - t0
    print(f"render {scene} intersector={intersector}: wall {wall:.1f} s "
          f"(load, BVH build and compile included)")
    print("\n".join("  " + l for l in err.strip().splitlines()[-6:]))
    return ckpt.load(ck).color.reshape(height, width, 3)


def sun_shadow_contrast(scene, width, height, hdr):
    """Mean HDR of primary-hit pixels the sun reaches against those it does
    not (occluded, or facing away): the atrium must be the brighter."""
    import jax.numpy as jnp
    import numpy as np

    from ptx import render as R
    from ptx.kernels import intersect as brute
    from ptx.scene import camera as pcamera

    fs, _ = R.load_scene(scene)
    pix = jnp.arange(width * height, dtype=jnp.int32)
    orig, dirn = pcamera.generate_rays(fs, pix, jnp.zeros_like(pix),
                                       width, height)
    h = brute.brute_closest_attrs(fs, orig, dirn)
    sun = jnp.broadcast_to(fs.sun_dir, dirn.shape)
    facing = jnp.sum(h.normal * sun, axis=1) > 0
    blocked = brute.brute_any(fs, h.position + sun * 1e-4, sun)
    lit = np.asarray(h.hit & facing & ~blocked)
    dark = np.asarray(h.hit & ~lit)
    y = hdr.reshape(-1, 3).mean(axis=1)
    return float(y[lit].mean()), float(y[dark].mean())


def _render_diff(a, b):
    import numpy as np

    diff = np.abs(a - b)
    return {"bit_identical": bool((diff == 0).all()),
            "mean_abs": float(diff.mean()), "max_abs": float(diff.max()),
            "frac_px_over_1e-3": float((diff.max(axis=-1) > 1e-3).mean())}


def phase_render(scene=MAIN_SCENE, width=WIDTH, height=HEIGHT, samples=8,
                 bounces=10, out_dir=OUT_DIR, card=None):
    import numpy as np

    os.makedirs(out_dir, exist_ok=True)
    png = os.path.join(out_dir, "smoke_render.png")
    img = _cli_render(scene, width, height, samples, bounces, png)
    ref = _cli_render(scene, width, height, samples, bounces,
                      os.path.join(out_dir, "smoke_render_xla_bvh.png"),
                      intersector="bvh")
    if not np.isfinite(img).all() or img.max() <= 0:
        raise RuntimeError("render is non-finite or black")
    lit, dark = sun_shadow_contrast(scene, width, height, img)
    res = dict(_render_diff(img, ref), sunlit_mean=lit, shadow_mean=dark)
    print(f"render vs XLA walk: {json.dumps(res)}")
    if not lit > dark:
        raise RuntimeError(f"sunlit {lit} not brighter than shadow {dark}")
    if (res["mean_abs"] > RENDER_MEAN_ABS_MAX
            or res["max_abs"] > RENDER_MAX_ABS_MAX
            or res["frac_px_over_1e-3"] > RENDER_FRAC_PX_MAX):
        raise RuntimeError(f"kernel render disagrees with the XLA walk: {res}")
    res["paths_per_s"] = steady_paths_per_s(scene, width, height, samples,
                                            bounces)[0]
    print(f"paths/s {res['paths_per_s']:.1f} on {card or card_info()}")
    return res


def steady_paths_per_s(scene, width, height, samples, bounces,
                       intersector="auto", repeats=1):
    """Paths/s of the production render loop with its executables warm,
    one figure per repeat: a one-sample render compiles the pass, the
    accumulation and the finalize, then each ``samples`` render is timed."""
    import dataclasses

    from ptx import render as R
    from ptx.config import RenderConfig

    cfg = RenderConfig(width=width, height=height, samples=samples,
                       bounces=bounces, intersector=intersector)
    fs, static = R.load_scene(scene, device=False)
    fs, static = R.ensure_accel(fs, static, cfg, device=True)
    k = R.resolve_samples_per_launch(cfg)
    if k > 1:
        batch_fn, sample_fn = R.make_batched_sample_fn(static, cfg, k), None
    else:
        batch_fn, sample_fn = None, R.make_sample_fn(static, cfg)
    R.progressive_render(fs, static, dataclasses.replace(cfg, samples=1),
                         sample_fn, batch_fn, k)
    rates = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        res = R.progressive_render(fs, static, cfg, sample_fn, batch_fn, k)
        rates.append(width * height * samples / (time.perf_counter() - t0))
        assert res.color.shape == (height, width, 3)
    return rates


# Adam moves every parameter by about lr per step.  Materials: below the
# CLI's 0.05, which the reference's x10 emissive quirk turns into an
# overshoot on a sunlit scene.  Vertices: the detached-sampling gradient
# sees only the smooth part of the image (no silhouette term), and each
# triangle's vertex moves on its own, opening cracks between neighbours, so
# a step must stay far below the distance at which edges or cracks sweep
# over pixel samples.
INVERSE_LR = {"mat_albedo,mat_emissive": 0.01, "tri_a": 1e-6}


def phase_inverse(scene=MAIN_SCENE, width=128, height=128, samples=4,
                  bounces=4, steps=5, lrs=INVERSE_LR):
    """``ptx.cli invert`` for each parameter set in ``lrs``."""
    out = {}
    for p, lr in lrs.items():
        text, _ = _cli(["invert", "--scene", scene, "--width", str(width),
                        "--height", str(height), "--samples", str(samples),
                        "--bounces", str(bounces), "--steps", str(steps),
                        "--lr", str(lr), "--params", p])
        losses = [float(x) for x in re.findall(r"loss ([0-9.eE+-]+)", text)]
        rate = re.search(r"grad-paths/s ([0-9.eE+-]+)", text)
        first, last = losses[0], losses[-1]
        out[p] = {"first_loss": first, "final_loss": last,
                  "grad_paths_per_s": float(rate.group(1)) if rate else None}
        print(f"invert --params {p}: {json.dumps(out[p])}")
        if not (all(map(lambda v: v == v and abs(v) < float("inf"), losses))
                and last < first):
            raise RuntimeError(f"invert --params {p}: loss did not fall "
                               f"({first} -> {last})")
    return out


def phase_four(scene=MAIN_SCENE, width=WIDTH, height=HEIGHT, samples=4,
               bounces=10, n=4, intersector="auto"):
    """The distributed path on ``n`` cards: dp, tp/reduce and tp/ring
    renders against the one-card render, and one distributed material
    gradient step against the one-card gradient.  Each render is also set
    beside a one-card render launched at the per-card width of the
    ray-sharded plans, which tells a difference of launch shape from one of
    the distributed path itself."""
    import dataclasses

    from ptx import render as R
    from ptx.config import RenderConfig
    from ptx.parallel import dist, mesh as pmesh

    cfg = RenderConfig(width=width, height=height, samples=samples,
                       bounces=bounces, intersector=intersector)
    fs, static = R.load_scene(scene, device=False)
    one = R.render(fs, static, cfg).color
    n_px = width * height
    narrow_width = (dist.launch_chunk(n_px, n) or n_px) // n
    narrow = R.render(fs, static, dataclasses.replace(
        cfg, rays_per_batch=narrow_width)).color
    print(f"one card, {narrow_width} vs {R.resolve_rays_per_batch(cfg) or n_px}"
          f" rays/launch: {json.dumps(_render_diff(narrow, one))}")
    out = {}
    for name, plan, comm in [
        ("dp4", pmesh.Plan(dp=n, tp=1, scene_sharded=False), "reduce"),
        ("tp4_reduce", pmesh.Plan(dp=1, tp=n, scene_sharded=True), "reduce"),
        ("tp4_ring", pmesh.Plan(dp=1, tp=n, scene_sharded=True), "ring"),
    ]:
        mesh = pmesh.make_mesh(plan)
        print(f"{name}: mesh devices {mesh.devices.tolist()}")
        fs_mesh, _ = dist.prepare_scene(fs, static, cfg, plan, mesh)
        leaf = fs_mesh.tri_a
        print(f"{name}: tri_a shards on "
              f"{[sorted(d.id for d in s.data.devices()) for s in leaf.addressable_shards]}")
        t0 = time.perf_counter()
        got = dist.render_distributed(fs, static, cfg, plan=plan, mesh=mesh,
                                      comm=comm).color
        wall = time.perf_counter() - t0
        out[name] = _render_diff(got, one)
        out[name]["wall_s_incl_compile"] = round(wall, 1)
        print(f"{name} vs one card: {json.dumps(out[name])}")
        print(f"{name} vs one card at {narrow_width} rays/launch: "
              f"{json.dumps(_render_diff(got, narrow))}")
        if (out[name]["mean_abs"] > DIST_MEAN_ABS_MAX
                or out[name]["max_abs"] > DIST_MAX_ABS_MAX
                or out[name]["frac_px_over_1e-3"] > DIST_FRAC_PX_MAX):
            raise RuntimeError(f"{name} disagrees with one card: {out[name]}")
    out["grad_step"] = distributed_grad_step(scene, n,
                                             intersector=intersector)
    return out


def distributed_grad_step(scene=MAIN_SCENE, n=4, width=64, height=64,
                          bounces=2, intersector="auto"):
    """One material-gradient step over a dp x tp mesh (rays over dp, the
    scene over tp with a BVH per shard) against the same gradient on one
    device.  A near-tie ray that takes another path changes one sample of
    one pixel, so the loss is held to 1e-3 and each gradient to 1e-2 of its
    largest entry."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ptx import render as R
    from ptx.config import RenderConfig
    from ptx.diff.inverse import inject_params
    from ptx.integrator.wavefront import make_integrator
    from ptx.parallel import dist, mesh as pmesh

    cfg = RenderConfig(width=width, height=height, samples=1,
                       bounces=bounces, intersector=intersector)
    host_fs, host_static = R.load_scene(scene, device=False)
    n_pixels = width * height
    pix = jnp.arange(n_pixels, dtype=jnp.int32)
    smp = jnp.zeros_like(pix)
    target = jnp.zeros((n_pixels, 3))

    def grads(fs_in, static, integrator):
        params = {"mat_albedo": fs_in.mat_albedo,
                  "mat_emissive": fs_in.mat_emissive}

        def loss(p):
            radiance, _ = integrator(inject_params(fs_in, p, static), pix, smp)
            return jnp.mean((radiance - target) ** 2)

        return jax.jit(jax.value_and_grad(loss))(params)

    fs, static = R.ensure_accel(host_fs, host_static, cfg, device=True)
    closest, any_hit = R.get_backend(static, cfg)
    v1, g1 = grads(fs, static, make_integrator(static, cfg, closest, any_hit,
                                               differentiable=True))

    tp = 2 if n % 2 == 0 else 1
    plan = pmesh.Plan(dp=n // tp, tp=tp, scene_sharded=tp > 1)
    mesh = pmesh.make_mesh(plan)
    fs_mesh, local = dist.prepare_scene(host_fs, host_static, cfg, plan, mesh)
    closest, any_hit = R.get_backend(local, cfg)
    if plan.scene_sharded:
        closest = dist.sharded_closest(closest)
        any_hit = dist.sharded_any_hit(any_hit)
    inner = jax.shard_map(
        make_integrator(local, cfg, closest, any_hit, differentiable=True),
        mesh=mesh,
        in_specs=(pmesh.scene_shardings(mesh, plan.scene_sharded,
                                        shard_bvh=plan.scene_sharded
                                        and local.n_bvh_nodes > 0),
                  P(pmesh.AXIS_RAYS), P(pmesh.AXIS_RAYS)),
        out_specs=(P(pmesh.AXIS_RAYS), P(pmesh.AXIS_RAYS)),
        check_vma=False)
    vn, gn = grads(fs_mesh, local, inner)
    res = {"mesh": f"dp={plan.dp} tp={plan.tp}",
           "loss_rel_err": float(abs(vn - v1) / abs(v1)),
           "grad_max_rel_err": max(
               float(jnp.max(jnp.abs(gn[k] - g1[k]))
                     / jnp.maximum(jnp.max(jnp.abs(g1[k])), 1e-30))
               for k in g1)}
    print(f"distributed grad step vs one device: {json.dumps(res)}")
    if res["loss_rel_err"] > 1e-3 or res["grad_max_rel_err"] > 1e-2:
        raise RuntimeError(f"distributed gradient disagrees: {res}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the distributed phase, on four GPUs")
    args = ap.parse_args(argv)

    from ptx.utils import enable_compile_cache

    import jax

    enable_compile_cache(jax)
    count = 4 if args.four else 1
    devs = phase_device("gpu", count)
    print(card_info())
    t0 = time.perf_counter()
    if args.four:
        phase_four()
    else:
        phase_resolution()
        phase_kernels()
        phase_render()
        phase_inverse()
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(card_info())
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
