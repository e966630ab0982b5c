"""Benchmark harness.

Primary metric: *paths/s* — camera paths fully traced per second (the
wavefront advanced to termination over all bounces), measured on whatever
backend JAX selects (the GPU on the card; CPU in tests).

``vs_baseline`` is the ratio against a **measured** run of the actual
reference C++ renderer (``path_tracer_lib/core/renderer.cpp``), compiled
standalone with ``tools/ref_baseline/build.sh`` and run on the same scene /
resolution / spp / bounces as the headline metric.

The JSON line also carries an ``extra`` dict: material and
full-resolution geometry backward grad-paths/s, the north-star configs
exactly (cornell at 256 spp, jack-class 512x512x64spp, and the reference's
own default 640x480x50spp workload with a measured same-scene ref_bench
baseline), jack-of-blades (textured + sun NEE), the sponza-new stand-in
(24 materials, 68M-texel pack), the structured architectural courtyard, a
1M-triangle synthetic soup, 1080p cornell
(auto-chunked launches), the transparent-background claim-blend path, and
a brute roofline.  Set ``PTX_BENCH_FULL=0`` for the headline metric only.

Run: ``python bench.py`` at the repo root (one JSON line on stdout).
"""

from __future__ import annotations

import os
import time
from typing import Optional

# MEASURED reference baseline (not an estimate): tools/ref_baseline driver
# around the reference's monolithic renderer, cornell-box 256x256, 16 spp,
# 4 bounces, all hardware threads -> 199,568 paths/s on a 2-vCPU Xeon
# @2.10GHz (elapsed 5.25 s), comparable to the reference's 4 GB Lambda
# budget (~2 vCPUs). Command:
#   sh tools/ref_baseline/build.sh && \
#   ./tools/ref_baseline/ref_bench scenes/cornell-box/cornell.gltf 256 256 16 4
BASELINE_PATHS_PER_SEC = 1.996e5

# MEASURED reference baseline at the reference's own default distributed
# workload — 640x480, 50 spp, <=10 bounces on sponza-new
# (events/event.json:39-42, worker.hpp:20-24) — run on the SAME
# deterministic sponza stand-in scene the ptx row renders (the real
# sponza.bin is S3-only; ptx.scene.standin).  Command (same 2-vCPU host):
#   ./tools/ref_baseline/ref_bench ~/.cache/ptx-scenes/sponza-new/scene.gltf \
#       640 480 50 10   -> ref_paths_per_sec=168671.1 elapsed_s=91.065
REF_DEFAULT_BASELINE = 1.68671e5

# MEASURED reference baselines at the other two north-star configs (same
# 2-vCPU host, same scenes/configs as the ptx rows):
#   ref_bench cornell.gltf 256 256 256 4  -> 226,091.7 paths/s (74.2 s)
#   ref_bench jack-of-blades.gltf 512 512 64 4 -> 436,604.7 paths/s (38.4 s)
# (jack's rate beats its cornell rate because the character covers a small
# screen fraction — most primary rays miss everything and terminate.)
REF_CORNELL_256SPP = 2.260917e5
REF_JACK_512_64 = 4.366047e5

CORNELL = "/root/reference/path-tracer-core/scenes/cornell-box/cornell.gltf"
JACK = (
    "/root/reference/path-tracer-core/scenes/jack-of-blades/jack-of-blades.gltf"
)

# FLOPs per Moller-Trumbore ray-triangle test (ptx.geometry.moller_trumbore,
# the brute oracle): 2 crosses (9 ea) + 3 dots (5 ea) + 1 div + 3 sub +
# 3 scale + ~8 cmp/select.
MT_FLOPS = 53

# Published peaks per device, keyed by ``device_kind``: (dense bf16 tensor
# FLOP/s, float32 FLOP/s outside the tensor cores, memory B/s).  Source:
# NVIDIA H100 SXM data sheet (dense rates, 700 W).  The ray-triangle test is
# a rank-4 contraction, so the tensor cores cannot carry it: its ceiling is
# the float32 rate or memory bandwidth.
CHIP_PEAKS = {
    "NVIDIA H100 80GB HBM3": (989e12, 67e12, 3.35e12),
}


def _device_peaks():
    """Peaks of the device JAX runs on; a device missing from the table is
    an error, not a default."""
    import jax

    kind = jax.devices()[0].device_kind
    if kind not in CHIP_PEAKS:
        raise KeyError(f"no published peaks for device {kind!r}")
    return CHIP_PEAKS[kind]


def _timed_passes(run_pass, reps: int):
    """Fastest of ``reps`` passes, each timed to ``block_until_ready``."""
    import jax

    dt = float("inf")
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        jax.block_until_ready(run_pass())
        dt = min(dt, time.perf_counter() - t0)
    return dt


def run_backward_bench(
    scene: Optional[str] = None,
    cfg=None,
    param_fields=("mat_albedo", "mat_emissive"),
    metric: str = "cornell_128x128x4spp_b4_backward",
) -> dict:
    """grad-paths/s: value+grad of the image MSE w.r.t. ``param_fields``
    through the full differentiable wavefront (BASELINE.md backward metric).

    Material/light params route to the fast shading-only custom_vjp path;
    geometry params (``tri_a``) route to the general differentiable scan
    whose backward flows through the Möller-Trumbore vjp
    (``inverse._resolve_diff_integrator``) — both regimes are benched.

    All cfg.samples passes are fused into ONE launch (sample-batched rays) —
    the same batching that drives the forward number; see
    ``inverse.make_batch_loss_fn``.
    """
    import jax
    import jax.numpy as jnp

    from ptx import render as R
    from ptx.config import RenderConfig
    from ptx.diff import inverse

    if cfg is None:
        cfg = RenderConfig(width=128, height=128, samples=4, bounces=4)
    scene = scene or CORNELL
    fs, static = R.load_scene(scene, quirks=cfg.quirks)
    # BVH-order the triangles + prepack traversal tiles up front: params
    # extracted AFTER the reorder stay index-aligned, the Pallas gate gets
    # leaf-contiguous (spatially tight) tiles, and the geometry-param path
    # refreshes the prepack once per loss eval instead of re-packing
    # inside every sweep (inverse.make_batch_value_and_grad_fn).
    fs, static = R.ensure_accel(fs, static, cfg, device=True)
    n_pixels = cfg.width * cfg.height
    target = jnp.zeros((n_pixels, 3))
    # Chunked forward+backward (inverse.make_batch_value_and_grad_fn):
    # residual memory is O(chunk), so geometry gradients run at full
    # resolution instead of OOMing past 64x64 (VERDICT r4 #1).
    grad_fn = jax.jit(inverse.make_batch_value_and_grad_fn(
        static, cfg, target, cfg.samples, param_fields=param_fields
    ))
    params = {f: getattr(fs, f) for f in param_fields}

    jax.block_until_ready(grad_fn(params, fs))
    dt = _timed_passes(lambda: grad_fn(params, fs), reps=2)
    paths = n_pixels * cfg.samples
    value = paths / dt
    return {
        "metric": metric,
        "value": round(value, 1),
        "unit": "grad-paths/s",
        "elapsed_s": round(dt, 3),
    }


def run_transparent_bench() -> dict:
    """Claim-blend (transparent background) cost vs the opaque running-mean
    fold (VERDICT r4 #9).

    Times the FULL production render() both ways — the claim semantics are
    order-dependent, so batched launches replay samples through a
    sequential ``fori_loop`` fold (``ptx.render._update_claim_batch``), a
    serialization cost that was only ever correctness-tested on CPU.  Reports the transparent path's paths/s with the opaque
    same-config number and the ratio alongside.
    """
    import dataclasses as _dc

    import jax

    from ptx import render as R
    from ptx.config import RenderConfig

    cfg_t = RenderConfig(width=256, height=256, samples=16, bounces=4,
                          transparent_background=True)
    cfg_o = _dc.replace(cfg_t, transparent_background=False)
    fs, static = R.load_scene(CORNELL, quirks=cfg_t.quirks, device=False)
    fs, static = R.ensure_accel(fs, static, cfg_t, device=True)
    paths = cfg_t.width * cfg_t.height * cfg_t.samples

    def time_mode(cfg):
        R.render(fs, static, cfg)  # compile + warm
        return _timed_passes(lambda: R.render(fs, static, cfg).color, 2)

    dt_o = time_mode(cfg_o)
    dt_t = time_mode(cfg_t)
    return {
        "metric": "cornell_256x256x16spp_b4_transparent",
        "value": round(paths / dt_t, 1),
        "unit": "paths/s",
        "elapsed_s": round(dt_t, 3),
        "opaque_paths_per_s": round(paths / dt_o, 1),
        "claim_over_opaque": round(dt_t / dt_o, 3),
    }


def _with_baseline(r: dict, baseline: float) -> dict:
    """Attach a measured same-config ref_bench baseline to a scene row."""
    r["vs_baseline"] = round(r["value"] / baseline, 3)
    r["baseline_paths_per_s"] = baseline
    return r


def run_ref_default_bench() -> dict:
    """The reference's default distributed workload (640x480, 50 spp, 10
    bounces, sponza-new — event.json:39-42) on the stand-in scene, with
    ``vs_baseline`` against the measured same-config same-scene ref_bench
    run (REF_DEFAULT_BASELINE)."""
    from ptx.config import RenderConfig

    r = run_scene_bench(
        _sponza_path(), "refdefault_640x480x50spp_b10_forward",
        RenderConfig(width=640, height=480, samples=50, bounces=10),
        reps=1, single_pass=True,
    )
    r["vs_baseline"] = round(r["value"] / REF_DEFAULT_BASELINE, 3)
    r["baseline_paths_per_s"] = REF_DEFAULT_BASELINE
    return r


def run_scene_bench(scene: str, metric: str, cfg, reps: int = 3,
                    single_pass: bool = False) -> dict:
    """paths/s on one scene/config via the production render path
    (sample-batched launches included).

    The full launch sequence is timed ``reps`` times and the fastest pass
    is reported: steady-state throughput, insulated from transient dispatch
    stalls.  ``single_pass``: for multi-second workloads (the 256-spp /
    512x512x64 / 640x480x50 north-star rows) one pass after warmup."""
    import jax
    import jax.numpy as jnp

    from ptx import render as R

    import sys

    t_load = time.perf_counter()
    fs, static = R.load_scene(scene, quirks=cfg.quirks, device=False)
    fs, static = R.ensure_accel(fs, static, cfg, device=True)
    t_accel = time.perf_counter()
    k = R.resolve_samples_per_launch(cfg)
    n_launches = -(-cfg.samples // k)
    if k > 1:
        fn = R.make_batched_sample_fn(static, cfg, k)
    else:
        fn = R.make_sample_fn(static, cfg)

    jax.block_until_ready(fn(fs, jnp.int32(0)))
    t_warm = time.perf_counter()
    print(
        f"[bench] {metric}: load+accel {t_accel - t_load:.1f}s, "
        f"compile+warmup {t_warm - t_accel:.1f}s",
        file=sys.stderr,
    )

    run = lambda: [fn(fs, jnp.int32(i * k)) for i in range(n_launches)]
    dt = _timed_passes(run, 1 if single_pass else reps)

    paths = cfg.width * cfg.height * k * n_launches
    value = paths / dt
    return {
        "metric": metric,
        "value": round(value, 1),
        "unit": "paths/s",
        "elapsed_s": round(dt, 3),
        "samples_per_launch": k,
        "n_tris": static.n_tris,
    }


def run_intersect_roofline(n_rays: int = 65536, n_tris: int = 65536) -> dict:
    """Speed-of-light account of the raw intersection sweep.

    A dense brute-force closest-hit sweep has an exactly known FLOP count
    (R x T Moller-Trumbore tests, no culling), so achieved FLOP/s is not a
    model — only the byte count is (triangle soup + ray IO read once from
    memory). Reported against the device's published peaks on the GPU.
    """
    import jax
    import jax.numpy as jnp

    from ptx import render as R
    from ptx.config import RenderConfig
    from ptx.kernels import intersect as intersect_mod

    cfg = RenderConfig(width=256, height=256, samples=1, bounces=1,
                       intersector="brute", sort_rays="off")
    fs, static = R.load_scene(f"synthetic:{n_tris}", quirks=cfg.quirks)
    closest, _ = intersect_mod.make_brute()

    from ptx.scene import camera as pcamera
    pixel_ids = jnp.arange(n_rays, dtype=jnp.int32) % (cfg.width * cfg.height)
    sample_ids = jnp.zeros((n_rays,), jnp.int32)
    orig, dirn = pcamera.generate_rays(
        fs, pixel_ids, sample_ids, cfg.width, cfg.height, cfg.seed,
        True, False,
    )
    sweep = jax.jit(lambda fs, o, d: closest(fs, o, d))
    jax.block_until_ready(sweep(fs, orig, dirn))
    dt = _timed_passes(lambda: sweep(fs, orig, dirn), reps=3)

    t_padded = int(static.n_tris_padded)
    tests = n_rays * t_padded
    flops = tests * MT_FLOPS
    # Minimum memory traffic: triangle soup (a,e1,e2 = 36 B) once per ray
    # block (assume perfect on-chip reuse within a 2048-ray block), rays in
    # (24 B), hit payload out (~64 B).
    n_blocks = max(n_rays // 2048, 1)
    bytes_min = t_padded * 36 * n_blocks + n_rays * (24 + 64)
    achieved_flops = flops / dt
    achieved_bw = bytes_min / dt
    row = {
        "metric": "brute_intersect_roofline",
        "rays": n_rays,
        "tris_padded": t_padded,
        "tri_tests_per_s": round(tests / dt, 1),
        "achieved_gflops": round(achieved_flops / 1e9, 1),
        "model_mem_gbps": round(achieved_bw / 1e9, 1),
        "elapsed_s": round(dt, 4),
    }
    if jax.default_backend() == "gpu":
        _, peak_f32, peak_bw = _device_peaks()
        row["sol_f32"] = round(achieved_flops / peak_f32, 4)
        row["sol_mem"] = round(achieved_bw / peak_bw, 4)
    return row


def _sponza_path() -> str:
    """The sponza-new stand-in (the reference's default worker fixture ships
    without its geometry buffer — ``ptx.scene.standin``)."""
    from ptx.scene.standin import sponza_standin

    return sponza_standin()


def extra_benches(tiny: bool = False):
    """The ``extra`` sub-bench table: ``name -> zero-arg callable``.

    ``tiny=True`` shrinks every entry to seconds-on-CPU sizes while walking
    the SAME code paths (scene files, loaders, batching, grad) — the smoke
    surface ``tests/test_bench.py`` runs so path/API breakage is caught
    before a device run (round 2's jack FileNotFoundError).
    """
    from ptx.config import RenderConfig

    if tiny:
        small = dict(width=16, height=16, samples=2, bounces=2,
                     intersector="auto")
        return {
            "backward": lambda: run_backward_bench(
                cfg=RenderConfig(**small)
            ),
            "vertex_backward": lambda: run_backward_bench(
                cfg=RenderConfig(**small),
                param_fields=("tri_a",), metric="vertex_backward_tiny",
            ),
            "intersect_roofline": lambda: run_intersect_roofline(
                n_rays=2048, n_tris=2048
            ),
            "jack_256x256x4spp_b4_forward": lambda: run_scene_bench(
                JACK, "jack_tiny_forward", RenderConfig(**small)
            ),
            "sponza_256x256x4spp_b4_forward": lambda: run_scene_bench(
                _sponza_path(), "sponza_tiny_forward", RenderConfig(**small)
            ),
            "soup1m_256x256x4spp_b4_forward": lambda: run_scene_bench(
                "synthetic:8192", "soup_tiny_forward", RenderConfig(**small)
            ),
        }
    full = dict(width=256, height=256, samples=4, bounces=4,
                )
    # Ordered by evidentiary value: whatever the deadline cuts off, the
    # roofline + backward numbers land first (VERDICT r3 "done" criteria).
    return {
        "backward": run_backward_bench,
        # Jack, not cornell: a closed flat-diffuse box is almost-everywhere
        # FLAT in vertex translations (tests/test_diff.py), so its vertex
        # gradient is structurally zero; jack's sun NEE + textures make the
        # geometry gradient real while still timing the same general
        # differentiable scan through the Moller-Trumbore vjp.
        # Full 128x128 thanks to the chunked vjp: pixel-chunked
        # forward+backward bounds residuals to one chunk
        # (inverse.make_batch_value_and_grad_fn, VERDICT r4 #1).
        "vertex_backward": lambda: run_backward_bench(
            scene=JACK,
            cfg=RenderConfig(width=128, height=128, samples=4, bounces=4),
            param_fields=("tri_a",),
            metric="jack_128x128x4spp_b4_vertex_backward",
        ),
        # --- north-star configs, exactly as specified (VERDICT r4 #2) ---
        # BASELINE.md's target metric is rays/sec/device at **256 spp**:
        "cornell_256x256x256spp_b4_forward": lambda: _with_baseline(
            run_scene_bench(
                CORNELL, "cornell_256x256x256spp_b4_forward",
                RenderConfig(width=256, height=256, samples=256, bounces=4),
                reps=1, single_pass=True,
            ), REF_CORNELL_256SPP,
        ),
        # BASELINE.json config #3: bundled glTF mesh scene, 512x512, 64 spp.
        "jack_512x512x64spp_b4_forward": lambda: _with_baseline(
            run_scene_bench(
                JACK, "jack_512x512x64spp_b4_forward",
                RenderConfig(width=512, height=512, samples=64, bounces=4),
                reps=1, single_pass=True,
            ), REF_JACK_512_64,
        ),
        # The reference's own default distributed workload: 640x480, 50 spp,
        # <=10 bounces on sponza-new (events/event.json:39-42,
        # worker.hpp:20-24), with a SAME-CONFIG measured ref_bench baseline
        # on the same stand-in scene (see REF_DEFAULT_BASELINE).
        "refdefault_640x480x50spp_b10_forward": run_ref_default_bench,
        "jack_256x256x4spp_b4_forward": lambda: run_scene_bench(
            JACK, "jack_256x256x4spp_b4_forward", RenderConfig(**full),
            reps=2,
        ),
        "sponza_256x256x4spp_b4_forward": lambda: run_scene_bench(
            _sponza_path(), "sponza_256x256x4spp_b4_forward",
            RenderConfig(**full), reps=1,
        ),
        "soup1m_256x256x4spp_b4_forward": lambda: run_scene_bench(
            "synthetic:1000000", "soup1m_256x256x4spp_b4_forward",
            RenderConfig(**full), reps=1,
        ),
        # Structured architectural scene (VERDICT r4 #5): coherent normals,
        # real occlusion (courtyard + colonnades + skylight sun), ~273k
        # tris — calibrates the soup-based sponza stand-in rows.
        "arch300k_256x256x4spp_b4_forward": lambda: run_scene_bench(
            "arch:300000", "arch300k_256x256x4spp_b4_forward",
            RenderConfig(**full), reps=1,
        ),
        # The reference's monolithic-renderer resolution (renderer.hpp:21):
        # 2.07M rays/sample auto-chunk into 72 launches of 28800 rays
        # (resolve_rays_per_batch), the measured large-frame optimum.
        "cornell_1080p_4spp_b4_forward": lambda: run_scene_bench(
            CORNELL, "cornell_1080p_4spp_b4_forward",
            RenderConfig(width=1920, height=1080, samples=4, bounces=4),
            reps=2,
        ),
        "transparent": run_transparent_bench,
        "intersect_roofline": lambda: run_intersect_roofline(
            n_rays=32768
        ),
    }


def run_bench(
    scene: Optional[str] = None,
    cfg=None,
    warmup_samples: int = 1,
    tiny: bool = False,
    emit=None,
    deadline: Optional[float] = None,
) -> dict:
    """Measure the headline + extras.

    ``emit(result)`` (when given) is called the moment the headline is
    measured and again after every completed extra, so the caller can print
    a complete JSON line incrementally — a hung or deadline-cut extra can
    never swallow the headline (round 3's rc-124 lesson).  ``deadline`` is a
    ``time.monotonic()`` value past which no further extra *starts*.
    """
    import jax

    from ptx.config import RenderConfig

    if cfg is None:
        if tiny:
            cfg = RenderConfig(width=32, height=32, samples=2, bounces=2,
                               intersector="auto")
        else:
            cfg = RenderConfig(width=256, height=256, samples=16, bounces=4)
    result = run_scene_bench(
        scene or CORNELL, "cornell_256x256x16spp_b4_forward", cfg
    )
    value = result["value"]
    result["vs_baseline"] = round(value / BASELINE_PATHS_PER_SEC, 3)
    result["baseline_paths_per_s"] = BASELINE_PATHS_PER_SEC
    result["device"] = str(jax.devices()[0])
    if emit is not None:
        emit(result)

    if os.environ.get("PTX_BENCH_FULL", "1") != "0":
        # Wall-clock budget for the extra sub-benches; whatever doesn't fit
        # is marked skipped so the headline JSON line always lands.
        if deadline is None:
            budget_s = float(os.environ.get("PTX_BENCH_BUDGET_S", "420"))
            deadline = time.monotonic() + budget_s
        extra = {}
        result["extra"] = extra

        def _run(name, fn):
            late = time.monotonic() - deadline
            if late > 0:
                extra[name] = {"skipped": f"deadline ({late:.0f}s past)"}
                return
            t0 = time.perf_counter()
            try:
                extra[name] = fn()
            except Exception as e:  # pragma: no cover - bench resilience
                if tiny:
                    raise
                extra[name] = {"error": repr(e)}
            extra[name]["total_s"] = round(time.perf_counter() - t0, 1)
            print(f"[bench] {name}: {extra[name]}", file=__import__("sys").stderr)
            if emit is not None:
                emit(result)

        for name, fn in extra_benches(tiny).items():
            _run(name, fn)
        if emit is not None:
            emit(result)  # record skipped/error markers in the final line
    return result
