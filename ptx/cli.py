"""Command-line entry points: render / invert / bench.

The reference's "CLI" is a Lambda payload (``events/event.json``) posted at a
deployed endpoint; here the same knobs are flags (or ``--config config.json``
using the payload-style :class:`ptx.config.RenderConfig` schema).

Usage:
    python -m ptx.cli render --scene scenes/cornell.gltf --out out.png \
        --width 256 --height 256 --samples 16 --bounces 4
    python -m ptx.cli bench --scene scenes/cornell.gltf
    python -m ptx.cli invert --scene scenes/cornell.gltf --steps 100
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _add_render_args(p: argparse.ArgumentParser):
    p.add_argument("--scene", required=True)
    p.add_argument("--out", default="out.png")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--samples", type=int, default=50)
    p.add_argument("--bounces", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--intersector", default="auto",
                   choices=["auto", "brute", "bvh", "pallas"])
    p.add_argument("--transparent-background", action="store_true")
    p.add_argument("--physical", action="store_true",
                   help="physically-correct mode instead of reference quirks")
    p.add_argument("--quirks", default="worker",
                   choices=["worker", "monolithic", "physical"],
                   help="reference semantics: wavefront worker (default), "
                        "monolithic renderer (out<=in indirect clamp, no RR), "
                        "or physical")
    p.add_argument("--sort-rays", default="auto",
                   choices=["auto", "on", "off"],
                   help="per-bounce ray sorting / wavefront compaction")
    p.add_argument("--config", help="JSON RenderConfig (overrides other flags)")
    p.add_argument("--checkpoint", help="checkpoint file for save/resume")
    p.add_argument("--env", help="environment map image (.hdr or LDR)")
    p.add_argument("--visualize", choices=["depth", "normals", "bvh-depth",
                                           "nan-check"],
                   help="debug visualization instead of a beauty render")
    p.add_argument("--checkpoint-every", type=int, default=5)
    p.add_argument("--cpu", action="store_true", help="force the CPU backend")
    p.add_argument("--distributed", action="store_true",
                   help="render over the full device mesh (multi-chip/host; "
                        "initializes jax.distributed on pods)")
    p.add_argument("--tp", type=int, default=None,
                   help="force the scene-sharding axis size (default: "
                        "planner picks from scene size vs device memory)")
    p.add_argument("--comm", default="reduce", choices=["reduce", "ring"],
                   help="scene-axis exchange: psum-min reduce or ring "
                        "ppermute schedule")
    p.add_argument("--profile", metavar="DIR",
                   help="write a jax.profiler trace to DIR (TensorBoard/xprof)")
    p.add_argument("--metrics", action="store_true",
                   help="print per-phase timing/throughput at the end")


def _config_from_args(args):
    from ptx.config import Quirks, RenderConfig

    if args.config:
        with open(args.config) as f:
            return RenderConfig.from_json(f.read())
    mode = "physical" if args.physical else getattr(args, "quirks", "worker")
    quirks = {
        "worker": Quirks,
        "monolithic": Quirks.monolithic,
        "physical": Quirks.physical,
    }[mode]()
    return RenderConfig(
        width=args.width,
        height=args.height,
        samples=args.samples,
        bounces=args.bounces,
        seed=args.seed,
        intersector=args.intersector,
        transparent_background=args.transparent_background,
        sort_rays=getattr(args, "sort_rays", "auto"),
        quirks=quirks,
    )


def cmd_render(args) -> int:
    if args.distributed:
        # Must run before anything touches the XLA backend (scene load
        # included): on pods this wires every host into one runtime.
        from ptx.parallel import multihost

        multihost.initialize()

    from ptx import render as R
    from ptx.io.png import write_png

    cfg = _config_from_args(args)
    env_image = None
    if args.env:
        from ptx.io.hdr import load_env_image

        env_image = load_env_image(args.env)
    t0 = time.time()
    fs, static = R.load_scene(args.scene, quirks=cfg.quirks, env_image=env_image,
                              device=False)
    t_load = time.time() - t0
    print(f"loaded {static.n_tris} triangles, {static.n_materials} materials "
          f"in {t_load:.2f}s (sun={static.has_sun})", file=sys.stderr)

    if args.visualize:
        from ptx.debug import visualize

        img = visualize(fs, static, cfg, args.visualize)
        write_png(args.out, img)
        print(f"wrote {args.visualize} visualization to {args.out}",
              file=sys.stderr)
        return 0

    def progress(done, total):
        print(f"\rsample {done}/{total}", end="", file=sys.stderr)

    from ptx.utils import Metrics, profiler_trace

    metrics = Metrics() if (args.metrics or args.profile) else None
    # Periodic viewable preview (reference renderer.cpp:409-424) lands next
    # to the output: out.png -> out.preview.png.
    import os as _os

    preview = (_os.path.splitext(args.out)[0] + ".preview.png"
               if args.checkpoint else None)
    t0 = time.time()
    with profiler_trace(args.profile):
        if args.distributed:
            import numpy as np

            from ptx.parallel import dist as pdist
            from ptx.parallel import mesh as pmesh

            plan = pmesh.plan(
                static.n_tris_padded,
                n_texels=int(np.asarray(fs.tex_texels).shape[0]),
                force_tp=args.tp,
            )
            print(f"mesh plan: dp={plan.dp} tp={plan.tp} "
                  f"scene_sharded={plan.scene_sharded} "
                  f"shard_textures={plan.shard_textures} comm={args.comm}",
                  file=sys.stderr)
            res = pdist.render_distributed(
                fs, static, cfg, plan=plan, comm=args.comm,
                progress=progress, checkpoint_path=args.checkpoint,
                checkpoint_every=args.checkpoint_every, metrics=metrics,
                preview_path=preview)
        else:
            res = R.render(fs, static, cfg, progress=progress,
                           checkpoint_path=args.checkpoint,
                           checkpoint_every=args.checkpoint_every,
                           metrics=metrics, preview_path=preview)
    dt = time.time() - t0
    rays = cfg.width * cfg.height * cfg.samples
    print(f"\nrendered {rays} primary rays in {dt:.2f}s "
          f"({rays / dt:,.0f} paths/s)", file=sys.stderr)
    if metrics is not None:
        print(metrics.report(), file=sys.stderr)
    write_png(args.out, res.image)
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


def cmd_bench(args) -> int:
    from ptx.bench import run_backward_bench, run_bench

    fn = run_backward_bench if args.backward else run_bench
    result = fn(scene=args.scene, cfg=_config_from_args(args))
    print(json.dumps(result))
    return 0


def cmd_partition(args) -> int:
    """Scene partitioning plan (the preprocessor's /preprocess response)."""
    from ptx.parallel.partition import split_scene

    split = split_scene(
        args.scene,
        num_workers=args.num_workers,
        memory_per_worker_gb=args.memory_per_worker_gb,
    )
    print(split.to_json())
    return 0


def cmd_invert(args) -> int:
    from ptx.diff.inverse import run_inverse_demo

    cfg = _config_from_args(args)
    fields = tuple(f.strip() for f in args.params.split(",") if f.strip())
    run_inverse_demo(args.scene, cfg, steps=args.steps, lr=args.lr,
                     param_fields=fields)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="ptx")
    sub = parser.add_subparsers(dest="cmd", required=True)
    for name, fn in [("render", cmd_render), ("bench", cmd_bench),
                     ("invert", cmd_invert)]:
        p = sub.add_parser(name)
        _add_render_args(p)
        if name == "invert":
            p.add_argument("--steps", type=int, default=100)
            p.add_argument("--lr", type=float, default=0.05)
            p.add_argument(
                "--params", default="mat_albedo,mat_emissive",
                help="comma-separated optimization fields (mat_albedo, "
                     "mat_emissive, mat_roughness, mat_metallic, "
                     "sun_energy, tri_a — geometry gradients flow through "
                     "the Moller-Trumbore vjp)",
            )
        if name == "bench":
            p.add_argument("--backward", action="store_true",
                           help="measure grad-paths/s instead of forward")
        p.set_defaults(fn=fn)
    p = sub.add_parser("partition")
    p.add_argument("--scene", required=True)
    p.add_argument("--num-workers", type=int, default=None)
    p.add_argument("--memory-per-worker-gb", type=float, default=None)
    p.add_argument("--cpu", action="store_true")
    p.set_defaults(fn=cmd_partition)
    args = parser.parse_args(argv)
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax

    # Persistent compile cache: repeat invocations skip the XLA compile,
    # which otherwise dominates CLI cold start.
    from ptx.utils import enable_compile_cache

    enable_compile_cache(jax)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
