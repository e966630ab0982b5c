"""High-level single-chip rendering API.

The accelerator equivalent of ``processors::worker::run()`` (``worker.cpp:25-105``):
load scene -> generate the wavefront -> integrate -> accumulate -> finalize.
Sample batches replace the reference's free-running queues: each batch is one
launch of the fused integrator with static shapes, and the per-pixel running
mean is carried between launches exactly like the accumulation stage's
``(c*n + x)/(n+1)`` (``accumulation_worker.cpp:25-52``) — which also makes
any prefix of batches a valid partial image (the reference's periodic-flush
behaviour, ``renderer.cpp:409-424``, and the natural checkpoint unit).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ptx.config import RenderConfig
from ptx.integrator import accumulate
from ptx.integrator.wavefront import make_integrator
from ptx.kernels import intersect as intersect_mod
from ptx.scene import gltf
from ptx.scene.flatten import FlatScene, SceneStatic, apply_emissive_strength, flatten


def load_scene(
    path: str,
    scene_work: Optional[Dict[str, List[int]]] = None,
    env_image: Optional[np.ndarray] = None,
    quirks=None,
    pad_multiple: int = 256,
    device: bool = True,
) -> Tuple[FlatScene, SceneStatic]:
    """Load + flatten a glTF scene (or ``synthetic:<n_tris>[:seed]``) to
    device-ready arrays."""
    import os

    if path.startswith("synthetic:"):
        from ptx.scene.synthetic import load_synthetic

        fs, static = load_synthetic(path)
        return (to_device(fs) if device else fs), static
    if path.startswith("arch:"):
        from ptx.scene.arch import load_arch

        fs, static = load_arch(path)
        return (to_device(fs) if device else fs), static
    scene = gltf.load(path, scene_work=scene_work)
    fs, static = flatten(
        scene,
        pad_multiple=pad_multiple,
        base_dir=os.path.dirname(os.path.abspath(path)),
        env_image=env_image,
    )
    if quirks is not None and quirks.use_emissive_strength:
        fs = apply_emissive_strength(fs, scene)
    # device=False keeps arrays on the host so accel builds (which permute
    # the triangle arrays) don't pay a device round-trip first — use it when
    # you will call ensure_accel + to_device yourself (render_gltf does).
    return (to_device(fs) if device else fs), static


def to_device(fs: FlatScene) -> FlatScene:
    return jax.tree.map(jnp.asarray, fs)


def get_backend(static: SceneStatic, cfg: RenderConfig, sort=None):
    """Resolve the intersection backend pair (closest, any_hit).

    ``sort=None`` resolves the per-call sorting wrapper from the config;
    pass False when the caller already keeps the wavefront sorted (the
    chunked forward integrator does its own dead-last morton sort)."""
    name = resolve_intersector(static, cfg)
    if name in ("bvh", "pallas") and static.n_bvh_nodes == 0:
        raise ValueError(f"{name} backend requires ensure_accel() first")
    if name == "brute":
        pair = intersect_mod.make_brute()
    elif name == "bvh":
        from ptx.accel import traverse as bvh_traverse

        pair = bvh_traverse.make_backend(static.bvh_leaf_size)
    elif name == "pallas":
        from ptx.kernels import traverse_pallas

        pair = traverse_pallas.make_backend(static.bvh_leaf_size)
    else:
        raise ValueError(f"unknown intersector {name!r}")
    if resolve_sort(static, cfg, name) if sort is None else sort:
        from ptx.kernels import sorting

        pair = sorting.make_sorting_backend(*pair, static)
    return pair


def resolve_sort(static: SceneStatic, cfg: RenderConfig, name: str) -> bool:
    """Per-bounce ray sorting for the kernel walk on non-trivial scenes:
    coherent blocks walk similar node paths."""
    from ptx.kernels import sorting

    if cfg.sort_rays == "on":
        return True
    if cfg.sort_rays == "off":
        return False
    return name == "pallas" and sorting.should_compact(static)


# Largest padded triangle count the brute sweep serves on the CPU; above it
# the XLA BVH walk wins.
CPU_BRUTE_MAX_TRIS = 65536


def resolve_intersector(static: SceneStatic, cfg: RenderConfig,
                        platform: Optional[str] = None) -> str:
    """The intersection backend: an explicit ``cfg.intersector``, else the
    platform's choice.  On the GPU the Pallas BVH walk
    (``ptx.kernels.traverse_pallas``); on the CPU (tests) the XLA paths,
    brute up to ``CPU_BRUTE_MAX_TRIS`` and the XLA walk above.  Any other
    platform has no measured choice and is refused."""
    if cfg.intersector != "auto":
        return cfg.intersector
    platform = platform or jax.default_backend()
    if platform == "gpu":
        return "pallas"
    if platform == "cpu":
        return "brute" if static.n_tris_padded <= CPU_BRUTE_MAX_TRIS else "bvh"
    raise ValueError(f"no intersection backend chosen for platform {platform!r}")


def ensure_accel(fs: FlatScene, static: SceneStatic, cfg: RenderConfig,
                 device: bool = False):
    """Attach the BVH when the resolved backend walks one."""
    if (resolve_intersector(static, cfg) in ("bvh", "pallas")
            and static.n_bvh_nodes == 0):
        from ptx.accel.bvh import build_bvh

        fs, static = build_bvh(fs, static)
    return (to_device(fs) if device else fs), static


def make_integrator_for(static: SceneStatic, cfg: RenderConfig):
    from ptx.kernels import sorting

    # The chunked forward loop keeps the wavefront sorted itself — skip the
    # per-call backend sorting wrapper then.
    chunk_active = sorting.resolve_compact(static, cfg)
    closest, any_hit = get_backend(
        static, cfg, sort=False if chunk_active else None
    )
    return make_integrator(static, cfg, closest, any_hit)


def make_sample_fn(static: SceneStatic, cfg: RenderConfig):
    """Jitted ``(fs, sample_id) -> (radiance [P,3], alpha [P])`` rendering one
    full-image sample pass.

    With ``cfg.rays_per_batch`` set, each pass runs in fixed-size pixel
    chunks (one jitted launch per chunk, same executable) so wavefront state
    stays bounded on huge frames — the static-shape analog of the
    reference's queue back-pressure.
    """
    integrator = make_integrator_for(static, cfg)
    n_pixels = cfg.width * cfg.height
    chunk = resolve_rays_per_batch(cfg)
    if chunk is None or chunk >= n_pixels:

        @jax.jit
        def sample_pass(fs: FlatScene, sample_id):
            pixel_ids = jnp.arange(n_pixels, dtype=jnp.int32)
            sample_ids = jnp.full((n_pixels,), sample_id, jnp.int32)
            return integrator(fs, pixel_ids, sample_ids)

        return sample_pass

    if n_pixels % chunk:
        raise ValueError(
            f"rays_per_batch {chunk} must divide the pixel count {n_pixels}"
        )

    @jax.jit
    def chunk_pass(fs: FlatScene, start, sample_id):
        pixel_ids = start + jnp.arange(chunk, dtype=jnp.int32)
        sample_ids = jnp.full((chunk,), sample_id, jnp.int32)
        return integrator(fs, pixel_ids, sample_ids)

    def sample_pass(fs: FlatScene, sample_id):
        parts = [
            chunk_pass(fs, jnp.int32(s), sample_id)
            for s in range(0, n_pixels, chunk)
        ]
        radiance = jnp.concatenate([p[0] for p in parts])
        alpha = jnp.concatenate([p[1] for p in parts])
        return radiance, alpha

    return sample_pass


# Upper bound on rays per integrator launch when auto-picking
# samples_per_launch: an untuned starting value, not yet measured on the
# H100.  2^15 batches small frames into one launch and leaves >=64k-pixel
# frames at one sample per launch.
MAX_RAYS_PER_LAUNCH = 1 << 15


def resolve_rays_per_batch(cfg: RenderConfig):
    """Per-launch pixel chunk, or ``None`` for whole-frame launches.

    Frames larger than MAX_RAYS_PER_LAUNCH are auto-chunked: over-cap
    frames render in the largest divisor of the pixel count that fits it,
    preferring multiples of 128 (whole kernel blocks).  An explicit
    ``cfg.rays_per_batch`` always wins.
    """
    if cfg.rays_per_batch is not None:
        return cfg.rays_per_batch
    n_pixels = cfg.width * cfg.height
    if n_pixels <= MAX_RAYS_PER_LAUNCH:
        return None
    for m in range(MAX_RAYS_PER_LAUNCH // 128, 0, -1):
        if n_pixels % (128 * m) == 0:
            return 128 * m
    for c in range(MAX_RAYS_PER_LAUNCH, 0, -1):
        if n_pixels % c == 0:
            # A 1-pixel "divisor" means the count is prime-ish: chunking
            # to single rays would be absurd, launch the whole frame.
            return c if c > 1 else None
    return None


def resolve_samples_per_launch(cfg: RenderConfig, ways: int = 1) -> int:
    """How many image samples to fuse into one wavefront launch.

    ``ways`` is the ray-sharding degree (dp, or dp*tp in ring mode): the
    launch-size cap applies to the *per-device* wavefront, so a
    dp-sharded frame batches more samples per launch."""
    if cfg.rays_per_batch is not None:
        return 1  # chunked-frame mode already bounds the launch size
    n_pixels = cfg.width * cfg.height // max(ways, 1)
    if cfg.samples_per_launch is not None:
        return max(1, min(cfg.samples_per_launch, cfg.samples))
    return max(1, min(cfg.samples, MAX_RAYS_PER_LAUNCH // max(n_pixels, 1)))


def make_batched_sample_fn(static: SceneStatic, cfg: RenderConfig, k: int):
    """Jitted ``(fs, sample0, count) -> (radiance [k,P,3], alpha [k,P])``
    tracing samples ``sample0 .. sample0+k-1`` in ONE integrator launch
    (k*P rays).

    One executable covers full and partial batches: ``count <= k`` tells the
    accumulator how many leading samples are valid (the tail lanes still
    trace — wasted only on the final ragged batch — so no second compile).
    The RNG is keyed by absolute (pixel, sample) ids, so batched results are
    bit-identical to one-launch-per-sample.
    """
    integrator = make_integrator_for(static, cfg)
    n_pixels = cfg.width * cfg.height

    @jax.jit
    def batch_pass(fs: FlatScene, sample0):
        pixel_ids = jnp.tile(jnp.arange(n_pixels, dtype=jnp.int32), k)
        sample_ids = sample0 + jnp.repeat(
            jnp.arange(k, dtype=jnp.int32), n_pixels
        )
        radiance, alpha = integrator(fs, pixel_ids, sample_ids)
        return radiance.reshape(k, n_pixels, 3), alpha.reshape(k, n_pixels)

    return batch_pass


@functools.partial(jax.jit, donate_argnums=(0,))
def _update_mean_batch(carry, colors, alphas, n, count):
    """Fold ``count`` valid samples (of the k in ``colors`` [k,P,3]) into the
    running mean — algebraically identical to ``count`` single-sample
    ``_update_mean`` steps."""
    color, alpha = carry
    k = colors.shape[0]
    valid = (jnp.arange(k) < count).astype(colors.dtype)
    inv = 1.0 / (n + count)
    # A masked sum, not a matrix product: no GEMM routine (or TF32) is
    # picked for it.
    return (
        (color * n + jnp.sum(valid[:, None, None] * colors, axis=0)) * inv,
        (alpha * n + jnp.sum(valid[:, None] * alphas, axis=0)) * inv,
    )


@functools.partial(jax.jit, donate_argnums=(0,))
def _update_claim_batch(carry, colors, alphas, n, count):
    """Sequential claim-blend fold over the batch (claim semantics are
    order-dependent, so replay samples in order inside one jit)."""
    k = colors.shape[0]

    def body(i, acc):
        carry, n = acc
        do = i < count  # scalar mask: skip tail lanes of a ragged batch
        new = _claim_step(carry, colors[i], alphas[i], n)
        carry = jax.tree.map(lambda a, b: jnp.where(do, b, a), carry, new)
        return carry, jnp.where(do, n + 1.0, n)

    carry, _ = jax.lax.fori_loop(0, k, body, (carry, n))
    return carry


def _claim_step(carry, sample_color, sample_alpha, n):
    """One claim-blend step (transparent background), see
    ``accumulate.accumulate_claim``."""
    color, alpha, claimed = carry
    opaque = sample_alpha > 0.5
    claim_now = opaque & ~claimed
    blend = opaque & claimed
    trans_on_claimed = ~opaque & claimed
    inv = 1.0 / (n + 1.0)
    new_color = jnp.where(
        claim_now[:, None],
        sample_color,
        jnp.where(blend[:, None], (color * n + sample_color) * inv, color),
    )
    new_alpha = jnp.where(
        claim_now,
        inv,
        jnp.where(blend | trans_on_claimed, (alpha * n + sample_alpha) * inv, alpha),
    )
    return new_color, new_alpha, claimed | claim_now


@functools.partial(jax.jit, donate_argnums=(0,))
def _update_mean(carry, sample_color, sample_alpha, n):
    color, alpha = carry
    inv = 1.0 / (n + 1.0)
    return (
        (color * n + sample_color) * inv,
        (alpha * n + sample_alpha) * inv,
    )


@functools.partial(jax.jit, donate_argnums=(0,))
def _update_claim(carry, sample_color, sample_alpha, n):
    return _claim_step(carry, sample_color, sample_alpha, n)


@dataclasses.dataclass
class RenderResult:
    color: np.ndarray  # [H, W, 3] linear HDR mean
    alpha: np.ndarray  # [H, W]
    image: np.ndarray  # [H, W, 4] uint8 (ACES + sRGB)


def render(
    fs: FlatScene,
    static: SceneStatic,
    cfg: RenderConfig,
    progress: Optional[callable] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 5,
    metrics=None,
    preview_path: Optional[str] = None,
) -> RenderResult:
    """Render ``cfg.samples`` progressive sample passes.

    With ``checkpoint_path``, resumes from a compatible checkpoint and writes
    one every ``checkpoint_every`` samples (the reference's save-every-5
    cadence, ``renderer.cpp:409``); the absolute-sample-id RNG makes the
    resumed image identical to an uninterrupted run.  Each checkpoint also
    writes a viewable tonemapped preview PNG (the reference's periodic image
    flush, ``renderer.cpp:409-424``) to ``preview_path``, defaulting to
    ``<checkpoint_path>.preview.png``.
    """
    fs, static = ensure_accel(fs, static, cfg, device=True)
    k = resolve_samples_per_launch(cfg)
    if k > 1:
        batch_fn, sample_fn = make_batched_sample_fn(static, cfg, k), None
    else:
        batch_fn, sample_fn = None, make_sample_fn(static, cfg)
    return progressive_render(
        fs, static, cfg, sample_fn, batch_fn, k,
        progress=progress,
        checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every,
        metrics=metrics,
        preview_path=preview_path,
    )


def progressive_render(
    fs: FlatScene,
    static: SceneStatic,
    cfg: RenderConfig,
    sample_fn,
    batch_fn,
    k: int,
    progress: Optional[callable] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 5,
    metrics=None,
    replicate=None,
    preview_path: Optional[str] = None,
) -> RenderResult:
    """The progressive sample loop shared by single-chip :func:`render` and
    :func:`ptx.parallel.dist.render_distributed`: running-mean / claim-blend
    accumulation, checkpoint/resume, optional per-phase metrics.

    Exactly one of ``sample_fn`` (k == 1) / ``batch_fn`` (k > 1 samples fused
    per launch) drives the trace.  ``replicate`` (multi-host runs only —
    ``ptx.parallel.multihost.replicator``) maps accumulator arrays to a
    fully-replicated sharding (an all-gather over the mesh) so every host
    can transfer them; applied before checkpoint writes and the final
    host fetch.
    """
    from ptx.io import checkpoint as ckpt_mod

    p = cfg.width * cfg.height
    if cfg.transparent_background:
        carry = (jnp.zeros((p, 3)), jnp.zeros((p,)), jnp.zeros((p,), bool))
    else:
        carry = (jnp.zeros((p, 3)), jnp.zeros((p,)))

    start_sample = 0
    fingerprint = None
    if checkpoint_path is not None:
        fingerprint = ckpt_mod.config_fingerprint(cfg)
        loaded = ckpt_mod.load(checkpoint_path, fingerprint)
        if loaded is not None and 0 < loaded.samples_done <= cfg.samples:
            start_sample = loaded.samples_done
            if cfg.transparent_background:
                carry = (
                    jnp.asarray(loaded.color),
                    jnp.asarray(loaded.alpha),
                    jnp.asarray(
                        loaded.claimed
                        if loaded.claimed is not None
                        else np.zeros(p, bool)
                    ),
                )
            else:
                carry = (jnp.asarray(loaded.color), jnp.asarray(loaded.alpha))

    if checkpoint_path is not None and preview_path is None:
        preview_path = checkpoint_path + ".preview.png"

    def write_checkpoint(done):
        c = replicate(carry) if replicate is not None else carry
        color_h, alpha_h = np.asarray(c[0]), np.asarray(c[1])
        ckpt_mod.save(
            checkpoint_path,
            ckpt_mod.Checkpoint(
                color=color_h,
                alpha=alpha_h,
                claimed=(
                    np.asarray(c[2]) if cfg.transparent_background else None
                ),
                samples_done=done,
                fingerprint=fingerprint,
            ),
        )
        if preview_path is not None:
            # Viewable partial image every checkpoint — the reference writes
            # a PNG every 5 samples (core/renderer.cpp:409-424).
            from ptx.io.png import write_png

            img = np.asarray(accumulate.finalize(color_h, alpha_h))
            write_png(preview_path,
                      img.reshape(cfg.height, cfg.width, 4))

    import contextlib

    def phase(name, items=0.0, block=None):
        if metrics is None:
            return contextlib.nullcontext()
        return metrics.phase(name, items=items, block=block)

    s = start_sample
    last_ckpt = start_sample // checkpoint_every
    while s < cfg.samples:
        n = jnp.float32(s)
        if k > 1:
            count = min(k, cfg.samples - s)
            with phase("trace", items=p * count) as _:
                out = batch_fn(fs, jnp.int32(s))
                if metrics is not None:
                    jax.block_until_ready(out)
            colors, alphas = out
            with phase("accumulate"):
                if cfg.transparent_background:
                    carry = _update_claim_batch(
                        carry, colors, alphas, n, jnp.int32(count)
                    )
                else:
                    carry = _update_mean_batch(
                        carry, colors, alphas, n, jnp.float32(count)
                    )
            s += count
        else:
            with phase("trace", items=p):
                out = sample_fn(fs, jnp.int32(s))
                if metrics is not None:
                    jax.block_until_ready(out)
            radiance, alpha = out
            with phase("accumulate"):
                if cfg.transparent_background:
                    carry = _update_claim(carry, radiance, alpha, n)
                else:
                    carry = _update_mean(carry, radiance, alpha, n)
            s += 1
        if progress is not None:
            progress(s, cfg.samples)
        if (
            checkpoint_path is not None
            and s // checkpoint_every > last_ckpt
            and s < cfg.samples
        ):
            last_ckpt = s // checkpoint_every
            with phase("checkpoint"):
                write_checkpoint(s)

    if checkpoint_path is not None:
        write_checkpoint(cfg.samples)

    color, alpha = carry[0], carry[1]
    if replicate is not None:
        color, alpha = replicate((color, alpha))
    with phase("finalize"):
        image = accumulate.finalize(color, alpha)
        h, w = cfg.height, cfg.width
        result = RenderResult(
            color=np.asarray(color).reshape(h, w, 3),
            alpha=np.asarray(alpha).reshape(h, w),
            image=np.asarray(image).reshape(h, w, 4),
        )
    return result


def render_gltf(path: str, cfg: RenderConfig, **load_kwargs) -> RenderResult:
    fs, static = load_scene(path, quirks=cfg.quirks, device=False, **load_kwargs)
    return render(fs, static, cfg)
