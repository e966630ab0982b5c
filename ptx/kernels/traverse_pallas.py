"""Per-lane BVH traversal kernel (Pallas, lowered through Triton for the GPU).

The GPU-native form of the reference's KD-tree walk (``core/mesh.cpp:300-405``)
over the stackless miss-link BVH of ``ptx.accel`` (the same arrays and
semantics as the XLA walk in ``ptx.accel.traverse``):

* one program walks a block of ``BLOCK`` rays; each lane holds one node
  register and its running best hit;
* a visit reads the node's packed row (:func:`pack_nodes`, 8 words: box lo,
  box hi, leaf range, miss link) with one per-lane gather, slab-tests the
  box, and on a leaf runs the same Möller-Trumbore test as
  ``ptx.geometry.moller_trumbore`` on up to ``leaf_size`` triangles read by
  per-lane gathers;
* the program loops while any lane of its block is live, so a divergent ray
  stalls its own block only, and the whole walk is one launch;
* the any-hit variant retires a lane at its first hit.

The kernel only *selects* ``(t, tri)``; ties at equal ``t`` go to the lower
triangle index, the rule of the brute oracle (``ptx.kernels.intersect``).
Exact barycentrics and the hit attributes are recomputed for the winner in
XLA (:func:`closest`), so vertex gradients flow through that recompute and
never through the kernel.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ptx import geometry
from ptx import math as pmath

# Rays per program and warps per program: one lane per thread.  64 rays on
# 2 warps beat 128/4, 256/8, 128/2, 256/4 and 64/1 end to end on arch:300000
# 640x480x4spp (H100, 400 W cap; PERF.md).
BLOCK = 64
NUM_WARPS = 2
INF = 3.0e38  # python float: kernels cannot capture jnp constants
EPS = float(pmath.EPS)
# Leaf ranges pack as (first << 4) | count; the builder caps leaves at 8
# triangles (``ptx.accel.bvh.LEAF_LEVELS``).
COUNT_BITS = 4


def pack_nodes(fs):
    """[Nn * 8] f32 node rows: lo xyz, hi xyz, leaf word, miss link (the two
    int32 words bit-cast), so one node visit reads one 32-byte row."""
    bc = jax.lax.bitcast_convert_type
    word = (fs.bvh_first << COUNT_BITS) | fs.bvh_count
    rows = jnp.concatenate(
        [fs.bvh_min, fs.bvh_max, bc(word, jnp.float32)[:, None],
         bc(fs.bvh_miss, jnp.float32)[:, None]], axis=1)
    return rows.reshape(-1)


def _kernel(rays_ref, nodes_ref, a_ref, e1_ref, e2_ref, t_ref, tri_ref, *,
            leaf_size: int, any_hit: bool):
    bc = jax.lax.bitcast_convert_type
    ox, oy, oz = rays_ref[0, :], rays_ref[1, :], rays_ref[2, :]
    dx, dy, dz = rays_ref[3, :], rays_ref[4, :], rays_ref[5, :]
    ix, iy, iz = 1.0 / dx, 1.0 / dy, 1.0 / dz

    def slab(lo, hi, o, inv):
        t0 = (lo - o) * inv
        t1 = (hi - o) * inv
        tmin = jnp.minimum(t0, t1)
        tmax = jnp.maximum(t0, t1)
        # 0 * inf (origin on a slab, zero direction) must not poison the
        # reduce; the other axes decide.
        return (jnp.where(tmin != tmin, -jnp.inf, tmin),
                jnp.where(tmax != tmax, jnp.inf, tmax))

    def gather(ref, idx, mask):
        return plgpu.load(ref.at[idx], mask=mask, other=0.0)

    n_nodes = nodes_ref.shape[0] // 8
    n_tris = a_ref.shape[0] // 3

    def body(carry):
        node, best_t, best_tri, steps = carry
        live = node >= 0
        # Clamped: no lane ever reads past an array, whatever the links say.
        base = jnp.clip(node, 0, n_nodes - 1) * 8
        lox, hix = gather(nodes_ref, base, live), gather(nodes_ref, base + 3, live)
        loy, hiy = gather(nodes_ref, base + 1, live), gather(nodes_ref, base + 4, live)
        loz, hiz = gather(nodes_ref, base + 2, live), gather(nodes_ref, base + 5, live)
        word = bc(gather(nodes_ref, base + 6, live), jnp.int32)
        miss = bc(gather(nodes_ref, base + 7, live), jnp.int32)
        count = word & ((1 << COUNT_BITS) - 1)
        first = word >> COUNT_BITS

        nx, fx = slab(lox, hix, ox, ix)
        ny, fy = slab(loy, hiy, oy, iy)
        nz, fz = slab(loz, hiz, oz, iz)
        near = jnp.maximum(jnp.maximum(nx, ny), nz)
        far = jnp.minimum(jnp.minimum(fx, fy), fz)
        # An inverted (empty) box would pass the slab test as all-space.
        nonempty = (lox <= hix) & (loy <= hiy) & (loz <= hiz)
        # <= keeps boxes that may hold an equal-t, lower-index triangle.
        box_hit = (live & nonempty & (far >= jnp.maximum(near, 0.0))
                   & (near <= best_t))
        leaf = box_hit & (count > 0)

        for j in range(leaf_size):
            valid = leaf & (j < count)
            k = jnp.clip(first + j, 0, n_tris - 1)
            k3 = k * 3
            ax, ay, az = (gather(a_ref, k3 + c, valid) for c in range(3))
            e1x, e1y, e1z = (gather(e1_ref, k3 + c, valid) for c in range(3))
            e2x, e2y, e2z = (gather(e2_ref, k3 + c, valid) for c in range(3))
            # ptx.geometry.moller_trumbore, term for term.
            px = dy * e2z - dz * e2y
            py = dz * e2x - dx * e2z
            pz = dx * e2y - dy * e2x
            det = e1x * px + e1y * py + e1z * pz
            degenerate = det == 0.0
            inv_det = 1.0 / jnp.where(degenerate, 1.0, det)
            tx, ty, tz = ox - ax, oy - ay, oz - az
            beta = (tx * px + ty * py + tz * pz) * inv_det
            qx = ty * e1z - tz * e1y
            qy = tz * e1x - tx * e1z
            qz = tx * e1y - ty * e1x
            gamma = (dx * qx + dy * qy + dz * qz) * inv_det
            t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
            ok = (valid & (beta >= -EPS) & (beta <= 1.0 + EPS)
                  & (gamma >= -EPS) & (beta + gamma <= 1.0 + EPS)
                  & (t >= 0.0) & (jnp.abs(t) < jnp.inf) & ~degenerate)
            closer = ok & ((t < best_t) | ((t == best_t) & (k < best_tri)))
            best_t = jnp.where(closer, t, best_t)
            best_tri = jnp.where(closer, k, best_tri)

        # Interior hit falls through to node+1 (the left child); a leaf or a
        # miss follows the escape link.
        nxt = jnp.where(box_hit & (count == 0), node + 1, miss)
        if any_hit:
            nxt = jnp.where(best_t < INF, -1, nxt)
        return jnp.where(live, nxt, -1), best_t, best_tri, steps + 1

    def cond(carry):
        node, _, _, steps = carry
        # Links only point forward in the depth-first layout, so a lane
        # visits each node at most once: n_nodes steps retire every lane of
        # a well-formed tree, and bound the loop for any other.
        return (jnp.max(node) >= 0) & (steps < n_nodes)

    node0 = jnp.zeros(ox.shape, jnp.int32)
    _, best_t, best_tri, _ = jax.lax.while_loop(
        cond, body,
        (node0, jnp.full(ox.shape, INF, jnp.float32), node0, jnp.int32(0)))
    t_ref[...] = best_t
    tri_ref[...] = best_tri


def _pack_rays(orig, dirn):
    """[8, R_pad] component rows; padding lanes get a unit direction."""
    r = orig.shape[0]
    r_pad = -(-r // BLOCK) * BLOCK
    pad_dir = jnp.zeros((r_pad - r, 3), jnp.float32).at[:, 0].set(1.0)
    o = jnp.concatenate([orig, jnp.zeros((r_pad - r, 3), jnp.float32)])
    d = jnp.concatenate([dirn, pad_dir])
    return jnp.concatenate([o.T, d.T, jnp.zeros((2, r_pad), jnp.float32)])


def select(fs, orig, dirn, leaf_size: int, any_hit: bool = False,
           interpret: bool = False):
    """Run the walk: ``(t [R], tri [R] i32)`` with ``t = INF`` on a miss
    (for ``any_hit``, ``t < INF`` marks an occluded ray)."""
    sg = jax.lax.stop_gradient
    r = orig.shape[0]
    rays = _pack_rays(sg(orig), sg(dirn))
    r_pad = rays.shape[1]
    flat = lambda x: sg(x).reshape(-1)
    kernel = functools.partial(
        _kernel, leaf_size=leaf_size, any_hit=any_hit)
    lane = pl.BlockSpec((BLOCK,), lambda i: (i,))
    t, tri = pl.pallas_call(
        kernel,
        grid=(r_pad // BLOCK,),
        in_specs=[pl.BlockSpec((8, BLOCK), lambda i: (0, i))]
        + [pl.BlockSpec()] * 4,
        out_specs=(lane, lane),
        out_shape=(jax.ShapeDtypeStruct((r_pad,), jnp.float32),
                   jax.ShapeDtypeStruct((r_pad,), jnp.int32)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="bvh_any" if any_hit else "bvh_closest",
    )(rays, pack_nodes(jax.tree.map(sg, fs)), flat(fs.tri_a),
      flat(fs.tri_e1), flat(fs.tri_e2))
    return t[:r], tri[:r]


def closest(fs, orig, dirn, leaf_size: int, interpret: bool = False):
    """Closest hit as the :class:`ptx.kernels.intersect.Hit` payload: the
    kernel picks the triangle, XLA recomputes ``t`` and the barycentrics
    for it (the gradient path for vertex positions)."""
    from ptx.kernels.intersect import attrs_from_indices

    t_sel, tri = select(fs, orig, dirn, leaf_size, interpret=interpret)
    if fs.tri_attrs.shape[0] == fs.tri_a.shape[0]:
        at = fs.tri_attrs[tri]
        a, e1, e2 = at[:, 25:28], at[:, 28:31], at[:, 31:34]
    else:
        at = None
        a, e1, e2 = fs.tri_a[tri], fs.tri_e1[tri], fs.tri_e2[tri]
    t, beta, gamma, ok = geometry.moller_trumbore(orig, dirn, a, e1, e2)
    hit = (t_sel < INF) & ok
    return attrs_from_indices(fs, jnp.where(hit, t, geometry.INF), tri, beta,
                              gamma, hit, at=at)


def make_backend(leaf_size: int, interpret: bool = False):
    """(closest, any_hit) pair over the attached BVH."""

    def closest_fn(fs, orig, dirn):
        return closest(fs, orig, dirn, leaf_size, interpret)

    def any_fn(fs, orig, dirn):
        t, _ = select(fs, orig, dirn, leaf_size, any_hit=True,
                      interpret=interpret)
        return t < INF

    return closest_fn, any_fn
