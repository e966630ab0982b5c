"""Multi-host initialization and the cross-host execution recipe.

Replaces the reference's AWS control plane (API Gateway -> preprocessor
Lambda -> async worker invokes, ``app.py:77-155``) with the standard JAX
multi-controller runway: every host runs the *same* SPMD program;
``jax.distributed.initialize`` wires the hosts into one runtime, the global
mesh spans all devices, and ``shard_map`` lays collectives onto the
interconnect.  There is no coordinator-worker asymmetry to orchestrate —
which is the whole point.

Usage on each host:

    from ptx.parallel import multihost
    multihost.initialize("host0:1234", num_processes=2, process_id=0)
    # ... build mesh over jax.devices() as usual (ptx.parallel.mesh.plan) ...

The coordinator comes from the arguments or ``JAX_COORDINATOR_ADDRESS``.
Single-process runs are a no-op.
"""

from __future__ import annotations

import logging
from typing import Optional

log = logging.getLogger("ptx")


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize the multi-host runtime; returns True when distributed.

    The coordinator is ``coordinator_address`` or the
    ``JAX_COORDINATOR_ADDRESS`` environment variable (with
    ``num_processes``/``process_id`` from the arguments or JAX's own
    environment).  Without either this is a single-process run: returns
    False and does nothing.
    """
    import os

    import jax

    if coordinator_address is None and "JAX_COORDINATOR_ADDRESS" not in os.environ:
        return False
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        if "already" in str(e):
            return True
        raise
    log.info(
        "multi-host: process %d/%d, %d local / %d global devices",
        jax.process_index(), jax.process_count(),
        jax.local_device_count(), jax.device_count(),
    )
    return True


def replicator(mesh):
    """Tree-map callable that reshards global arrays to fully-replicated
    over ``mesh`` (an all-gather across hosts/chips) so every process can
    ``np.asarray`` them — the hook ``ptx.render.progressive_render`` applies
    before checkpoint writes and the final host fetch.  ``None`` in
    single-process runs (everything is already addressable)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    if jax.process_count() == 1:
        return None
    rep = jax.jit(lambda x: x, out_shardings=NamedSharding(mesh, P()))
    return lambda tree: jax.tree.map(rep, tree)


def put_global(x, sharding):
    """Build a global :class:`jax.Array` for ``sharding`` from a host-local
    full copy of ``x`` (every process holds the whole array — the scene is
    loaded from the same file on each host, the multi-controller analog of
    every Lambda worker downloading its shard from S3,
    ``load_gltf.cpp:180-185``).  Each process materializes only the shards
    its local devices own."""
    import jax
    import numpy as np

    x = np.asarray(x)
    return jax.make_array_from_callback(
        x.shape, sharding, lambda idx: x[idx]
    )
