"""Multi-host (multi-process) execution — no accelerator required.

The reference's cross-machine story is the preprocessor fanning out one
Lambda per scene shard (``app.py:131-140``); the SPMD equivalent is
the standard JAX multi-controller runway: every host runs the same SPMD
program, ``jax.distributed.initialize`` wires them into one runtime, and
the global mesh spans all hosts' devices.  These tests spawn a real
2-process "pod" (2 x 4 virtual CPU devices, Gloo collectives) and require
the rendered image to match the single-process 8-device render exactly —
for pure ray parallelism across hosts (dp=8) and for the scene axis
spanning the host boundary (tp=8, the per-ray min reduce riding
cross-process collectives).
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from ptx import render as R
from ptx.config import RenderConfig
from ptx.parallel import dist, mesh as pmesh

CORNELL = "/root/reference/path-tracer-core/scenes/cornell-box/cornell.gltf"
WORKER = "tests/_multihost_worker.py"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_pod(dp, tp, out, timeout=600):
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), "2", str(port),
             str(dp), str(tp), out],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(2)
    ]
    outs = []
    deadline = time.time() + timeout
    for p in procs:
        try:
            o, _ = p.communicate(timeout=max(deadline - time.time(), 1))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(o)
    for p, o in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{o[-3000:]}"
    return outs


@pytest.mark.parametrize("dp,tp", [(8, 1), (1, 8)])
def test_two_process_pod_matches_single_process(tmp_path, dp, tp):
    out = str(tmp_path / f"pod_{dp}x{tp}")
    _run_pod(dp, tp, out)
    pod = np.load(out + ".npz")

    # Single-process oracle over the same 8 (virtual) devices.
    fs, static = R.load_scene(CORNELL, device=False)
    cfg = RenderConfig(width=16, height=16, samples=2, bounces=2,
                       intersector="brute")
    plan = pmesh.Plan(dp=dp, tp=tp, scene_sharded=tp > 1)
    single = dist.render_distributed(fs, static, cfg, plan=plan,
                                     mesh=pmesh.make_mesh(plan))

    np.testing.assert_allclose(pod["color"], single.color,
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pod["alpha"], single.alpha,
                               rtol=1e-6, atol=1e-7)

    # Sanity only: this 512-path smoke workload is rendezvous-dominated, so
    # it says nothing about scaling efficiency (that needs real cards:
    # chip_smoke.py --four).
    with open(out + ".json") as f:
        pod_stats = json.load(f)
    assert pod_stats["paths_per_s"] > 0
