#!/usr/bin/env python3
"""End-to-end paths/s of the production render loop per intersection
backend and walk-kernel block shape, on the GPU.

    python tools/backend_timing.py
    python tools/backend_timing.py --scenes arch:300000 \\
        --intersectors pallas bvh brute --blocks 64x2 128x4 --repeats 3

Each (scene, intersector, block) renders 640x480 at 10 bounces through
``chip_smoke.steady_paths_per_s`` (executables warm) and prints one JSON
line with every repeat and their median, after the card's name and power
limit.  ``--blocks`` sets the walk kernel's rays per program and warps per
program (``traverse_pallas.BLOCK`` and ``NUM_WARPS``); it only matters for
``pallas``.  ``brute`` on ``arch:300000`` takes minutes per render.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenes", nargs="+",
                    default=[chip_smoke.MAIN_SCENE, chip_smoke.SMALL_SCENE])
    ap.add_argument("--intersectors", nargs="+", default=["pallas", "bvh"])
    ap.add_argument("--blocks", nargs="+", default=None,
                    help="walk-kernel shapes as RAYSxWARPS, e.g. 64x2")
    ap.add_argument("--samples", type=int, default=4)
    ap.add_argument("--bounces", type=int, default=10)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)

    import jax

    from ptx.kernels import traverse_pallas as tk
    from ptx.utils import enable_compile_cache

    enable_compile_cache(jax)
    chip_smoke.phase_device("gpu")
    print(chip_smoke.card_info())
    blocks = [tuple(map(int, b.split("x"))) for b in args.blocks or
              [f"{tk.BLOCK}x{tk.NUM_WARPS}"]]
    for scene in args.scenes:
        for name in args.intersectors:
            for block, warps in blocks if name == "pallas" else blocks[:1]:
                tk.BLOCK, tk.NUM_WARPS = block, warps
                rates = chip_smoke.steady_paths_per_s(
                    scene, chip_smoke.WIDTH, chip_smoke.HEIGHT, args.samples,
                    args.bounces, intersector=name, repeats=args.repeats)
                row = {"scene": scene, "intersector": name,
                       "paths_per_s": statistics.median(rates), "all": rates}
                if name == "pallas":
                    row.update(block=block, warps=warps)
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
