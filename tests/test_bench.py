"""Smoke-test the whole bench surface at tiny sizes on CPU.

Round 2's jack sub-bench died on a wrong scene path and shipped an
``{"error": ...}`` entry to the driver; this walks every bench entry —
same scene files, same code paths, tiny shapes — so path/API breakage
fails CI instead of the device run (VERDICT r2 task 2).
"""

import json

from ptx import bench


def test_tiny_bench_has_all_entries_and_no_errors(tmp_path, monkeypatch):
    monkeypatch.setenv("PTX_BENCH_FULL", "1")
    monkeypatch.setenv("PTX_BENCH_BUDGET_S", "100000")
    result = bench.run_bench(tiny=True)

    assert result["unit"] == "paths/s"
    assert result["value"] > 0
    assert "vs_baseline" in result

    extra = result["extra"]
    expected = set(bench.extra_benches(tiny=True))
    assert expected <= set(extra), f"missing entries: {expected - set(extra)}"
    for name, entry in extra.items():
        assert "error" not in entry, f"{name}: {entry}"
        assert "skipped" not in entry, f"{name}: {entry}"

    # The driver prints this as one JSON line — it must serialize.
    json.dumps(result)


def test_emit_fires_before_and_during_extras(monkeypatch):
    # The headline must be emitted BEFORE any extra starts (round 3's
    # timeout captured nothing because the line printed last), and again
    # after each completed extra.
    monkeypatch.setenv("PTX_BENCH_FULL", "1")
    emitted = []
    bench.run_bench(tiny=True, emit=lambda r: emitted.append(json.dumps(r)))
    assert len(emitted) >= 2
    first = json.loads(emitted[0])
    assert "extra" not in first and first["value"] > 0
    last = json.loads(emitted[-1])
    assert set(bench.extra_benches(tiny=True)) <= set(last["extra"])


def test_past_deadline_skips_extras_but_emits_headline(monkeypatch):
    monkeypatch.setenv("PTX_BENCH_FULL", "1")
    import time

    emitted = []
    result = bench.run_bench(
        tiny=True,
        emit=lambda r: emitted.append(dict(r)),
        deadline=time.monotonic() - 1.0,
    )
    assert emitted and emitted[0]["value"] > 0
    assert all("skipped" in e for e in result["extra"].values())


def test_full_extra_bench_table_entries_are_callable():
    # The full-size table must name the same code paths the tiny one walks
    # (so the smoke run really covers the driver's run), plus the
    # Pallas roofline which needs real hardware timing.
    tiny = set(bench.extra_benches(tiny=True))
    full = set(bench.extra_benches(tiny=False))
    assert tiny <= full
    for fn in bench.extra_benches(tiny=False).values():
        assert callable(fn)


def test_bench_cli_smoke():
    """`ptx bench` (forward + --backward) honours the CLI size flags and
    prints one JSON object."""
    import subprocess
    import sys

    base = [sys.executable, "-m", "ptx.cli", "bench", "--scene",
            "/root/reference/path-tracer-core/scenes/cornell-box/cornell.gltf",
            "--width", "16", "--height", "16", "--samples", "2",
            "--bounces", "2", "--cpu", "--intersector", "brute"]
    env = {"PTX_BENCH_FULL": "0"}
    import os

    env = {**os.environ, **env}
    for extra in ([], ["--backward"]):
        out = subprocess.run(base + extra, capture_output=True, text=True,
                             timeout=420, cwd="/root/repo", env=env)
        assert out.returncode == 0, out.stderr[-2000:]
        doc = json.loads(out.stdout.strip().splitlines()[-1])
        assert doc["value"] > 0
