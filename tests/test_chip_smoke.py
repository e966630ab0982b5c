"""CPU rehearsal of ``chip_smoke.py``'s phases at tiny sizes, plus the
platform plumbing it relies on (device memory, compile cache).  The script
itself refuses to run without a GPU; its phase functions take sizes and
``interpret`` so the same code paths run here."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from ptx import utils  # noqa: E402
from ptx.parallel import mesh as pmesh  # noqa: E402

SCENE = "arch:20000"


def test_script_refuses_without_a_gpu(capsys):
    with pytest.raises(RuntimeError, match="not 'gpu'"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_phase_resolution_checks_the_platform_choice():
    chip_smoke.phase_resolution((SCENE,), "cpu", {SCENE: "brute"})
    with pytest.raises(RuntimeError, match="measured winner"):
        chip_smoke.phase_resolution((SCENE,), "cpu", {SCENE: "pallas"})


def test_phase_kernels_rehearsal():
    # Primary rays, one bounce, and the primary rays after lifting
    # triangles out of their boxes (checked on the refit tree).
    res = chip_smoke.phase_kernels(SCENE, 32, 24, interpret=True)
    assert [r["rays"] for r in res] == [768, 768, 768]
    assert all(r["hit_mask_mismatch"] == r["payload_hit_mismatch"] == 0
               for r in res)


def test_phase_render_rehearsal(tmp_path):
    res = chip_smoke.phase_render(SCENE, 32, 24, 2, 3, out_dir=str(tmp_path),
                                  card="cpu")
    assert res["sunlit_mean"] > res["shadow_mean"]
    assert res["paths_per_s"] > 0
    assert (tmp_path / "smoke_render.png").exists()


def test_phase_inverse_rehearsal():
    res = chip_smoke.phase_inverse(SCENE, 16, 16, 2, 2, 5)
    for p in chip_smoke.INVERSE_LR:
        assert res[p]["final_loss"] < res[p]["first_loss"]


def test_plan_with_explicit_memory():
    big = pmesh.plan(n_tris=1_000_000, n_devices=4, memory_bytes=80 * 2**30)
    assert (big.dp, big.tp) == (4, 1)
    small = pmesh.plan(n_tris=1_000_000, n_devices=4, memory_bytes=2**27)
    assert small.tp > 1 and small.dp * small.tp == 4


def test_plan_refuses_a_device_without_a_memory_limit():
    # The CPU reports no memory stats: the budget must be given.
    with pytest.raises(ValueError, match="memory_bytes"):
        pmesh.plan(n_tris=1024, n_devices=8)


class _Config:
    def __init__(self):
        self.updates = {}

    def update(self, key, value):
        self.updates[key] = value


class _Jax:
    def __init__(self):
        self.config = _Config()


def test_compile_cache_honours_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    fake = _Jax()
    utils.enable_compile_cache(fake)
    assert fake.config.updates == {}  # JAX reads the variable itself
    assert utils.compile_cache_dir() == str(tmp_path)


def test_compile_cache_defaults_to_the_repo(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    fake = _Jax()
    utils.enable_compile_cache(fake)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    assert fake.config.updates["jax_compilation_cache_dir"] == want
    assert utils.compile_cache_dir() == want


def test_phase_four_rehearsal(monkeypatch):
    """The --four phase on four of the virtual CPU devices, with the kernel
    walk in the Pallas interpreter (the GPU's choice of intersector)."""
    import functools

    from ptx.kernels import traverse_pallas as tk

    monkeypatch.setattr(tk, "make_backend",
                        functools.partial(tk.make_backend, interpret=True))
    res = chip_smoke.phase_four(SCENE, 16, 8, 1, 2, n=4, intersector="pallas")
    assert set(res) == {"dp4", "tp4_reduce", "tp4_ring", "grad_step"}
    assert res["dp4"]["bit_identical"]
