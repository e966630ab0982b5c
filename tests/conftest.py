"""Test harness configuration.

Runs the whole suite on a *virtual 8-device CPU mesh* so the multi-device
sharding paths (shard_map / psum min-reduces) execute in CI without GPUs —
the idiomatic JAX fake-multi-node backend (see SURVEY.md §4).  Must set
flags before the first ``import jax``.  Tests marked ``gpu`` need the card
and skip here; ``chip_smoke.py`` covers that path on the card.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)
# Persistent compilation cache keeps repeat test runs fast.
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from ptx.utils import enable_compile_cache  # noqa: E402

enable_compile_cache(jax)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running statistical parity tests"
    )
    config.addinivalue_line(
        "markers", "gpu: needs the GPU; skips elsewhere (chip_smoke.py)"
    )


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU, decided when the test runs."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; chip_smoke.py runs this path on the card")
