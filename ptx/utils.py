"""Observability: phase timers, throughput counters, profiler traces.

The reference's observability is a 1 Hz queue-depth monitor thread
(``worker.cpp:80-92``) plus spdlog lines at every S3 op.  Here metrics are
first-class (SURVEY.md §5): phase timers with rays/s throughput, and a thin
wrapper over ``jax.profiler`` for device traces.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time
from typing import Dict, Optional

log = logging.getLogger("ptx")


# The repository-local cache (listed in .gitignore): a fixed path, because
# the path is part of the cache key.
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def compile_cache_dir() -> str:
    """The persistent XLA compile cache: ``JAX_COMPILATION_CACHE_DIR`` when
    the environment sets it, else :data:`REPO_CACHE_DIR`."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR


def enable_compile_cache(jax) -> None:
    """Turn on the persistent compile cache.  Where
    ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
    is set here; otherwise the cache goes to :data:`REPO_CACHE_DIR`."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)


@dataclasses.dataclass
class PhaseStat:
    calls: int = 0
    seconds: float = 0.0
    items: float = 0.0

    @property
    def items_per_s(self) -> float:
        return self.items / self.seconds if self.seconds else 0.0


class Metrics:
    """Accumulates per-phase wall time + item throughput.

    >>> m = Metrics()
    >>> with m.phase("intersect", items=65536):
    ...     ...
    >>> m.report()
    """

    def __init__(self):
        self.phases: Dict[str, PhaseStat] = {}

    @contextlib.contextmanager
    def phase(self, name: str, items: float = 0.0, block=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block is not None:
                import jax

                jax.block_until_ready(block)
            stat = self.phases.setdefault(name, PhaseStat())
            stat.calls += 1
            stat.seconds += time.perf_counter() - t0
            stat.items += items

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.phases.items()):
            rate = f" {s.items_per_s:,.0f}/s" if s.items else ""
            lines.append(
                f"{name}: {s.seconds:.3f}s over {s.calls} calls{rate}"
            )
        text = "\n".join(lines)
        log.info("metrics:\n%s", text)
        return text


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """``jax.profiler`` trace scope (no-op when ``log_dir`` is None).
    View with TensorBoard or xprof."""
    if log_dir is None:
        yield
        return
    import jax

    with jax.profiler.trace(log_dir):
        yield
