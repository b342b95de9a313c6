"""Profiling & observability utilities.

The reference profiles offline with %timeit and warns on slow fallbacks
(SURVEY.md §5). Here:

- `timeit(fn, *args)` — block_until_ready timing harness for jitted ops.
- `trace(path)` — context manager around jax.profiler for device traces.
- `op_counters` — counters of kernel-vs-fallback dispatch; every densifying
  fallback in the library calls `count_fallback(...)` and warns (once per
  site) when config.warn_on_densify is set.
"""

from __future__ import annotations

import collections
import contextlib
import time
import warnings
from typing import Callable

import jax

from ..config import config

op_counters = collections.Counter()
_warned_sites = set()


def count_fallback(site: str, detail: str = "") -> None:
    """Record (and optionally warn about) a slow-path dispatch."""
    op_counters[site] += 1
    if config.warn_on_densify and site not in _warned_sites:
        _warned_sites.add(site)
        warnings.warn(
            f"symtensor-tpu slow path '{site}' {detail} — performance "
            "warning emitted once per site; see utils.profiling.op_counters",
            stacklevel=3,
        )


def count_kernel(site: str) -> None:
    op_counters[f"kernel:{site}"] += 1


def reset_counters() -> None:
    op_counters.clear()
    _warned_sites.clear()


def timeit(fn: Callable, *args, repeats: int = 5, warmup: int = 1, **kw):
    """Median wall time of fn(*args) with block_until_ready. Returns
    (median_seconds, last_result)."""
    out = None
    for _ in range(warmup):
        out = jax.block_until_ready(fn(*args, **kw))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args, **kw))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2], out


@contextlib.contextmanager
def trace(path: str):
    """jax.profiler trace context (view with TensorBoard / xprof)."""
    jax.profiler.start_trace(path)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
