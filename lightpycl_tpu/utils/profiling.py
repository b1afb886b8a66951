"""Profiling helpers.

Reference parity: wall-clock timing + printed throughput around the trace
loop (SURVEY.md §5.1). Adds a `jax.profiler` trace
context producing a Perfetto/XPlane dump for xprof.
"""

from __future__ import annotations

import contextlib
import time


class Timer:
    """Wall-clock timer; `with Timer() as t: ...; t.elapsed`."""

    def __enter__(self):
        self.start = time.perf_counter()
        self.elapsed = 0.0
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start
        return False


@contextlib.contextmanager
def trace_profile(logdir: str | None):
    """jax.profiler trace context; no-op when logdir is None."""
    if logdir is None:
        yield
        return
    import jax

    with jax.profiler.trace(logdir):
        yield
