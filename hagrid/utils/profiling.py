"""Timing and profiling utilities.

Counterpart of the reference's cudaEvent timing + per-stage ms printouts
(reference src/common.h, main.cpp). The device timeline comes from
jax.profiler; wall timing always goes through block_until_ready.
"""

from __future__ import annotations

import contextlib
import time

import jax


class StageTimer:
    """Accumulates per-stage wall times; prints a breakdown table."""

    def __init__(self):
        self.stages: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        t0 = time.perf_counter()
        yield
        if block_on is not None:
            jax.block_until_ready(block_on)
        self.stages[name] = self.stages.get(name, 0.0) + (
            time.perf_counter() - t0)

    def report(self) -> str:
        total = sum(self.stages.values()) or 1.0
        lines = [f"{'stage':<24}{'ms':>10}{'%':>7}"]
        for name, s in sorted(self.stages.items(), key=lambda kv: -kv[1]):
            lines.append(f"{name:<24}{s * 1e3:>10.2f}{100 * s / total:>6.1f}%")
        return "\n".join(lines)


def timed(fn, *args, warmup: int = 1, iters: int = 5, **kw) -> float:
    """Median wall seconds of fn(*args) with full device sync."""
    import numpy as np

    for _ in range(warmup):
        jax.block_until_ready(fn(*args, **kw))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args, **kw))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


@contextlib.contextmanager
def device_trace(log_dir: str = "/tmp/hagrid_xprof"):
    """jax.profiler trace around a region (view with TensorBoard/xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
