"""Tracing/profiling: step timers + jax.profiler integration.

The reference's observability is a wall-clock step timer printed at exit
(letf/__init__.py:25-32,176-188) plus tqdm bars. Here the step timer is a
reusable object and device-side profiling hooks into jax.profiler
(SURVEY.md §5 'keep step timer; add jax.profiler traces').
"""

from __future__ import annotations

import contextlib
import time
from typing import List, Tuple


class StepTimer:
    """Labelled wall-clock step timer with a percentage breakdown."""

    def __init__(self):
        self._steps: List[Tuple[str, float]] = []
        self._t0 = time.time()

    def step(self, label: str) -> None:
        now = time.time()
        if self._steps:
            prev_label, prev_start = self._steps[-1]
            print(f"  [{now - prev_start:7.1f}s] {prev_label}")
        self._steps.append((label, now))

    def summary(self) -> None:
        total = time.time() - self._t0
        print("\nTIMING SUMMARY")
        for i in range(len(self._steps) - 1):
            label, start = self._steps[i]
            _, end = self._steps[i + 1]
            pct = (end - start) / total * 100 if total > 0 else 0
            print(f"  {label:<40s} {end - start:8.1f}s ({pct:5.1f}%)")
        print(f"  {'TOTAL':<40s} {total:8.1f}s")


@contextlib.contextmanager
def device_trace(log_dir: str = "out/trace"):
    """Capture a jax.profiler trace (XLA ops, fusion, device-memory
    traffic) around a block into ``log_dir`` (relative paths resolve
    against the working directory); view with TensorBoard or xprof."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
        print(f"  [profiler] trace written to {log_dir}")


def annotate(name: str):
    """Named TraceAnnotation context for device timelines."""
    import jax

    return jax.profiler.TraceAnnotation(name)
