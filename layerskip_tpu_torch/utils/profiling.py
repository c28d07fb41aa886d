"""Tracing, annotation and per-phase timing (port of
``layerskip_tpu/utils/profiling.py``).

  * ``trace(logdir)`` — ``torch.profiler`` over the block (CPU, and CUDA
    when a card is present), written to ``logdir`` as a Chrome trace;
  * ``annotate(name)`` — a named host span on that timeline
    (``torch.profiler.record_function``);
  * ``StepTimer`` — wall-clock phase timing with mean/p50/p99 summaries.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List


@contextlib.contextmanager
def trace(logdir: str):
    """Profile everything inside the block into ``logdir/trace.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named region on the profiler timeline (host span)."""
    import torch

    return torch.profiler.record_function(name)


class StepTimer:
    """Accumulates wall-clock durations per phase name."""

    def __init__(self):
        self._t: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._t[name].append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        self._t[name].append(seconds)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self._t.items():
            xs_sorted = sorted(xs)
            n = len(xs_sorted)
            out[name] = {
                "count": n,
                "total": sum(xs_sorted),
                "mean": sum(xs_sorted) / n,
                "p50": xs_sorted[n // 2],
                "p99": xs_sorted[min(int(n * 0.99), n - 1)],
            }
        return out

    def __str__(self) -> str:
        lines = []
        for name, s in sorted(self.summary().items()):
            lines.append(
                f"{name:24s} n={s['count']:<6d} mean={s['mean'] * 1e3:8.2f}ms "
                f"p50={s['p50'] * 1e3:8.2f}ms p99={s['p99'] * 1e3:8.2f}ms"
            )
        return "\n".join(lines)
