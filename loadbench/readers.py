"""Readings shared by the metric files of several cells (each metric file
under ``metrics/`` names one of these, or reads the run itself)."""

from __future__ import annotations

from typing import Optional

from loadbench.yardstick.peaks import BF16_FLOP_PER_S


def acceptance(run) -> Optional[float]:
    """Accepted over drafted tokens in the window, as a percentage."""
    return None if run.acceptance is None else run.acceptance * 100.0


def launches_per_token(run) -> Optional[float]:
    """Device kernels in the profiled stretch per output token committed in it."""
    if run.device is None or not run.traced.tokens:
        return None
    return run.device.kernels / run.traced.tokens


def idle_share(run) -> Optional[float]:
    """Share of the profiled stretch in which no kernel ran, as a percentage."""
    return None if run.device is None else run.device.idle_share * 100.0


def step_mfu(run) -> Optional[float]:
    """Model FLOPs delivered (``yardstick/flops.py``) over the host seconds
    the port spent inside its calls, over the bf16 peak, as a percentage;
    over the window (the profiler is off there)."""
    s = run.measured
    return s.flops / s.host_s / BF16_FLOP_PER_S * 100.0 if s.host_s > 0 else None

