"""Median over every request due in the window of due-to-returned time,
a failed or missing request counted as missing (above every other)."""

import math

from loadbench.yardstick.stats import percentile


def read(run):
    v = percentile([r.latency_s for r in run.window_requests], 50)
    return None if v is None or math.isinf(v) else v * 1e3
