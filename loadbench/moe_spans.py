"""Readings of the program's MoE layer calls (``ops/moe.py``): their
``moe`` spans and their records (``RECORDS.moe``, kept while a profiler
records), for the metric files that name them. Each is None where the
program keeps no such span or record."""

from __future__ import annotations

from typing import Optional

import torch

from loadbench.spans import _profiling, window_spans
from loadbench.yardstick.moe_bound import moe_bound


def moe_records() -> Optional[list]:
    """The recorded MoE calls of the profiled stretch, or None."""
    prof = _profiling()
    rows = None if prof is None else getattr(prof.RECORDS, "moe", None)
    if not rows or prof.RECORDS.dropped:
        return None
    return rows


def bound_s(rows: list) -> float:
    """Σ ``moe_bound`` of the recorded calls, each with the experts its
    assignment counts (read here, once, after the stretch) say it hit."""
    hits = (torch.stack([r[7] for r in rows]) > 0).sum(dim=1).tolist()
    return sum(moe_bound(n, k, e, d, f, hit, esize)[0]
               for (n, k, e, d, f, _path, esize, _counts), hit in zip(rows, hits))


def roofline(run) -> Optional[float]:
    """The MoE layer's share of its roofline: the summed bound of the calls
    recorded in the profiled stretch over the device time under the
    benchmark's MoE range there, as a percentage."""
    rows = moe_records()
    if run.device is None or rows is None:
        return None
    t = run.device.range_device_s.get(run.range_names.get("moe", ""), 0.0)
    if t <= 0:
        return None
    return bound_s(rows) / t * 100.0


def host_ms_per_round(run) -> Optional[float]:
    """Summed milliseconds of the program's ``moe`` spans over its
    ``session.round`` spans, in the window."""
    w = window_spans(run)
    if w is None or not w.of("session.round") or not w.of("moe"):
        return None
    return w.total_ms("moe") / len(w.of("session.round"))
