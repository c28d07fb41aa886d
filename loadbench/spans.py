"""Readings of the program's own spans and kernel-entry records
(``layerskip_tpu_torch/utils/profiling.py``: ``RECORDER``, ``RECORDS``) for
the metric files that name them. Counts and per-round times read the spans
that started inside ``run.window`` (perf_counter seconds; the spans' clock
in ns); shares of the window read the part of each span inside it, so a
pass of the loop that outlasts the window (the profiler is warmed up right
after it) adds only its part before the close. Each reading is None where
the program keeps no such record, or where the ring lost spans that started
in the window."""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

import numpy as np

from loadbench.yardstick.roofline import flash_bound, paged_bound

LOOP_CHILDREN = ("sched.wait", "session.insert", "session.step")


def _profiling():
    """The program's tracing module, or None where it has no spans."""
    try:
        from layerskip_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "RECORDER") or not hasattr(profiling, "RECORDS"):
        return None
    return profiling


class WindowSpans:
    """The closed spans that started in the window and those that overlap
    it, by name, and every closed span's children, by parent."""

    def __init__(self, spans: list, t0_ns: int, t1_ns: int):
        self.t0, self.t1 = t0_ns, t1_ns
        self.seconds = (t1_ns - t0_ns) * 1e-9
        self.by_name: Dict[str, list] = {}
        self.overlapping: Dict[str, list] = {}
        self.children: Dict[int, list] = {}
        for s in spans:
            if s.end_ns is None:
                continue
            self.children.setdefault(s.parent, []).append(s)
            if t0_ns <= s.start_ns < t1_ns:
                self.by_name.setdefault(s.name, []).append(s)
            if s.start_ns < t1_ns and s.end_ns > t0_ns:
                self.overlapping.setdefault(s.name, []).append(s)

    def of(self, name: str) -> List:
        return self.by_name.get(name, [])

    def total_ms(self, name: str) -> float:
        return sum(s.end_ns - s.start_ns for s in self.of(name)) * 1e-6

    def inside_ns(self, s) -> int:
        """The part of span ``s`` inside the window."""
        return max(min(s.end_ns, self.t1) - max(s.start_ns, self.t0), 0)

    def share(self, ns: int) -> float:
        return ns * 1e-9 / self.seconds * 100.0


def window_spans(run) -> Optional[WindowSpans]:
    prof = _profiling()
    if prof is None:
        return None
    rec = prof.RECORDER
    t0, t1 = int(run.window[0] * 1e9), int(run.window[1] * 1e9)
    spans = rec.spans()
    if rec.dropped and (not spans or spans[0].start_ns >= t0):
        return None  # the ring may have lost spans of the window
    return WindowSpans(spans, t0, t1)


def per_round_ms(run, name: str) -> Optional[float]:
    """Summed milliseconds of ``name`` spans over the rounds
    (``session.round`` spans) in the window."""
    w = window_spans(run)
    if w is None or not w.of("session.round"):
        return None
    return w.total_ms(name) / len(w.of("session.round"))


def syncs_per_round(run) -> Optional[float]:
    w = window_spans(run)
    if w is None or not w.of("session.round"):
        return None
    return len(w.of("sync")) / len(w.of("session.round"))


def sched_self_share(run) -> Optional[float]:
    """The scheduler loop's own time in the window: each ``sched.loop``
    span less its ``sched.wait``, ``session.insert`` and ``session.step``
    children, over the window's seconds, as a percentage."""
    w = window_spans(run)
    if w is None or not w.of("sched.loop"):
        return None
    own = 0
    for loop in w.overlapping["sched.loop"]:
        own += w.inside_ns(loop) - sum(w.inside_ns(c) for c in w.children.get(loop.seq, [])
                                       if c.name in LOOP_CHILDREN)
    return w.share(own)


def share_of_window(run, name: str) -> Optional[float]:
    """The seconds of ``name`` spans inside the window over its seconds, as a
    percentage."""
    w = window_spans(run)
    if w is None or not w.of("sched.loop"):
        return None
    return w.share(sum(w.inside_ns(s) for s in w.overlapping.get(name, [])))


def median_ms(run, name: str) -> Optional[float]:
    w = window_spans(run)
    if w is None or not w.of(name):
        return None
    return statistics.median(s.end_ns - s.start_ns for s in w.of(name)) * 1e-6


def _records(kind: str) -> Optional[list]:
    prof = _profiling()
    if prof is None or prof.RECORDS.dropped:
        return None
    rows = getattr(prof.RECORDS, kind)
    return rows or None


def records_count() -> Optional[dict]:
    """How many K1 and K2 calls the program recorded (while a profiler
    recorded), and how many it dropped."""
    prof = _profiling()
    if prof is None:
        return None
    r = prof.RECORDS
    return {"k1": len(r.k1), "k2": len(r.k2), "dropped": r.dropped}


def _bound_s(kind: str, rows: list) -> float:
    if kind == "k1":
        return sum(flash_bound(b, t, s, past, hq, hkv, dh, int(window), esize)[0]
                   for (b, t, hq, dh), s, hkv, past, window, esize in rows)
    total, seen = 0.0, {}
    for shape, pos, hkv, n_slots, window, esize in rows:
        key = (id(pos), shape, n_slots, int(window))
        if key not in seen:
            b, t, hq, dh = shape
            p = np.asarray(pos.to("cpu").long().expand(b, t))
            seen[key] = paged_bound(p, hq, hkv, dh, n_slots, int(window), esize)[0]
        total += seen[key]
    return total


def roofline_from_records(run, kind: str, fragment: str) -> Optional[float]:
    """A kernel's share of its roofline from the program's own records of
    its calls in the profiled stretch: their summed bound seconds over the
    kernel's device time there (kernels whose name holds ``fragment``), as
    a percentage."""
    if run.device is None:
        return None
    rows = _records(kind)
    t = run.device.kernel_seconds(fragment)
    if rows is None or t <= 0:
        return None
    return _bound_s(kind, rows) / t * 100.0
