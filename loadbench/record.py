"""What one run saw, for the metric readers (``metrics/<name>.py``: each
has ``read(run) -> float | None``; None leaves the metric out)."""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

from loadbench.yardstick.trace import DeviceSummary


@dataclass
class Request:
    phase: str  # "ramp", "window" or "tail"
    prompt: List[int]
    budget: int
    due: float  # perf_counter seconds
    due_wall: float  # the same instant on time.time()
    sent: float = 0.0  # perf_counter when handed to the program
    admitted_wall: float = 0.0  # the scheduler's own admission stamp (time.time())
    done: float = 0.0  # perf_counter when the whole completion came back
    tokens: Optional[List[int]] = None
    error: Optional[str] = None
    # what the program kept for the request (the ``records`` mapping its
    # future carries, if any), for the cell's check
    records: dict = field(default_factory=dict)

    @property
    def latency_s(self) -> float:
        """Due to returned; a request that failed or never came is missing."""
        if self.tokens is None or self.error is not None:
            return math.inf
        return self.done - self.due

    @property
    def queue_s(self) -> Optional[float]:
        return self.admitted_wall - self.due_wall if self.admitted_wall else None


@dataclass
class Span:
    """Counts over a stretch of a run, from the benchmark's wrappers around
    the program's calls."""

    host_s: float = 0.0  # inside insert and step
    rounds: int = 0  # draft+verify rounds run
    tokens: int = 0  # output tokens committed (the first one at insert)
    flops: float = 0.0  # model FLOPs delivered (yardstick/flops.py)
    step_s: float = 0.0  # inside step alone



@dataclass
class Run:
    cell: str
    seconds: float
    window: tuple = (0.0, 0.0)  # perf_counter open and close
    setup_s: float = 0.0
    requests: List[Request] = field(default_factory=list)
    measured: Span = field(default_factory=Span)  # the window
    traced: Span = field(default_factory=Span)  # the profiled stretch, after it
    acceptance: Optional[float] = None  # accepted / drafted over the window
    device: Optional[DeviceSummary] = None  # the profiled stretch
    range_names: dict = field(default_factory=dict)  # metric -> host range name
    late_s: float = 0.0  # the open loop's worst lateness in sending
    traced_host_s: Optional[float] = None  # host seconds the profiler was on

    @property
    def window_requests(self) -> List[Request]:
        return [r for r in self.requests if r.phase == "window"]

    def tokens_in_window(self) -> float:
        """Output tokens delivered in the window: each returned request's
        tokens, in the share of its time (due to returned) that lies inside
        the window."""
        t0, t1 = self.window
        total = 0.0
        for r in self.requests:
            if r.tokens is None or r.done <= r.due:
                continue
            inside = min(r.done, t1) - max(r.due, t0)
            if inside > 0:
                total += len(r.tokens) * inside / (r.done - r.due)
        return total
