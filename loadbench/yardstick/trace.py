"""What a ``torch.profiler`` trace of a stretch of the window says about the
device: the union of kernel intervals (busy time), the stretch's length,
kernel counts and times by name, device time under a named range, and the
idle gaps labelled by the host operation that was running then."""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


def union_seconds(spans: Sequence[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals, in their unit."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(spans: Sequence[Tuple[float, float]], t0: float, t1: float
              ) -> List[Tuple[float, float]]:
    """The intervals of [t0, t1) that no span covers."""
    gaps, cur = [], t0
    for s, e in sorted(spans):
        if s > cur:
            gaps.append((cur, min(s, t1)))
        cur = max(cur, e)
    if cur < t1:
        gaps.append((cur, t1))
    return [(s, e) for s, e in gaps if e > s]


@dataclass
class DeviceSummary:
    busy_s: float
    window_s: float
    kernels: int
    kernel_s_by_name: Dict[str, float]
    kernel_count_by_name: Dict[str, int]
    range_device_s: Dict[str, float]  # device time under each named host range
    idle_by_host_op: Dict[str, float] = field(default_factory=dict)
    extent: Dict[str, float] = field(default_factory=dict)  # where the events lie

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def kernel_seconds(self, fragment: str) -> float:
        return sum(v for k, v in self.kernel_s_by_name.items() if fragment in k)

    def kernel_count(self, fragment: str) -> int:
        return sum(v for k, v in self.kernel_count_by_name.items() if fragment in k)

    def breakdown(self, n: int = 10) -> dict:
        ops = sorted(self.kernel_s_by_name.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.idle_by_host_op.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k[:120], v] for k, v in ops],
                "idle_gaps": [[k[:120], v] for k, v in gaps]}


def _innermost(starts: List[float], cpu: list, t: float, lookback: int = 256) -> str:
    """Name of the latest-starting host event that covers ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - lookback, -1), -1):
        if cpu[j][1] >= t:
            return cpu[j][2]
    return "host (no recorded op)"


def summarize(events, ranges: Sequence[str] = ()) -> Optional[DeviceSummary]:
    """The summary of a profiler's ``events()``, or None when it holds no
    device event. Times in the events are microseconds."""
    import torch

    cuda_t = torch.autograd.DeviceType.CUDA
    kernels, cpu, range_us = [], [], defaultdict(float)
    for e in events:
        if e.device_type == cuda_t:
            # a named range shows on the device too (its first kernel to its
            # last): it is no operation of its own
            if e.name not in ranges:
                kernels.append((e.time_range.start, e.time_range.end, e.name))
        else:
            cpu.append((e.time_range.start, e.time_range.end, e.name))
            if e.name in ranges:  # the kernels launched under the range
                range_us[e.name] += getattr(e, "device_time_total", None) \
                    or getattr(e, "cuda_time_total", 0.0)
    if not kernels:
        return None
    spans = [(s, e) for s, e, _ in kernels]
    t0 = min([s for s, _ in spans] + [c[0] for c in cpu])
    t1 = max([e for _, e in spans] + [c[1] for c in cpu])
    by_name, count = defaultdict(float), defaultdict(int)
    for s, e, name in kernels:
        by_name[name] += (e - s) * 1e-6
        count[name] += 1
    cpu.sort()
    starts = [c[0] for c in cpu]
    idle = defaultdict(float)
    for s, e in idle_gaps(spans, t0, t1):
        idle[_innermost(starts, cpu, s)] += (e - s) * 1e-6
    extent = {"kernels_from_s": (min(s for s, _ in spans) - t0) * 1e-6,
              "kernels_to_s": (max(e for _, e in spans) - t0) * 1e-6,
              "host_events": len(cpu),
              "host_from_s": (cpu[0][0] - t0) * 1e-6 if cpu else None,
              "host_to_s": (max(c[1] for c in cpu) - t0) * 1e-6 if cpu else None}
    return DeviceSummary(busy_s=union_seconds(spans) * 1e-6, window_s=(t1 - t0) * 1e-6,
                         kernels=len(kernels), kernel_s_by_name=dict(by_name),
                         kernel_count_by_name=dict(count),
                         range_device_s={k: v * 1e-6 for k, v in range_us.items()},
                         idle_by_host_op=dict(idle), extent=extent)
