"""The port's spans, kernel-entry records and profiler traces (port of
``layerskip_tpu/utils/profiling.py``).

  * ``span(name, rids=(), **attrs)`` — a span on the calling thread's stack
    (``with span(...) as s: ... s.set(k=v)``): name, start and end in
    ``time.perf_counter_ns()``, its parent (the thread's open span), its
    thread, the request ids it serves and a few attributes (counts ride on
    spans: rows, prompt tokens, rounds, tokens committed, a read's site);
  * ``detached(name, parent=None, rids=())`` — a span that starts on one
    thread and ends (``.end()``) on another, outside every stack: a
    request from submit to its future's resolution, its wait in the queue;
  * ``RECORDER`` — the process's ring of the last ``CAPACITY`` spans;
    ``dropped`` says how many older ones were overwritten (a reader of a
    stretch whose oldest kept span starts inside it has lost some),
    ``summary`` gives a count, p50 and p95 by name;
  * ``ENABLED`` — set it False and ``span``/``detached`` return one shared
    no-op object: no allocation, no clock read;
  * ``RECORDS`` — the facts of each K1 and K2 call (``ops/attention.py``)
    and each MoE layer call (``ops/moe.py``) while a ``torch.profiler``
    records, so a device trace's kernel times can be put beside the least
    time the calls could take;
  * ``trace(logdir)`` — ``torch.profiler`` over the block (CPU, and CUDA
    when a card is present) into ``logdir/trace.json``, the program's
    spans on their own track shifted to the profiler's clock, and the
    device's idle seconds by the innermost span open at the time
    (``idle_by_span``) in ``logdir/idle_by_span.json``.

Spans never enter the profiler (no ``record_function``): the profiler puts
a user range on the device timeline too, where it would read as a kernel.
They are merged at export. The profiler's clock is the host's wall clock
(``time.time_ns``); ``PROFILER_OFFSET_NS``, sampled once at import, takes a
``perf_counter_ns`` stamp there.
"""

from __future__ import annotations

import contextlib
import heapq
import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

ENABLED = True
CAPACITY = 65536  # spans kept in the ring
RECORD_CAPACITY = 65536  # K1, K2 or MoE records kept per profiled stretch
OUTSIDE = "(outside any span)"

# perf_counter_ns + PROFILER_OFFSET_NS is the same instant on the profiler's
# (and time.time_ns's) clock
PROFILER_OFFSET_NS = time.time_ns() - time.perf_counter_ns()


class Span:
    """One span; ``end_ns`` is None while it is open. ``parent`` is the
    ``seq`` of the span that caused it, or -1; ``stacked`` spans nest on
    their thread, detached ones (``detached``) do not."""

    __slots__ = ("seq", "name", "start_ns", "end_ns", "parent", "thread", "rids", "attrs",
                 "stacked", "_recorder")

    def __init__(self, recorder: "SpanRecorder", name: str, rids: Tuple[int, ...],
                 attrs: dict, stacked: bool):
        self._recorder = recorder
        self.name, self.rids, self.attrs, self.stacked = name, rids, attrs, stacked
        self.seq, self.parent, self.end_ns, self.thread, self.start_ns = -1, -1, None, 0, 0

    def set(self, rids: Optional[Sequence[int]] = None, **attrs) -> None:
        """Add attributes, and the request ids served when given."""
        if rids is not None:
            self.rids = tuple(rids)
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        self._recorder._open(self, None)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.attrs["error"] = 1
        self.end_ns = time.perf_counter_ns()
        stack = self._recorder._thread()[0]
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:  # an inner span left open: drop it with this one
            del stack[stack.index(self):]

    def end(self, **attrs) -> None:
        """Close a detached span (once; later calls do nothing)."""
        if self.end_ns is None:
            self.attrs.update(attrs)
            self.end_ns = time.perf_counter_ns()


class _NullSpan:
    """What ``span`` and ``detached`` return while spans are off."""

    __slots__ = ()
    rids, attrs, end_ns = (), {}, None

    def set(self, rids=None, **attrs) -> None:
        pass

    def end(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass


NULL_SPAN = _NullSpan()


class SpanRecorder:
    """A bounded ring of spans, in the order they started, with a stack of
    open spans per thread."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = int(capacity)
        self._ring: List[Optional[Span]] = [None] * self.capacity
        self._next = 0  # seq of the next span
        self._lock = threading.Lock()
        self._local = threading.local()

    def _thread(self) -> tuple:
        """(this thread's stack of open spans, its native id). The id is
        read once a thread: ``get_native_id`` is a system call."""
        loc = self._local
        try:
            return loc.stack, loc.tid
        except AttributeError:
            loc.stack, loc.tid = [], threading.get_native_id()
            return loc.stack, loc.tid

    def _open(self, sp: Span, parent: Optional[Span]) -> None:
        stack, sp.thread = self._thread()
        if sp.stacked:
            sp.parent = stack[-1].seq if stack else -1
            stack.append(sp)
        else:
            sp.parent = parent.seq if isinstance(parent, Span) else -1
        with self._lock:
            sp.seq = self._next
            self._next += 1
            self._ring[sp.seq % self.capacity] = sp
            sp.start_ns = time.perf_counter_ns()

    @property
    def dropped(self) -> int:
        """Spans overwritten since the last ``clear``."""
        return max(self._next - self.capacity, 0)

    def clear(self) -> None:
        with self._lock:
            self._ring = [None] * self.capacity
            self._next = 0

    def spans(self) -> List[Span]:
        """The spans in the ring, oldest first."""
        with self._lock:
            n, ring = self._next, list(self._ring)
        lo = max(n - self.capacity, 0)
        return [ring[i % self.capacity] for i in range(lo, n)]

    def summary(self) -> Dict[str, dict]:
        """Count, p50 and p95 in ms of the closed spans in the ring, by name."""
        by_name: Dict[str, list] = {}
        for s in self.spans():
            if s.end_ns is not None:
                by_name.setdefault(s.name, []).append(s.end_ns - s.start_ns)
        out = {}
        for name, ds in sorted(by_name.items()):
            ds.sort()
            out[name] = {"count": len(ds), "p50_ms": _pick_ms(ds, 0.5),
                         "p95_ms": _pick_ms(ds, 0.95)}
        return out


def _pick_ms(sorted_ns: list, q: float) -> float:
    """The q-quantile (nearest rank) of sorted nanoseconds, in ms."""
    return round(sorted_ns[min(int(q * (len(sorted_ns) - 1) + 0.5), len(sorted_ns) - 1)]
                 / 1e6, 3)


RECORDER = SpanRecorder()


def span(name: str, rids: Sequence[int] = (), **attrs):
    """A span on this thread's stack, over a ``with`` block."""
    if not ENABLED:
        return NULL_SPAN
    return Span(RECORDER, name, tuple(rids), attrs, True)


def detached(name: str, parent=None, rids: Sequence[int] = (), **attrs):
    """A span started now and closed by ``.end()`` on any thread; ``parent``
    is the detached span that caused it."""
    if not ENABLED:
        return NULL_SPAN
    sp = Span(RECORDER, name, tuple(rids), attrs, False)
    RECORDER._open(sp, parent)
    return sp


class KernelRecords:
    """What a device trace needs to put each K1, K2 and MoE call beside its
    roofline, appended by ``ops/attention.py`` and ``ops/moe.py`` while a
    profiler records: K1 ``(q.shape, keys, Hkv, past, window, element
    size)``, K2 ``(q.shape, the positions tensor (kept, never read there),
    Hkv, slots a row's table maps, window, element size)``, MoE ``(tokens,
    k, E, D, F, path, element size, the per-expert assignment counts [E] on
    the device (made only then, never read there))``.

    A CUDA graph's calls are launched by its replays, not by the entry
    points: ``calls_of`` collects the calls a thread makes while the graph's
    function runs, and each replay adds them (generation/draft_graph.py)."""

    def __init__(self, capacity: int = RECORD_CAPACITY):
        self.capacity = int(capacity)
        self.k1: list = []
        self.k2: list = []
        self.moe: list = []
        self.dropped = 0
        self.collecting = 0  # threads inside ``calls_of``
        self._local = threading.local()
        self._lock = threading.Lock()

    def add(self, kind: str, record: tuple, kept: bool = True) -> None:
        """Keep a call's record (``kept``: a profiler records), or give it to
        this thread's ``calls_of`` block."""
        calls = getattr(self._local, "calls", None)
        if calls is not None:
            calls.append((kind, record))
            return
        if not kept:
            return
        rows = getattr(self, kind)
        if len(rows) < self.capacity:
            rows.append(record)
        else:
            self.dropped += 1

    @contextlib.contextmanager
    def calls_of(self):
        """The ``(kind, record)`` of every recorded call this thread makes
        inside the block, in order, kept apart from the records."""
        calls = self._local.calls = []
        with self._lock:
            self.collecting += 1
        try:
            yield calls
        finally:
            self._local.calls = None
            with self._lock:
                self.collecting -= 1

    def clear(self) -> None:
        self.k1, self.k2, self.moe, self.dropped = [], [], [], 0


RECORDS = KernelRecords()


def on_profiler_clock(spans: Sequence[Span], trace_start_ns: int
                      ) -> List[Tuple[float, float, str]]:
    """Closed stacked spans as ``(start_us, end_us, name)`` on the time base
    of a profiler's ``events()`` (microseconds from ``trace_start_ns``)."""
    shift = PROFILER_OFFSET_NS - int(trace_start_ns)
    return [((s.start_ns + shift) / 1e3, (s.end_ns + shift) / 1e3, s.name)
            for s in spans if s.stacked and s.end_ns is not None]


def _union_gaps(kernels: List[Tuple[float, float]], t0: float, t1: float):
    gaps, cur = [], t0
    for s, e in sorted(kernels):
        if s > cur:
            gaps.append((cur, min(s, t1)))
        cur = max(cur, e)
    if cur < t1:
        gaps.append((cur, t1))
    return [(s, e) for s, e in gaps if e > s]


def _innermost_timeline(spans: Sequence[Tuple[float, float, str]]):
    """[(from, to, name)]: the span open with the latest start over each
    stretch between span boundaries (``OUTSIDE`` where none is open)."""
    points = sorted({p for s, e, _ in spans for p in (s, e)})
    by_start = sorted(spans)
    heap, i, out = [], 0, []
    for a, b in zip(points, points[1:]):
        while i < len(by_start) and by_start[i][0] <= a:
            s, e, name = by_start[i]
            heapq.heappush(heap, (-s, e, name))
            i += 1
        while heap and heap[0][1] <= a:
            heapq.heappop(heap)
        # a span closed under a later-starting one stays in the heap until
        # it surfaces: skip every closed span on top
        out.append((a, b, heap[0][2] if heap else OUTSIDE))
    return out


def idle_by_span(events, spans: Sequence[Tuple[float, float, str]]) -> Dict[str, float]:
    """The device's idle seconds by the innermost program span open at the
    time, and ``OUTSIDE`` for idle time under no span. ``events`` is a
    profiler's ``events()``; ``spans`` are on their clock
    (``on_profiler_clock``). Idle time is the stretch from the first event
    to the last (host or device) less the union of device events, a user
    range's device span excluded."""
    import torch

    cuda_t = torch.autograd.DeviceType.CUDA
    kernels, bounds = [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        bounds += (s, t)
        if e.device_type == cuda_t and not getattr(e, "is_user_annotation", False):
            kernels.append((s, t))
    if not kernels:
        return {}
    out: Dict[str, float] = {}
    timeline = _innermost_timeline(spans)
    j = 0
    for g0, g1 in _union_gaps(kernels, min(bounds), max(bounds)):
        covered = 0.0
        while j < len(timeline) and timeline[j][1] <= g0:
            j += 1
        k = j
        while k < len(timeline) and timeline[k][0] < g1:
            a, b, name = timeline[k]
            d = min(b, g1) - max(a, g0)
            if d > 0:
                out[name] = out.get(name, 0.0) + d * 1e-6
                covered += d
            k += 1
        if g1 - g0 > covered:
            out[OUTSIDE] = out.get(OUTSIDE, 0.0) + (g1 - g0 - covered) * 1e-6
    return out


def _add_spans_to_chrome_trace(path: str, spans: Sequence[Span]) -> None:
    """Write ``spans`` into a profiler's Chrome trace at ``path``, shifted to
    its clock: stacked spans as complete events on one track per thread,
    detached ones (requests, queue waits) as async events."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = "layerskip_tpu_torch spans"
    events = doc.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                   "args": {"name": pid}})
    for s in spans:
        if s.end_ns is None:
            continue
        ts = (s.start_ns + PROFILER_OFFSET_NS - base) / 1e3
        args = dict(s.attrs, seq=s.seq, parent=s.parent, rids=list(s.rids))
        if s.stacked:
            events.append({"ph": "X", "name": s.name, "cat": "span", "pid": pid,
                           "tid": s.thread, "ts": ts, "dur": (s.end_ns - s.start_ns) / 1e3,
                           "args": args})
        else:
            for ph, t in (("b", ts), ("e", ts + (s.end_ns - s.start_ns) / 1e3)):
                events.append({"ph": ph, "name": s.name, "cat": "request", "pid": pid,
                               "tid": 0, "id": s.seq, "ts": t, "args": args})
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile everything inside the block into ``logdir/trace.json`` with
    the program's spans of the block merged in, and write the device's idle
    seconds by innermost span to ``logdir/idle_by_span.json``. The K1, K2
    and MoE records (``RECORDS``) hold this block's calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    RECORDS.clear()
    t0 = time.perf_counter_ns()
    with profile(activities=activities) as prof:
        yield prof
    t1 = time.perf_counter_ns()
    spans = [s for s in RECORDER.spans()
             if s.end_ns is not None and s.end_ns >= t0 and s.start_ns <= t1]
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    _add_spans_to_chrome_trace(path, spans)
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    idle = idle_by_span(prof.events(), on_profiler_clock(spans, start_ns))
    with open(os.path.join(logdir, "idle_by_span.json"), "w") as f:
        json.dump({"idle_s": idle, "spans_dropped": RECORDER.dropped}, f, indent=1)
