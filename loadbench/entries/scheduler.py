"""Entry: ``ContinuousBatchScheduler.submit`` over paged KV, under an open
loop.

The program is the configuration family's build (``families/<family>.py``:
``engine``). The main thread sends each planned request at its due time
(the traffic kind's schedule) and stamps its completion from the future's
callback, with whatever ``records`` mapping the future carries; the
scheduler runs its own thread, as it does behind the HTTP server. The
benchmark wraps the session's ``insert`` and ``step`` (host seconds, the
scheduler's admission stamp, output tokens committed and their model
FLOPs, from the session's host-side counters) and counts draft+verify
rounds. With ``trace``, once the window has closed the load goes on and
``trace_s`` seconds run under ``torch.profiler``, started and stopped on
the scheduler's thread between two steps, with a named range around the
MoE layer (the program records each K1 and K2 call's shapes itself while
a profiler records: ``profiling.RECORDS``). The profiler is not touched
before the window closes: once started it slows every launch of the
process, so the window's host-side readings stay clean.

Cell settings: ``slots``, ``max_steps``, ``prompt_bucket``, ``page_size``,
``pool_pages``, ``prefix_cache``, ``trace_s`` and the traffic kind's keys.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from loadbench import catalog
from loadbench.entries import port
from loadbench.record import Request, Run, Span
from loadbench.yardstick import trace as trace_mod
from loadbench.yardstick.flops import ModelShape

MOE_RANGE = "loadbench.moe_mlp"
# seconds between warming the profiler (which stalls the scheduler for
# seconds) and profiling, for the requests that queued meanwhile to go in
SETTLE_S = 3.0


def profiler():
    """A profiler of the host's operations (the idle gaps' labels and the MoE
    range need them) and the device's kernels."""
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])


def warm_profiler() -> None:
    """Start and stop a profiler once, on the thread that will profile: the
    first start initialises the device's tracing (seconds), which belongs
    in set-up and not in the profiled stretch."""
    prof = profiler()
    prof.start()
    torch.zeros(1, device="cuda" if torch.cuda.is_available() else "cpu").add_(1)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()


class _MoeRange:
    """A profiler range around the MoE layer, patched where the port binds
    ``moe_mlp``, while installed."""

    def __init__(self):
        self._saved = []

    def install(self) -> None:
        from layerskip_tpu_torch.models import llama

        moe = llama.moe_mlp

        def moe_mlp(*a, **kw):
            with torch.profiler.record_function(MOE_RANGE):
                return moe(*a, **kw)

        self._saved = [(llama, "moe_mlp", moe)]
        llama.moe_mlp = moe_mlp

    def remove(self) -> None:
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        self._saved = []


class _Probe:
    """Wraps one session's ``insert`` and ``step`` (called on the scheduler's
    thread) and sorts what they do into the run's spans."""

    def __init__(self, run: Run, sched, shape: ModelShape, by_future: dict,
                 t_trace: Optional[float], trace_s: float):
        self.run, self.sched, self.shape = run, sched, shape
        self.session = sched.session
        self.by_future = by_future
        self.t_trace = t_trace  # the profiler is warmed at the first step at or
        self._start_at = None  # after it, on SETTLE_S later, and off after the
        self.trace_s = trace_s  # first step that ends trace_s after that
        self.prompt_len = np.zeros(self.session.batch, np.int64)
        self.rounds = 0
        self.prof = None
        self.traced_s = None  # host seconds the profiler was on
        self.moe_range = _MoeRange()
        self.stats_at = {}  # scheduler stats when the window opened / closed
        self._wrap()

    def _span(self, t: float) -> Optional[Span]:
        t0, t1 = self.run.window
        if self.prof is not None and self.traced_s is None:
            return self.run.traced
        if t0 <= t < t1:
            return self.run.measured
        return None

    def _wrap(self) -> None:
        from layerskip_tpu_torch.generation import continuous

        session, insert, step = self.session, self.session.insert, self.session.step
        spec_round = continuous._spec_round

        def counted_round(*a, **kw):
            self.rounds += 1
            return spec_round(*a, **kw)

        continuous._spec_round = counted_round
        self._restore_round = lambda: setattr(continuous, "_spec_round", spec_round)

        def wrapped_insert(rows, prompts, seeds=None, max_tokens=None):
            t = time.perf_counter()
            insert(rows, prompts, seeds=seeds, max_tokens=max_tokens)
            span = self._span(t)
            flops = 0.0
            for r, p in zip(rows, prompts):
                n = min(len(p), session.prompt_bucket)
                self.prompt_len[r] = n
                flops += self.shape.prompt_flops(n)
                req = self.sched._slot_req.get(r)
                rec = self.by_future.get(id(req.future)) if req is not None else None
                if rec is not None:
                    rec.admitted_wall = req.t_start
            if span is not None:
                span.host_s += time.perf_counter() - t
                span.tokens += len(rows)
                span.flops += flops

        def wrapped_step(max_rounds=1):
            self._before_step(time.perf_counter())
            t = time.perf_counter()
            live = session.active & ~session._done
            pre = np.minimum(session._out_len, session._steps)
            r0 = self.rounds
            out = step(max_rounds)
            dt = time.perf_counter() - t
            span = self._span(t)
            if span is not None:
                post = np.minimum(session._out_len, session._steps)
                span.host_s += dt
                span.step_s += dt
                span.rounds += self.rounds - r0
                for r in np.flatnonzero(live):
                    a, b = int(pre[r]), int(post[r])
                    span.tokens += b - a
                    span.flops += self.shape.output_flops(int(self.prompt_len[r]), a, b)
            self._after_step()
            return out

        session.insert = wrapped_insert
        session.step = wrapped_step

    def _before_step(self, t: float) -> None:
        t0, t1 = self.run.window
        if "open" not in self.stats_at and t >= t0:
            self.stats_at["open"] = dict(self.sched.stats)
        if "close" not in self.stats_at and t >= t1:
            self.stats_at["close"] = dict(self.sched.stats)
        if self.t_trace is None or t < self.t_trace or self.prof is not None:
            return
        if self._start_at is None:
            warm_profiler()
            self._start_at = time.perf_counter() + SETTLE_S
        elif t >= self._start_at:
            self.prof = profiler()
            self.prof.start()
            self.moe_range.install()
            self._trace_t0 = time.perf_counter()

    def _after_step(self) -> None:
        if self.prof is not None and self.traced_s is None \
                and time.perf_counter() >= self._trace_t0 + self.trace_s:
            self.stop_trace()

    def trace_done(self) -> bool:
        return self.t_trace is None or self.traced_s is not None

    def stop_trace(self) -> None:
        if self.prof is None or self.traced_s is not None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.traced_s = time.perf_counter() - self._trace_t0
        self.prof.stop()
        self.moe_range.remove()

    def close(self) -> None:
        self._restore_round()
        self.moe_range.remove()

    def acceptance(self) -> Optional[float]:
        a, b = self.stats_at.get("open"), self.stats_at.get("close")
        if a is None or b is None or b["completed"] == a["completed"]:
            return None
        return (b["acceptance_sum"] - a["acceptance_sum"]) / (b["completed"] - a["completed"])


def run(cell, weights, device, seconds: float, trace: bool, t_process: float,
        plan) -> Run:
    """The run's record, once the load has stopped. The program's objects
    are dropped on return."""
    from layerskip_tpu_torch.serving import ContinuousBatchScheduler

    st = cell.settings
    family = catalog.load_module("families", cell.family)
    shape = family.model_shape(cell.config)
    engine = family.engine(cell, weights, device)
    sched = ContinuousBatchScheduler(
        engine, port.gen_config(cell, st["max_steps"]), batch_size=int(st["slots"]),
        prompt_bucket=int(st["prompt_bucket"]), eos_ids=port.no_eos(cell),
        paged_pool_pages=int(st["pool_pages"]), page_size=int(st["page_size"]),
        prefix_cache=bool(st.get("prefix_cache", False)))
    run_rec = Run(cell=cell.name, seconds=float(seconds))
    by_future = {}
    t_origin = time.perf_counter() + 0.05  # open loop: the schedule's start
    ramp_s = float(st["ramp_s"])
    run_rec.window = (t_origin + ramp_s, t_origin + ramp_s + float(seconds))
    t_trace = run_rec.window[1] if trace else None
    probe = _Probe(run_rec, sched, shape, by_future, t_trace, float(st["trace_s"]))
    sched.start()
    try:
        if plan[0].client is None:
            _drive(plan, sched, run_rec, by_future, t_origin, probe.trace_done)
        else:
            _drive_closed(plan, sched, run_rec, by_future, float(st["tail_s"]),
                          probe.trace_done)
    finally:
        sched.stop()
        probe.stop_trace()
        probe.close()
    run_rec.setup_s = run_rec.window[0] - t_process
    run_rec.acceptance = probe.acceptance()
    run_rec.traced_host_s = probe.traced_s
    if probe.prof is not None:
        run_rec.device = trace_mod.summarize(probe.prof.events(), ranges=(MOE_RANGE,))
        run_rec.range_names = {"moe": MOE_RANGE}
    if sched._thread is not None and sched._thread.is_alive():
        raise RuntimeError("the scheduler's thread did not stop")
    return run_rec


def _finisher(lock: threading.Lock):
    def finish(rec: Request, fut) -> None:
        now = time.perf_counter()
        with lock:
            rec.done = now
            exc = fut.exception()
            if exc is not None:
                rec.error = repr(exc)
            else:
                rec.tokens = list(fut.result())
            rec.records = dict(getattr(fut, "records", None) or {})
    return finish


def _drive(plan, sched, run: Run, by_future: dict, t_origin: float, trace_done) -> None:
    """Send every planned request at its due time; stop once every request
    due in the window has come back and the trace is done (or the tail's
    time is up)."""
    lock = threading.Lock()
    window: List[Request] = []
    finish = _finisher(lock)

    for p in plan:
        if p.phase == "tail" and trace_done():
            with lock:
                if all(r.done for r in window):
                    break
        due = t_origin + p.due
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        rec = Request(phase=p.phase, prompt=p.prompt, budget=p.budget, due=due,
                      due_wall=time.time() - (time.perf_counter() - due))
        fut = sched.submit(p.prompt, seed=0, max_tokens=p.budget)
        rec.sent = time.perf_counter()
        run.late_s = max(run.late_s, rec.sent - due)
        by_future[id(fut)] = rec
        run.requests.append(rec)
        if p.phase == "window":
            window.append(rec)
        fut.add_done_callback(lambda f, r=rec: finish(r, f))


def _drive_closed(plan, sched, run: Run, by_future: dict, tail_s: float,
                  trace_done) -> None:
    """Each client sends its next request when its last one has come back;
    stop once every request sent in the window has come back and the trace
    is done (or ``tail_s`` past the close)."""
    lock = threading.Lock()
    finish = _finisher(lock)
    queues = collections.defaultdict(collections.deque)
    for p in plan:
        queues[p.client].append(p)
    free = queue.Queue()
    for c in queues:
        free.put(c)
    t0, t1 = run.window
    window: List[Request] = []

    def settled() -> bool:
        with lock:
            return all(r.done for r in window) and trace_done()

    while time.perf_counter() < t1 + tail_s:
        if time.perf_counter() >= t1 and settled():
            break
        try:
            c = free.get(timeout=0.05)
        except queue.Empty:
            continue
        if not queues[c]:
            continue
        now = time.perf_counter()
        if now >= t1 and settled():
            break
        p = queues[c].popleft()
        rec = Request(phase="ramp" if now < t0 else "window" if now < t1 else "tail",
                      prompt=p.prompt, budget=p.budget, due=now, due_wall=time.time())
        fut = sched.submit(p.prompt, seed=0, max_tokens=p.budget)
        rec.sent = time.perf_counter()
        by_future[id(fut)] = rec
        run.requests.append(rec)
        if rec.phase == "window":
            window.append(rec)

        def done(f, r=rec, client=c):
            finish(r, f)
            free.put(client)

        fut.add_done_callback(done)
