"""The port's spans and kernel-entry records (layerskip_tpu_torch/utils/
profiling.py) on the CPU: the span tree of a scheduler run, the device
reads it counts, spans off, the ring's overflow, the Chrome export on the
profiler's clock, idle time by span, the K1/K2 records kept only under a
profiler, and the benchmark's readers of all of them (loadbench/spans.py)
on hand-made spans.
"""

import json
import types

import numpy as np
import pytest
import torch

from layerskip_tpu_torch import serving
from layerskip_tpu_torch.config import GenerationConfig, tiny_config
from layerskip_tpu_torch.generation.engine import Engine
from layerskip_tpu_torch.models.params import init_params
from layerskip_tpu_torch.utils import profiling
from loadbench import catalog
from loadbench.record import Run
from loadbench.yardstick.peaks import MEM_BYTES_PER_S
from loadbench.yardstick.trace import DeviceSummary

EOS = [135]  # unreachable (vocab 128): every request runs to its budget
GEN = GenerationConfig(max_steps=12, sample=False, generation_strategy="self_speculative",
                       exit_layer=2, num_speculations=3)
REQUESTS = [([3, 17, 52], 5), ([5, 9], 12), ([100, 2, 44, 8], 8)]
WAIT = 120


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engine():
    # head_dim 64: the paged calls take K2's path and the prompt blocks K1's
    cfg = tiny_config(hidden_size=128, num_attention_heads=2, num_key_value_heads=1,
                      vocab_size=128)
    params = init_params(cfg, seed=7, device="cpu")
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        getattr(params.layers, name).mul_(7.5)
    params.embed.mul_(15.0)
    params.lm_head.mul_(7.5)
    return Engine(params, cfg, device="cpu")


def _serve(engine):
    """Three requests through a paged continuous scheduler (two slots):
    (tokens, the spans recorded meanwhile)."""
    first = profiling.RECORDER._next
    sched = serving.ContinuousBatchScheduler(engine, GEN, batch_size=2, prompt_bucket=32,
                                             eos_ids=EOS, paged_pool_pages=16,
                                             page_size=16).start()
    try:
        futs = [sched.submit(p, max_tokens=m) for p, m in REQUESTS]
        tokens = [f.result(timeout=WAIT) for f in futs]
    finally:
        sched.stop()
    assert not sched._thread.is_alive()
    spans = [s for s in profiling.RECORDER.spans() if s.seq >= first]
    return tokens, spans, sched


@pytest.fixture(scope="module")
def served(engine):
    return _serve(engine)


def _children(spans):
    out = {}
    for s in spans:
        out.setdefault(s.parent, []).append(s)
    return out


def test_scheduler_spans_form_a_tree(served):
    tokens, spans, _ = served
    assert [len(t) for t in tokens] == [m for _, m in REQUESTS]
    by_seq = {s.seq: s for s in spans}
    for s in spans:
        assert s.end_ns is not None and s.end_ns >= s.start_ns, s.name
        if s.parent >= 0:
            p = by_seq[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (s.name, p.name)
            assert s.stacked == p.stacked or (s.name, p.name) == ("queue", "request")
    names = {s.name for s in spans}
    assert {"request", "queue", "sched.loop", "sched.wait", "session.insert", "session.step",
            "session.round", "spec.draft", "spec.verify", "sync"} <= names
    rids = sorted(r for s in spans if s.name == "request" for r in s.rids)
    assert len(rids) == 3
    for rid in rids:
        for name in ("queue", "session.insert", "session.step"):
            assert sum(rid in s.rids for s in spans if s.name == name) == 1, (rid, name)
    kids = _children(spans)
    for s in spans:
        if s.name in ("session.insert", "session.step", "sched.wait"):
            assert by_seq[s.parent].name == "sched.loop"
        if s.name in ("spec.draft", "spec.verify"):
            assert by_seq[s.parent].name == "session.round"
        if s.name == "request":
            assert [c.name for c in kids[s.seq]] == ["queue"]
            assert s.attrs["tokens"] == len(tokens[rids.index(s.rids[0])])
            assert s.attrs["prompt_tokens"] == len(REQUESTS[rids.index(s.rids[0])][0])


def test_sync_count_per_step_is_rounds_plus_one_plus_three_on_harvest(served):
    _, spans, _ = served
    kids = _children(spans)
    steps = [s for s in spans if s.name == "session.step"]
    assert steps and sum(len(s.rids) for s in steps) == 3
    for step in steps:
        rounds = [c for c in kids[step.seq] if c.name == "session.round"]
        syncs = [c for c in kids[step.seq] if c.name == "sync"]
        syncs += [c for r in rounds for c in kids.get(r.seq, []) if c.name == "sync"]
        assert len(syncs) == len(rounds) + 1 + (3 if step.rids else 0)
        assert step.attrs["rounds"] == sum(
            any(c.name == "spec.draft" for c in kids.get(r.seq, [])) for r in rounds)
    assert sum(s.attrs["tokens"] for s in steps) == sum(m - 1 for _, m in REQUESTS)


def test_latency_summary_and_ring_summary_read_the_spans(served):
    _, spans, sched = served
    summary = sched.latency.summary()
    assert summary["window"] == 3
    by_seq = {s.seq: s for s in spans}
    waits = [(s.end_ns - by_seq[s.parent].start_ns) / 1e6 for s in spans if s.name == "queue"]
    assert summary["queue_ms"]["p99"] == pytest.approx(max(waits), abs=0.006)
    ring = profiling.RECORDER.summary()
    assert ring["request"]["count"] >= 3 and ring["request"]["p95_ms"] >= 0


def test_spans_off_record_nothing_and_leave_the_tokens(engine, served, monkeypatch):
    monkeypatch.setattr(profiling, "ENABLED", False)
    before = profiling.RECORDER._next
    tokens, spans, sched = _serve(engine)
    assert profiling.RECORDER._next == before and spans == []
    assert tokens == served[0]
    assert profiling.span("x") is profiling.NULL_SPAN
    assert sched.latency.summary() == {"window": 0}


def test_chrome_trace_puts_a_span_around_its_op(tmp_path):
    a = torch.randn(256, 256)
    with profiling.trace(str(tmp_path)):
        with profiling.span("outer.span", rows=3):
            torch.mm(a, a)
    doc = json.loads((tmp_path / "trace.json").read_text())
    mine = [e for e in doc["traceEvents"] if e.get("name") == "outer.span"]
    ops = [e for e in doc["traceEvents"] if e.get("name") == "aten::mm" and e.get("ph") == "X"]
    assert len(mine) == 1 and ops and mine[0]["args"]["rows"] == 3
    s, op = mine[0], ops[0]
    assert s["ts"] - 1000 <= op["ts"] and op["ts"] + op["dur"] <= s["ts"] + s["dur"] + 1000
    idle = json.loads((tmp_path / "idle_by_span.json").read_text())
    assert idle["idle_s"] == {}  # no device here


def test_idle_by_span_splits_each_gap_by_the_innermost_span():
    cuda = torch.autograd.DeviceType.CUDA

    def ev(start, end, device=False):
        return types.SimpleNamespace(time_range=types.SimpleNamespace(start=start, end=end),
                                     device_type=cuda if device else None, name="e")

    # host events span [0, 100] us; kernels busy [10, 20] and [60, 70]
    events = [ev(0, 100), ev(10, 20, True), ev(60, 70, True)]
    spans = [(5, 90, "loop"), (30, 80, "step"), (40, 50, "sync")]
    idle = profiling.idle_by_span(events, spans)
    # gaps [0,10] [20,60] [70,100]: outside 5 + 10; loop 5 + 10 + 10; step
    # 10 + 10 + 10; sync 10
    expect = {profiling.OUTSIDE: 15e-6, "loop": 25e-6, "step": 30e-6, "sync": 10e-6}
    assert idle.keys() == expect.keys()
    for k, v in expect.items():
        assert idle[k] == pytest.approx(v), k
    assert sum(idle.values()) == pytest.approx(80e-6)


def test_kernel_records_only_while_a_profiler_records(engine):
    session = engine.continuous_session(GEN, 2, 32, EOS, paged_pool_pages=8, page_size=16)
    profiling.RECORDS.clear()
    session.insert([0], [list(range(3, 23))], max_tokens=[6])
    session.step(1)
    assert profiling.RECORDS.k1 == [] and profiling.RECORDS.k2 == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        session.insert([1], [list(range(5, 25))], max_tokens=[6])
        session.step(1)
    k1, k2 = profiling.RECORDS.k1, profiling.RECORDS.k2
    cfg = engine.cfg
    # the prompt block through every layer, over the row's gathered pages
    assert k1 == [((1, 32, 2, 64), session._max_pages * 16, 1, 0, 0, 4)] \
        * cfg.num_hidden_layers
    # a round: W + 1 one-token passes through the early layers (the drafts,
    # then the last draft's own), then the window of W + 1 through the rest
    assert len(k2) == (GEN.num_speculations + 1) * GEN.exit_layer + \
        (cfg.num_hidden_layers - GEN.exit_layer)
    assert {r[0] for r in k2} == {(2, 1, 2, 64), (2, GEN.num_speculations + 1, 2, 64)}
    assert all(isinstance(r[1], torch.Tensor) and r[2] == 1 for r in k2)
    profiling.RECORDS.clear()


# ---- the benchmark's readers on hand-made spans ----------------------------

S = 1_000_000_000  # ns a second


def _add(rec, name, t0, t1, parent=None, **attrs):
    sp = profiling.Span(rec, name, (), attrs, False)
    rec._open(sp, parent)
    sp.stacked, sp.start_ns, sp.end_ns = True, int(t0 * S), int(t1 * S)
    return sp


def _hand_made(rec):
    """A window [10 s, 12 s): three scheduler passes, one step of two
    rounds; spans before and after it."""
    _add(rec, "sched.loop", 9.0, 9.5)
    a = _add(rec, "sched.loop", 10.0, 10.5)
    _add(rec, "sched.wait", 10.0, 10.1, a)
    _add(rec, "session.insert", 10.1, 10.2, a)
    st = _add(rec, "session.step", 10.2, 10.45, a)
    for r0, sync, draft, verify, graph in ((10.2, 0.002, 0.060, 0.035, 1),
                                           (10.3, 0.001, 0.055, 0.040, 0)):
        r = _add(rec, "session.round", r0, r0 + 0.1, st)
        _add(rec, "sync", r0, r0 + sync, r)
        _add(rec, "spec.draft", r0 + sync, r0 + sync + draft, r, graph=graph)
        _add(rec, "spec.verify", r0 + sync + draft, r0 + sync + draft + verify, r,
             graph=1 - graph)
    _add(rec, "sync", 10.4, 10.403, st)
    b = _add(rec, "sched.loop", 11.0, 11.2)
    _add(rec, "sched.wait", 11.0, 11.2, b)
    c = _add(rec, "sched.loop", 11.5, 11.9)
    _add(rec, "session.insert", 11.5, 11.8, c)
    # a pass that outlasts the window: only its part before 12 s counts
    d = _add(rec, "sched.loop", 11.95, 13.0)
    _add(rec, "session.step", 11.96, 11.99, d)
    _add(rec, "sched.wait", 11.99, 12.5, d)
    _add(rec, "spec.draft", 12.5, 12.6, graph=1)
    _add(rec, "spec.verify", 12.6, 12.7, graph=1)


# self time: loop a 0.5 - 0.1 - 0.1 - 0.25, loop b 0, loop c 0.4 - 0.3,
# loop d 0.05 - 0.03 - 0.01 (inside the window): 0.16 s of 2
HAND = {"draft_ms.chat": 57.5, "verify_ms.chat": 37.5, "sync_wait_ms.chat": 3.0,
        "syncs_per_round.chat": 1.5, "sched_self_share.chat": 8.0,
        "sched_self_share.longdoc": 8.0, "sched_wait_share.longdoc": 15.5,
        "insert_ms.longdoc": 200.0,
        # one of the window's two draft passes replayed the graph
        "draft_graph_share.chat": 50.0, "draft_graph_share.longdoc": 50.0,
        # and the other of its two verify passes the verify graph
        "verify_graph_share.chat": 50.0, "verify_graph_share.longdoc": 50.0,
        # K2: q (1, 1, 1, 64) at position 3 of 8 slots: 4 keys, q and o once,
        # K and V of 4 keys, 2 bytes each: 1280 bytes in 10 ns
        "k2_roofline.chat": 1280 / MEM_BYTES_PER_S / 10e-9 * 100,
        # K1: q (1, 4, 1, 64) at past 0 over 4 keys: 2 * (512 + 512) bytes
        # in 20 ns
        "k1_roofline.longdoc": 2048 / MEM_BYTES_PER_S / 20e-9 * 100}


@pytest.fixture
def hand_made(monkeypatch):
    rec, records = profiling.SpanRecorder(), profiling.KernelRecords()
    monkeypatch.setattr(profiling, "RECORDER", rec)
    monkeypatch.setattr(profiling, "RECORDS", records)
    _hand_made(rec)
    records.add("k2", ((1, 1, 1, 64), torch.tensor([3]), 1, 8, 0, 2))
    records.add("k1", ((1, 4, 1, 64), 4, 1, 0, 0, 2))
    device = DeviceSummary(busy_s=1.0, window_s=2.0, kernels=2,
                           kernel_s_by_name={"paged_decode_kernel<bf16>": 10e-9,
                                             "flash_prefill_tc_kernel": 20e-9},
                           kernel_count_by_name={}, range_device_s={})
    return Run(cell="hand", seconds=2.0, window=(10.0, 12.0), device=device), rec


def test_every_new_reader_is_in_the_benchmark():
    names = {m["name"] for m in catalog.benchmark()["per_layer"]}
    assert set(HAND) <= names


@pytest.mark.parametrize("name", sorted(HAND))
def test_reader_gives_the_hand_worked_value(name, hand_made):
    run, _ = hand_made
    assert catalog.load_module("metrics", name).read(run) == pytest.approx(HAND[name])


@pytest.mark.parametrize("name", sorted(HAND))
def test_reader_is_none_once_the_ring_lost_window_spans(name, hand_made, monkeypatch):
    run, _ = hand_made
    small = profiling.SpanRecorder(capacity=8)
    monkeypatch.setattr(profiling, "RECORDER", small)
    _hand_made(small)
    assert small.dropped > 0
    records = profiling.KernelRecords(capacity=0)
    records.add("k1", ((1, 4, 1, 64), 4, 1, 0, 0, 2))
    records.add("k2", ((1, 1, 1, 64), np.zeros(1), 1, 8, 0, 2))
    monkeypatch.setattr(profiling, "RECORDS", records)
    assert catalog.load_module("metrics", name).read(run) is None


@pytest.mark.parametrize("name", ["draft_graph_share.chat", "draft_graph_share.longdoc",
                                  "verify_graph_share.chat", "verify_graph_share.longdoc"])
def test_graph_share_is_none_without_the_graph_attribute(name, hand_made):
    """A program whose draft or verify spans carry no ``graph`` attribute
    gives no reading, and no error."""
    run, rec = hand_made
    for s in rec.spans():
        s.attrs.pop("graph", None)
    assert catalog.load_module("metrics", name).read(run) is None
