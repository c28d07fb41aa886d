"""Route records of a mixture-of-experts session, and the benchmark's check
that follows them (``loadbench/reference/mixtral.py``,
``loadbench/checks/routes.py``), on a tiny Mixtral on the CPU.

A continuous session over an MoE model records, for every position a
served request fed, the experts each layer chose there, written by the
pass that wrote that position's KV (insert, draft passes, verify; a
rejected draft's record is overwritten with its KV), and the scheduler
puts them on the request's future as ``records["routes"]``. The routes
check reads a sound program ``correct`` and a program that routes
otherwise (a router with two experts swapped, records a position off,
top-1 routing, no records) not ``correct``. Also: the ``moe`` span and
``RECORDS.moe`` of ``ops/moe.py``, ``moe_bound`` on hand-worked shapes,
and the two MoE readers of the benchmark.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from layerskip_tpu_torch import serving
from layerskip_tpu_torch.config import GenerationConfig, ModelConfig
from layerskip_tpu_torch.generation.core import _mk_group_cache
from layerskip_tpu_torch.models import llama
from layerskip_tpu_torch.models.llama import NO_ROUTE, RouteSink
from layerskip_tpu_torch.ops import moe
from layerskip_tpu_torch.utils import profiling

from loadbench import catalog
from loadbench.check import Served, positions
from loadbench.checks import routes as routes_check
from loadbench.families import mistral as mistral_family
from loadbench.families import mixtral as family
from loadbench.record import Run
from loadbench.reference import float32_exact
from loadbench.reference import mistral as mistral_ref
from loadbench.reference import mixtral as reference
from loadbench.tests.tiny import tiny_cell
from loadbench.yardstick.peaks import BF16_FLOP_PER_S, MEM_BYTES_PER_S
from loadbench.yardstick.trace import DeviceSummary

CPU = torch.device("cpu")
SEED = 2 ** 31 + 21
# a sound tiny program (bf16, as the benchmark serves) needs strays of at
# most ~0.003 to explain its differing sets and reads a widest gap of 0;
# the limits leave it ~15x room
MARGIN = 0.05
LIMITS = {"max_gap": 0.05, "route_mismatch": 0, "routes_missing": 0}
REQUESTS = [(23, 12), (7, 20), (40, 9), (15, 16), (31, 14), (5, 18)]  # (prompt, budget)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cell(**config):
    base = tiny_cell(moe=True)
    return dataclasses.replace(base, config=dict(base.config, family="mixtral",
                                                 route_margin=MARGIN, **config))


@pytest.fixture(scope="module")
def weights():
    cell = _cell()
    return family.make_weights(cell.config, cell.exit_layer, cell.tail_eps, SEED, CPU)


def _prompts():
    g = np.random.default_rng(5)
    return [(g.integers(3, 512, n).tolist(), budget) for n, budget in REQUESTS]


def _serve(engine, cell, **draft):
    """The requests through a paged continuous scheduler of 4 slots:
    ([(prompt, tokens, the future's records)], the scheduler); ``draft``
    overrides the draft source (``GenerationConfig`` fields)."""
    gen = GenerationConfig(**dict(dict(
        max_steps=24, sample=False, generation_strategy="self_speculative",
        exit_layer=cell.exit_layer, num_speculations=cell.num_speculations), **draft))
    sched = serving.ContinuousBatchScheduler(engine, gen, batch_size=4, prompt_bucket=64,
                                             eos_ids=(1000,), paged_pool_pages=28,
                                             page_size=16).start()
    try:
        reqs = [(p, sched.submit(p, max_tokens=m)) for p, m in _prompts()]
        out = [(p, f.result(timeout=120), getattr(f, "records", None)) for p, f in reqs]
    finally:
        sched.stop()
    assert not sched._thread.is_alive()
    return out, sched


def _served(engine, cell):
    out, _ = _serve(engine, cell)
    return [Served(p, t, records=r or {}) for p, t, r in out]


def _read(served, weights, cell):
    with float32_exact():
        return routes_check.read(reference, weights, cell.config, served)


def _correct(read):
    return all(read[k] <= v for k, v in LIMITS.items())


@pytest.fixture(scope="module")
def sound(weights):
    cell = _cell()
    return _served(family.engine(cell, weights, CPU), cell)


# ---- the records follow the KV ---------------------------------------------

@pytest.mark.parametrize("draft", [
    {}, {"draft_exit_prob": 0.5}, {"generation_strategy": "prompt_lookup", "pld_ngram": 1},
    {"generation_strategy": "hybrid", "pld_ngram": 1}], ids=["early_exit", "adaptive",
                                                             "prompt_lookup", "hybrid"])
def test_recorded_routes_are_those_of_a_plain_forward_pass_of_the_served_tokens(draft):
    """fp32, so that the incremental passes and one whole pass route alike;
    at least one request has a rejected draft."""
    cell = _cell()
    w = family.make_weights(cell.config, cell.exit_layer, cell.tail_eps, SEED, CPU,
                            dtype=torch.float32)
    engine = family.engine(cell, w, CPU)
    cfg = ModelConfig.from_hf_dict(cell.config, dtype=torch.float32)
    engine = type(engine)(engine.params, cfg, device=CPU)
    out, sched = _serve(engine, cell, **draft)
    assert sched.stats["acceptance_sum"] < sched.stats["completed"]  # a draft was rejected
    n_layers, k = cfg.num_hidden_layers, cfg.num_experts_per_tok
    for prompt, tokens, records in out:
        fed = prompt + tokens[:-1]
        got = records["routes"]
        assert got.dtype == np.uint8 and got.shape == (n_layers, len(fed), k)
        buf = torch.full((n_layers, 1, len(fed), k), NO_ROUTE, dtype=torch.uint8)
        cache = _mk_group_cache(cfg, n_layers, 1, len(fed), CPU, False)
        with torch.inference_mode():
            h = llama.embed_tokens(engine.params, torch.tensor([fed]), cfg)
            llama.run_layers(cfg, engine.params.layers, h, cache.k, cache.v, 0,
                             routes=RouteSink(buf))
        want = np.sort(buf[:, 0].numpy(), axis=-1)
        np.testing.assert_array_equal(np.sort(got, axis=-1), want)


def test_a_dense_session_keeps_no_routes_and_makes_no_extra_read():
    cell = tiny_cell()
    w = mistral_family.make_weights(cell.config, cell.exit_layer, cell.tail_eps, SEED, CPU)
    first = profiling.RECORDER._next
    out, sched = _serve(mistral_family.engine(cell, w, CPU), cell)
    assert sched.session.routes is None and sched.session.records == {}
    assert all(r is None for _, _, r in out)
    sites = {s.attrs.get("site") for s in profiling.RECORDER.spans()
             if s.seq >= first and s.name == "sync"}
    assert "harvest.out" in sites and "harvest.routes" not in sites


# ---- the check is tight ----------------------------------------------------

def test_the_routes_check_reads_a_sound_program_correct(sound, weights):
    read = _read(sound, weights, _cell())
    assert _correct(read), read
    assert read["tokens"] == sum(m for _, m in REQUESTS)
    assert 0.0 <= read["followed_share"] < 0.05


def _swapped_router(weights):
    w = dict(weights)
    r = w["w_router"].clone()
    r[1] = r[1][:, [1, 0, 2, 3]]
    w["w_router"] = r
    return w


@pytest.mark.parametrize("fault", ["swapped_router", "shifted_records", "top1", "no_records"])
def test_the_routes_check_reads_a_program_that_routes_otherwise_not_correct(
        fault, sound, weights):
    cell = _cell()
    if fault == "swapped_router":
        served = _served(family.engine(cell, _swapped_router(weights), CPU), cell)
    elif fault == "top1":
        served = _served(family.engine(_cell(num_experts_per_tok=1), weights, CPU), cell)
        assert served[0].records["routes"].shape[-1] == 1
    elif fault == "shifted_records":
        served = [dataclasses.replace(r, records={"routes": np.roll(r.records["routes"], 1,
                                                                     axis=1)})
                  for r in sound]
    else:
        served = [dataclasses.replace(r, records={}) for r in sound]
    read = _read(served, weights, cell)
    assert not _correct(read), read
    key = "routes_missing" if fault == "no_records" else "route_mismatch"
    assert read[key] > 0


def _own_routes(weights, hf, seqs, spans, monkeypatch):
    """The reference's own expert sets of every sequence, [L, len, k] each."""
    chosen = []
    combine = reference._combine

    def keep(x, w, i, topv, topi, ops):
        chosen.append(topi.clone())
        return combine(x, w, i, topv, topi, ops)

    monkeypatch.setattr(reference, "_combine", keep)
    reference.routed_logits_at(weights, hf, seqs, spans, [None] * len(seqs), 0.0)
    monkeypatch.setattr(reference, "_combine", combine)
    per_layer = [c.split([len(s) for s in seqs]) for c in chosen]
    return [torch.stack([layer[j] for layer in per_layer]).numpy().astype(np.uint8)
            for j in range(len(seqs))]


def test_routed_logits_with_its_own_routes_are_logits_at_bit_for_bit(sound, weights,
                                                                      monkeypatch):
    hf = _cell().config
    seqs, spans = positions(sound[:3])
    with float32_exact():
        own = _own_routes(weights, hf, seqs, spans, monkeypatch)
        plain = mistral_ref.logits_at(weights, hf, seqs, spans, "fp32")
        mine = reference.logits_at(weights, hf, seqs, spans, "fp32")
        routed, tally = reference.routed_logits_at(weights, hf, seqs, spans, own, MARGIN)
    assert tally["followed"] == tally["mismatch"] == tally["missing"] == 0
    assert tally["judged"] == hf["num_hidden_layers"] * sum(len(s) for s in seqs)
    for a, b, c in zip(plain, mine, routed):
        assert torch.equal(a, b) and torch.equal(a, c)


# ---- tracing and the readers -------------------------------------------------

D, F, E, K = 16, 24, 4, 2


def _experts():
    g = torch.Generator().manual_seed(3)
    n = lambda *s: torch.randn(s, generator=g) * 0.3  # noqa: E731
    return n(D, E), n(E, D, F), n(E, D, F), n(E, F, D)


@pytest.mark.parametrize("tokens,path", [(1, "few"), (8, "dense"), (2048, "grouped")])
def test_each_moe_call_is_a_span_and_a_record_only_while_a_profiler_records(tokens, path):
    w = _experts()
    x = torch.randn(1, tokens, D, generator=torch.Generator().manual_seed(4))
    profiling.RECORDS.clear()
    first = profiling.RECORDER._next
    got = []
    moe.moe_mlp(x, *w, K, routes_out=got.append)
    spans = [s for s in profiling.RECORDER.spans() if s.seq >= first and s.name == "moe"]
    assert [(s.attrs["path"], s.attrs["tokens"]) for s in spans] == [(path, tokens)]
    assert profiling.RECORDS.moe == [] and got[0].shape == (tokens, K)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        moe.moe_mlp(x, *w, K)
    (rec,) = profiling.RECORDS.moe
    assert rec[:7] == (tokens, K, E, D, F, path, 4)
    assert rec[7].shape == (E,) and int(rec[7].sum()) == tokens * K
    assert torch.equal(rec[7], torch.bincount(got[0].reshape(-1), minlength=E))
    profiling.RECORDS.clear()


def test_moe_bound_on_hand_worked_shapes():
    from loadbench.yardstick.moe_bound import moe_bound

    # a batch-32 draft pass of Mixtral's layer, all 8 experts hit: the
    # experts' 8 x 3 x 4096 x 14336 bf16 weights bound it (0.8414 ms)
    t, what = moe_bound(32, 2, 8, 4096, 14336, 8, 2)
    assert what == "bytes"
    assert t == pytest.approx(2 * (8 * 3 * 4096 * 14336 + 4096 * 8 + 2 * 32 * 4096)
                              / MEM_BYTES_PER_S)
    assert t == pytest.approx(0.8414e-3, rel=1e-3)
    # a 4096-token prefill: its routed FLOPs bound it
    t, what = moe_bound(4096, 2, 8, 4096, 14336, 8, 2)
    assert what == "operations"
    assert t == pytest.approx((2 * 3 * 4096 * 14336 * 4096 * 2 + 2 * 4096 * 4096 * 8)
                              / BF16_FLOP_PER_S)
    # a single token touches two experts' weights only
    assert moe_bound(1, 2, 8, 4096, 14336, 2, 2)[0] == pytest.approx(
        2 * (2 * 3 * 4096 * 14336 + 4096 * 8 + 2 * 4096) / MEM_BYTES_PER_S)


READERS = ("moe_roofline.chat", "moe_host_ms.chat")


def test_the_moe_readers_are_in_the_benchmark_for_the_mixtral_cell():
    entries = {m["name"]: m for m in catalog.benchmark()["per_layer"]}
    for name in READERS:
        assert entries[name]["workloads"] == ["mixtral-8x7b-l16.chat"]
        assert entries[name]["layer"] == "MoE (ops/moe.py)"
    cell = catalog.cell("mixtral-8x7b-l16.chat")
    assert (cell.family, cell.check) == ("mixtral", "routes")
    assert set(LIMITS) <= set(cell.settings["limits"])


def _span(name, seq, start_ms, end_ms):
    return types.SimpleNamespace(name=name, seq=seq, parent=-1, start_ns=int(start_ms * 1e6),
                                 end_ns=int(end_ms * 1e6), attrs={})


def test_the_moe_readers_give_hand_worked_values_and_none_without_records(monkeypatch):
    run = Run(cell="hand", seconds=1.0, window=(0.0, 1.0), range_names={"moe": "r"},
              device=DeviceSummary(busy_s=1.0, window_s=1.0, kernels=1, kernel_s_by_name={},
                                   kernel_count_by_name={}, range_device_s={"r": 2e-3}))
    records = profiling.KernelRecords()
    ring = profiling.SpanRecorder(16)
    monkeypatch.setattr(profiling, "RECORDS", records)
    monkeypatch.setattr(profiling, "RECORDER", ring)
    roof = catalog.load_module("metrics", "moe_roofline.chat")
    host = catalog.load_module("metrics", "moe_host_ms.chat")
    assert roof.read(run) is None and host.read(run) is None
    # two calls of 32 tokens: one hit 8 experts, one 2
    records.add("moe", (32, 2, 8, 4096, 14336, "dense", 2, torch.tensor([8] * 8)))
    records.add("moe", (32, 2, 8, 4096, 14336, "dense", 2,
                        torch.tensor([32, 32, 0, 0, 0, 0, 0, 0])))
    from loadbench.yardstick.moe_bound import moe_bound

    want = (moe_bound(32, 2, 8, 4096, 14336, 8, 2)[0]
            + moe_bound(32, 2, 8, 4096, 14336, 2, 2)[0]) / 2e-3 * 100
    assert roof.read(run) == pytest.approx(want)
    # two rounds in the window, with MoE calls of 3 + 1 + 4 ms
    spans = [_span("session.round", 0, 100, 200), _span("moe", 1, 110, 113),
             _span("moe", 2, 120, 121), _span("session.round", 3, 300, 400),
             _span("moe", 4, 310, 314), _span("moe", 5, 1100, 1200)]
    monkeypatch.setattr(ring, "spans", lambda: spans)
    assert host.read(run) == pytest.approx((3 + 1 + 4) / 2)
