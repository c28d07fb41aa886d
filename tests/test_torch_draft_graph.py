"""The draft graph of a continuous session (generation/draft_graph.py) on
the CPU, where no CUDA graph can be captured: the rule that decides which
sessions draft from a graph, one case per condition; the graph's staging
(static buffers copied in, the lifted ``early_exit_draft`` called on them,
its outputs read out) through inserts, harvests and a park, equal to the
eager session token for token and counter for counter; the K2 records a
replay adds against the eager draft's; and the graph's refusals.
"""

import dataclasses
import types

import pytest
import torch

from layerskip_tpu_torch.config import GenerationConfig, tiny_config
from layerskip_tpu_torch.generation.draft_graph import DraftGraph, eager_reason
from layerskip_tpu_torch.generation.engine import Engine
from layerskip_tpu_torch.models.params import init_params
from layerskip_tpu_torch.quant import quantize_llama_params
from layerskip_tpu_torch.utils import profiling

EOS = [135]  # unreachable (vocab 128): every request runs to its budget
GEN = GenerationConfig(max_steps=12, sample=False, generation_strategy="self_speculative",
                       exit_layer=2, num_speculations=3)
PROMPTS = [[3, 17, 52, 9, 40], [5, 9], [100, 2, 44, 8, 71, 12, 90], [7, 7, 31]]
BUDGETS = [5, 12, 9, 11]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine(**cfg_kw):
    # head_dim 64: paged drafts and verifies take K2's (plain) path
    cfg = tiny_config(hidden_size=128, num_attention_heads=2, num_key_value_heads=1,
                      vocab_size=128, **cfg_kw)
    params = init_params(cfg, seed=7, device="cpu")
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        getattr(params.layers, name).mul_(7.5)
    params.embed.mul_(15.0)
    params.lm_head.mul_(7.5)
    return Engine(params, cfg, device="cpu")


@pytest.fixture(scope="module")
def engine():
    return _engine()


PAGED = dict(paged_pool_pages=12, page_size=16)

# one case per condition of the rule: (the engine: None for the shared one,
# "quantized" for its int8 copy, else a config change; the session's
# settings; the reason given)
RULE = {
    "sharded": (None, {}, "a sharded engine"),
    "sampled": (None, dict(sample=True), "sampled drafts"),
    "ngram_ban": (None, dict(no_repeat_ngram_size=2), "an n-gram ban"),
    "adaptive": (None, dict(draft_exit_prob=0.3), "adaptive drafting"),
    "prompt_lookup": (None, dict(generation_strategy="prompt_lookup", pld_ngram=2),
                      "prompt-lookup or hybrid drafting"),
    "hybrid": (None, dict(generation_strategy="hybrid", pld_ngram=2),
               "prompt-lookup or hybrid drafting"),
    "tree": (None, dict(spec_tree_width=2), "tree drafting"),
    "quantized_drafter": (None, dict(draft_quant=8), "a quantized drafter"),
    "quantized_base": ("quantized", {}, "a quantized base"),
    "moe": (dict(num_local_experts=4, num_experts_per_tok=2), {}, "MoE layers"),
    "embedding_scale": (dict(scale_embeddings=True), {}, "an embedding scale"),
    "cpu": (None, {}, "no CUDA device"),
}


@pytest.mark.parametrize("case", sorted(RULE))
def test_the_rule_names_why_a_session_drafts_eagerly(case, engine):
    """Each condition alone keeps the draft eager (and, on the CPU, the
    device does); such a session's draft spans all carry ``graph=0``."""
    change, gen_kw, why = RULE[case]
    eng = engine
    if change == "quantized":
        eng = Engine(quantize_llama_params(engine.params), engine.cfg, device="cpu")
    elif change is not None:
        eng = _engine(**change)
    session = eng.continuous_session(dataclasses.replace(GEN, **gen_kw), 2, 16, EOS,
                                     **PAGED)
    assert session.draft_graph is None
    if case == "sharded":
        eng.shard, shard = types.SimpleNamespace(dp=None, sp=None), eng.shard
        try:
            assert eager_reason(session) == why
        finally:
            eng.shard = shard
    else:
        assert eager_reason(session) == why
    first = profiling.RECORDER._next
    session.insert([0], [PROMPTS[0]], max_tokens=[BUDGETS[0]])
    session.step(2)
    drafts = [s for s in profiling.RECORDER.spans()
              if s.seq >= first and s.name == "spec.draft"]
    assert all(s.attrs["graph"] == 0 for s in drafts)


def _staged(session):
    """``session`` drafting through the graph's staging, built as the
    session builds its graph (over the blank state, in inference mode)."""
    with session.engine.inference():
        session.draft_graph = DraftGraph(session, capture=False)
    return session


def _drive(session):
    """Two requests, a third into the slot the first leaves (after a park
    where the KV is paged), a fourth once a slot frees again: each
    request's tokens and (matches, drafts), the rounds run and the final
    history buffer."""
    results, counters, rounds = {}, {}, 0
    queue = list(range(len(PROMPTS)))

    def admit(slots):
        for slot in slots:
            if queue:
                i = queue.pop(0)
                session.request_ids[slot] = i
                session.insert([slot], [PROMPTS[i]], max_tokens=[BUDGETS[i]])

    admit([0, 1])
    while session.has_active():
        first = profiling.RECORDER._next
        done = session.step(max_rounds=2)
        rounds += sum(s.attrs["rounds"] for s in profiling.RECORDER.spans()
                      if s.seq >= first and s.name == "session.step")
        for slot, toks, _ in done:
            i = int(session.request_ids[slot])
            results[i] = toks
            counters[i] = (int(session.state.matches[slot]), int(session.state.drafts[slot]))
        if done:
            session.park_free_slots()
            admit([slot for slot, _, _ in done])
    return results, counters, rounds, session.state.hist.clone()


@pytest.mark.parametrize("kv", ["paged", "paged_int8", "contiguous"])
def test_staged_graph_session_equals_the_eager_session(kv, engine):
    """A session whose draft goes through the graph's staging equals the
    eager session: every request's tokens, matches and drafts; the staging
    ran once a round, and its spans carry ``graph=1``."""
    gen = dataclasses.replace(GEN, kv_quant=kv == "paged_int8")
    paged = PAGED if kv != "contiguous" else {}

    def session():
        return engine.continuous_session(gen, 2, 16, EOS, **paged)

    want, want_counts, _, want_hist = _drive(session())
    staged = _staged(session())
    first = profiling.RECORDER._next
    got, got_counts, rounds, hist = _drive(staged)
    assert got == want and got_counts == want_counts and torch.equal(hist, want_hist)
    assert sorted(got) == list(range(len(PROMPTS)))
    assert [len(got[i]) for i in range(len(PROMPTS))] == BUDGETS
    assert staged.draft_graph.replays == rounds > 0
    drafts = [s for s in profiling.RECORDER.spans()
              if s.seq >= first and s.name == "spec.draft"]
    assert len(drafts) == rounds and all(s.attrs["graph"] == 1 for s in drafts)


def test_a_replay_adds_the_draft_passes_k2_records(engine):
    """The records a replay adds (the graph's calls, captured once, with
    this replay's positions) equal those the eager draft passes make."""
    session = _staged(engine.continuous_session(GEN, 2, 16, EOS, **PAGED))
    graph = session.draft_graph
    w, e = GEN.num_speculations, GEN.exit_layer
    assert len(graph._template) == w * e and graph._launches == (0, 0)
    session.insert([0, 1], PROMPTS[:2], max_tokens=BUDGETS[:2])
    session.step(1)  # positions past the prompts
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.RECORDS.clear()
        session.step(1)
        n = len(profiling.RECORDS.k2)
        graph._record_replay()
    k2 = profiling.RECORDS.k2
    eager, replayed = k2[:w * e], k2[n:]
    profiling.RECORDS.clear()
    assert len(replayed) == w * e and n == (w + 1) * e + engine.cfg.num_hidden_layers - e
    for a, b in zip(eager, replayed):
        assert a[0] == b[0] == (2, 1, 2, 64) and a[2:] == b[2:]
        assert torch.equal(a[1].long(), b[1].long())
    # pass i of each row at its context length + i
    assert [int(r[1][0, 0]) - int(eager[0][1][0, 0]) for r in replayed[::e]] == list(range(w))


@pytest.mark.parametrize("setting", ["sample", "draft_params", "pld", "hybrid", "adaptive",
                                     "ngram"])
def test_the_round_refuses_a_graph_outside_greedy_early_exit(setting, engine):
    """``DraftGraph``, the one place a round's graph is built, refuses a
    session whose plan is not greedy early exit from the base weights."""
    case = {"sample": "sampled", "draft_params": "quantized_drafter", "pld": "prompt_lookup",
            "hybrid": "hybrid", "adaptive": "adaptive", "ngram": "ngram_ban"}[setting]
    _, gen_kw, why = RULE[case]
    session = engine.continuous_session(dataclasses.replace(GEN, **gen_kw), 2, 16, EOS,
                                        **PAGED)
    with pytest.raises(ValueError, match=f"draft graph .* not {why}"):
        _staged(session)
