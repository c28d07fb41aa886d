"""The verify graph of a continuous session (generation/draft_graph.py
``VerifyGraph``) on the CPU, where no CUDA graph can be captured: the
graph's staging (the round's state copied into static buffers, the lifted
``spec.early_exit_verify`` called on them and on the draft graph's
outputs) through inserts, harvests and a park, equal to the eager session
token for token and counter for counter; the K2 records a replay adds
against the eager verify's; the sessions the rule keeps eager, one case per
reason; the replay's refusals; and greedy acceptance, which draws nothing.
"""

import dataclasses
import types

import pytest
import torch
import torch.nn.functional as F

from layerskip_tpu_torch.generation import spec
from layerskip_tpu_torch.generation.core import RoundPlan, _SpecState
from layerskip_tpu_torch.generation.draft_graph import (
    DraftGraph,
    VerifyGraph,
    eager_reason,
    plan_reason,
)
from layerskip_tpu_torch.generation.engine import Engine
from layerskip_tpu_torch.generation.sampling import SamplingConfig
from layerskip_tpu_torch.models import llama
from layerskip_tpu_torch.quant import quantize_llama_params
from layerskip_tpu_torch.utils import profiling
from test_torch_draft_graph import (  # noqa: F401 (an autouse fixture)
    BUDGETS,
    EOS,
    GEN,
    PAGED,
    PROMPTS,
    RULE,
    _drive,
    _engine,
    _one_torch_thread,
)


@pytest.fixture(scope="module")
def engine():
    return _engine()


def _staged(session):
    """``session`` drafting and verifying through the graphs' staging,
    built as the session builds its graphs (over the blank state, in
    inference mode)."""
    with session.engine.inference():
        session.draft_graph = DraftGraph(session, capture=False)
        session.verify_graph = VerifyGraph(session, session.draft_graph, capture=False)
    return session


def _spans(first, name):
    return [s for s in profiling.RECORDER.spans() if s.seq >= first and s.name == name]


@pytest.mark.parametrize("kv", ["paged", "paged_int8", "contiguous"])
def test_staged_verify_session_equals_the_eager_session(kv, engine):
    """A session whose draft and verify go through the graphs' staging
    equals the eager session: every request's tokens, matches and drafts
    and the final history buffer; each graph ran once a round, and every
    verify span carries ``graph=1``."""
    gen = dataclasses.replace(GEN, kv_quant=kv == "paged_int8")
    paged = PAGED if kv != "contiguous" else {}

    def session():
        return engine.continuous_session(gen, 2, 16, EOS, **paged)

    want, want_counts, _, want_hist = _drive(session())
    staged = _staged(session())
    first = profiling.RECORDER._next
    got, got_counts, rounds, hist = _drive(staged)
    assert got == want and got_counts == want_counts and torch.equal(hist, want_hist)
    assert [len(got[i]) for i in range(len(PROMPTS))] == BUDGETS
    assert staged.verify_graph.replays == staged.draft_graph.replays == rounds > 0
    verifies = _spans(first, "spec.verify")
    assert len(verifies) == rounds and all(s.attrs["graph"] == 1 for s in verifies)


def test_a_replay_adds_the_verify_passes_k2_records(engine):
    """The records a replay adds (the graph's calls, kept once, with this
    replay's positions) equal those the eager verify makes: the last
    draft's E early layers at ctx + W (T 1), the L - E full layers at ctx
    (T W + 1)."""
    session = _staged(engine.continuous_session(GEN, 2, 16, EOS, **PAGED))
    graph = session.verify_graph
    w, e, nl = GEN.num_speculations, GEN.exit_layer, engine.cfg.num_hidden_layers
    assert len(graph._template) == nl and graph._launches == (0, 0)
    session.insert([0, 1], PROMPTS[:2], max_tokens=BUDGETS[:2])
    session.step(1)  # positions past the prompts
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.RECORDS.clear()
        session.step(1)
        n = len(profiling.RECORDS.k2)
        graph._record_replay()
    k2 = profiling.RECORDS.k2
    eager, replayed = k2[w * e:n], k2[n:]
    profiling.RECORDS.clear()
    assert n == (w + 1) * e + nl - e and len(replayed) == len(eager) == nl
    for a, b in zip(eager, replayed):
        assert a[0] == b[0] and a[2:] == b[2:]
        assert torch.equal(a[1].long(), b[1].long())
    assert [r[0] for r in replayed] == [(2, 1, 2, 64)] * e + [(2, w + 1, 2, 64)] * (nl - e)
    ctx = graph.ctx[:, None]
    assert torch.equal(replayed[0][1], ctx + w)
    assert torch.equal(replayed[e][1], ctx + torch.arange(w + 1))


@pytest.mark.parametrize("case", sorted(RULE))
def test_a_session_the_rule_keeps_eager_builds_no_verify_graph(case, engine):
    """Each condition alone keeps the verify eager (``verify_graph`` None,
    verify spans ``graph=0``), and ``VerifyGraph`` refuses every plan the
    rule's plan half keeps eager."""
    change, gen_kw, why = RULE[case]
    eng = engine
    if change == "quantized":
        eng = Engine(quantize_llama_params(engine.params), engine.cfg, device="cpu")
    elif change is not None:
        eng = _engine(**change)
    session = eng.continuous_session(dataclasses.replace(GEN, **gen_kw), 2, 16, EOS,
                                     **PAGED)
    assert session.verify_graph is None
    if case == "sharded":
        eng.shard, shard = types.SimpleNamespace(dp=None, sp=None), eng.shard
        try:
            assert eager_reason(session) == why
        finally:
            eng.shard = shard
    else:
        assert eager_reason(session) == why
    if plan_reason(session.plan) is not None:
        with pytest.raises(ValueError, match=f"verify graph .* not {why}"):
            VerifyGraph(session, None, capture=False)
    first = profiling.RECORDER._next
    session.insert([0], [PROMPTS[0]], max_tokens=[BUDGETS[0]])
    session.step(2)
    assert all(s.attrs["graph"] == 0 for s in _spans(first, "spec.verify"))


def test_a_replay_refuses_kv_it_does_not_hold(engine):
    """A state whose early or full KV is not the captured one is refused
    before anything is copied in."""
    session = _staged(engine.continuous_session(GEN, 2, 16, EOS, **PAGED))
    other = engine.continuous_session(GEN, 2, 16, EOS, **PAGED).state
    s = session.state
    for bad in (dataclasses.replace(s, full=other.full),
                dataclasses.replace(s, early=other.early)):
        with pytest.raises(RuntimeError, match="KV is not the one the verify graph holds"):
            session.verify_graph.replay(bad, None)
    assert session.verify_graph.replays == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_acceptance_draws_nothing_and_equals_drawn_acceptance(seed, monkeypatch):
    """On one-hot distributions, the greedy round's acceptance with u = 0
    equals rejection sampling with drawn u (the same round with sampling
    on, its distributions kept one-hot): the same window, counts and
    state; the greedy round leaves every row's generator untouched."""
    b, w, v = 4, 3, 16
    gen = torch.Generator().manual_seed(seed)
    drafts = torch.randint(0, v, (b, w), generator=gen)
    logits = torch.randn((b, w + 1, v), generator=gen)
    # row r's verifier agrees with its first r drafts and no further
    for r in range(b):
        for j in range(w):
            logits[r, j, drafts[r, j]] = 10.0 if j < r else -10.0
    p_draft = F.one_hot(drafts, v).float()

    def one_hot(x, scfg):
        return F.one_hot(torch.argmax(x.float(), dim=-1), x.shape[-1]).float()

    monkeypatch.setattr(spec, "token_distribution", one_hot)

    def round_with(sample):
        gens = [torch.Generator().manual_seed(100 + r) for r in range(b)]
        zeros = torch.zeros((b,), dtype=torch.long)
        s = _SpecState(early=None, full=None, ctx=torch.full((b,), 5), prompt_len=zeros + 4,
                       next_tok=zeros[:, None], out=torch.zeros((b, 12), dtype=torch.long),
                       hist=torch.zeros((b, 16), dtype=torch.long), out_len=zeros + 1,
                       steps=torch.tensor([12, 12, 12, 3]), done=torch.tensor([0, 0, 1, 0]) > 0,
                       matches=zeros, drafts=zeros, generator=gens)
        plan = RoundPlan(source="early_exit", exit_layer=1, num_speculations=w,
                         scfg=SamplingConfig(sample=sample), eos_ids=(v + 1,))
        vres = llama.RemainderResult(logits=logits, early_cache=None, full_cache=None)
        before = [g.get_state() for g in gens]
        out = spec.accept_and_commit(None, s, plan, s.prompt_len + s.out_len, drafts, p_draft,
                                     s.hist, torch.full((b,), w), vres)
        moved = [not torch.equal(a, g.get_state()) for a, g in zip(before, gens)]
        return out, moved

    (greedy, window, n), moved = round_with(False)
    (drawn, window_d, n_d), moved_d = round_with(True)
    assert not any(moved) and all(moved_d)
    assert torch.equal(window, window_d) and torch.equal(n, n_d)
    for f in ("ctx", "next_tok", "out", "hist", "out_len", "done", "matches", "drafts"):
        assert torch.equal(getattr(greedy, f), getattr(drawn, f)), f
    # rows 0-2 accept their agreed prefix; row 3 stops at its budget
    assert n.tolist() == [0, 1, 2, 1]
