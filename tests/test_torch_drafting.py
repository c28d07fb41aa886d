"""The port's other draft sources against the JAX package's, on the CPU in
fp32: prompt lookup, hybrid and confidence-adaptive drafting (also with a
quantized drafter), through ``generate``, ``stream_generate``, continuous
sessions, the strategy classes, a CLI app and the server.

``_pld_propose`` must equal the JAX package's bit for bit; greedy tokens,
``num_tokens``, ``matches`` and ``drafts`` must be EQUAL to the JAX
engine's, and greedy output equal to greedy AR. Sampled streams come from
other generators, so prompt-lookup sampling is held to the AR distribution
(tests/test_torch_generation.py's bound).
"""

import io
import json
import sys
import threading
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from layerskip_tpu.config import GenerationConfig as JGenerationConfig
from layerskip_tpu.generation.spec import _pld_propose as jax_pld_propose
from layerskip_tpu_torch.config import GenerationConfig
from layerskip_tpu_torch.generation import spec as tspec
from layerskip_tpu_torch.generation.engine import postprocess_batch, postprocess_output
from test_torch_generation import (
    PROMPT,
    V,
    _assert_same,
    _engines,
    _marginals,
    _numpy_tree,
)

EOS = (V + 7,)  # unreachable: every run makes all its steps


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ _pld_propose


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("w", [1, 4])
def test_pld_propose_equals_jax(n, w):
    """Seeded histories over a small alphabet (so most rows match, some do
    not), lengths from 1 to the whole buffer: proposals and match flags
    equal the JAX package's exactly."""
    rng = np.random.default_rng(10 * n + w)
    b, l = 64, 24
    hist = rng.integers(0, 5 if n < 3 else 3, size=(b, l))
    hist[::7] = np.arange(l) + 10  # no repeats: never a match
    lens = rng.integers(1, l + 1, size=b)
    lens[:3] = (1, 2, l)
    want, want_has = jax_pld_propose(jnp.asarray(hist, jnp.int32),
                                     jnp.asarray(lens, jnp.int32), w, n)
    got, has = tspec._pld_propose(torch.from_numpy(hist), torch.from_numpy(lens), w, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(has.numpy(), np.asarray(want_has))
    assert 0 < int(has.sum()) < b


def test_pld_propose_lookup_semantics():
    """The JAX package's unit cases (tests/test_engine_edges.py): the first
    match, the most recent of two, and the fallback without one."""
    def propose(row, length, w):
        out, has = tspec._pld_propose(torch.tensor([row]), torch.tensor([length]), w, 2)
        return out[0].tolist(), bool(has[0])

    assert propose([1, 2, 9, 8, 7, 1, 2, 0, 0, 0], 7, 3) == ([9, 8, 7], True)
    assert propose([1, 2, 9, 1, 2, 4, 4, 1, 2, 0, 0, 0], 9, 2) == ([4, 4], True)
    toks, has = propose([5, 6, 7, 8, 0, 0], 4, 2)
    assert len(toks) == 2 and not has


# ------------------------------------------------------------ generation


@pytest.fixture(scope="module")
def lookup_engines():
    """A narrow-weight model whose greedy stream falls into loops, so
    prompt-lookup drafts are accepted part of the time, and whose early
    exits agree with the full model often (hybrid mixes both sources)."""
    return _engines(_numpy_tree(2, tail_eps=0.03, std=0.05))


@pytest.fixture(scope="module")
def agreeable_engines():
    return _engines(_numpy_tree(1, tail_eps=0.03))


_SPEC = dict(generation_strategy="self_speculative", exit_layer=2, num_speculations=3)
_CASES = {
    "pld_n1": ("lookup", dict(generation_strategy="prompt_lookup", num_speculations=3,
                              pld_ngram=1)),
    "pld_n2_w4": ("lookup", dict(generation_strategy="prompt_lookup", num_speculations=4,
                                 pld_ngram=2)),
    "pld_n3_exit3": ("lookup", dict(generation_strategy="prompt_lookup", exit_layer=3,
                                    num_speculations=3, pld_ngram=3)),
    "pld_ngram_ban": ("lookup", dict(generation_strategy="prompt_lookup", num_speculations=3,
                                     pld_ngram=2, no_repeat_ngram_size=4)),
    "hybrid_n2": ("lookup", dict(generation_strategy="hybrid", exit_layer=2,
                                 num_speculations=3, pld_ngram=2)),
    "hybrid_n1_kv_quant": ("lookup", dict(generation_strategy="hybrid", exit_layer=2,
                                          num_speculations=3, pld_ngram=1, kv_quant=True)),
    "adaptive_0.3": ("agreeable", dict(_SPEC, draft_exit_prob=0.3)),
    "adaptive_0.7_w6": ("agreeable", dict(_SPEC, num_speculations=6, draft_exit_prob=0.7)),
    "adaptive_0.3_dq8": ("agreeable", dict(_SPEC, draft_exit_prob=0.3, draft_quant=8)),
    "adaptive_0.5_ngram": ("agreeable", dict(_SPEC, draft_exit_prob=0.5,
                                             no_repeat_ngram_size=3)),
}


def _both(engs, prompt, max_steps, eos_ids=EOS, **kw):
    je, te = engs
    jout = je.generate(prompt, JGenerationConfig(max_steps=max_steps, sample=False, **kw),
                       jax.random.PRNGKey(0), eos_ids=eos_ids)
    tout = te.generate(prompt, GenerationConfig(max_steps=max_steps, sample=False, **kw),
                       eos_ids=eos_ids)
    return jout, tout


def _ar(te, prompts, max_steps, **kw):
    kw = {k: v for k, v in kw.items() if k in ("kv_quant", "no_repeat_ngram_size",
                                               "max_seq_len")}
    return te.generate(prompts, GenerationConfig(max_steps=max_steps, sample=False,
                                                 generation_strategy="autoregressive", **kw),
                       eos_ids=EOS)


@pytest.mark.parametrize("case", list(_CASES))
def test_greedy_drafting_equals_jax_and_ar(lookup_engines, agreeable_engines, case,
                                           monkeypatch):
    """Each draft source's greedy stream and counters equal the JAX
    engine's, and the port's stream equals its greedy AR; hybrid runs both
    of its sources."""
    model, kw = _CASES[case]
    engs = lookup_engines if model == "lookup" else agreeable_engines
    picks = []
    real = tspec._pld_propose
    monkeypatch.setattr(tspec, "_pld_propose", lambda *a: picks.append(
        bool(real(*a)[1].all())) or real(*a))
    jout, tout = _both(engs, PROMPT, 40, **kw)
    _assert_same(jout, tout)
    assert postprocess_output(tout, (), 40) == postprocess_output(
        _ar(engs[1], PROMPT, 40, **kw), (), 40)
    assert 0 < int(tout.matches) < int(tout.drafts)
    if kw["generation_strategy"] == "hybrid":
        assert 0 < sum(picks) < len(picks), picks


@pytest.mark.parametrize("case", ["pld_n1", "hybrid_n2", "adaptive_0.3", "adaptive_0.3_dq8"])
def test_greedy_drafting_batch_and_edges_equal_jax(lookup_engines, agreeable_engines, case):
    """A ragged batch (rows finish and draft at different times), then a
    RoPE cap that leaves 7 steps past the bucket and a one-step run."""
    model, kw = _CASES[case]
    engs = lookup_engines if model == "lookup" else agreeable_engines
    prompts = [PROMPT[:21], PROMPT[:5], PROMPT, PROMPT[:12]]
    jout, tout = _both(engs, prompts, 24, **kw)
    _assert_same(jout, tout)
    assert postprocess_batch(tout, (), 24) == postprocess_batch(_ar(engs[1], prompts, 24),
                                                                (), 24)
    prompts = [PROMPT[:30], PROMPT[:7], PROMPT]
    jout, tout = _both(engs, prompts, 50, max_seq_len=71, **kw)
    _assert_same(jout, tout)
    assert int(tout.num_tokens.max()) == 7
    _assert_same(*_both(engs, PROMPT[:3], 1, **kw))


@pytest.mark.parametrize("case", ["pld_n1", "hybrid_n2", "adaptive_0.3"])
def test_drafting_stream_rounds_equal_jax(lookup_engines, agreeable_engines, case):
    """``stream_generate``'s per-round (drafted, accepted) lists equal the
    JAX package's and concatenate to ``generate``'s tokens."""
    model, kw = _CASES[case]
    je, te = lookup_engines if model == "lookup" else agreeable_engines
    kw = dict(kw, exit_layer=kw.get("exit_layer", 2), max_steps=32, sample=False)
    trounds, jrounds = [], []
    tout = te.stream_generate(PROMPT, GenerationConfig(**kw), None, EOS,
                              on_round=lambda d, a: trounds.append((d, a)))
    je.stream_generate(PROMPT, JGenerationConfig(**kw), jax.random.PRNGKey(0), EOS,
                       on_round=lambda d, a: jrounds.append((d, a)))
    assert trounds == jrounds and len(trounds) > 2
    n = int(tout.num_tokens[0])
    assert sum((a for _, a in trounds), [])[:n] == tout.tokens[0, :n].tolist()
    gout = te.generate(PROMPT, GenerationConfig(**kw), eos_ids=EOS)
    for k in ("num_tokens", "matches", "drafts"):
        assert torch.equal(getattr(tout, k), getattr(gout, k)), k


def test_contract_errors_are_value_errors(lookup_engines):
    """What the JAX engine asserts, the port refuses with ValueError, in
    generate, stream_generate and continuous sessions."""
    _, te = lookup_engines
    bad = (dict(_SPEC, spec_tree_width=2, draft_exit_prob=0.5),
           dict(generation_strategy="hybrid", exit_layer=2, num_speculations=3,
                draft_exit_prob=0.5),
           dict(generation_strategy="hybrid", exit_layer=2, num_speculations=3, pld_ngram=0),
           dict(generation_strategy="hybrid", num_speculations=3),
           dict(generation_strategy="prompt_lookup", num_speculations=0))
    for kw in bad:
        cfg = GenerationConfig(max_steps=4, sample=False, **kw)
        for call in (lambda: te.generate(PROMPT, cfg), lambda: te.stream_generate(PROMPT, cfg),
                     lambda: te.continuous_session(cfg, 2, 16)):
            with pytest.raises(ValueError):
                call()


def test_prompt_lookup_takes_a_default_exit_layer(lookup_engines):
    """Without ``exit_layer`` prompt lookup splits at L // 2, as the JAX
    engine does; the split does not change its output."""
    engs = lookup_engines
    kw = dict(generation_strategy="prompt_lookup", num_speculations=3, pld_ngram=1)
    jout, tout = _both(engs, PROMPT, 24, **kw)
    _assert_same(jout, tout)
    _assert_same(tout, engs[1].generate(PROMPT, GenerationConfig(
        max_steps=24, sample=False, exit_layer=1, **kw), eos_ids=EOS))


def test_prompt_lookup_sampling_matches_ar_distribution(lookup_engines):
    """Per-position marginals of sampled prompt lookup over 2048 rows against
    the port's AR: total-variation distance within 1.5x the AR-vs-AR null
    plus 0.05."""
    _, te = lookup_engines
    n_rows, positions = 2048, [0, 3, 5]
    common = dict(max_steps=6, sample=True, temperature=0.9, top_k=0, top_p=1.0)

    def port(seed):
        return lambda eng, prompts, cfg: eng.generate(
            prompts, cfg, torch.Generator().manual_seed(seed), eos_ids=EOS)

    ar1 = _marginals(te, GenerationConfig(**common), port(1), positions, n_rows)
    ar2 = _marginals(te, GenerationConfig(**common), port(2), positions, n_rows)
    pl = _marginals(te, GenerationConfig(generation_strategy="prompt_lookup",
                                         num_speculations=3, pld_ngram=1, **common),
                    port(4), positions, n_rows)
    tv = lambda p, q: 0.5 * float(np.abs(p - q).sum())  # noqa: E731
    for j in range(len(positions)):
        null = tv(ar1[j], ar2[j])
        assert tv(ar1[j], pl[j]) < 1.5 * null + 0.05, (positions[j], null)


# ------------------------------------------------------------ sessions


_PROMPTS = [PROMPT[:11], PROMPT[20:23], PROMPT[5:21], PROMPT[30:37]]
_BUDGETS = [16, 9, 12, 16]


def _drive(session):
    """Two requests to completion, then two more into the same slots; the
    results and each finished row's (matches, drafts)."""
    results, counters = {}, {}
    for wave in (0, 2):
        session.insert([0, 1], _PROMPTS[wave:wave + 2], seeds=[0, 0],
                       max_tokens=_BUDGETS[wave:wave + 2])
        while session.has_active():
            for r, toks, _ in session.step(max_rounds=3):
                results[wave + r] = toks
                counters[wave + r] = (int(session.state.matches[r]),
                                      int(session.state.drafts[r]))
    return results, counters


@pytest.mark.parametrize("case", ["pld_n1", "hybrid_n2", "adaptive_0.3", "adaptive_0.3_dq8"])
@pytest.mark.parametrize("paged", [False, True])
def test_session_equals_jax_and_solo(lookup_engines, agreeable_engines, case, paged):
    """Continuous sessions (contiguous, and paged with pages of 16) emit
    each request's solo stream, and the JAX session's streams and per-row
    counters."""
    model, kw = _CASES[case]
    je, te = lookup_engines if model == "lookup" else agreeable_engines
    kw = dict(kw, exit_layer=kw.get("exit_layer", 2), max_steps=16, sample=False)
    pg = dict(paged_pool_pages=12, page_size=16) if paged else {}
    got, counts = _drive(te.continuous_session(GenerationConfig(**kw), 2, 16, EOS, **pg))
    want, jcounts = _drive(je.continuous_session(JGenerationConfig(**kw), 2, 16, EOS, **pg))
    assert got == want and counts == jcounts
    for i, p in enumerate(_PROMPTS):
        solo = te.generate(p, GenerationConfig(**dict(kw, max_steps=_BUDGETS[i])),
                           eos_ids=EOS)
        assert got[i] == postprocess_output(solo, EOS, _BUDGETS[i]), i
    assert any(d > 0 for _, d in counts.values())


@pytest.mark.parametrize("case", ["adaptive_sampled", "pld_sampled"])
def test_sampled_session_stream_depends_only_on_the_request(agreeable_engines, case):
    """A sampled request of an adaptive (or prompt-lookup) session gives the
    same tokens alone and in another slot beside requests that stop
    drafting at other steps: rows that stopped draw nothing."""
    _, te = agreeable_engines
    extra = (dict(_SPEC, draft_exit_prob=0.5) if case == "adaptive_sampled" else
             dict(generation_strategy="prompt_lookup", exit_layer=2, num_speculations=3,
                  pld_ngram=1))
    gen = GenerationConfig(max_steps=12, sample=True, temperature=1.2, top_k=0, top_p=1.0,
                           **extra)

    def run(slot, seed, neighbours):
        s = te.continuous_session(gen, 3, 16, EOS, paged_pool_pages=12, page_size=16)
        if neighbours:
            s.insert([0, 1], _PROMPTS[1:3], seeds=[5, 6])
            s.step()
        s.insert([slot], [_PROMPTS[0]], seeds=[seed])
        for _ in range(40):
            for r, toks, _ in s.step():
                if r == slot:
                    return toks
        raise AssertionError("did not finish")

    alone = run(0, 7, False)
    assert run(2, 7, True) == alone and len(alone) == 12
    assert run(0, 8, False) != alone


# ------------------------------------------------------------ the user surface


def test_cli_generate_runs_prompt_lookup(monkeypatch, capsys):
    """``cli.generate --generation_strategy prompt_lookup`` on random:tiny:
    the flags parse into the config, and each prediction equals the
    generator's, with its acceptance printed."""
    from layerskip_tpu_torch.cli.args import Arguments, parse_dataclasses
    from layerskip_tpu_torch.cli.generate import GenerateArguments, main
    from layerskip_tpu_torch.cli.loading import load_from_args
    from layerskip_tpu_torch.generation.generator import LlamaGenerator

    args, gen_args, gen_cfg = parse_dataclasses(
        (Arguments, GenerateArguments, GenerationConfig),
        ["--model", "random:tiny", "--device", "cpu", "--generation_strategy",
         "prompt_lookup", "--num_speculations", "3", "--pld_ngram", "1", "--max_steps", "12",
         "--sample", "false", "--streamer", "none", "--warmup", "false"])
    assert (gen_cfg.generation_strategy, gen_cfg.pld_ngram) == ("prompt_lookup", 1)
    prompts = ["the cat sat on the mat", "and the cat sat"]
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(prompts) + "\n"))
    main(args, gen_args, gen_cfg)
    out, err = capsys.readouterr()
    params, cfg, tok = load_from_args(args)
    gen = LlamaGenerator(tok, params, cfg, device="cpu")
    want = [gen.generate(p, gen_cfg) for p in prompts]
    assert out.split("\n")[:2] == [w.decoded_prediction for w in want]
    assert err.count("acceptance:") == 2
    assert all(w.generation_strategy_result.acceptance_rate is not None for w in want)


def test_server_serves_prompt_lookup():
    """The serving command line with ``--generation_strategy prompt_lookup``
    (paged continuous batching): a POST equals the solo stream."""
    from layerskip_tpu_torch import serving
    from layerskip_tpu_torch.cli.loading import SimpleTokenizer

    args = serving.parse_args([
        "--model", "random:tiny", "--device", "cpu", "--continuous",
        "--paged-pool-pages", "8", "--page-size", "16", "--port", "0",
        "--batch-size", "2", "--prompt-bucket", "64", "--max_steps", "10",
        "--exit_layer", "2", "--num_speculations", "3", "--sample", "false",
        "--generation_strategy", "prompt_lookup"])
    sched, server = serving.build_from_args(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = "http://%s:%d" % server.server_address[:2]
    try:
        req = urllib.request.Request(f"{url}/generate",
                                     data=json.dumps({"prompt": "hello hello"}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            payload = json.load(r)
        assert sched.gen_cfg.generation_strategy == "prompt_lookup"
        ids = SimpleTokenizer(sched.engine.cfg.vocab_size).encode("hello hello")
        eos = sched.engine.cfg.eos_token_ids
        solo = postprocess_output(sched.engine.generate(ids, sched.gen_cfg), eos, 10)
        assert payload["tokens"] == solo
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        sched.stop()


@pytest.mark.parametrize("name", ["prompt_lookup", "hybrid"])
def test_strategy_classes_report_acceptance(lookup_engines, name):
    """``PromptLookupGenerationStrategy`` and ``HybridGenerationStrategy``
    run their engine strategy and report matches / drafts, as the JAX
    package's classes do."""
    from layerskip_tpu.generation import strategies as jstrategies
    from layerskip_tpu_torch.generation import strategies as tstrategies

    je, te = lookup_engines
    cls = {"prompt_lookup": "PromptLookupGenerationStrategy",
           "hybrid": "HybridGenerationStrategy"}[name]
    kw = dict(max_steps=24, sample=False, exit_layer=2, num_speculations=3, pld_ngram=1)
    t = getattr(tstrategies, cls)().generate_token_ids(te, PROMPT, EOS,
                                                       GenerationConfig(**kw))
    j = getattr(jstrategies, cls)().generate_token_ids(je, PROMPT, EOS,
                                                       JGenerationConfig(**kw),
                                                       jax.random.PRNGKey(0))
    assert t.predicted_tokens == j.predicted_tokens
    assert t.acceptance_rate == j.acceptance_rate and 0 < t.acceptance_rate < 1
    out = te.generate(PROMPT, GenerationConfig(generation_strategy=name, **kw), eos_ids=EOS)
    assert t.acceptance_rate == int(out.matches) / int(out.drafts)
