"""The port's offline eval (``cli/eval.py``) against the JAX package's, on
the CPU in fp32: the same JAX-made weights go through both scorers
(``params_from_numpy``; head_dim 64, so every prompt block takes the
flash-prefill route), and the CLI runs both packages on one JAX-written
checkpoint. Scores agree within atol 1e-4 / rtol 1e-5 with equal greedy
flags, log-probs within atol 3e-4 / rtol 1e-3, and everything built from
them (rolling loglikelihoods, MC accuracies, generated text) is equal; a
row's score does not depend on its batch, bit for bit.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from layerskip_tpu.cli import eval as jeval
from layerskip_tpu.cli.args import Arguments as JArguments
from layerskip_tpu.cli.loading import SimpleTokenizer as JSimpleTokenizer
from layerskip_tpu.cli.loading import load_model_and_tokenizer as jload
from layerskip_tpu.config import GenerationConfig as JGenerationConfig
from layerskip_tpu.config import tiny_config as jax_tiny_config
from layerskip_tpu.generation.generator import LlamaGenerator as JLlamaGenerator
from layerskip_tpu.models import params as jparams
from layerskip_tpu.models.llama import LayerParams as JLayerParams
from layerskip_tpu.models.llama import LlamaParams as JLlamaParams
from layerskip_tpu_torch.cli import eval as teval
from layerskip_tpu_torch.cli.args import Arguments
from layerskip_tpu_torch.cli.loading import SimpleTokenizer
from layerskip_tpu_torch.config import GenerationConfig, tiny_config
from layerskip_tpu_torch.generation.generator import LlamaGenerator
from layerskip_tpu_torch.models import params as tparams

L, D, F, V, HQ, HKV, DH = 4, 128, 128, 256, 2, 1, 64
SIZES = dict(hidden_size=D, num_attention_heads=HQ, num_key_value_heads=HKV,
             intermediate_size=F, vocab_size=V, num_hidden_layers=L)
ATOL, RTOL = 1e-4, 1e-5  # scores (sums of fp32 log-probs)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(seed=0):
    """Random dense-Llama JAX params; std 0.15 gives varied greedy choices."""
    rng = np.random.default_rng(seed)
    n = lambda *s: (rng.standard_normal(s) * 0.15).astype(np.float32)  # noqa: E731
    layers = dict(attn_norm=np.ones((L, D), np.float32), wq=n(L, HQ * DH, D),
                  wk=n(L, HKV * DH, D), wv=n(L, HKV * DH, D), wo=n(L, HQ * DH, D),
                  mlp_norm=np.ones((L, D), np.float32), w_gate=n(L, D, F), w_up=n(L, D, F),
                  w_down=n(L, F, D))
    return JLlamaParams(
        embed=jnp.asarray(n(V, D) * 2),
        layers=JLayerParams(**{k: jnp.asarray(v) for k, v in layers.items()}),
        final_norm=jnp.ones((D,), jnp.float32), lm_head=jnp.asarray(n(D, V)))


def _scorers(max_pos, max_batch=4):
    jp = _jax_params()
    jcfg = jax_tiny_config(max_position_embeddings=max_pos, **SIZES)
    tcfg = tiny_config(max_position_embeddings=max_pos, **SIZES)
    return (jeval.TokenScorer(jp, jcfg, max_batch=max_batch),
            teval.TokenScorer(tparams.params_from_numpy(jp, device="cpu"), tcfg,
                              max_batch=max_batch))


@pytest.fixture(scope="module")
def scorers():
    return _scorers(256)


def _rows(seed, shapes):
    rng = np.random.RandomState(seed)
    return [(rng.randint(1, V, size=n).tolist(), rng.randint(1, V, size=m).tolist())
            for n, m in shapes]


def _assert_scores(got, want):
    assert len(got) == len(want)
    for (gl, gg), (wl, wg) in zip(got, want):
        assert gl == pytest.approx(wl, abs=ATOL, rel=RTOL)
        assert gg == wg


def _greedy_rows(scorer, rows):
    """Each row with its continuation replaced by the model's greedy
    continuation (so the greedy flag is true for some rows)."""
    out = []
    for ctx, cont in rows:
        seq = list(ctx)
        for _ in range(len(cont)):
            seq.append(int(np.argmax(scorer.logprobs(seq)[-1])))
        out.append((ctx, seq[len(ctx):]))
    return out


def test_score_batch_matches_jax(scorers):
    """Mixed buckets (64 to 256), a padded batch, greedy-true rows."""
    js, ts = scorers
    rows = _rows(0, [(3, 2), (50, 4), (7, 1), (12, 3), (3, 2), (100, 5), (140, 3),
                     (70, 8), (230, 6)])
    rows += _greedy_rows(ts, rows[:4])
    got, want = ts.score_batch(rows), js.score_batch(rows)
    _assert_scores(got, want)
    assert any(g for _, g in got) and not all(g for _, g in got)


def test_truncation_and_batching_match_jax():
    """Left-truncation to max_position_embeddings (the joint length 40 past 32
    scores as if the first 7 context tokens were dropped), the refusal of a
    continuation longer than the model's range, and batched == one row at
    a time in original order (tests/test_apps.py's cases)."""
    js, ts = _scorers(32)
    rng = np.random.RandomState(0)
    ctx = rng.randint(1, 200, size=36).tolist()
    cont = rng.randint(1, 200, size=4).tolist()
    long_t, long_j = ts.loglikelihood_tokens(ctx, cont), js.loglikelihood_tokens(ctx, cont)
    _assert_scores([long_t], [long_j])
    assert long_t[0] == pytest.approx(ts.loglikelihood_tokens(ctx[-(33 - 4):], cont)[0],
                                      abs=ATOL)
    with pytest.raises(ValueError):
        ts.loglikelihood_tokens([1], list(range(1, 40)))
    with pytest.raises(ValueError):
        js.loglikelihood_tokens([1], list(range(1, 40)))
    rows = _rows(1, [(3, 2), (50, 4), (7, 1), (12, 3), (3, 2)])
    batched = ts.score_batch(rows)
    _assert_scores(batched, js.score_batch(rows))
    _assert_scores(batched, [ts.loglikelihood_tokens(c, k) for c, k in rows])


def test_batched_equals_alone_bit_exact(scorers):
    """A row's score is the same bits in a batch of 4 (the padded rows
    included) as alone."""
    _, ts = scorers
    rows = _rows(2, [(5, 2), (9, 3), (40, 1), (61, 2), (120, 4), (200, 3), (33, 7)])
    assert ts.score_batch(rows) == [ts.score_batch([r])[0] for r in rows]


def test_empty_rows_are_refused(scorers):
    _, ts = scorers
    for ctx, cont in (([], [1]), ([1], [])):
        with pytest.raises(ValueError, match="empty"):
            ts.loglikelihood_tokens(ctx, cont)


@pytest.mark.parametrize("n", [5, 64, 300])
def test_logprobs_match_jax(scorers, n):
    """[T, V] log-probs, also past max_position_embeddings (left-truncated)."""
    js, ts = scorers
    ids = np.random.RandomState(n).randint(1, V, size=n).tolist()
    got, want = ts.logprobs(ids), js.logprobs(ids)
    assert got.shape == want.shape == (min(n, 256), V)
    np.testing.assert_allclose(got, np.asarray(want), atol=3e-4, rtol=1e-3)


def test_rolling_token_windows_equal_jax():
    for length in (0, 1, 4, 5, 6, 8, 10, 11, 23, 64, 100):
        for max_len in (1, 2, 5, 7, 32):
            toks = list(range(100, 100 + length))
            assert teval.rolling_token_windows(toks, 99, max_len) == \
                jeval.rolling_token_windows(toks, 99, max_len), (length, max_len)


@pytest.fixture(scope="module")
def wraps(tmp_path_factory):
    """The JAX and the port's ``EvalHarnessLM`` over the same fp32 weights
    (max_position_embeddings 128, so rolling texts span several windows)."""
    jp = _jax_params(1)
    jcfg = jax_tiny_config(max_position_embeddings=128, **SIZES)
    tcfg = tiny_config(max_position_embeddings=128, **SIZES)
    jgen = JLlamaGenerator(JSimpleTokenizer(V), jp, jcfg, eos_ids=[0])
    tgen = LlamaGenerator(SimpleTokenizer(V), tparams.params_from_numpy(jp, device="cpu"),
                          tcfg, eos_ids=[0], device="cpu")
    return (jeval.EvalHarnessLM(jgen, JGenerationConfig(max_steps=12, sample=False),
                                batch_size=4),
            teval.EvalHarnessLM(tgen, GenerationConfig(max_steps=12, sample=False),
                                batch_size=4))


def test_loglikelihood_rolling_equals_jax(wraps):
    jw, tw = wraps
    texts = ["hi there", "a longer text " * 12, "x" * 300]
    got, want = tw.loglikelihood_rolling(texts), jw.loglikelihood_rolling(texts)
    assert got == pytest.approx(want, abs=ATOL, rel=RTOL)
    for text, ll in zip(texts, got):  # == its windows scored one by one
        windows = teval.rolling_token_windows(tw.tok_encode(text), tw.eot_token_id, 128)
        assert ll == pytest.approx(sum(tw.scorer.loglikelihood_tokens(c, k)[0]
                                       for c, k in windows), abs=ATOL)


def _mc_task(path, n=9, seed=0):
    rng = np.random.default_rng(seed)
    words = ["alpha", "beta", "gamma", "delta", "omega", "kappa"]
    rows = [{"query": f"q {i}: " + " ".join(rng.choice(words, size=3 + i)) + " is",
             "choices": [" " + w for w in rng.choice(words, size=3, replace=False)],
             "gold": i % 3} for i in range(n)]
    path.write_text("\n".join(json.dumps(r) for r in rows))
    return str(path)


@pytest.mark.parametrize("fewshot", [0, 2])
def test_run_local_mc_equals_jax(wraps, tmp_path, fewshot):
    jw, tw = wraps
    task = _mc_task(tmp_path / "mc.jsonl")
    got = teval.run_local_mc(tw, task, num_fewshot=fewshot)
    want = jeval.run_local_mc(jw, task, num_fewshot=fewshot)
    assert got == want
    assert got["num_docs"] == 9 - fewshot and got["num_requests"] == 3 * (9 - fewshot)
    assert teval.run_local_mc(tw, task, limit=4) == jeval.run_local_mc(jw, task, limit=4)
    with pytest.raises(ValueError, match="no docs"):
        teval.run_local_mc(tw, str(_empty(tmp_path)))


def _empty(tmp_path):
    p = tmp_path / "empty.jsonl"
    p.write_text("\n")
    return p


def test_loglikelihood_tokens_scatter_back_in_request_order(wraps):
    jw, tw = wraps
    reqs = [("k", c, k) for c, k in _rows(3, [(3, 2), (30, 1), (9, 4), (60, 2), (1, 1)])]
    got = tw._loglikelihood_tokens([teval._Instance(r) for r in reqs])
    _assert_scores(got, jw._loglikelihood_tokens(reqs))
    _assert_scores(got, [tw.scorer.loglikelihood_tokens(c, k) for _, c, k in reqs])


class _Req:
    def __init__(self, *args):
        self.args = args


def test_generate_until_equals_jax_greedy(wraps):
    jw, tw = wraps
    reqs = [_Req("hello", {"until": []}), _Req("the prompt", {"until": []})]
    full_t, full_j = tw.generate_until(reqs), jw.generate_until(reqs)
    assert full_t == full_j and all(full_t)
    stop = " ".join(full_t[0].split()[3:5])  # cut at a stop string inside the text
    reqs = [_Req("hello", {"until": ["", stop]})]
    assert tw.generate_until(reqs) == jw.generate_until(reqs) == [full_t[0].split(stop)[0]]
    assert tw.eot_token_id == jw.eot_token_id == 0


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("eval_ckpt"))
    jparams.save_params(_jax_params(2), d, jax_tiny_config(**SIZES))
    return d


def test_main_writes_eval_json_equal_to_jax(jax_ckpt, tmp_path, monkeypatch, capsys):
    """``main`` on a ``local:`` task writes ``eval_<time>.json`` holding its
    results, equal to the JAX CLI's on the same checkpoint (both loaded in
    fp32); a task that is not ``local:`` needs lm_eval, which is absent."""
    task = _mc_task(tmp_path / "mc.jsonl", n=6, seed=1)
    out = tmp_path / "out"
    res = teval.main(Arguments(model=jax_ckpt, model_args="dtype=float32", device="cpu",
                               output_dir=str(out)),
                     teval.EvalArguments(tasks=f"local:{task}", batch_size=4, num_fewshot=1),
                     GenerationConfig(max_steps=4, sample=False))
    (name,) = os.listdir(out)
    assert name.startswith("eval_") and name.endswith(".json")
    assert json.loads((out / name).read_text()) == res["results"]
    assert json.loads(capsys.readouterr().out) == res["results"]
    monkeypatch.setattr(jeval, "load_model_and_tokenizer",
                        lambda model, **kw: jload(model, **dict(kw, dtype=jnp.float32)))
    want = jeval.main(JArguments(model=jax_ckpt, output_dir=str(tmp_path / "jout")),
                      jeval.EvalArguments(tasks=f"local:{task}", batch_size=4, num_fewshot=1),
                      JGenerationConfig(max_steps=4, sample=False))
    assert res["results"] == want["results"]
    assert res["results"]["mc.jsonl"]["num_docs"] == 5
    with pytest.raises(SystemExit, match="lm_eval is not installed"):
        teval.main(Arguments(model="random:tiny", device="cpu", output_dir=str(out)),
                   teval.EvalArguments(tasks="hellaswag"), GenerationConfig(max_steps=2))


def test_eval_arguments_equal_jax():
    assert [dataclasses.astuple(teval.EvalArguments())] == \
        [dataclasses.astuple(jeval.EvalArguments())]
    assert [f.name for f in dataclasses.fields(teval.EvalArguments)] == \
        [f.name for f in dataclasses.fields(jeval.EvalArguments)]


def test_scorer_logits_never_reach_the_host(scorers, monkeypatch):
    """Only (ll, greedy) a row cross to the host: the forward's [B, T, V]
    logits are reduced where they live."""
    _, ts = scorers
    moved = []
    real = torch.Tensor.cpu

    def spy(self, *a, **kw):
        moved.append(tuple(self.shape))
        return real(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", spy)
    ts.score_batch(_rows(4, [(10, 2), (20, 3), (90, 1)]))
    assert moved and all(len(s) == 1 for s in moved), moved
