"""The PyTorch port's generation engines against the JAX package's, on the
CPU in fp32.

Greedy token streams, ``num_tokens`` and the ``matches``/``drafts``
counters must be EQUAL to the JAX engine's. Sampled streams come from
different generators, so sampling is held to the AR distribution in the
style of tests/test_sampling_equivalence.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from layerskip_tpu.config import GenerationConfig as JGenerationConfig
from layerskip_tpu.config import tiny_config as jax_tiny_config
from layerskip_tpu.generation.engine import Engine as JEngine
from layerskip_tpu.models.llama import LayerParams as JLayerParams
from layerskip_tpu.models.llama import LlamaParams as JLlamaParams
from layerskip_tpu_torch.config import GenerationConfig, tiny_config
from layerskip_tpu_torch.generation.engine import (
    Engine,
    postprocess_batch,
    postprocess_output,
)
from layerskip_tpu_torch.models.params import params_from_numpy
from layerskip_tpu_torch.ops import attention as tattn

L, D, F, V, HQ, HKV, DH = 4, 128, 128, 256, 2, 1, 64
SIZES = dict(hidden_size=D, num_attention_heads=HQ, num_key_value_heads=HKV)
PROMPT = [int(x) for x in np.random.default_rng(0).integers(3, V, size=40)]


def _numpy_tree(seed, tail_eps=1.0, std=0.15):
    """Random dense-Llama weights (JAX field names), head_dim 64 so prompt
    prefills take the flash-prefill route. std 0.15 keeps the tiny model's
    streams varied; ``tail_eps`` < 1 shrinks the output projections
    of layers >= 2 so early exits agree more often with the full model."""
    rng = np.random.default_rng(seed)
    n = lambda *s: (rng.standard_normal(s) * std).astype(np.float32)  # noqa: E731
    tail = np.ones((L, 1, 1), np.float32)
    tail[2:] = tail_eps
    layers = dict(
        attn_norm=np.ones((L, D), np.float32), wq=n(L, HQ * DH, D),
        wk=n(L, HKV * DH, D), wv=n(L, HKV * DH, D), wo=n(L, HQ * DH, D) * tail,
        mlp_norm=np.ones((L, D), np.float32), w_gate=n(L, D, F), w_up=n(L, D, F),
        w_down=n(L, F, D) * tail,
    )
    return dict(embed=n(V, D) * 2, layers=layers,
                final_norm=np.ones(D, np.float32), lm_head=n(D, V))


def _engines(tree):
    jp = JLlamaParams(
        embed=jnp.asarray(tree["embed"]),
        layers=JLayerParams(**{k: jnp.asarray(v) for k, v in tree["layers"].items()}),
        final_norm=jnp.asarray(tree["final_norm"]), lm_head=jnp.asarray(tree["lm_head"]),
    )
    return (JEngine(jp, jax_tiny_config(**SIZES)),
            Engine(params_from_numpy(tree, device="cpu"), tiny_config(**SIZES), device="cpu"))


@pytest.fixture(scope="module")
def engines():
    return _engines(_numpy_tree(0))


@pytest.fixture(scope="module")
def agreeable_engines():
    """A model whose early exits agree with the full model most of the time
    (acceptance well above the plain random model's)."""
    return _engines(_numpy_tree(1, tail_eps=0.03))


def _gen_cfg(cls, name, max_steps, **kw):
    spec = {"ar": {}, "spec13": dict(exit_layer=1, num_speculations=3),
            "spec24": dict(exit_layer=2, num_speculations=4),
            "spec36": dict(exit_layer=3, num_speculations=6)}[name]
    strategy = "self_speculative" if spec else "autoregressive"
    return cls(max_steps=max_steps, sample=False, generation_strategy=strategy,
               **spec, **kw)


def _assert_same(jout, tout):
    np.testing.assert_array_equal(tout.num_tokens.numpy(), np.asarray(jout.num_tokens))
    n = np.asarray(jout.num_tokens)
    for r in range(n.shape[0]):
        np.testing.assert_array_equal(tout.tokens[r, :n[r]].numpy(),
                                      np.asarray(jout.tokens)[r, :n[r]])
    assert (int(tout.matches), int(tout.drafts)) == (int(jout.matches), int(jout.drafts))


def _both(engs, prompt, name, max_steps, eos_ids=(), **kw):
    je, te = engs
    jout = je.generate(prompt, _gen_cfg(JGenerationConfig, name, max_steps, **kw),
                       jax.random.PRNGKey(0), eos_ids=eos_ids)
    tout = te.generate(prompt, _gen_cfg(GenerationConfig, name, max_steps, **kw),
                       eos_ids=eos_ids)
    return jout, tout


@pytest.mark.parametrize("name", ["ar", "spec13", "spec24", "spec36"])
def test_greedy_generate_equals_jax(engines, name):
    jout, tout = _both(engines, PROMPT, name, 32)
    _assert_same(jout, tout)
    if name != "ar":
        assert 0 < int(tout.drafts)


def test_greedy_generate_with_ngram_ban_equals_jax(engines):
    jout, tout = _both(engines, PROMPT, "spec24", 24, no_repeat_ngram_size=2)
    _assert_same(jout, tout)


@pytest.mark.parametrize("name", ["ar", "spec36"])
def test_max_steps_clamp_equals_jax(engines, name):
    """The max_seq_len cap leaves 7 steps past the 64-token bucket, barely
    above W: the accepted count is clamped (w_eff), and in a ragged batch
    frozen rows' updates land at the end of their buffers, where the start
    index is clamped."""
    prompts = [PROMPT[:30], PROMPT[:7], PROMPT]
    jout, tout = _both(engines, prompts, name, 50, max_seq_len=71)
    _assert_same(jout, tout)
    assert int(tout.num_tokens.max()) == 7


@pytest.mark.parametrize("name", ["ar", "spec24", "spec36"])
def test_eos_inside_window_equals_jax(agreeable_engines, name):
    _, te = agreeable_engines
    ar = postprocess_output(te.generate(PROMPT, _gen_cfg(GenerationConfig, "ar", 40),
                                        eos_ids=(V + 7,)), (), 40)
    eos = ar[17]  # a token the stream reaches mid-generation
    jout, tout = _both(agreeable_engines, PROMPT, name, 40, eos_ids=(eos,))
    _assert_same(jout, tout)
    assert postprocess_output(tout, (eos,), 40) == ar[:ar.index(eos)]
    if name != "ar":
        assert int(tout.matches) > int(tout.drafts) // 2  # high acceptance


@pytest.mark.parametrize("name", ["ar", "spec24"])
def test_ragged_batch_equals_solo_runs(engines, name):
    _, te = engines
    prompts = [PROMPT[:33], PROMPT[:5], PROMPT[:70], PROMPT[:12]]
    batch = postprocess_batch(te.generate(prompts, _gen_cfg(GenerationConfig, name, 20)),
                              (), 20)
    for p, got in zip(prompts, batch):
        solo = postprocess_output(te.generate(p, _gen_cfg(GenerationConfig, name, 20)), (), 20)
        assert got == solo


def test_greedy_spec_equals_ar_in_the_port(agreeable_engines):
    """Committed windows may run past an EOS; the streams agree up to it."""
    _, te = agreeable_engines
    prompts = [PROMPT[:21], PROMPT]
    eos = tuple(te.cfg.eos_token_ids)
    for ngram in (0, 3):
        want = postprocess_batch(te.generate(prompts, _gen_cfg(
            GenerationConfig, "ar", 36, no_repeat_ngram_size=ngram)), eos, 36)
        for name in ("spec13", "spec24", "spec36"):
            out = te.generate(prompts, _gen_cfg(GenerationConfig, name, 36,
                                                no_repeat_ngram_size=ngram))
            assert postprocess_batch(out, eos, 36) == want, (ngram, name)


def test_prefill_dispatches_to_flash_once_per_layer(engines, monkeypatch):
    """AR and spec prefills (one shared past of 0, T = 64) take the
    flash-prefill route in every layer; drafts and verifies never do."""
    _, te = engines
    calls = []

    def counting(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    real = tattn.flash_prefill_attention
    monkeypatch.setattr(tattn, "flash_prefill_attention", counting)
    for name in ("ar", "spec24"):
        calls.clear()
        te.generate(PROMPT, _gen_cfg(GenerationConfig, name, 12))
        assert calls == [(1, 64, HQ, DH)] * L


def test_generate_refuses_what_the_contract_refuses(engines):
    """The contract errors of ``generate`` (tree or hybrid with adaptive
    drafting, hybrid without a lookup length) are ValueErrors; the int8 KV
    cache and a quantized drafter run (tests/test_torch_quant.py holds them
    to the JAX engine, tests/test_torch_drafting.py and
    tests/test_torch_tree.py every draft source)."""
    spec = dict(generation_strategy="self_speculative", exit_layer=2, num_speculations=3)
    _, te = engines
    for kw in (dict(spec, spec_tree_width=2, draft_exit_prob=0.5),
               dict(spec, generation_strategy="hybrid", draft_exit_prob=0.5),
               dict(spec, generation_strategy="hybrid", pld_ngram=0)):
        with pytest.raises(ValueError):
            te.generate(PROMPT, GenerationConfig(max_steps=4, sample=False, **kw))
    for kw in (dict(kv_quant=True), dict(spec, kv_quant=True, draft_quant=8)):
        out = te.generate(PROMPT, GenerationConfig(max_steps=4, sample=False, **kw))
        assert int(out.num_tokens[0]) == 4


def _marginals(engine, gen_cfg, generate, positions, n_rows):
    out = generate(engine, [PROMPT[:5]] * n_rows, gen_cfg)
    toks, counts = np.asarray(out.tokens), np.asarray(out.num_tokens)
    dists = []
    for j in positions:
        valid = counts > j
        assert valid.mean() > 0.9
        hist = np.bincount(toks[valid, j], minlength=V).astype(np.float64)
        dists.append(hist / hist.sum())
    return dists


def test_sampled_spec_matches_ar_distribution(engines):
    """Per-position marginals of sampled self-spec over 2048 rows, against
    the port's AR and the JAX package's AR: total-variation distance within
    1.5x the AR-vs-AR null plus 0.05 (the slow-tier test's bound)."""
    je, te = engines
    n_rows, positions, unreachable = 2048, [0, 3, 5], (V + 7,)
    common = dict(max_steps=6, sample=True, temperature=0.9, top_k=0, top_p=1.0)

    def port(seed):
        return lambda eng, prompts, cfg: eng.generate(
            prompts, cfg, torch.Generator().manual_seed(seed), eos_ids=unreachable)

    def ref(eng, prompts, cfg):
        return eng.generate(prompts, cfg, jax.random.PRNGKey(3), eos_ids=unreachable)

    ar1 = _marginals(te, GenerationConfig(**common), port(1), positions, n_rows)
    ar2 = _marginals(te, GenerationConfig(**common), port(2), positions, n_rows)
    jar = _marginals(je, JGenerationConfig(**common), ref, positions, n_rows)
    sp = _marginals(te, GenerationConfig(generation_strategy="self_speculative",
                                         exit_layer=2, num_speculations=4, **common),
                    port(4), positions, n_rows)
    tv = lambda p, q: 0.5 * float(np.abs(p - q).sum())  # noqa: E731
    for j in range(len(positions)):
        null = tv(ar1[j], ar2[j])
        assert tv(ar1[j], sp[j]) < 1.5 * null + 0.05, (positions[j], null)
        assert tv(jar[j], sp[j]) < 1.5 * null + 0.05, (positions[j], null)
