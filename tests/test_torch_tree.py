"""The port's tree speculation against the JAX package's, on the CPU in fp32:
the tree clause of attention (contiguous and paged, where K2/K3's plain
versions carry it), ``run_layers``' position and slot overrides, the
winning chain's compaction, greedy tree generation, streaming and paged
tree sessions.

Tolerances: the attention clause within tests/test_torch_ops.py's ATOL
(1e-5; 3e-5 and rtol 1e-4 with the Gemma score math, as
tests/test_torch_paged.py holds K2/K3's plain versions); ``run_layers``
within the suite's logits tolerance (atol 3e-4, rtol 1e-3). Compaction is
bit-exact, and greedy streams and counters must be equal.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from layerskip_tpu.config import GenerationConfig as JGenerationConfig
from layerskip_tpu.config import tiny_config as jax_tiny_config
from layerskip_tpu.generation import tree as jtree
from layerskip_tpu.models import llama as jllama
from layerskip_tpu.ops import attention as jattn
from layerskip_tpu.ops import kv_cache as jkv
from layerskip_tpu.ops import paged_kv as jpkv
from layerskip_tpu_torch.config import GenerationConfig, tiny_config
from layerskip_tpu_torch.generation import tree as ttree
from layerskip_tpu_torch.generation.engine import postprocess_batch, postprocess_output
from layerskip_tpu_torch.models import llama as tllama
from layerskip_tpu_torch.ops import attention as tattn
from layerskip_tpu_torch.ops import kv_cache as tkv
from layerskip_tpu_torch.ops import paged_kv as tpkv
from layerskip_tpu_torch.ops.cuda import paged_decode as tpd
from test_torch_generation import (
    PROMPT,
    SIZES,
    V,
    _assert_same,
    _engines,
    _marginals,
    _numpy_tree,
)

ATOL = 1e-5
EOS = (V + 7,)  # unreachable: every run makes all its steps


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------ the tree clause


def _tree_case(w, k, scalar_scratch=False, draft=False, b=2, s=48, hkv=2, g=2, dh=64,
               seed=0):
    """Random q/k/v and the tree arguments of a verify window (1 + W*k
    queries: the root, then depth-major chain nodes) or, with ``draft``, of
    the draft step at depth 2 (k queries), for rows at contexts 20 and 9
    (both at 20 with ``scalar_scratch``)."""
    rng = np.random.default_rng(seed)
    ctx = np.array([20, 20] if scalar_scratch else [20, 9])[:b]
    scratch = ctx + 1
    if draft:
        qpos = np.repeat((ctx + 2)[:, None], k, 1)
        chain = np.tile(np.arange(k), (b, 1))
    else:
        qpos = ctx[:, None] + np.array([0] + [1 + d for d in range(w) for _ in range(k)])
        chain = np.tile(np.array([-1] + [c for _ in range(w) for c in range(k)]), (b, 1))
    t = qpos.shape[1]
    q = rng.standard_normal((b, t, hkv * g, dh)).astype(np.float32)
    kc = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    vc = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    scr = np.int32(scratch[0]) if scalar_scratch else scratch.astype(np.int32)
    return q, kc, vc, qpos.astype(np.int32), chain.astype(np.int32), scr


_CLAUSE_CASES = {
    "verify_w3_k2": dict(w=3, k=2),
    "verify_w2_k3_scalar_scratch": dict(w=2, k=3, scalar_scratch=True),
    "draft_k3": dict(w=2, k=3, draft=True),
    "window": dict(w=3, k=2, window=4),
    "runtime_window": dict(w=3, k=2, window=4, runtime=True),
    "gemma": dict(w=3, k=2, window=6, runtime=True, gemma=True),
}


def _clause_kw(case):
    c = dict(_CLAUSE_CASES[case])
    window, runtime, gemma = c.pop("window", 0), c.pop("runtime", False), c.pop("gemma", False)
    kw = dict(score_scale=32.0 ** -0.5, logit_softcap=50.0) if gemma else {}
    return c, window, runtime, kw, (3e-5, 1e-4) if gemma else (ATOL, 0)


@pytest.mark.parametrize("case", list(_CLAUSE_CASES))
def test_tree_clause_contiguous_equals_jax(case):
    """The masked path's tree clause (with static and runtime windows and
    the Gemma score math) equals the JAX package's gqa_attention."""
    shape, window, runtime, kw, (atol, rtol) = _clause_kw(case)
    q, kc, vc, qpos, chain, scratch = _tree_case(**shape)
    k = shape["k"]
    want = jattn.gqa_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(qpos), q_heads_per_kv=2,
        sliding_window=jnp.int32(window) if runtime else window,
        tree_meta=(jnp.asarray(chain), jnp.asarray(scratch), k), **kw)
    got = tattn.gqa_attention(
        _t(q), _t(kc), _t(vc), _t(qpos), q_heads_per_kv=2,
        sliding_window=torch.tensor(window) if runtime else window,
        tree_meta=(_t(chain), _t(scratch), k), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=rtol)


def _paged_pair(kc, vc, quant, pg=16, seed=1):
    """The contiguous [B, S, Hkv, Dh] caches written through scrambled page
    tables into both packages' paged buffers (int8 with ``quant``)."""
    b, s, hkv, dh = kc.shape
    cap_pages, trash_pages, maxp = jpkv.paged_geometry(s, pg, prompt_bucket=16)
    pool_pages = b * cap_pages
    table = np.full((b, maxp), pool_pages, np.int32)
    perm = np.random.RandomState(seed).permutation(pool_pages)
    for r in range(b):
        table[r, :cap_pages] = perm[r * cap_pages:(r + 1) * cap_pages]
    shape = (pool_pages + trash_pages, hkv, pg, dh)
    pairs = []
    for x in (kc, vc):
        if quant:
            j = jpkv.PagedQuantKV(pool=jnp.zeros(shape, jnp.int8),
                                  scale=jnp.zeros(shape[:-1], jnp.bfloat16),
                                  table=jnp.asarray(table), capacity=s, trash_start=s)
            t = tpkv.PagedQuantKV(pool=torch.zeros(shape, dtype=torch.int8),
                                  scale=torch.zeros(shape[:-1], dtype=torch.bfloat16),
                                  table=_t(table), capacity=s, trash_start=s)
        else:
            j = jpkv.PagedKV(pool=jnp.zeros(shape, jnp.float32), table=jnp.asarray(table),
                             capacity=s, trash_start=s)
            t = tpkv.PagedKV(pool=torch.zeros(shape), table=_t(table), capacity=s,
                             trash_start=s)
        j = j.write(jnp.asarray(x), jnp.int32(0))
        t.write(_t(x), 0)
        pairs.append((j, t))
    return pairs


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("case", ["verify_w3_k2", "draft_k3", "gemma", "verify_w6_k3"])
def test_tree_clause_paged_equals_jax(case, quant, monkeypatch):
    """Over a paged cache a tree call of at most 16 queries runs K2's (K3's)
    plain version with the tree arguments, a wider one (W 6, k 3: 19
    queries) the gathered view; both equal the JAX package's paged
    gqa_attention (its gathered fallback on the CPU)."""
    if case == "verify_w6_k3":
        shape, window, runtime, kw, tol = dict(w=6, k=3), 0, False, {}, (ATOL, 0)
    else:
        shape, window, runtime, kw, tol = _clause_kw(case)
    q, kc, vc, qpos, chain, scratch = _tree_case(**shape)
    k = shape["k"]
    (jk, tk), (jv, tv) = _paged_pair(kc, vc, quant)
    calls = []
    name = "paged_decode_attention_q8_plain" if quant else "paged_decode_attention_plain"
    real = getattr(tpd, name)
    monkeypatch.setattr(tpd, name, lambda *a, **kwa: calls.append(kwa["tree_fanout"])
                        or real(*a, **kwa))
    want = jattn.gqa_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(qpos), q_heads_per_kv=2,
        sliding_window=jnp.int32(window) if runtime else window,
        tree_meta=(jnp.asarray(chain), jnp.asarray(scratch), k), **kw)
    got = tattn.gqa_attention(
        _t(q), tk, tv, _t(qpos), q_heads_per_kv=2,
        sliding_window=torch.tensor(window) if runtime else window,
        tree_meta=(_t(chain), _t(scratch), k), **kw)
    atol, rtol = tol
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=rtol)
    assert calls == ([] if q.shape[1] > 16 else [k])


# ------------------------------------------------------------ run_layers


L, D, F, HQ, HKV, DH = 4, 128, 128, 2, 1, 64


@pytest.mark.parametrize("cache", ["contiguous", "int8", "paged"])
def test_run_layers_overrides_equal_jax(cache):
    """A tree verify through layers [1, 4): positions, KV slots and the tree
    clause given explicitly. Hidden states and the written KV equal the
    JAX package's (contiguous, int8 and paged caches); the int8 values and
    scales agree except where a rounding edge flips a code."""
    tree = _numpy_tree(3)
    cfg, jcfg = tiny_config(**SIZES), jax_tiny_config(**SIZES)
    from layerskip_tpu.models.llama import LayerParams as JLayerParams
    from layerskip_tpu_torch.models.params import params_from_numpy

    jlayers = JLayerParams(**{k: jnp.asarray(v) for k, v in tree["layers"].items()})
    tlayers = params_from_numpy(tree, device="cpu").layers
    rng = np.random.default_rng(4)
    b, w, k, s, off = 2, 3, 2, 48, 1
    ctx = np.array([20, 9])
    h = rng.standard_normal((b, 1 + w * k, D)).astype(np.float32)
    past = rng.standard_normal((2, L - off, b, s, HKV, DH)).astype(np.float32)
    qpos = ctx[:, None] + np.array([0] + [1 + d for d in range(w) for _ in range(k)])
    chain = np.tile(np.array([-1] + [c for _ in range(w) for c in range(k)]), (b, 1))
    scratch = ctx + 1
    if cache == "paged":
        pj, pt = zip(*[_paged_pair(past[0, j], past[1, j], False)[0] for j in range(L - off)])
        jk = dataclasses.replace(pj[0], pool=jnp.stack([p.pool for p in pj]),
                                 table=jnp.stack([p.table for p in pj]))
        tk = dataclasses.replace(pt[0], pool=torch.stack([p.pool for p in pt]))
        pj, pt = zip(*[_paged_pair(past[0, j], past[1, j], False)[1] for j in range(L - off)])
        jv = dataclasses.replace(pj[0], pool=jnp.stack([p.pool for p in pj]),
                                 table=jnp.stack([p.table for p in pj]))
        tv = dataclasses.replace(pt[0], pool=torch.stack([p.pool for p in pt]))
    elif cache == "int8":
        shape = past.shape[1:]
        jk, jv = (jkv.QuantKV(q=jnp.zeros(shape, jnp.int8),
                              scale=jnp.zeros(shape[:-1], jnp.bfloat16)) for _ in range(2))
        tk, tv = tkv.QuantKV.zeros(shape, "cpu"), tkv.QuantKV.zeros(shape, "cpu")
    else:
        jk, jv, tk, tv = jnp.asarray(past[0]), jnp.asarray(past[1]), _t(past[0]), _t(past[1])
    want_h, want_k, want_v = jllama.run_layers(
        jcfg, jlayers, jnp.asarray(h), jk, jv, jnp.asarray(ctx, jnp.int32), layer_offset=off,
        q_positions=jnp.asarray(qpos, jnp.int32), write_pos=jnp.asarray(ctx, jnp.int32),
        tree_meta=(jnp.asarray(chain, jnp.int32), jnp.asarray(scratch, jnp.int32), k))
    got_h, got_k, got_v = tllama.run_layers(
        cfg, tlayers, _t(h), tk, tv, _t(ctx), layer_offset=off, q_positions=_t(qpos),
        write_pos=_t(ctx), tree_meta=(_t(chain), _t(scratch), k))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=3e-4, rtol=1e-3)
    for g, j in ((got_k, want_k), (got_v, want_v)):
        if cache == "paged":
            g, j = g.pool, j.pool
        elif cache == "int8":
            assert (g.q.numpy() != np.asarray(j.q)).mean() < 1e-3  # rounding edges
            g, j = g.dequantize(torch.float32), j.dequantize(jnp.float32)
        np.testing.assert_allclose(np.asarray(g), np.asarray(j), atol=3e-4, rtol=1e-3)


def test_overrides_never_take_the_flash_kernel(monkeypatch):
    """With ``q_positions`` a 20-query block at a shared int past takes the
    masked path, never K1 (K1 takes no tree)."""
    calls = []
    real = tattn.flash_prefill_attention
    monkeypatch.setattr(tattn, "flash_prefill_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    tree = _numpy_tree(3)
    from layerskip_tpu_torch.models.params import params_from_numpy

    layers = params_from_numpy(tree, device="cpu").layers
    cfg = tiny_config(**SIZES)
    kv = torch.zeros((L, 1, 64, HKV, DH))
    h = torch.randn(1, 20, D)
    tllama.run_layers(cfg, layers, h, kv, kv.clone(), 0, q_positions=torch.arange(20))
    assert calls == []
    tllama.run_layers(cfg, layers, h, kv, kv.clone(), 0)
    assert calls == [1] * L


# ------------------------------------------------------------ compaction


def _bf(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_tree_compact_equals_jax(kind):
    """``_tree_compact`` over bf16 KV and over an int8 cache's values and
    scales moves the same bytes as the JAX package's, overlapping runs and
    a start clamped at the buffer's end included."""
    rng = np.random.default_rng(5)
    lsub, b, s, h, dh, w, k = 3, 3, 40, 2, 8, 4, 3
    start = np.array([5, 11, 35], np.int32)  # row 2's runs clamp at the end
    c_star = np.array([0, 2, 1], np.int32)
    first = start + c_star
    vals = rng.standard_normal((lsub, b, s, h, dh)).astype(np.float32) * 3
    if kind == "bf16":
        jbuf = jnp.asarray(vals, jnp.bfloat16)
        want = [jtree._tree_compact(jbuf, jnp.asarray(start), jnp.asarray(first), k, w)]
        tbuf = torch.from_numpy(vals).bfloat16()
        got = [ttree._tree_compact(tbuf, _t(start), _t(first), k, w)]
        assert got[0] is tbuf  # in place
    else:
        q = rng.integers(-127, 128, size=vals.shape).astype(np.int8)
        sc = rng.random(vals.shape[:-1]).astype(np.float32)
        jq = jkv.QuantKV(q=jnp.asarray(q), scale=jnp.asarray(sc, jnp.bfloat16))
        jout = jax.tree.map(lambda a: jtree._tree_compact(
            a, jnp.asarray(start), jnp.asarray(first), k, w), jq)
        want = [jout.q, jout.scale]
        tq = tkv.QuantKV(q=_t(q), scale=_t(sc).bfloat16())
        ttree._compact(tq, _t(start), _t(c_star), k, w)
        got = [tq.q, tq.scale]
    for g, j in zip(got, want):
        np.testing.assert_array_equal(_bf(g), _bf(j))


@pytest.mark.parametrize("quant", [False, True])
def test_paged_tree_compact_equals_jax(quant):
    """``PagedKV``/``PagedQuantKV.tree_compact`` (stacked over layers) move
    the same bytes through the page tables as the JAX package's: the int8
    values and scales as they are."""
    rng = np.random.default_rng(6)
    lsub, b, s, pg, w, k = 2, 2, 48, 16, 3, 2
    start = np.array([21, 9], np.int32)
    c_star = np.array([1, 0], np.int32)
    idx = start[:, None] + np.arange(w) * k + c_star[:, None]
    pairs = [_paged_pair(rng.standard_normal((b, s, 2, 64)).astype(np.float32),
                         rng.standard_normal((b, s, 2, 64)).astype(np.float32), quant)[0]
             for _ in range(lsub)]
    j0, t0 = pairs[0]
    jstack = dataclasses.replace(j0, pool=jnp.stack([p[0].pool for p in pairs]),
                                 table=jnp.stack([p[0].table for p in pairs]))
    tstack = dataclasses.replace(t0, pool=torch.stack([p[1].pool for p in pairs]))
    if quant:
        jstack = dataclasses.replace(jstack, scale=jnp.stack([p[0].scale for p in pairs]))
        tstack = dataclasses.replace(tstack, scale=torch.stack([p[1].scale for p in pairs]))
    before = tstack.pool.clone()
    jout = jstack.tree_compact(jnp.asarray(start), jnp.asarray(idx))
    assert tstack.tree_compact(_t(start), _t(idx)) is tstack
    np.testing.assert_array_equal(_bf(tstack.pool), _bf(jout.pool))
    if quant:
        np.testing.assert_array_equal(_bf(tstack.scale), _bf(jout.scale))
    assert not torch.equal(tstack.pool, before)


# ------------------------------------------------------------ generation


@pytest.fixture(scope="module")
def engines():
    return _engines(_numpy_tree(0))


@pytest.fixture(scope="module")
def agreeable_engines():
    return _engines(_numpy_tree(1, tail_eps=0.03))


_SPEC = dict(generation_strategy="self_speculative", exit_layer=2, num_speculations=3)


def _both(engs, prompt, max_steps, eos_ids=EOS, **kw):
    je, te = engs
    jout = je.generate(prompt, JGenerationConfig(max_steps=max_steps, sample=False, **kw),
                       jax.random.PRNGKey(0), eos_ids=eos_ids)
    tout = te.generate(prompt, GenerationConfig(max_steps=max_steps, sample=False, **kw),
                       eos_ids=eos_ids)
    return jout, tout


def _ar(te, prompt, max_steps, **kw):
    cfg = GenerationConfig(max_steps=max_steps, sample=False,
                           generation_strategy="autoregressive", **kw)
    return te.generate(prompt, cfg, eos_ids=EOS)


_TREE_CASES = {
    "k2": dict(spec_tree_width=2),
    "k3_w4": dict(spec_tree_width=3, num_speculations=4),
    "k2_kv_quant": dict(spec_tree_width=2, kv_quant=True),
    "k3_ngram": dict(spec_tree_width=3, no_repeat_ngram_size=2),
}


@pytest.mark.parametrize("model", ["plain", "agreeable"])
@pytest.mark.parametrize("case", list(_TREE_CASES))
def test_greedy_tree_equals_jax_and_ar(engines, agreeable_engines, case, model):
    """Greedy tree speculation: tokens, num_tokens, matches and drafts equal
    the JAX engine's; the port's stream equals its greedy AR (with the same
    cache and n-gram ban)."""
    engs = engines if model == "plain" else agreeable_engines
    kw = {**_SPEC, **_TREE_CASES[case]}
    jout, tout = _both(engs, PROMPT, 30, **kw)
    _assert_same(jout, tout)
    ar_kw = {k: kw[k] for k in ("kv_quant", "no_repeat_ngram_size") if k in kw}
    assert postprocess_output(tout, (), 30) == postprocess_output(
        _ar(engs[1], PROMPT, 30, **ar_kw), (), 30)
    assert int(tout.drafts) > 0 and (model == "plain" or int(tout.matches) > 0)


@pytest.mark.parametrize("case", ["ragged", "max_steps_edge"])
def test_greedy_tree_batch_and_edges_equal_jax(agreeable_engines, case):
    """A ragged batch, and a cap that leaves 7 steps past the bucket (the
    accepted count clamped, frozen rows' updates clamped at their buffers'
    ends) and a one-step run."""
    kw = dict(_SPEC, spec_tree_width=2)
    if case == "ragged":
        prompts = [PROMPT[:21], PROMPT[:5], PROMPT, PROMPT[:12]]
        jout, tout = _both(agreeable_engines, prompts, 24, **kw)
        want = postprocess_batch(_ar(agreeable_engines[1], prompts, 24), (), 24)
    else:
        prompts = [PROMPT[:30], PROMPT[:7], PROMPT]
        jout, tout = _both(agreeable_engines, prompts, 50, max_seq_len=71, **kw)
        assert int(tout.num_tokens.max()) == 7
        want = postprocess_batch(_ar(agreeable_engines[1], prompts, 50, max_seq_len=71),
                                 (), 50)
        one_j, one_t = _both(agreeable_engines, PROMPT[:2], 1, **kw)
        _assert_same(one_j, one_t)
    _assert_same(jout, tout)
    assert postprocess_batch(tout, (), 50) == want


def test_tree_eos_inside_window_equals_jax(agreeable_engines):
    _, te = agreeable_engines
    ar = postprocess_output(_ar(te, PROMPT, 40), (), 40)
    eos = (ar[17],)
    jout, tout = _both(agreeable_engines, PROMPT, 40, eos_ids=eos,
                       **dict(_SPEC, spec_tree_width=3))
    _assert_same(jout, tout)
    assert postprocess_output(tout, eos, 40) == ar[:ar.index(eos[0])]


def test_tree_stream_rounds_equal_jax(agreeable_engines):
    """``stream_generate``'s per-round (drafted, accepted) lists of a tree
    run equal the JAX package's, and concatenate to ``generate``'s."""
    je, te = agreeable_engines
    kw = dict(_SPEC, spec_tree_width=2, max_steps=24, sample=False)
    trounds, jrounds = [], []
    tout = te.stream_generate(PROMPT, GenerationConfig(**kw), None, EOS,
                              on_round=lambda d, a: trounds.append((d, a)))
    je.stream_generate(PROMPT, JGenerationConfig(**kw), jax.random.PRNGKey(0), EOS,
                       on_round=lambda d, a: jrounds.append((d, a)))
    assert trounds == jrounds and len(trounds) > 2
    n = int(tout.num_tokens[0])
    assert sum((a for _, a in trounds), [])[:n] == tout.tokens[0, :n].tolist()


def test_tree_sampling_matches_ar_distribution(engines):
    """Per-position marginals of sampled tree speculation (k 2) over 2048
    rows against the port's AR: total-variation distance within 1.5x the
    AR-vs-AR null plus 0.05, as test_sampled_spec_matches_ar_distribution
    holds linear spec."""
    _, te = engines
    n_rows, positions = 2048, [0, 3, 5]
    common = dict(max_steps=6, sample=True, temperature=0.9, top_k=0, top_p=1.0)

    def port(seed):
        return lambda eng, prompts, cfg: eng.generate(
            prompts, cfg, torch.Generator().manual_seed(seed), eos_ids=EOS)

    ar1 = _marginals(te, GenerationConfig(**common), port(1), positions, n_rows)
    ar2 = _marginals(te, GenerationConfig(**common), port(2), positions, n_rows)
    tr = _marginals(te, GenerationConfig(spec_tree_width=2, **_SPEC, **common), port(4),
                    positions, n_rows)
    tv = lambda p, q: 0.5 * float(np.abs(p - q).sum())  # noqa: E731
    for j in range(len(positions)):
        null = tv(ar1[j], ar2[j])
        assert tv(ar1[j], tr[j]) < 1.5 * null + 0.05, (positions[j], null)


# ------------------------------------------------------------ paged sessions


_PROMPTS = [[int(x) for x in np.random.default_rng(i).integers(3, V, size=n)]
            for i, n in enumerate((11, 3, 16, 7))]
_BUDGETS = [16, 9, 12, 16]


def _gen(cls, **kw):
    return cls(**{**dict(max_steps=16, sample=False, spec_tree_width=2), **_SPEC, **kw})


def _drive(session, prompts=_PROMPTS, budgets=_BUDGETS):
    """Two requests to completion, then two more into the same slots; the
    results and each finished row's (matches, drafts)."""
    results, counters = {}, {}
    for wave in (0, 2):
        session.insert([0, 1], prompts[wave:wave + 2], seeds=[0, 0],
                       max_tokens=budgets[wave:wave + 2])
        while session.has_active():
            for r, toks, _ in session.step(max_rounds=3):
                results[wave + r] = toks
                counters[wave + r] = (int(session.state.matches[r]),
                                      int(session.state.drafts[r]))
    return results, counters


def _solo(te, prompt, budget, **kw):
    cfg = dataclasses.replace(_gen(GenerationConfig, **kw), max_steps=budget)
    return postprocess_output(te.generate(prompt, cfg, eos_ids=EOS), EOS, budget)


@pytest.mark.parametrize("case", ["bf16_pool", "int8_pool", "k3_wide_verify"])
def test_paged_tree_session_equals_jax_and_solo(engines, case, monkeypatch):
    """A paged tree session (pages of 16) emits each request's solo stream,
    with the JAX package's streams and per-row counters. Its drafts (k
    queries) and verifies (1 + W*k <= 16) run K2's (K3's) plain version
    with the tree clause; at W 6, k 3 the 19-query verify takes the
    gathered view."""
    je, te = engines
    kw = {"bf16_pool": {}, "int8_pool": dict(kv_quant=True),
          "k3_wide_verify": dict(spec_tree_width=3, num_speculations=6)}[case]
    fanouts = []
    name = "paged_decode_attention_q8_plain" if kw.get("kv_quant") else \
        "paged_decode_attention_plain"
    real = getattr(tpd, name)
    monkeypatch.setattr(tpd, name, lambda q, *a, **kwa: fanouts.append(
        (q.shape[1], kwa["tree_fanout"])) or real(q, *a, **kwa))
    paged = dict(paged_pool_pages=12, page_size=16)
    got, counts = _drive(te.continuous_session(_gen(GenerationConfig, **kw), 2, 16, EOS,
                                               **paged))
    want, jcounts = _drive(je.continuous_session(_gen(JGenerationConfig, **kw), 2, 16, EOS,
                                                 **paged))
    assert got == want and counts == jcounts
    assert all(got[i] == _solo(te, _PROMPTS[i], _BUDGETS[i], **kw) for i in range(4))
    g = _gen(GenerationConfig, **kw)
    k, w = g.spec_tree_width, g.num_speculations
    tree_calls = {t for t, f in fanouts if f == k}
    assert tree_calls == ({k} if 1 + w * k > 16 else {k, 1 + w * k})


def test_paged_tree_session_with_prefix_cache(engines):
    """Tree rounds over shared prefix pages: warm requests equal their solo
    streams and the JAX session's, and the shared pages never change."""
    je, te = engines
    system = [int(x) for x in np.random.default_rng(9).integers(3, V, size=16)]
    prompts = [system + tail for tail in ([3, 17], [5], [9, 11, 2], [40])]
    budgets = [12, 10, 12, 8]
    out = []
    for eng, cls in ((te, GenerationConfig), (je, JGenerationConfig)):
        s = eng.continuous_session(_gen(cls, max_steps=12), 2, 32, EOS,
                                   paged_pool_pages=24, page_size=16, prefix_cache=True)
        out.append(_drive(s, prompts, budgets))
        assert s.prefix_cache.hits >= 2
    assert out[0] == out[1]
    for i, p in enumerate(prompts):
        assert out[0][0][i] == _solo(te, p, budgets[i], max_steps=12), i


def test_paged_tree_session_at_the_budget_edge(agreeable_engines):
    """Requests whose prompts and budgets fill their pages to the edge: a
    tree round writes up to ctx + W*k, W*k - W slots past what a linear
    round's reservation (prompt + budget + W + 2) maps, and at W 3, k 4
    nodes whose verifier output commits a token (depth W) can lie there.
    The session maps W*k slots past each budget, so before every round
    each live row's last scratch slot maps to one of its own pages, never
    to the trash page that idle rows write; the streams equal the solo
    ones and the JAX session's."""
    je, te = agreeable_engines
    w, k, pg, budget = 3, 4, 16, 13
    prompts = [PROMPT[:14], PROMPT[20:34]]  # 14 + 13 + W + 2 = 32: two pages; + W*k: three
    kw = dict(num_speculations=w, spec_tree_width=k, max_steps=budget)
    got = []
    for eng, cls in ((te, GenerationConfig), (je, JGenerationConfig)):
        s = eng.continuous_session(_gen(cls, **kw), 3, 16, EOS, paged_pool_pages=9,
                                   page_size=pg)
        s.insert([0, 1], prompts, max_tokens=[budget] * 2)
        res = {}
        while s.has_active():
            if eng is te:
                assert [len(s.allocator.owned(r)) for r in (0, 1)] == [3, 3]
                table, ctx = s.state.early.k.table, s.state.ctx
                for r in np.flatnonzero(~s.state.done.numpy()):
                    assert int(table[r, (int(ctx[r]) + w * k) // pg]) < 9, (r, int(ctx[r]))
            res.update({r: (toks, int(s.state.matches[r]), int(s.state.drafts[r]))
                        for r, toks, _ in s.step()})
        got.append(res)
    assert got[0] == got[1]
    for r in (0, 1):
        assert got[0][r][0] == _solo(te, prompts[r], budget, **kw) and \
            len(got[0][r][0]) == budget


def test_chunked_insert_checks_the_tree_round_width(engines):
    """A parked row's tree round writes 1 + W*k slots: a trash zone (the
    prompt bucket) narrower than that refuses a chunked insert."""
    _, te = engines
    s = te.continuous_session(_gen(GenerationConfig, spec_tree_width=3, num_speculations=6),
                              2, 16, EOS)
    with pytest.raises(ValueError, match="trash zone"):
        s.begin_chunked_insert([0], [[1, 2, 3]])
    s = te.continuous_session(_gen(GenerationConfig), 2, 16, EOS)
    s.begin_chunked_insert([0], [_PROMPTS[0]], max_tokens=[_BUDGETS[0]], chunk_tokens=8)
    res = {}
    for _ in range(40):
        res.update({r: toks for r, toks, _ in s.step()})
        if 0 in res:
            break
    assert res[0] == _solo(te, _PROMPTS[0], _BUDGETS[0])
