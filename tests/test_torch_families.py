"""The PyTorch port's model families against the JAX package and the HF
classes, on the CPU in fp32: Qwen2, Qwen3, Mistral, Gemma, Gemma-2, Gemma-3,
Phi-3, Mixtral and Qwen3-MoE.

Each family is a tiny model (4 layers, 6 for Gemma-3; D 128, Hq 2, Hkv 1,
head_dim 64, so prompt prefills take K1's plain version and paged decode
K2/K3's) with the same numpy weights in both packages. Logits agree at atol
3e-4 / rtol 1e-3, the tolerance the JAX package holds itself to against HF
torch (tests/test_model_parity.py); greedy token streams and the
``matches``/``drafts`` counters must be EQUAL to the JAX engine's. Prompts
are longer than the 8-token window of the windowed families, so the window
really masks. Paged sessions and tree speculation of the windowed families
are in tests/test_torch_families_paged.py.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from layerskip_tpu.config import GenerationConfig as JGenerationConfig
from layerskip_tpu.config import tiny_config as jax_tiny_config
from layerskip_tpu.generation.engine import Engine as JEngine
from layerskip_tpu.models import llama as jllama
from layerskip_tpu.models.llama import LayerParams as JLayerParams
from layerskip_tpu.models.llama import LlamaParams as JLlamaParams
from layerskip_tpu.models.params import init_params as jax_init_params
from layerskip_tpu.ops.kv_cache import init_kv_cache as jax_init_kv_cache
from layerskip_tpu_torch.config import GenerationConfig, ModelConfig, tiny_config
from layerskip_tpu_torch.generation.engine import Engine, postprocess_output
from layerskip_tpu_torch.models import llama as tllama
from layerskip_tpu_torch.models import params as tparams
from layerskip_tpu_torch.ops.kv_cache import init_kv_cache

LOGIT_TOL = dict(atol=3e-4, rtol=1e-3)
SIZES = dict(hidden_size=128, num_attention_heads=2, num_key_value_heads=1,
             intermediate_size=128)
V = 256
_GEMMA = dict(hidden_act="gelu_pytorch_tanh", rms_norm_offset=True, scale_embeddings=True,
              tie_word_embeddings=True)
_GEMMA3_LAYERS = ("sliding_attention",) * 5 + ("full_attention",)
FAMILIES = {
    "qwen2": dict(attention_bias=True),
    "qwen3": dict(qk_norm=True, tie_word_embeddings=True),
    "mistral": dict(sliding_window=8),
    "gemma": dict(_GEMMA),
    "gemma2": dict(_GEMMA, attn_logit_softcap=50.0, final_logit_softcap=30.0,
                   query_pre_attn_scalar=32.0, sliding_window=8, sliding_window_pattern=2,
                   post_norms=True),
    "gemma3": dict(_GEMMA, num_hidden_layers=6, qk_norm=True, post_norms=True,
                   query_pre_attn_scalar=32.0, sliding_window=8,
                   sliding_layers=tuple(t == "sliding_attention" for t in _GEMMA3_LAYERS),
                   rope_theta=100000.0, rope_local_theta=10000.0),
    "phi3": dict(),  # Llama's block; its fused projections are a checkpoint layout
    "mixtral": dict(num_local_experts=4, num_experts_per_tok=2, intermediate_size=96),
    "qwen3moe": dict(qk_norm=True, tie_word_embeddings=True, num_local_experts=4,
                     num_experts_per_tok=2, norm_topk_prob=False, intermediate_size=96),
}
PROMPT = [int(x) for x in np.random.default_rng(0).integers(3, V, size=20)]
EOS = (V + 7,)  # unreachable: every request runs to its budget


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Thousands of tiny torch ops: one intra-op thread keeps them fast,
    also when the suite runs several workers per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(family):
    return {**SIZES, "vocab_size": V, **FAMILIES[family]}


def _numpy_tree(family, seed=0, std=0.15, tail=0.3):
    """Random weights of the family's shapes (the JAX package's
    ``init_params`` gives the fields and shapes): matmul weights and biases
    normal(0, std), norms the identity plus normal(0, std), the output
    projections of layers >= 2 shrunk by ``tail`` so early exits agree
    with the full model part of the time."""
    jp0 = jax_init_params(jax.random.PRNGKey(0), jax_tiny_config(**_kw(family)))
    rng = np.random.default_rng(seed)
    n = lambda shape: (rng.standard_normal(shape) * std).astype(np.float32)  # noqa: E731
    layers = {}
    for f in dataclasses.fields(jp0.layers):
        x = getattr(jp0.layers, f.name)
        if x is None:
            continue
        base = np.asarray(x, np.float32) if "norm" in f.name else 0.0
        w = base + n(x.shape)
        if f.name in ("wo", "w_down"):
            w[2:] *= tail
        layers[f.name] = w.astype(np.float32)
    final = np.asarray(jp0.final_norm, np.float32) + n(jp0.final_norm.shape)
    return dict(embed=n(jp0.embed.shape) * 2, layers=layers, final_norm=final,
                lm_head=None if jp0.lm_head is None else n(jp0.lm_head.shape))


def _jax_params(tree):
    jl = JLayerParams(**{k: jnp.asarray(v) for k, v in tree["layers"].items()})
    head = tree["lm_head"]
    return JLlamaParams(embed=jnp.asarray(tree["embed"]), layers=jl,
                        final_norm=jnp.asarray(tree["final_norm"]),
                        lm_head=None if head is None else jnp.asarray(head))


_MODELS = {}


def _models(family):
    """(jax cfg, jax params, port cfg, port params), built once per family."""
    if family not in _MODELS:
        tree = _numpy_tree(family)
        _MODELS[family] = (jax_tiny_config(**_kw(family)), _jax_params(tree),
                           tiny_config(**_kw(family)),
                           tparams.params_from_numpy(tree, device="cpu"))
    return _MODELS[family]


_ENGINES = {}


def _engines(family):
    if family not in _ENGINES:
        jcfg, jp, cfg, tp = _models(family)
        _ENGINES[family] = (JEngine(jp, jcfg), Engine(tp, cfg, device="cpu"))
    return _ENGINES[family]


def _ids(b, t, seed):
    return np.random.default_rng(seed).integers(0, V, size=(b, t))


def _caches(jcfg, cfg, n, b, s):
    """Zeroed KV caches of ``n`` layers in both packages."""
    jc = jax_init_kv_cache(dataclasses.replace(jcfg, num_hidden_layers=n), b, s)
    tc = init_kv_cache(dataclasses.replace(cfg, num_hidden_layers=n), b, s, device="cpu")
    return jc, tc


# ------------------------------------------------------------ the weights


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_params_from_numpy_carries_the_family_fields(family):
    jcfg, jp, cfg, tp = _models(family)
    for f in dataclasses.fields(jp.layers):
        want, got = getattr(jp.layers, f.name), getattr(tp.layers, f.name)
        assert (want is None) == (got is None), f.name
        if want is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (tp.lm_head is None) == cfg.tie_word_embeddings


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_init_params_matches_the_jax_init(family):
    """The port's ``init_params`` makes the JAX package's fields, shapes and
    identity norms (zeros under Gemma's (1 + w), ones otherwise)."""
    jp = jax_init_params(jax.random.PRNGKey(0), jax_tiny_config(**_kw(family)))
    tp = tparams.init_params(tiny_config(**_kw(family)), seed=1, device="cpu")
    for f in dataclasses.fields(jp.layers):
        want, got = getattr(jp.layers, f.name), getattr(tp.layers, f.name)
        assert (want is None) == (got is None), f.name
        if want is not None:
            assert tuple(got.shape) == tuple(want.shape), f.name
            if "norm" in f.name or f.name.startswith("b"):
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tp.final_norm.numpy(), np.asarray(jp.final_norm))


# ------------------------------------------------------------ the forwards


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forwards_equal_jax(family):
    """``forward`` over a 20-token prompt (K1's plain version, the window
    masking), ``forward_split`` with ``last_pos``, three ``forward_early``
    draft steps at per-row pasts and ``forward_remainder``: the logits agree
    with the JAX package's at every stage."""
    jcfg, jp, cfg, tp = _models(family)
    nl, e, b, s, p, w = cfg.num_hidden_layers, 2, 2, 48, 20, 3
    ids = _ids(b, p, 1)
    jc, tc = _caches(jcfg, cfg, nl, b, s)
    want = jllama.forward(jp, jcfg, jnp.asarray(ids), jc, jnp.int32(0))
    got = tllama.forward(tp, cfg, torch.from_numpy(ids), tc, 0)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits), **LOGIT_TOL)

    last = np.array([19, 13])
    (je, te), (jf, tf) = _caches(jcfg, cfg, e, b, s), _caches(jcfg, cfg, nl - e, b, s)
    jres = jllama.forward_split(jp, jcfg, jnp.asarray(ids), je, jf, jnp.int32(0), e,
                                last_pos=jnp.asarray(last, jnp.int32))
    tres = tllama.forward_split(tp, cfg, torch.from_numpy(ids), te, tf, 0, e,
                                last_pos=torch.from_numpy(last))
    np.testing.assert_allclose(tres.logits.numpy(), np.asarray(jres.logits), **LOGIT_TOL)

    ctx, toks = last + 1, _ids(b, w + 1, 2)
    jearly, tearly, jh, th = jres.early_cache, tres.early_cache, [], []
    for i in range(w):
        jr = jllama.forward_early(jp, jcfg, jnp.asarray(toks[:, i:i + 1]), jearly,
                                  jnp.asarray(ctx + i, jnp.int32), e)
        tr = tllama.forward_early(tp, cfg, torch.from_numpy(toks[:, i:i + 1]), tearly,
                                  torch.from_numpy(ctx + i), e)
        np.testing.assert_allclose(tr.logits.numpy(), np.asarray(jr.logits), **LOGIT_TOL)
        jearly, tearly = jr.cache, tr.cache
        jh.append(jr.hidden[:, 0])
        th.append(tr.hidden[:, 0])
    jv = jllama.forward_remainder(
        jp, jcfg, jnp.asarray(toks[:, w:]), jnp.stack(jh, 1), jearly, jres.full_cache,
        draft_len=jnp.asarray(ctx + w, jnp.int32), full_len=jnp.asarray(ctx, jnp.int32),
        exit_layer=e)
    tv = tllama.forward_remainder(
        tp, cfg, torch.from_numpy(toks[:, w:]), torch.stack(th, 1), tearly,
        tres.full_cache, draft_len=torch.from_numpy(ctx + w),
        full_len=torch.from_numpy(ctx), exit_layer=e)
    np.testing.assert_allclose(tv.logits.numpy(), np.asarray(jv.logits), **LOGIT_TOL)


@pytest.mark.parametrize("family,change", [
    ("mistral", dict(sliding_window=None)),
    ("gemma2", dict(sliding_window=None)),
    ("gemma3", dict(sliding_window=None)),
    ("gemma3", dict(rope_local_theta=None)),
])
def test_window_and_local_rope_change_the_logits(family, change):
    """Dropping the window (or Gemma-3's local RoPE base) changes the logits
    of a 20-token prompt: the per-layer window and the cos/sin select do
    not silently no-op. The JAX package agrees on the changed config too."""
    jcfg, jp, cfg, tp = _models(family)
    ids = torch.from_numpy(_ids(1, 20, 3))
    out = []
    for c in (cfg, dataclasses.replace(cfg, **change)):
        cache = init_kv_cache(c, 1, 32, device="cpu")
        out.append(tllama.forward(tp, c, ids, cache, 0).logits.numpy())
    assert not np.allclose(out[0], out[1], atol=1e-3)
    jc2 = dataclasses.replace(jcfg, **change)
    want = jllama.forward(jp, jc2, jnp.asarray(ids.numpy()), jax_init_kv_cache(jc2, 1, 32),
                          jnp.int32(0))
    np.testing.assert_allclose(out[1], np.asarray(want.logits), **LOGIT_TOL)


# ------------------------------------------------------------ the engines


def _gen(cls, strategy, max_steps=16, **kw):
    spec = dict(exit_layer=2, num_speculations=3) if strategy != "autoregressive" else {}
    return cls(max_steps=max_steps, sample=False, generation_strategy=strategy, **spec, **kw)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_greedy_streams_equal_jax(family):
    """Greedy AR and self-speculative (exit 2, W 3) streams, token counts
    and the matches/drafts counters equal the JAX engine's; spec == AR."""
    je, te = _engines(family)
    streams = []
    for strategy in ("autoregressive", "self_speculative"):
        jout = je.generate(PROMPT, _gen(JGenerationConfig, strategy), jax.random.PRNGKey(0),
                           eos_ids=EOS)
        tout = te.generate(PROMPT, _gen(GenerationConfig, strategy), eos_ids=EOS)
        n = int(np.asarray(jout.num_tokens)[0])
        assert int(tout.num_tokens[0]) == n
        np.testing.assert_array_equal(tout.tokens[0, :n].numpy(),
                                      np.asarray(jout.tokens)[0, :n])
        assert (int(tout.matches), int(tout.drafts)) == (int(jout.matches),
                                                          int(jout.drafts))
        streams.append(postprocess_output(tout, EOS, 16))
    assert streams[0] == streams[1] and len(streams[0]) == 16


# ------------------------------------------------------------ the HF classes


_HF = {  # model_type and the family's config fields at SIZES' widths
    "qwen2": ("qwen2", {}),
    "qwen3": ("qwen3", dict(head_dim=64)),
    "mistral": ("mistral", dict(sliding_window=8, head_dim=64)),
    "gemma": ("gemma", dict(head_dim=64, hidden_activation="gelu_pytorch_tanh")),
    "gemma2": ("gemma2", dict(head_dim=64, sliding_window=8, query_pre_attn_scalar=32,
                              attn_logit_softcapping=50.0, final_logit_softcapping=30.0)),
    "gemma3": ("gemma3_text", dict(head_dim=64, num_hidden_layers=6, sliding_window=8,
                                   query_pre_attn_scalar=32, rope_theta=100000.0,
                                   rope_local_base_freq=10000.0,
                                   layer_types=list(_GEMMA3_LAYERS))),
    "phi3": ("phi3", dict(pad_token_id=0)),
    "mixtral": ("mixtral", dict(num_local_experts=4, num_experts_per_tok=2,
                                intermediate_size=96, head_dim=64)),
    "qwen3moe": ("qwen3_moe", dict(num_experts=4, num_experts_per_tok=2,
                                   moe_intermediate_size=96, norm_topk_prob=False,
                                   head_dim=64)),
}


def _hf_model(family):
    from transformers import AutoConfig, AutoModelForCausalLM

    model_type, extra = _HF[family]
    kw = dict(vocab_size=V, num_hidden_layers=4, max_position_embeddings=256,
              **SIZES)
    kw.update(extra)
    hf_cfg = AutoConfig.for_model(model_type, **kw)
    hf_cfg._attn_implementation = "eager"  # softcapping needs the eager path
    torch.manual_seed(0)
    model = AutoModelForCausalLM.from_config(hf_cfg).eval()
    cfg = ModelConfig.from_hf_dict(hf_cfg.to_dict(), dtype=torch.float32)
    return model, cfg


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_hf_logits_and_checkpoint_round_trip(family, tmp_path):
    """An HF random-init model of the family through
    ``params_from_torch_state_dict``: logits of a 20-token prompt agree with
    the HF class's; ``save_params`` -> ``load_params`` gives the same
    tensors (Phi-3's fused names load, and save as the split names)."""
    model, cfg = _hf_model(family)
    params = tparams.params_from_torch_state_dict(model.state_dict(), cfg, device="cpu")
    ids = torch.from_numpy(_ids(2, 20, 4))
    with torch.no_grad():
        want = model(ids).logits.float().numpy()
    cache = init_kv_cache(cfg, 2, 32, device="cpu")
    got = tllama.forward(params, cfg, ids, cache, 0).logits.numpy()
    np.testing.assert_allclose(got, want, **LOGIT_TOL)

    tparams.save_params(params, str(tmp_path), cfg)
    cfg2 = ModelConfig.from_pretrained(str(tmp_path), dtype=torch.float32)
    back = tparams.load_params(str(tmp_path), cfg2, device="cpu")
    for f in dataclasses.fields(params.layers):
        a, b = getattr(params.layers, f.name), getattr(back.layers, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            assert torch.equal(a, b), f.name
    assert torch.equal(params.embed, back.embed)
    assert (params.lm_head is None) == (back.lm_head is None)
    if family == "phi3":
        assert any(k.endswith("qkv_proj.weight") for k in model.state_dict())
