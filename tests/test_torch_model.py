"""The PyTorch port's config, params and Llama forwards against the JAX
package (and against HF ``LlamaForCausalLM``) on the CPU in fp32.

Logits agree at atol 3e-4 / rtol 1e-3, the tolerance the JAX package holds
itself to against HF torch (tests/test_model_parity.py): the two frameworks
sum the same fp32 products in different orders through several layers.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from layerskip_tpu.config import ModelConfig as JModelConfig
from layerskip_tpu.config import tiny_config as jax_tiny_config
from layerskip_tpu.models import llama as jllama
from layerskip_tpu.models.llama import LayerParams as JLayerParams
from layerskip_tpu.models.llama import LlamaParams as JLlamaParams
from layerskip_tpu.ops.kv_cache import KVCache as JKVCache
from layerskip_tpu.ops.kv_cache import init_kv_cache as jax_init_kv_cache
from layerskip_tpu_torch.config import ModelConfig, tiny_config
from layerskip_tpu_torch.models import llama as tllama
from layerskip_tpu_torch.models import params as tparams
from layerskip_tpu_torch.ops.kv_cache import KVCache, init_kv_cache

LOGIT_TOL = dict(atol=3e-4, rtol=1e-3)

_HF_DICTS = {
    "llama3": {"model_type": "llama", "vocab_size": 256, "hidden_size": 64,
               "intermediate_size": 128, "num_hidden_layers": 2,
               "num_attention_heads": 4, "num_key_value_heads": 2,
               "rope_theta": 500000.0, "eos_token_id": [1, 2],
               "rope_scaling": {"rope_type": "llama3", "factor": 8.0,
                                "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                                "original_max_position_embeddings": 8192},
               "tie_word_embeddings": True},
    "qwen2": {"model_type": "qwen2", "vocab_size": 128, "hidden_size": 32,
              "intermediate_size": 64, "num_hidden_layers": 2,
              "num_attention_heads": 2, "num_key_value_heads": 1},
    "mistral": {"model_type": "mistral", "vocab_size": 128, "hidden_size": 32,
                "intermediate_size": 64, "num_hidden_layers": 2,
                "num_attention_heads": 2, "sliding_window": 4096},
    "gemma2": {"model_type": "gemma2", "vocab_size": 256, "hidden_size": 64,
               "intermediate_size": 128, "num_hidden_layers": 4,
               "num_attention_heads": 4, "num_key_value_heads": 2,
               "head_dim": 16, "sliding_window": 8, "query_pre_attn_scalar": 16},
    "gemma3": {"model_type": "gemma3_text", "vocab_size": 256, "hidden_size": 64,
               "intermediate_size": 128, "num_hidden_layers": 6,
               "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
               "sliding_window": 8, "rope_local_base_freq": 10000.0,
               "layer_types": ["sliding_attention"] * 5 + ["full_attention"]},
    "qwen3_moe": {"model_type": "qwen3_moe", "vocab_size": 256, "hidden_size": 64,
                  "intermediate_size": 128, "moe_intermediate_size": 96,
                  "num_hidden_layers": 4, "num_attention_heads": 4,
                  "num_key_value_heads": 2, "head_dim": 16},
}


@pytest.mark.parametrize("name", sorted(_HF_DICTS))
def test_from_hf_dict_gives_equal_fields(name):
    got = dataclasses.asdict(ModelConfig.from_hf_dict(_HF_DICTS[name], dtype=torch.float32))
    want = dataclasses.asdict(JModelConfig.from_hf_dict(_HF_DICTS[name], dtype=jnp.float32))
    got.pop("dtype"), want.pop("dtype")
    assert got == want
    cfg = ModelConfig.from_hf_dict(_HF_DICTS[name])
    jcfg = JModelConfig.from_hf_dict(_HF_DICTS[name])
    assert (cfg.q_heads_per_kv, cfg.sliding_layer_flags, cfg.norm_offset,
            cfg.eos_token_ids) == (jcfg.q_heads_per_kv, jcfg.sliding_layer_flags,
                                   jcfg.norm_offset, jcfg.eos_token_ids)


# ------------------------------------------------------------ shared model

L, D, F, V, HQ, HKV, DH = 4, 64, 128, 256, 4, 2, 16


def _numpy_tree(seed=0, std=0.15):
    """Random dense-Llama weights as the JAX package's nested field names.
    std 0.15 (not HF's 0.02) keeps the tiny model's logits well separated."""
    rng = np.random.default_rng(seed)
    n = lambda *s: (rng.standard_normal(s) * std).astype(np.float32)  # noqa: E731
    layers = dict(
        attn_norm=1 + n(L, D), wq=n(L, HQ * DH, D), wk=n(L, HKV * DH, D),
        wv=n(L, HKV * DH, D), wo=n(L, HQ * DH, D), mlp_norm=1 + n(L, D),
        w_gate=n(L, D, F), w_up=n(L, D, F), w_down=n(L, F, D),
    )
    return dict(embed=n(V, D) * 2, layers=layers, final_norm=1 + n(D), lm_head=n(D, V))


def _jax_params(tree):
    layers = JLayerParams(**{k: jnp.asarray(v) for k, v in tree["layers"].items()})
    return JLlamaParams(embed=jnp.asarray(tree["embed"]), layers=layers,
                        final_norm=jnp.asarray(tree["final_norm"]),
                        lm_head=jnp.asarray(tree["lm_head"]))


@pytest.fixture(scope="module")
def models():
    tree = _numpy_tree()
    return (jax_tiny_config(), _jax_params(tree), tiny_config(),
            tparams.params_from_numpy(tree, device="cpu"))


def test_params_from_numpy_round_trips(models):
    jcfg, jp, cfg, tp = models
    tree = jax.tree.map(np.asarray, jp)  # the JAX dataclass with numpy leaves
    for got in (tp, tparams.params_from_numpy(tree, device="cpu")):
        for name in ("embed", "final_norm", "lm_head"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(jp, name)))
        for f in dataclasses.fields(got.layers):
            mine, want = getattr(got.layers, f.name), getattr(jp.layers, f.name)
            assert (mine is None) == (want is None), f.name  # absent family fields
            if want is not None:
                np.testing.assert_array_equal(mine.numpy(), np.asarray(want))
    bf = tparams.params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)
    assert bf.layers.wq.dtype == torch.bfloat16 and bf.layers.wq.shape == (L, HQ * DH, D)


def test_params_from_numpy_rejects_family_fields(models):
    """A family's optional field (here Qwen2's q bias) loads as it is, and
    the absent ones stay None; a field the port does not know is rejected."""
    tree = _numpy_tree()
    bq = np.random.default_rng(5).standard_normal((L, HQ * DH)).astype(np.float32)
    tree["layers"]["bq"] = bq
    got = tparams.params_from_numpy(tree, device="cpu")
    np.testing.assert_array_equal(got.layers.bq.numpy(), bq)
    assert got.layers.bk is None and got.layers.w_router is None
    tree["layers"]["w_nope"] = bq
    with pytest.raises(ValueError, match="w_nope"):
        tparams.params_from_numpy(tree, device="cpu")


def test_init_params_shapes_and_tied_head():
    cfg = tiny_config(tie_word_embeddings=True)
    p = tparams.init_params(cfg, seed=3, device="cpu")
    assert p.lm_head is None and p.embed.shape == (cfg.vocab_size, cfg.hidden_size)
    assert p.layers.wq.shape == (4, 64, 64) and p.layers.w_down.shape == (4, 128, 64)
    assert 0.015 < p.layers.w_up.std().item() < 0.025
    again = tparams.init_params(cfg, seed=3, device="cpu")
    assert torch.equal(p.layers.wk, again.layers.wk)


def test_make_random_params_scales_the_tail():
    cfg = tiny_config()
    p = tparams.make_random_params(cfg, exit_layer=2, tail_eps=0.0, device="cpu")
    assert p.layers.wo[2:].abs().max() == 0 and p.layers.w_down[2:].abs().max() == 0
    assert p.layers.wo[:2].abs().max() > 0 and p.layers.wq[3].abs().max() > 0
    half = tparams.make_random_params(cfg, exit_layer=2, tail_eps=0.5, device="cpu")
    full = tparams.make_random_params(cfg, exit_layer=4, tail_eps=0.5, device="cpu")
    assert torch.equal(half.layers.w_down[3], full.layers.w_down[3] * 0.5)


def test_params_from_flat_dict_matches_hf_logits():
    from transformers import LlamaConfig, LlamaForCausalLM

    cfg = tiny_config()
    hf_cfg = LlamaConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size,
        num_hidden_layers=cfg.num_hidden_layers,
        num_attention_heads=cfg.num_attention_heads,
        num_key_value_heads=cfg.num_key_value_heads, head_dim=cfg.head_dim,
        max_position_embeddings=cfg.max_position_embeddings,
        rms_norm_eps=cfg.rms_norm_eps, rope_theta=cfg.rope_theta,
        attention_bias=False, tie_word_embeddings=False,
    )
    torch.manual_seed(0)
    model = LlamaForCausalLM(hf_cfg).eval()
    params = tparams.params_from_flat_dict(model.state_dict(), cfg, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 20)))
    with torch.no_grad():
        want = model(ids).logits.float().numpy()
    cache = init_kv_cache(cfg, batch=2, max_len=32, device="cpu")
    got = tllama.forward(params, cfg, ids, cache, 0).logits.numpy()
    np.testing.assert_allclose(got, want, **LOGIT_TOL)


# --------------------------------------------------------------- forwards


def _ids(b, t, seed):
    return np.random.default_rng(seed).integers(0, V, size=(b, t))


def _jcache(n, b, s):
    return JKVCache(k=jnp.zeros((n, b, s, HKV, DH)), v=jnp.zeros((n, b, s, HKV, DH)))


def _tcache(n, b, s):
    return KVCache(k=torch.zeros((n, b, s, HKV, DH)), v=torch.zeros((n, b, s, HKV, DH)))


def _same_cache(got: KVCache, want, atol=1e-4):
    np.testing.assert_allclose(got.k.numpy(), np.asarray(want.k), atol=atol, rtol=1e-3)
    np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), atol=atol, rtol=1e-3)


@pytest.mark.parametrize("t,past", [(24, 0), (3, 9)])
def test_forward_matches_jax(models, t, past):
    """T=24 at past 0 takes the flash route; T=3 after a 9-token prefix the
    masked one."""
    jcfg, jp, cfg, tp = models
    ids = _ids(2, 9 + t, 1)
    jc = jax_init_kv_cache(jcfg, 2, 40)
    tc = init_kv_cache(cfg, 2, 40, device="cpu")
    if past:
        jc = jllama.forward(jp, jcfg, jnp.asarray(ids[:, :past]), jc, jnp.int32(0)).cache
        tllama.forward(tp, cfg, torch.from_numpy(ids[:, :past]), tc, 0)
    seg = ids[:, past:past + t]
    want = jllama.forward(jp, jcfg, jnp.asarray(seg), jc, jnp.int32(past))
    got = tllama.forward(tp, cfg, torch.from_numpy(seg), tc, past)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits), **LOGIT_TOL)
    np.testing.assert_allclose(got.hidden.numpy(), np.asarray(want.hidden), **LOGIT_TOL)
    _same_cache(got.cache, want.cache)


def test_forward_early_and_remainder_match_jax(models):
    """A prefill through forward_split (with last_pos), three draft steps
    through forward_early at per-row pasts, then forward_remainder: logits
    agree at every stage and both KV groups agree afterwards."""
    jcfg, jp, cfg, tp = models
    e, b, s, p, w = 2, 2, 48, 20, 3
    ids = _ids(b, p, 2)
    last = np.array([19, 13])
    jres = jllama.forward_split(jp, jcfg, jnp.asarray(ids), _jcache(e, b, s),
                                _jcache(L - e, b, s), jnp.int32(0), e,
                                last_pos=jnp.asarray(last, jnp.int32))
    tres = tllama.forward_split(tp, cfg, torch.from_numpy(ids), _tcache(e, b, s),
                                _tcache(L - e, b, s), 0, e, last_pos=torch.from_numpy(last))
    assert tres.logits.shape == (b, 1, V)
    np.testing.assert_allclose(tres.logits.numpy(), np.asarray(jres.logits), **LOGIT_TOL)
    _same_cache(tres.early_cache, jres.early_cache)
    _same_cache(tres.full_cache, jres.full_cache)

    ctx = last + 1
    toks = _ids(b, w + 1, 3)
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
    assert tv.logits.shape == (b, w + 1, V)
    np.testing.assert_allclose(tv.logits.numpy(), np.asarray(jv.logits), **LOGIT_TOL)
    _same_cache(tv.early_cache, jv.early_cache)
    _same_cache(tv.full_cache, jv.full_cache)
