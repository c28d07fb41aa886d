"""The PyTorch port's LayerSkip training recipe (``training/recipe.py``)
against the JAX package's, on the CPU in fp32.

The same numpy weights and batches go through both packages. The layer
dropout mask is the JAX package's own draw (``jax.random.uniform(rng, (L,
B)) >= p_max * D(l)``, from the key its ``layerskip_loss`` is given), passed
to the port explicitly, as threefry cannot be reproduced in torch; p_max 0.3
makes samples really skip layers. Tolerances: the total, final and exit
losses, exit weights and MoE aux term at rtol 1e-5; every parameter's
gradient at atol 2e-5 / rtol 2e-3 (the JAX suite's own bound between its
chunked and dense CE, tests/test_parallel_and_training.py); the schedules
at 1e-7; two AdamW steps against optax's adamw at atol 2e-6 / rtol 1e-5
(the gradients' rtol times the learning rate), where each step's gradient
is above the gradients' atol.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from layerskip_tpu.config import tiny_config as jax_tiny_config
from layerskip_tpu.models.llama import LayerParams as JLayerParams
from layerskip_tpu.models.llama import LlamaParams as JLlamaParams
from layerskip_tpu.models.params import init_params as jax_init_params
from layerskip_tpu.training import recipe as jrecipe
from layerskip_tpu_torch.config import tiny_config
from layerskip_tpu_torch.models import llama as tllama
from layerskip_tpu_torch.models import params as tparams
from layerskip_tpu_torch.ops import moe as tmoe
from layerskip_tpu_torch.ops.kv_cache import init_kv_cache
from layerskip_tpu_torch.ops.linear import QuantTensor
from layerskip_tpu_torch.training import recipe

LOSS_TOL = dict(rtol=1e-5)
GRAD_TOL = dict(atol=2e-5, rtol=2e-3)
# an Adam update is lr * m/(sqrt(v) + eps): gradients within GRAD_TOL's
# rtol move it by up to lr * 2e-3 (lr 1e-3 in the test)
ADAM_TOL = dict(atol=2e-6, rtol=1e-5)
SIZES = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
             intermediate_size=96, vocab_size=128)
_GEMMA = dict(hidden_act="gelu_pytorch_tanh", rms_norm_offset=True, scale_embeddings=True,
              tie_word_embeddings=True)
FAMILIES = {
    "llama": dict(),
    "qwen2": dict(attention_bias=True),
    "qwen3": dict(qk_norm=True, tie_word_embeddings=True),
    "mistral": dict(sliding_window=5),
    "gemma2": dict(_GEMMA, attn_logit_softcap=50.0, final_logit_softcap=30.0,
                   query_pre_attn_scalar=32.0, sliding_window=5, sliding_window_pattern=2,
                   post_norms=True),
    "gemma3": dict(_GEMMA, num_hidden_layers=6, qk_norm=True, post_norms=True,
                   query_pre_attn_scalar=32.0, sliding_window=5, sliding_window_pattern=6,
                   rope_theta=100000.0, rope_local_theta=10000.0),
    "mixtral": dict(num_local_experts=4, num_experts_per_tok=2),
    # 8 experts and 3 tokens: 6 assignments < 8, the ``few`` path
    "mixtral_few": dict(num_local_experts=8, num_experts_per_tok=2),
}
T = 12  # > the 5-token window, so the windowed layers really mask


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(family):
    return {**SIZES, **FAMILIES[family]}


def _numpy_tree(family, seed=0, std=0.15, **over):
    """Random weights of the family's fields and shapes (the JAX package's
    ``init_params`` gives them; ``over`` changes its config): normal(0,
    std), norms the identity plus normal(0, std)."""
    jp0 = jax_init_params(jax.random.PRNGKey(0), jax_tiny_config(**{**_kw(family), **over}))
    rng = np.random.default_rng(seed)
    n = lambda shape: (rng.standard_normal(shape) * std).astype(np.float32)  # noqa: E731
    layers = {}
    for f in dataclasses.fields(jp0.layers):
        x = getattr(jp0.layers, f.name)
        if x is not None:
            base = np.asarray(x, np.float32) if "norm" in f.name else 0.0
            layers[f.name] = (base + n(x.shape)).astype(np.float32)
    final = np.asarray(jp0.final_norm, np.float32) + n(jp0.final_norm.shape)
    return dict(embed=n(jp0.embed.shape) * 2, layers=layers, final_norm=final,
                lm_head=None if jp0.lm_head is None else n(jp0.lm_head.shape))


def _jax_params(tree):
    head = tree["lm_head"]
    return JLlamaParams(
        embed=jnp.asarray(tree["embed"]),
        layers=JLayerParams(**{k: jnp.asarray(v) for k, v in tree["layers"].items()}),
        final_norm=jnp.asarray(tree["final_norm"]),
        lm_head=None if head is None else jnp.asarray(head))


def _port_params(tree):
    params = tparams.params_from_numpy(tree, device="cpu")
    for w in recipe.trainable_tensors(params).values():
        w.requires_grad_(True)
    return params


def _batch(b, t, v, seed):
    """ids and next-token labels, with -100 labels at the start of row 0
    and at the end of every row."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, v, size=(b, t))
    labels = np.concatenate([ids[:, 1:], np.full((b, 1), -100)], axis=1)
    labels[0, :3] = -100
    return ids, labels


def _jax_keep(tcfg, nl, b):
    """(key, the keep mask JAX's layerskip_loss draws from it): the first
    key whose mask drops at least one sample from a layer."""
    p_drop = tcfg.p_max * jrecipe.depth_scale(jnp.arange(nl, dtype=jnp.int32), nl,
                                              tcfg.dropout_scale)
    for seed in range(100):
        key = jax.random.PRNGKey(seed)
        keep = np.array(jax.random.uniform(key, (nl, b)) >= p_drop[:, None])
        if not keep.all():
            return key, keep
    raise AssertionError("no key drops a layer")


def _jax_loss_and_grads(jp, jcfg, jtcfg, ids, labels, key, step):
    fn = jax.jit(jax.value_and_grad(
        lambda p: jrecipe.layerskip_loss(p, jcfg, jtcfg, jnp.asarray(ids, jnp.int32),
                                         jnp.asarray(labels, jnp.int32), key,
                                         jnp.int32(step)), has_aux=True))
    (_, aux), grads = fn(jp)
    return aux, grads


def _named_jax(tree):
    """name -> array of a JAX ``LlamaParams`` (gradients included), under
    ``recipe.trainable_tensors``' names."""
    out = {"embed": tree.embed, "final_norm": tree.final_norm}
    if tree.lm_head is not None:
        out["lm_head"] = tree.lm_head
    for f in dataclasses.fields(tree.layers):
        x = getattr(tree.layers, f.name)
        if x is not None:
            out[f"layers.{f.name}"] = x
    return out


def _assert_grads_equal(params, jgrads, label):
    want = _named_jax(jgrads)
    got = recipe.trainable_tensors(params)
    assert set(got) == set(want), label
    for name, w in got.items():
        np.testing.assert_allclose(w.grad.numpy(), np.asarray(want[name]),
                                   err_msg=f"{label}: grad of {name}", **GRAD_TOL)


def _assert_aux_equal(aux, jaux, label):
    for key in ("loss", "final_loss", "exit_losses", "exit_weights", "moe_aux"):
        np.testing.assert_allclose(aux[key].detach().numpy(), np.asarray(jaux[key]),
                                   err_msg=f"{label}: {key}", **LOSS_TOL)


# ------------------------------------------------------------ the schedules


def test_schedules_equal_jax():
    for nl in (1, 2, 4, 8, 16):
        for kind in ("exp", "linear", "none"):
            want = np.asarray(jrecipe.depth_scale(jnp.arange(nl, dtype=jnp.int32), nl, kind))
            got = recipe.depth_scale(torch.arange(nl), nl, kind).numpy()
            np.testing.assert_allclose(got, want, atol=1e-7, rtol=1e-7)
    for exits, nl, e_scale, r in (((1, 2, 3), 4, 1.0, 2), ((4, 8, 12), 16, 0.5, 0),
                                  ((2, 4, 6, 8), 10, 2.0, 3), ((), 4, 1.0, 0)):
        for step in (0, 1, 2):
            want = np.asarray(jrecipe.exit_loss_weights(exits, nl, e_scale, r,
                                                        jnp.int32(step)))
            got = recipe.exit_loss_weights(exits, nl, e_scale, r, step).numpy()
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, atol=1e-7, rtol=1e-7)
    # the rotational curriculum: every other exit a step, weights summing to 1
    w0 = recipe.exit_loss_weights((1, 2, 3), 4, 1.0, 2, 0)
    w1 = recipe.exit_loss_weights((1, 2, 3), 4, 1.0, 2, 1)
    assert (w0 > 0).tolist() == [True, False, True]
    assert (w1 > 0).tolist() == [False, True, False]
    for nl in (1, 2, 4, 6, 16, 32):
        assert recipe.default_exit_layers(nl) == jrecipe.default_exit_layers(nl)


def test_token_cross_entropy_equals_jax():
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((2, 7, 33)) * 3).astype(np.float32)
    labels = rng.integers(0, 33, size=(2, 7))
    labels[1, 2:5] = -100
    for smoothing in (0.0, 0.1):
        want = float(jrecipe.token_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                                 smoothing))
        got = float(recipe.token_cross_entropy(torch.from_numpy(logits),
                                               torch.from_numpy(labels), smoothing))
        np.testing.assert_allclose(got, want, **LOSS_TOL)
    all_ignored = np.full((2, 7), -100)
    assert float(recipe.token_cross_entropy(torch.from_numpy(logits),
                                            torch.from_numpy(all_ignored))) == 0.0


# ------------------------------------------------------------ the loss


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_layerskip_loss_and_grads_equal_jax(family):
    """Total, final and exit losses, exit weights, the MoE aux term and the
    gradient of every weight equal the JAX package's, with JAX's keep mask
    (p_max 0.3), rotational exits at step 1, label smoothing 0.1 and a
    16-token chunked CE (24 tokens: two chunks, the second padded)."""
    kw = _kw(family)
    jcfg, cfg = jax_tiny_config(**kw), tiny_config(**kw)
    nl = cfg.num_hidden_layers
    b, t = (1, 3) if family == "mixtral_few" else (2, T)
    exits = tuple(range(1, nl))
    jtcfg = jrecipe.TrainConfig(p_max=0.3, early_exit_layers=exits, e_scale=0.5,
                                rotational_r=2, label_smoothing=0.1, ce_chunk_tokens=16)
    tcfg = recipe.TrainConfig(p_max=0.3, early_exit_layers=exits, e_scale=0.5,
                              rotational_r=2, label_smoothing=0.1, ce_chunk_tokens=16)
    tree = _numpy_tree(family)
    ids, labels = _batch(b, t, cfg.vocab_size, seed=3)
    key, keep = _jax_keep(jtcfg, nl, b)
    jaux, jgrads = _jax_loss_and_grads(_jax_params(tree), jcfg, jtcfg, ids, labels, key, 1)

    params = _port_params(tree)
    tmoe.reset_path_calls()
    loss, aux = recipe.layerskip_loss(params, cfg, tcfg, torch.from_numpy(ids),
                                      torch.from_numpy(labels), step=1,
                                      keep=torch.from_numpy(keep))
    loss.backward()
    if cfg.is_moe:
        path = "few" if family == "mixtral_few" else "dense"
        assert tmoe.PATH_CALLS[path] == nl and sum(tmoe.PATH_CALLS.values()) == nl
        assert float(aux["moe_aux"].detach()) > 0.99  # 1.0 when perfectly balanced
    else:
        assert float(aux["moe_aux"].detach()) == 0.0
    assert len(aux["exit_losses"]) == nl - 1
    _assert_aux_equal(aux, jaux, family)
    _assert_grads_equal(params, jgrads, family)


def test_chunked_ce_equals_dense():
    """Token-chunked CE (three 16-token chunks, recomputed in backward) ==
    dense [B, T, V] CE: losses and gradients, with label smoothing 0.1 and
    ignored labels spanning chunks (the JAX package's
    test_chunked_ce_matches_dense)."""
    tree = _numpy_tree("llama", seed=4)
    cfg = tiny_config(**_kw("llama"))
    ids, labels = _batch(2, 24, cfg.vocab_size, seed=5)
    keep = torch.ones((cfg.num_hidden_layers, 2), dtype=torch.bool)
    keep[3, 1] = False
    dense = recipe.TrainConfig(p_max=0.2, early_exit_layers=(1, 2), e_scale=0.5,
                               ce_chunk_tokens=0, label_smoothing=0.1)
    runs = []
    for tcfg in (dense, dataclasses.replace(dense, ce_chunk_tokens=16)):
        params = _port_params(tree)
        loss, aux = recipe.layerskip_loss(params, cfg, tcfg, torch.from_numpy(ids),
                                          torch.from_numpy(labels), keep=keep)
        loss.backward()
        runs.append((aux, {k: w.grad for k, w in recipe.trainable_tensors(params).items()}))
    (aux_d, g_d), (aux_c, g_c) = runs
    for key in ("loss", "final_loss", "exit_losses"):
        np.testing.assert_allclose(aux_c[key].detach().numpy(), aux_d[key].detach().numpy(),
                                   **LOSS_TOL)
    for name in g_d:
        np.testing.assert_allclose(g_c[name].numpy(), g_d[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("family", ["llama", "mistral", "gemma2", "gemma3", "qwen3"])
def test_training_forward_matches_inference(family):
    """With layer dropout off and no exits, the training CE equals the CE
    of the port's inference ``forward`` logits: training optimizes the
    architecture inference runs (the JAX package's test of the same name)."""
    cfg = tiny_config(**dict(_kw(family), num_hidden_layers=6))
    params = tparams.params_from_numpy(_numpy_tree(family, seed=5, num_hidden_layers=6),
                                       device="cpu")
    ids = np.random.default_rng(9).integers(0, cfg.vocab_size, size=(2, T))
    labels = np.concatenate([ids[:, 1:], np.full((2, 1), -100)], axis=1)
    tcfg = recipe.TrainConfig(p_max=0.0, early_exit_layers=(99,))  # filtered to none
    with torch.no_grad():
        _, aux = recipe.layerskip_loss(params, cfg, tcfg, torch.from_numpy(ids),
                                       torch.from_numpy(labels))
        cache = init_kv_cache(cfg, 2, T + 2, device="cpu")
        res = tllama.forward(params, cfg, torch.from_numpy(ids), cache, 0)
        ref = recipe.token_cross_entropy(res.logits, torch.from_numpy(labels))
    np.testing.assert_allclose(float(aux["final_loss"]), float(ref), **LOSS_TOL)
    assert aux["exit_losses"].shape == (0,)


def test_keep_mask_from_the_generator():
    """Without ``keep``, the mask comes from the generator: one seed gives
    one loss; p_max 0 keeps every layer (== an all-ones mask)."""
    tree = _numpy_tree("llama", seed=6)
    cfg = tiny_config(**_kw("llama"))
    ids, labels = (torch.from_numpy(x) for x in _batch(4, 8, cfg.vocab_size, seed=7))
    params = tparams.params_from_numpy(tree, device="cpu")
    tcfg = recipe.TrainConfig(p_max=0.9, early_exit_layers=(2,))

    def loss(tc, **kw):
        with torch.no_grad():
            return float(recipe.layerskip_loss(params, cfg, tc, ids, labels, **kw)[0])

    gen = lambda: torch.Generator().manual_seed(11)  # noqa: E731
    assert loss(tcfg, generator=gen()) == loss(tcfg, generator=gen())
    off = dataclasses.replace(tcfg, p_max=0.0)
    ones = torch.ones((cfg.num_hidden_layers, 4), dtype=torch.bool)
    assert loss(off, generator=gen()) == loss(tcfg, keep=ones)
    assert loss(tcfg, generator=gen()) != loss(tcfg, keep=ones)


# ------------------------------------------------------------ the optimizer


def test_two_train_steps_equal_optax_adamw():
    """Two ``train_step``s (torch AdamW) == two steps of the JAX package's
    ``make_train_step`` (optax adamw) on the same batch, with each step's
    JAX keep mask passed in: the losses, and the params after each step.
    Adam divides by the gradient's own scale, so a weight whose gradient
    is below GRAD_TOL's atol in some step (where the two packages' fp32
    gradients may differ in sign) is held to Adam's own bound instead, lr a
    step (|m / sqrt(v)| <= 1 in the first two steps)."""
    family = "qwen2"
    kw = _kw(family)
    jcfg, cfg = jax_tiny_config(**kw), tiny_config(**kw)
    tree = _numpy_tree(family, seed=8)
    ids, labels = _batch(2, T, cfg.vocab_size, seed=9)
    common = dict(p_max=0.3, early_exit_layers=(1, 3), learning_rate=1e-3,
                  weight_decay=0.1, ce_chunk_tokens=16)
    jtcfg, tcfg = jrecipe.TrainConfig(**common), recipe.TrainConfig(**common)
    jstep, jinit = jrecipe.make_train_step(jcfg, jtcfg)
    jstep = jax.jit(jstep)
    jp = _jax_params(tree)
    jopt = jinit(jp)
    step_fn, init_opt = recipe.make_train_step(cfg, tcfg)
    params = tparams.params_from_numpy(tree, device="cpu")
    opt = init_opt(params)
    assert isinstance(opt, torch.optim.AdamW)
    nl, lr = cfg.num_hidden_layers, common["learning_rate"]
    p_drop = jtcfg.p_max * jrecipe.depth_scale(jnp.arange(nl, dtype=jnp.int32), nl, "exp")
    small = {}
    for step in range(2):
        key = jax.random.PRNGKey(20 + step)
        keep = np.array(jax.random.uniform(key, (nl, 2)) >= p_drop[:, None])
        jp, jopt, jaux = jstep(jp, jopt, jnp.asarray(ids, jnp.int32),
                               jnp.asarray(labels, jnp.int32), key, jnp.int32(step))
        params, opt, aux = step_fn(params, opt, torch.from_numpy(ids),
                                   torch.from_numpy(labels), step=step,
                                   keep=torch.from_numpy(keep))
        np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), **LOSS_TOL)
        want = _named_jax(jp)
        for name, w in recipe.trainable_tensors(params).items():
            small[name] = small.get(name, False) | (w.grad.abs() < GRAD_TOL["atol"]).numpy()
            got, ref = w.detach().numpy(), np.asarray(want[name])
            np.testing.assert_allclose(got[~small[name]], ref[~small[name]],
                                       err_msg=f"step {step}: {name}", **ADAM_TOL)
            assert np.all(np.abs(got - ref) <= lr * (step + 1) * 2 + ADAM_TOL["atol"]), name
    assert all(w.dtype == torch.float32 for st in opt.state.values()
               for w in (st["exp_avg"], st["exp_avg_sq"]))


# ------------------------------------------------------------ the pieces


def test_product_f32_backward_in_bf16():
    """The fp32-output product of bf16 operands (the LM head and the
    attention scores on the card): the forward equals the exact fp32
    product of the operands, and the backward multiplies the cotangent
    rounded to bf16, for the 2-D head and the batched scores."""
    g = torch.Generator().manual_seed(0)
    for a_shape, b_shape in (((2, 5, 16), (16, 24)), ((2, 3, 5, 16), (2, 3, 16, 7))):
        a = torch.randn(a_shape, generator=g).bfloat16().requires_grad_(True)
        b = torch.randn(b_shape, generator=g).bfloat16().requires_grad_(True)
        out = recipe._product_f32(a, b)
        assert out.dtype == torch.float32
        torch.testing.assert_close(out, torch.matmul(a.float(), b.float()), atol=0, rtol=0)
        cot = torch.randn(out.shape, generator=g)
        out.backward(cot)
        c16 = cot.bfloat16()
        torch.testing.assert_close(a.grad, torch.matmul(c16, b.detach().mT))
        if b.dim() == 2:
            want_b = a.detach().reshape(-1, 16).T @ c16.reshape(-1, c16.shape[-1])
        else:
            want_b = torch.matmul(a.detach().mT, c16)
        torch.testing.assert_close(b.grad, want_b)
        assert a.grad.dtype == b.grad.dtype == torch.bfloat16


def test_moe_grouped_path_gradients_equal_dense():
    """The grouped MoE path (taken from 2048 tokens, as at moe-3b training
    on the card) has the dense path's gradients through autograd."""
    rng = np.random.default_rng(2)
    d, f, e, k, n = 16, 24, 4, 2, 40
    mk = lambda *s: torch.tensor(rng.standard_normal(s) * 0.3,  # noqa: E731
                                 dtype=torch.float32)
    x, router = mk(n, d), mk(d, e) * 3
    ws = [mk(e, d, f), mk(e, d, f), mk(e, f, d)]
    cot = mk(n, d)
    grads = []
    for path in (tmoe._moe_dense, tmoe._moe_grouped):
        leaves = [t.clone().requires_grad_(True) for t in (x, router, *ws)]
        topv, topi, _ = tmoe.route(leaves[0], leaves[1], k)
        extra = (e,) if path is tmoe._moe_dense else (e, k)
        path(leaves[0], topv, topi, *leaves[2:], *extra).backward(cot)
        grads.append([t.grad for t in leaves])
    for name, gd, gg in zip(("x", "router", "w_gate", "w_up", "w_down"), *grads):
        torch.testing.assert_close(gg, gd, atol=1e-5, rtol=1e-5, msg=name)


def test_parallel_settings_and_quantized_weights_are_refused():
    with pytest.raises(NotImplementedError, match="not ported yet"):
        recipe.TrainConfig(act_spec=("dp", "fsdp", None))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        recipe.TrainConfig(ring_axis="sp")
    params = tparams.params_from_numpy(_numpy_tree("llama"), device="cpu")
    params.layers.wq = QuantTensor(q=params.layers.wq.to(torch.int8),
                                   scale=torch.ones(params.layers.wq.shape[:2]),
                                   k_last=True)
    cfg = tiny_config(**_kw("llama"))
    ids = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="quantized"):
        recipe.layerskip_loss(params, cfg, recipe.TrainConfig(), ids, ids)
