"""The port's LayerSkip training on the [dp, fsdp, tp] mesh against the JAX
package's single-device recipe, on the CPU in fp32.

Two, four and eight gloo ranks started by the port's launcher
(tests/torch_train_mesh_ranks.py, suites ``mesh2``, ``mesh4``, ``mesh8``)
train a dense model (Qwen2's biases) and a Mixtral-style MoE at dp 2,
fsdp 2, tp 2 and fsdp 2 with the ring, then fsdp 2 x tp 2 and dp 2 x
fsdp 2, then dp 2 x fsdp 2 x tp 2 with and without the ring (the JAX
dryrun's eight devices): each rank holds its shards and its part of a B 4
x T 12 batch. This process holds them to ``jax.value_and_grad`` of the JAX
package's ``layerskip_loss`` on one device, with JAX's own keep mask
(p_max 0.3), rotational exits at step 1, label smoothing 0.1 and a
16-token chunked CE, and two AdamW steps to optax's.

Tolerances are the single-device training tests' (tests/test_torch_training.py):
losses at rtol 1e-5, gradients (gathered whole with ``gather_params``) at
atol 2e-5 / rtol 2e-3, parameters after AdamW at atol 2e-6 / rtol 1e-5
where the step's gradient is above the gradients' atol, else within
Adam's own bound of lr a step. They hold although the collectives reorder
fp32 sums (the largest gradient error measured was 4.7e-6, on the MoE at
tp 2), so none is loosened to the sharded inference tests' atol 2e-4 /
rtol 1e-3 (tests/test_torch_parallel_tp.py).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import torch_train_mesh_ranks as R
from layerskip_tpu.config import tiny_config as jax_tiny_config
from layerskip_tpu.training import recipe as jrecipe
from layerskip_tpu_torch.config import tiny_config
from layerskip_tpu_torch.parallel.collectives import Axis, ShardContext
from layerskip_tpu_torch.parallel.mesh import make_train_mesh
from layerskip_tpu_torch.parallel.sharding import check_divisible
from test_torch_training import (
    _batch,
    _jax_loss_and_grads,
    _jax_params,
    _kw,
    _named_jax,
    _numpy_tree,
)

LOSS_TOL = dict(rtol=1e-5)
GRAD_TOL = dict(atol=2e-5, rtol=2e-3)
ADAM_TOL = dict(atol=2e-6, rtol=1e-5)
FAMILY = {"dense": "qwen2", "moe": "mixtral"}  # tests/test_torch_training.py's families
B, T = 4, 12
COMMON = dict(p_max=0.3, early_exit_layers=(1, 2, 3), e_scale=0.5, rotational_r=2,
              label_smoothing=0.1, ce_chunk_tokens=16)
ADAM = dict(learning_rate=1e-3, weight_decay=0.1)
CASES = [(suite, name, family) for suite, meshes in R.MESHES.items() for name in meshes
         for family in R.FAMILIES if not (meshes[name][3] and family == "moe")]


def _keep(key, nl):
    p_drop = 0.3 * jrecipe.depth_scale(jnp.arange(nl, dtype=jnp.int32), nl, "exp")
    return np.array(jax.random.uniform(key, (nl, B)) >= p_drop[:, None])


@pytest.fixture(scope="module")
def prepared():
    """The inputs every suite reads and the JAX references: loss, aux and
    gradients at step 1 (the key's mask drops samples), and two optax adamw
    steps with the gradients before each."""
    ids, labels = _batch(B, T, 128, seed=5)
    trees = {fam: _numpy_tree(FAMILY[fam], seed=6) for fam in R.FAMILIES}
    nl = 4
    key = next(k for k in (jax.random.PRNGKey(s) for s in range(100))
               if not _keep(k, nl).all())
    adam_keys = [jax.random.PRNGKey(20 + s) for s in range(2)]
    inputs = dict(cfg={fam: _kw(FAMILY[fam]) for fam in R.FAMILIES}, trees=trees, ids=ids,
                  labels=labels, keep=_keep(key, nl), tcfg=COMMON, adam=ADAM,
                  adam_keep=[_keep(k, nl) for k in adam_keys])
    refs = {}
    for fam in R.FAMILIES:
        jcfg = jax_tiny_config(**_kw(FAMILY[fam]))
        jtcfg = jrecipe.TrainConfig(**COMMON)
        aux, grads = _jax_loss_and_grads(_jax_params(trees[fam]), jcfg, jtcfg, ids, labels,
                                         key, 1)
        jtcfg = jrecipe.TrainConfig(**COMMON, **ADAM)
        jstep, jinit = jrecipe.make_train_step(jcfg, jtcfg)
        jstep = jax.jit(jstep)
        jp = _jax_params(trees[fam])
        jopt = jinit(jp)
        steps = []
        for step, k in enumerate(adam_keys):
            _, g = _jax_loss_and_grads(jp, jcfg, jtcfg, ids, labels, k, step)
            jp, jopt, saux = jstep(jp, jopt, jnp.asarray(ids, jnp.int32),
                                   jnp.asarray(labels, jnp.int32), k, jnp.int32(step))
            steps.append(dict(loss=float(saux["loss"]), grads=_named_jax(g),
                              params=_named_jax(jp)))
        refs[fam] = dict(aux=aux, grads=_named_jax(grads), steps=steps)
    return inputs, refs


@pytest.fixture(scope="module")
def results(prepared, tmp_path_factory):
    inputs, _ = prepared
    out = {}
    for suite, n in (("mesh2", 2), ("mesh4", 4), ("mesh8", 8)):
        out[suite] = R.run_suite(suite, n, str(tmp_path_factory.mktemp(suite)), inputs)
    return out


def _local_shapes(family, dp, fsdp, tp):
    """The shards a rank holds: L/fsdp layers, Megatron slices over tp."""
    cfg = tiny_config(**_kw(FAMILY[family]))
    l, d, f, v = (cfg.num_hidden_layers // fsdp, cfg.hidden_size, cfg.intermediate_size,
                  cfg.vocab_size)
    hq, hkv = cfg.num_attention_heads * cfg.head_dim, cfg.num_key_value_heads * cfg.head_dim
    want = {"embed": (v // tp, d), "final_norm": (d,), "lm_head": (d, v // tp),
            "layers.wq": (l, hq // tp, d), "layers.wk": (l, hkv // tp, d),
            "layers.wo": (l, hq // tp, d), "layers.attn_norm": (l, d)}
    if family == "moe":
        e = cfg.num_local_experts
        want.update({"layers.w_gate": (l, e, d, f // tp), "layers.w_down": (l, e, f // tp, d),
                     "layers.w_router": (l, d, e)})
    else:
        want.update({"layers.w_gate": (l, d, f // tp), "layers.w_down": (l, f // tp, d),
                     "layers.bq": (l, hq // tp)})
    return want


@pytest.mark.parametrize("suite,name,family", CASES)
def test_loss_and_grads_equal_jax(prepared, results, suite, name, family):
    _, refs = prepared
    ref = refs[family]
    dp, fsdp, tp, _ = R.MESHES[suite][name]
    ranks = results[suite]
    for r in ranks:
        got = r[(name, family)]
        for key in ("loss", "final_loss", "exit_losses", "exit_weights", "moe_aux"):
            np.testing.assert_allclose(got["aux"][key].numpy(), np.asarray(ref["aux"][key]),
                                       err_msg=f"{name}/{family}: {key}", **LOSS_TOL)
        assert torch.equal(got["aux"]["loss"], ranks[0][(name, family)]["aux"]["loss"])
        assert set(got["grads"]) == set(ref["grads"])
        for k, g in got["grads"].items():
            np.testing.assert_allclose(g.numpy(), np.asarray(ref["grads"][k]),
                                       err_msg=f"{name}/{family}: grad of {k}", **GRAD_TOL)
        for k, shape in _local_shapes(family, dp, fsdp, tp).items():
            assert got["shapes"][k] == shape, (name, family, k)
    calls = ranks[0][(name, family)]["calls"]
    assert (calls["broadcast_from"] > 0) == (fsdp > 1)  # a layer from its owner
    assert (calls["ring_shift"] > 0) == R.MESHES[suite][name][3]


@pytest.mark.parametrize("suite,name,family", CASES)
def test_two_adamw_steps_equal_optax(prepared, results, suite, name, family):
    """Each step's loss, and the whole params after it (gathered), against
    the JAX package's ``make_train_step``; a weight whose gradient is
    below GRAD_TOL's atol in some step is held to Adam's own bound, lr a
    step, as in tests/test_torch_training.py."""
    _, refs = prepared
    lr = ADAM["learning_rate"]
    for r in results[suite]:
        got = r[(name, family)]
        small = {}
        for step, ref in enumerate(refs[family]["steps"]):
            np.testing.assert_allclose(got["losses"][step], ref["loss"], **LOSS_TOL)
            for k, w in got["after"][step].items():
                grad = np.asarray(ref["grads"][k])
                small[k] = small.get(k, False) | (np.abs(grad) < GRAD_TOL["atol"])
                want, w = np.asarray(ref["params"][k]), w.numpy()
                np.testing.assert_allclose(w[~small[k]], want[~small[k]],
                                           err_msg=f"{name}/{family} step {step}: {k}",
                                           **ADAM_TOL)
                assert np.all(np.abs(w - want) <= lr * (step + 1) * 2 + ADAM_TOL["atol"]), k


def test_inference_era_collectives_give_wrong_tp_gradients(prepared, results):
    """The fault this slice repairs: at tp 2 the port's inference-time
    all-gather (fresh buffers) cuts the loss from every weight, and its
    all-reduce without Megatron's f (identity backward, no summed
    gradient in front of the column-parallel products) leaves the
    replicated weights' gradients partial sums, far off JAX's; the
    differentiable collectives match (test_loss_and_grads_equal_jax)."""
    ref = prepared[1]["dense"]["grads"]
    for r in results["mesh2"]:
        old = r["inference_era_tp2"]
        assert old["old_gather"] == {"requires_grad": False}
        grads = old["old_reduce"]["grads"]
        for k in ("embed", "final_norm", "layers.attn_norm", "layers.mlp_norm"):
            err = np.abs(grads[k].numpy() - np.asarray(ref[k])).max()
            assert err > 100 * GRAD_TOL["atol"], (k, err)
        good = r[("tp2", "dense")]["grads"]
        for k in ("embed", "final_norm", "layers.attn_norm", "layers.mlp_norm"):
            np.testing.assert_allclose(good[k].numpy(), np.asarray(ref[k]), **GRAD_TOL)


def _ctx(**sizes):
    return ShardContext(**{k: Axis(group=None, size=n, rank=0) for k, n in sizes.items()})


@pytest.mark.parametrize("kw,ctx_kw,what", [
    (dict(), dict(fsdp=3), "num_hidden_layers=4 does not divide by fsdp=3"),
    (dict(seq=10), dict(fsdp=4), "seq_len=10 does not divide by fsdp=4"),
    (dict(batch=3), dict(dp=2), "batch_size=3 does not divide by dp=2"),
])
def test_what_the_mesh_would_pad_is_refused(kw, ctx_kw, what):
    with pytest.raises(ValueError, match=what):
        check_divisible(tiny_config(), _ctx(**ctx_kw), **kw)


def test_train_mesh_needs_its_ranks():
    """One process is no world of 2 (the JAX package's words)."""
    with pytest.raises(ValueError, match=r"dp\*fsdp\*tp=2 != #devices=1"):
        make_train_mesh(1, 2, 1, device_type="cpu")
    assert make_train_mesh(1, 1, 1, device_type="cpu") is None

