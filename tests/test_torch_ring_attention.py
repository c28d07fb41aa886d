"""The port's ring attention (``ops/ring_attention.py``) against the JAX
package's, on the CPU in fp32.

Two and four gloo ranks started by the port's launcher
(tests/torch_train_mesh_ranks.py, suite ``ring``) run
``ring_attention_sharded`` on the same global q/k/v and take dq, dk and dv
of ``sum(out * cot)``; this process holds them to JAX's
``ring_attention_sharded`` on a 2- and 4-device CPU mesh and to dense
``gqa_attention`` at atol/rtol 2e-5 (the JAX ring test's own bound,
tests/test_ring_attention.py), and the gradients to ``jax.grad`` through
JAX's ring at atol 2e-5 / rtol 2e-3 (the training tests' gradient bound,
tests/test_torch_training.py).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh

import torch_train_mesh_ranks as R
from layerskip_tpu.ops.attention import gqa_attention as jgqa_attention
from layerskip_tpu.ops.ring_attention import ring_attention_sharded as jring
from layerskip_tpu_torch.ops.ring_attention import ring_attention, ring_attention_sharded

OUT_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=2e-5, rtol=2e-3)
B, T, HKV, G, DH = 2, 16, 2, 2, 16


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(q=n(B, T, HKV * G, DH), k=n(B, T, HKV, DH), v=n(B, T, HKV, DH),
                cot=n(B, T, HKV * G, DH), rs_x=n(4, 8, 3), rs_cot=n(4, 8, 3))


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, inputs, tmp_path_factory):
    """(n, every rank's results, JAX's ring output and dq/dk/dv on n devices)."""
    n = request.param
    res = R.run_suite("ring", n, str(tmp_path_factory.mktemp(f"ring{n}")), inputs)
    mesh = Mesh(np.asarray(jax.devices()[:n]), axis_names=("sp",))
    q, k, v, cot = (jnp.asarray(inputs[x]) for x in ("q", "k", "v", "cot"))

    def loss(q, k, v):
        out = jring(q, k, v, mesh, axis="sp")
        return jnp.sum(out * cot), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        q, k, v)
    return n, res, np.asarray(out), [np.asarray(g) for g in grads]


def test_ring_equals_jax_ring_and_dense(inputs, ranks):
    n, res, want, _ = ranks
    dense = np.asarray(jgqa_attention(
        jnp.asarray(inputs["q"]), jnp.asarray(inputs["k"]), jnp.asarray(inputs["v"]),
        jnp.arange(T, dtype=jnp.int32), q_heads_per_kv=G))
    for r in res:
        np.testing.assert_allclose(r["out"].numpy(), want, **OUT_TOL)
        np.testing.assert_allclose(r["out"].numpy(), dense, **OUT_TOL)
        assert torch.equal(r["out"], res[0]["out"])
        # n - 1 hops of K and of V forward, as many back
        assert r["shifts"] == 4 * (n - 1)


def test_ring_gradients_equal_jax(inputs, ranks):
    _, res, _, want = ranks
    for r in res:
        for name, w in zip(("dq", "dk", "dv"), want):
            np.testing.assert_allclose(r[name].numpy(), w, err_msg=name, **GRAD_TOL)


def test_reduce_scatter_and_its_gradient(inputs, ranks):
    """Rank r gets rows [r * 8/n, (r + 1) * 8/n) of the ranks' summed rows;
    the gradient of each rank's rows is every rank's cotangent, gathered
    (the loss is the sum of the ranks' parts)."""
    n, res, _, _ = ranks
    rows = 8 // n
    total = inputs["rs_x"][:n].sum(axis=0)
    grad = np.concatenate([inputs["rs_cot"][r][:rows] for r in range(n)])
    for r, got in enumerate(res):
        np.testing.assert_allclose(got["rs_y"].numpy(), total[r * rows:(r + 1) * rows],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got["rs_grad"].numpy(), grad)


def test_ring_without_an_axis_is_causal_attention(inputs):
    """A world of one (no axis): the ring's single block is plain causal
    attention."""
    q, k, v = (torch.from_numpy(inputs[x]) for x in ("q", "k", "v"))
    got = ring_attention(q, k, v, None)
    want = jgqa_attention(jnp.asarray(inputs["q"]), jnp.asarray(inputs["k"]),
                          jnp.asarray(inputs["v"]), jnp.arange(T, dtype=jnp.int32),
                          q_heads_per_kv=G)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)


@pytest.mark.parametrize("kw,what", [(dict(window=4), "window=4"),
                                     (dict(logit_softcap=50.0), "softcap=50.0"),
                                     (dict(score_scale=0.125), "score_scale=0.125")])
def test_ring_refuses_window_softcap_and_query_scale(inputs, kw, what):
    q, k, v = (torch.from_numpy(inputs[x]) for x in ("q", "k", "v"))
    for fn in (ring_attention, ring_attention_sharded):
        with pytest.raises(ValueError, match=what):
            fn(q, k, v, None, **kw)
