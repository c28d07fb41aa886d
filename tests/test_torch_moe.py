"""The PyTorch port's mixture-of-experts MLP (``ops/moe.py``) against the JAX
package's, on the CPU in fp32: routing, each execution path (``few``,
``dense``, ``grouped``) with dense, int8 and int4 experts, the automatic
path rule, and the int8/int4 bases' greedy streams of Mixtral and Qwen3-MoE
models equal to the JAX engine's.

Outputs of one path agree with the JAX package's at atol 1e-5 / rtol 1e-5
(tests/test_moe.py's bound between the JAX paths); routing weights at
1e-6 and expert ids exactly. Model streams and counters are EQUAL.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from layerskip_tpu import quant as jquant
from layerskip_tpu.config import GenerationConfig as JGenerationConfig
from layerskip_tpu.generation.engine import Engine as JEngine
from layerskip_tpu.ops import moe as jmoe
from layerskip_tpu_torch import quant as tquant
from layerskip_tpu_torch.config import GenerationConfig
from layerskip_tpu_torch.generation.engine import Engine
from layerskip_tpu_torch.ops import moe as tmoe
from layerskip_tpu_torch.ops.linear import QuantTensor
from test_torch_families import (  # noqa: F401 (an autouse fixture)
    EOS, PROMPT, _gen, _models, _one_torch_thread)

PATH_TOL = dict(atol=1e-5, rtol=1e-5)
D, F, E, K = 32, 48, 4, 2


def _experts(seed=0, std=0.3):
    rng = np.random.default_rng(seed)
    n = lambda *s: (rng.standard_normal(s) * std).astype(np.float32)  # noqa: E731
    return dict(w_router=n(D, E) * 3, w_gate=n(E, D, F), w_up=n(E, D, F), w_down=n(E, F, D))


def _as_port(w):
    """A JAX array or QuantTensor as the port's tensor or QuantTensor."""
    if hasattr(w, "q"):
        return QuantTensor(q=torch.from_numpy(np.array(w.q)),
                           scale=torch.from_numpy(np.array(w.scale)),
                           k_last=bool(w.k_last), group=int(w.group))
    return torch.from_numpy(np.array(w))


def _weights(bits):
    """The experts of ``_experts`` in both packages; ``bits`` 8 or 4
    quantizes the three stacks with the JAX package's ``quantize_tensor``."""
    w = {k: jnp.asarray(v) for k, v in _experts().items()}
    if bits:
        for f in ("w_gate", "w_up", "w_down"):
            w[f] = jquant.quantize_tensor(w[f], bits=bits, group=16 if bits == 4 else 0)
    return w, {k: _as_port(v) for k, v in w.items()}


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal((*shape, D)).astype(np.float32)


def _jax_moe(x, w, impl, norm_topk=True):
    """The JAX package's ``moe_mlp`` with its path forced by its environment
    switch (read when the function runs)."""
    old = os.environ.get("LAYERSKIP_MOE_IMPL")
    os.environ["LAYERSKIP_MOE_IMPL"] = impl
    try:
        return jmoe.moe_mlp(jnp.asarray(x), w["w_router"], w["w_gate"], w["w_up"],
                            w["w_down"], K, norm_topk=norm_topk)
    finally:
        if old is None:
            del os.environ["LAYERSKIP_MOE_IMPL"]
        else:
            os.environ["LAYERSKIP_MOE_IMPL"] = old


@pytest.mark.parametrize("norm_topk", [True, False])
def test_route_equals_jax(norm_topk):
    w = _experts()
    x2 = _x((40,)).reshape(40, D)
    jv, ji, jaux = jmoe.route(jnp.asarray(x2), jnp.asarray(w["w_router"]), K, norm_topk)
    tv, ti, taux = tmoe.route(torch.from_numpy(x2), torch.from_numpy(w["w_router"]), K,
                              norm_topk)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    if norm_topk:
        np.testing.assert_allclose(tv.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("bits", [0, 8, 4], ids=["dense", "int8", "int4"])
@pytest.mark.parametrize("impl", ["few", "dense", "grouped"])
@pytest.mark.parametrize("shape", [(3, 40), (1, 1), (1, 37)])
def test_each_path_equals_jax(shape, impl, bits):
    """Each path, called directly, on dense, int8 and int4 experts: the
    output and the load-balancing term equal the JAX package's same path
    (forced by its environment switch). (1, 1) is the decode shape, (3, 40)
    a short prompt, (1, 37) a token count that is no multiple of 8."""
    jw, tw = _weights(bits)
    x = _x(shape)
    jout, jaux = _jax_moe(x, jw, impl)
    x2 = torch.from_numpy(x).reshape(-1, D)
    topv, topi, taux = tmoe.route(x2, tw["w_router"], K)
    args = (x2, topv, topi, tw["w_gate"], tw["w_up"], tw["w_down"])
    tout = {"few": lambda: tmoe._moe_few(*args, K),
            "dense": lambda: tmoe._moe_dense(*args, E),
            "grouped": lambda: tmoe._moe_grouped(*args, E, K)}[impl]().reshape(x.shape)
    assert tout.dtype == torch.float32
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **PATH_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("split", ["whole", "ep", "tp"])
def test_dense_path_copies_no_expert_stack(split):
    """The ``dense`` path reads the bf16 expert stacks as they lie: no
    ``copy_``, ``clone`` or ``contiguous`` in the call has an input as large
    as a stack, for the whole stack, an ep rank's half of the experts
    (``e0``) and a tp rank's half of F (contiguous, as ``shard_params``
    cuts it). Tokens fewer than D keep the broadcast tokens [E, N, D] and
    the activations [N, E*F] under a stack's size."""
    d, f, n = 64, 96, 40
    g = torch.Generator().manual_seed(0)
    mk = lambda *s: torch.randn(s, generator=g).bfloat16()  # noqa: E731
    w_gate, w_up, w_down = mk(E, d, f), mk(E, d, f), mk(E, f, d)
    e0 = None
    if split == "ep":
        e0 = E // 2
        w_gate, w_up, w_down = w_gate[e0:], w_up[e0:], w_down[e0:]
    elif split == "tp":
        w_gate, w_up = w_gate[..., :f // 2].contiguous(), w_up[..., :f // 2].contiguous()
        w_down = w_down[:, :f // 2].contiguous()
    x2 = mk(n, d)
    topv, topi, _ = tmoe.route(x2, mk(d, E), K)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                record_shapes=True) as prof:
        out = tmoe._moe_dense(x2, topv, topi, w_gate, w_up, w_down, E, e0)
    assert out.shape == (n, d) and out.dtype == torch.bfloat16
    events = prof.events()
    assert any(ev.name in ("aten::bmm", "aten::mm") for ev in events)
    stack = w_gate.numel()
    copies = [(ev.name, ev.input_shapes) for ev in events
              if ev.name in ("aten::copy_", "aten::clone", "aten::contiguous")
              and any(isinstance(s, list) and all(isinstance(i, int) for i in s)
                      and np.prod(s, dtype=np.int64) >= stack for s in ev.input_shapes)]
    assert not copies, copies


@pytest.mark.parametrize("shape,path", [((1, 1), "few"), ((3, 40), "dense"),
                                        ((1, 2048), "grouped"), ((2, 1024), "grouped")])
def test_auto_takes_the_jax_path(shape, path):
    """``moe_mlp`` takes the JAX package's path (few when n*k < E, grouped
    from 2048 tokens, dense between), counts it, and equals its result."""
    jw, tw = _weights(0)
    x = _x(shape, seed=2)
    tmoe.reset_path_calls()
    tout, _ = tmoe.moe_mlp(torch.from_numpy(x), tw["w_router"], tw["w_gate"], tw["w_up"],
                           tw["w_down"], K)
    assert tmoe.PATH_CALLS[path] == 1 and sum(tmoe.PATH_CALLS.values()) == 1
    jout, _ = _jax_moe(x, jw, "auto")
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **PATH_TOL)


def test_environment_switch_is_ignored(monkeypatch):
    """The port reads no environment variable: the JAX package's
    ``LAYERSKIP_MOE_IMPL`` leaves the path to the size rule."""
    _, tw = _weights(0)
    monkeypatch.setenv("LAYERSKIP_MOE_IMPL", "dense")
    tmoe.reset_path_calls()
    tmoe.moe_mlp(torch.from_numpy(_x((1, 1))), tw["w_router"], tw["w_gate"], tw["w_up"],
                 tw["w_down"], K)
    assert tmoe.PATH_CALLS == {"few": 1, "dense": 0, "grouped": 0}


def test_quantize_keeps_router_and_quantizes_experts_per_layer():
    """int8 quantization of an MoE model: expert stacks [L, E, D, F] become
    QuantTensors bit-equal to the JAX package's, with scales per (expert,
    output channel); the router, norms and absent fields stay as they are."""
    jcfg, jp, cfg, tp = _models("qwen3moe")
    jq = jquant.quantize_llama_params(jp, bits=8)
    tq = tquant.quantize_llama_params(tp, bits=8)
    for f in ("w_gate", "w_up", "w_down"):
        got, want = getattr(tq.layers, f), getattr(jq.layers, f)
        assert isinstance(got, QuantTensor) and got.scale.shape == (4, 4, cfg.hidden_size
                                                                   if f == "w_down" else 96)
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert tq.layers.w_router.data_ptr() == tp.layers.w_router.data_ptr()  # a view
    assert torch.equal(tq.layers.w_router, tp.layers.w_router) and tq.layers.bq is None
    assert torch.equal(tq.layers.q_norm, tp.layers.q_norm)
    drafter = tquant.quantize_draft_params(tp, 2, bits=4)
    assert drafter.layers.w_router.shape[0] == 2 and drafter.layers.w_gate.q.shape[0] == 2
    assert tquant.quantized_bytes(tq) < tquant.quantized_bytes(tp)


@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
@pytest.mark.parametrize("family", ["mixtral", "qwen3moe"])
def test_quantized_base_streams_equal_jax(family, bits):
    """An int8 (int4) base of the MoE families: greedy AR and self-spec
    streams and counters equal the JAX engine's on its own quantized base
    (decode steps take the ``few`` path through the K4-K7 wrappers' plain
    versions, verify windows ``dense``); spec == AR."""
    jcfg, jp, cfg, tp = _models(family)
    je = JEngine(jquant.quantize_llama_params(jp, bits=bits), jcfg)
    te = Engine(tquant.quantize_llama_params(tp, bits=bits), cfg, device="cpu")
    streams = []
    tmoe.reset_path_calls()
    for strategy in ("autoregressive", "self_speculative"):
        jout = je.generate(PROMPT, _gen(JGenerationConfig, strategy, max_steps=12),
                           jax.random.PRNGKey(0), eos_ids=EOS)
        tout = te.generate(PROMPT, _gen(GenerationConfig, strategy, max_steps=12),
                           eos_ids=EOS)
        n = int(np.asarray(jout.num_tokens)[0])
        np.testing.assert_array_equal(tout.tokens[0, :n].numpy(),
                                      np.asarray(jout.tokens)[0, :n])
        assert (int(tout.num_tokens[0]), int(tout.matches), int(tout.drafts)) == (
            n, int(jout.matches), int(jout.drafts))
        streams.append(tout.tokens[0, :12].tolist())
    assert streams[0] == streams[1]
    assert tmoe.PATH_CALLS["few"] > 0 and tmoe.PATH_CALLS["dense"] > 0
