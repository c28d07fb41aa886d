"""The port's sharded inference over four ranks and its refusals, on the
CPU.

Four gloo ranks started by the port's launcher (tests/torch_parallel_ranks.py,
suite ``w4``) run the forward at tp 4 and at dp 2 x tp 2, AR with the KV
sequence over sp 2 and the weights over tp 2, and a Mixtral-style MoE at ep
2 x tp 2; this process holds them to the JAX package's sharded runs on the
8 virtual CPU devices of conftest.py (logits within the JAX sharding test's
atol 2e-4 / rtol 1e-3, streams and counters equal).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_parallel_ranks as R
from layerskip_tpu.config import GenerationConfig as JGenerationConfig
from layerskip_tpu.config import tiny_config as jax_tiny_config
from layerskip_tpu.generation.engine import Engine as JEngine
from layerskip_tpu.generation.engine import postprocess_batch as jpost_batch
from layerskip_tpu.generation.engine import postprocess_output as jpost
from layerskip_tpu.models import llama as jllama
from layerskip_tpu.models.llama import LayerParams as JLayerParams
from layerskip_tpu.models.llama import LlamaParams as JLlamaParams
from layerskip_tpu.ops.kv_cache import init_kv_cache as jinit_kv_cache
from layerskip_tpu.parallel.mesh import make_mesh as jmake_mesh
from layerskip_tpu.parallel.sharding import shard_params as jshard_params
from layerskip_tpu_torch.config import tiny_config
from layerskip_tpu_torch.parallel.collectives import Axis, ShardContext
from layerskip_tpu_torch.parallel.sharding import check_divisible


def jax_model(inputs, name):
    c, tree = inputs["cfg"][name], inputs["trees"][name]
    cfg = dataclasses.replace(jax_tiny_config(**c["sizes"]), **c.get("extra", {}))
    params = JLlamaParams(
        embed=jnp.asarray(tree["embed"]),
        layers=JLayerParams(**{k: jnp.asarray(v) for k, v in tree["layers"].items()}),
        final_norm=jnp.asarray(tree["final_norm"]), lm_head=jnp.asarray(tree["lm_head"]))
    return cfg, params


def jax_stream(eng, prompt, **kw):
    out = eng.generate(prompt, JGenerationConfig(**{**dict(max_steps=12, sample=False), **kw}),
                       jax.random.PRNGKey(0), eos_ids=R.EOS)
    return jpost(out, R.EOS, 12), int(out.matches), int(out.drafts)


@pytest.fixture(scope="module")
def inputs():
    return R.build_inputs()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return R.run_suite("w4", 4, str(tmp_path_factory.mktemp("w4")))


@pytest.mark.parametrize("key,dp,tp", [("forward_tp4", 1, 4), ("forward_dp2tp2", 2, 2)])
def test_sharded_forward_matches_jax_sharded(inputs, ranks, key, dp, tp):
    """The logits of B 2 x T 16 (under dp each dp group's row, gathered)."""
    cfg, params = jax_model(inputs, "main")
    mesh = jmake_mesh(dp=dp, tp=tp, devices=jax.devices()[:dp * tp])
    ids = jax.device_put(jnp.asarray(inputs["ids"].numpy()), NamedSharding(mesh, P("dp", None)))
    kv = jax.tree.map(lambda x: jax.device_put(
        x, NamedSharding(mesh, P(None, "dp", None, "tp", None))),
        jinit_kv_cache(cfg, batch=2, max_len=32))
    fn = jax.jit(lambda p, i, c: jllama.forward(p, cfg, i, c, jnp.int32(0)))
    want = np.asarray(fn(jshard_params(params, mesh), ids, kv).logits)
    for r in ranks:
        np.testing.assert_allclose(r[key].numpy(), want, atol=2e-4, rtol=1e-3)
        assert torch.equal(r[key], ranks[0][key])


def test_dp2_tp2_batch_generate_equals_jax(inputs, ranks):
    """Each dp group runs one row of a B 2 spec generation; every rank
    returns both rows and the summed counters."""
    cfg, params = jax_model(inputs, "main")
    out = JEngine(params, cfg).generate(
        inputs["session_prompts"][:2],
        JGenerationConfig(max_steps=12, sample=False, **R.SPEC), jax.random.PRNGKey(0),
        eos_ids=R.EOS)
    want = (jpost_batch(out, R.EOS, 12), int(out.matches), int(out.drafts))
    for r in ranks:
        assert r["dp2tp2_batch"] == want


def test_sp2_tp2_ar_equals_jax(inputs, ranks):
    cfg, params = jax_model(inputs, "main")
    want = jax_stream(JEngine(params, cfg), inputs["prompt"])
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("sp", "tp"))
    got = jax_stream(JEngine(jshard_params(params, mesh), cfg, mesh=mesh, kv_shard_axis="sp"),
                     inputs["prompt"])
    assert got == want
    for r in ranks:
        assert r["sp2tp2"]["ar"] == want


@pytest.mark.parametrize("name", ["ar", "spec"])
def test_moe_ep2_tp2_streams_equal_jax(inputs, ranks, name):
    """Each rank holds 2 of the 4 experts with half their features."""
    cfg, params = jax_model(inputs, "moe")
    kw = R.STREAMS[name]
    want = jax_stream(JEngine(params, cfg), inputs["prompt"], **kw)
    mesh = jmake_mesh(dp=1, tp=2, ep=2, devices=jax.devices()[:4])
    assert jax_stream(JEngine(jshard_params(params, mesh), cfg), inputs["prompt"], **kw) == want
    for r in ranks:
        assert r["ep2tp2"][name] == want
        assert r["moe_shapes"] == ((4, 2, 64, 64), (4, 2, 64, 64))


def _ctx(**sizes):
    return ShardContext(**{k: Axis(group=None, size=n, rank=0) for k, n in sizes.items()})


@pytest.mark.parametrize("cfg_kw,ctx_kw,what", [
    (dict(num_attention_heads=6, num_key_value_heads=2, hidden_size=48), dict(tp=4),
     "num_attention_heads=6"),
    (dict(num_key_value_heads=2), dict(tp=4), "num_key_value_heads=2"),
    (dict(num_attention_heads=8, num_key_value_heads=4, intermediate_size=102), dict(tp=4),
     "intermediate_size=102"),
    (dict(num_local_experts=3, num_experts_per_tok=2), dict(ep=2), "num_local_experts=3"),
])
def test_counts_the_axis_does_not_divide_are_refused(cfg_kw, ctx_kw, what):
    with pytest.raises(ValueError, match=what):
        check_divisible(tiny_config(**cfg_kw), _ctx(**ctx_kw))


def test_quantize_with_tp_and_the_training_mesh_are_refused(tmp_path):
    from layerskip_tpu_torch.cli import train
    from layerskip_tpu_torch.cli.args import Arguments
    from layerskip_tpu_torch.cli.loading import load_model_and_tokenizer

    with pytest.raises(ValueError, match="--quantize requires dp=tp=1"):
        load_model_and_tokenizer("random:tiny", tp=2, quantize="int8", device="cpu")
    with pytest.raises(ValueError, match="!= #devices=1"):  # one process is no tp 2
        load_model_and_tokenizer("random:tiny", tp=2, device="cpu")
    data = tmp_path / "d.jsonl"
    data.write_text('{"prompt": "ab", "response": "cd"}\n')
    targs = train.TrainArguments(dataset="custom_jsonl", data_path=str(data), steps=1,
                                 batch_size=1, seq_len=16, fsdp=2)
    # the training mesh runs now (tests/test_torch_train_cli_mesh.py): one
    # process is no fsdp 2 mesh
    with pytest.raises(ValueError, match="!= #devices=1"):
        train.main(Arguments(model="random:tiny", device="cpu"), targs)
