"""The port's tensor- and sequence-sharded inference at tp 2 and sp 2 on
the CPU, against the JAX package.

Two gloo ranks started by the port's launcher (tests/torch_parallel_ranks.py,
suite ``w2``) run the sharded forward, greedy streams (AR, spec, tree k 3,
the int8 and int4 drafters), sequence-sharded AR and spec, a sampled spec
stream and three continuous sessions; this process holds their results to
the JAX package's single-device and sharded runs on the 8 virtual CPU
devices of conftest.py. Logits within the JAX sharding test's tolerance
(atol 2e-4, rtol 1e-3); streams, counters and drafters equal.
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
from layerskip_tpu.generation.engine import postprocess_output as jpost
from layerskip_tpu.models import llama as jllama
from layerskip_tpu.models.llama import LayerParams as JLayerParams
from layerskip_tpu.models.llama import LlamaParams as JLlamaParams
from layerskip_tpu.ops.kv_cache import init_kv_cache as jinit_kv_cache
from layerskip_tpu.parallel.mesh import make_mesh as jmake_mesh
from layerskip_tpu.parallel.sharding import shard_params as jshard_params
from layerskip_tpu_torch.models.params import params_from_numpy
from layerskip_tpu_torch.quant import quantize_draft_params


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
    return R.run_suite("w2", 2, str(tmp_path_factory.mktemp("w2")))


@pytest.fixture(scope="module")
def jax_engines(inputs):
    """name -> (single-device engine, tp 2 engine) of the JAX package."""
    tp2 = jmake_mesh(dp=1, tp=2, devices=jax.devices()[:2])
    out = {}
    for name in ("main", "quant"):
        cfg, params = jax_model(inputs, name)
        out[name] = (JEngine(params, cfg), JEngine(jshard_params(params, tp2), cfg))
    return out


def test_tp2_forward_matches_jax_sharded(inputs, ranks):
    cfg, params = jax_model(inputs, "main")
    ids = jnp.asarray(inputs["ids"].numpy())
    mesh = jmake_mesh(dp=1, tp=2, devices=jax.devices()[:2])
    kv = jax.tree.map(lambda x: jax.device_put(
        x, NamedSharding(mesh, P(None, "dp", None, "tp", None))),
        jinit_kv_cache(cfg, batch=2, max_len=32))
    fn = jax.jit(lambda p, i, c: jllama.forward(p, cfg, i, c, jnp.int32(0)))
    want = np.asarray(fn(jshard_params(params, mesh), ids, kv).logits)
    for r in ranks:
        np.testing.assert_allclose(r["forward_tp2"].numpy(), want, atol=2e-4, rtol=1e-3)
    assert torch.equal(ranks[0]["forward_tp2"], ranks[1]["forward_tp2"])


@pytest.mark.parametrize("field,dim", [("wq", 1), ("wk", 1), ("wo", 1), ("w_gate", 2),
                                       ("w_down", 1), ("embed", 0), ("lm_head", 1)])
def test_shard_params_local_shapes_contiguity_and_round_trip(inputs, ranks, field, dim):
    """Each rank holds a contiguous half of the split dim; the halves in
    rank order are the whole weight."""
    tree = inputs["trees"]["main"]
    full = torch.from_numpy(tree[field] if field in tree else tree["layers"][field])
    parts = [r["shards"][field] for r in ranks]
    for p in parts:
        want = list(full.shape)
        want[dim] //= 2
        assert list(p.shape) == want and p.is_contiguous()
    assert torch.equal(torch.cat(parts, dim=dim), full)
    assert all(r["contiguous"] for r in ranks)


@pytest.mark.parametrize("name", ["ar", "spec", "tree3", "draft8"])
def test_tp2_streams_equal_jax(inputs, ranks, jax_engines, name):
    single, sharded = jax_engines["main"]
    kw = R.STREAMS[name]
    want = jax_stream(single, inputs["prompt"], **kw)
    assert jax_stream(sharded, inputs["prompt"], **kw) == want
    for r in ranks:
        assert r["tp2"][name] == want


@pytest.mark.parametrize("name", ["draft8", "draft4"])
def test_tp2_quantized_drafter_streams_equal_jax(inputs, ranks, jax_engines, name):
    """On a model whose wo/w_down K slices hold whole int4 groups of 128."""
    single, sharded = jax_engines["quant"]
    kw = R.STREAMS[name]
    want = jax_stream(single, inputs["prompt"], **kw)
    assert jax_stream(sharded, inputs["prompt"], **kw) == want
    for r in ranks:
        assert r["quant_tp2"][name] == want


def _slice(t, dim, rank):
    n = t.shape[dim] // 2
    return t.narrow(dim, rank * n, n)


# (field, dim of q split, dim of the scale split or None): int8 scales drop K
_DRAFT8 = [("wq", 1, 1), ("wo", 1, None), ("w_gate", 2, 1), ("w_down", 1, None),
           ("lm_head", 1, 0)]
_DRAFT4 = [("wq", 1, 1), ("wo", 1, 1), ("w_gate", 2, 2), ("w_down", 1, 1),
           ("lm_head", 1, 1)]


@pytest.mark.parametrize("bits", [8, 4])
def test_tp_drafter_is_the_single_device_drafters_slice(inputs, ranks, bits):
    """Quantized from the rank's shards under tp (the int8 absmax of the
    row-parallel wo/w_down all-reduced MAX), each rank's drafter is the
    single-device drafter's slice, bit for bit."""
    name, key, fields = ("main", "drafter8", _DRAFT8) if bits == 8 else \
        ("quant", "drafter4", _DRAFT4)
    full = params_from_numpy(inputs["trees"][name], device="cpu")
    whole = quantize_draft_params(full, 2, bits=bits, group=0 if bits == 8 else 128,
                                  quantize_head=True)
    for rank, r in enumerate(ranks):
        for field, qdim, sdim in fields:
            w = whole.lm_head if field == "lm_head" else getattr(whole.layers, field)
            got = r[key][field]
            assert torch.equal(got["q"], _slice(w.q, qdim, rank)), field
            want_scale = w.scale if sdim is None else _slice(w.scale, sdim, rank)
            assert torch.equal(got["scale"], want_scale), field
            assert got["group"] == w.group


def test_per_rank_absmax_is_not_the_single_device_drafter(inputs, ranks):
    """Quantized with each rank's own absmax over its K slice, the
    row-parallel weights' scales differ from the single-device drafter's:
    the fault the all-reduce MAX removes."""
    full = params_from_numpy(inputs["trees"]["main"], device="cpu")
    whole = quantize_draft_params(full, 2, bits=8, group=0, quantize_head=True)
    for r in ranks:
        for field in ("wo", "w_down"):
            assert not torch.equal(r["drafter8"]["naive"][field]["scale"],
                                   getattr(whole.layers, field).scale)


def test_int4_group_straddling_a_shard_is_refused(ranks):
    """wo's K of 64 makes one int4 group of 64; at tp 2 a rank holds half."""
    for r in ranks:
        assert "straddles a tp shard" in r["draft4_refused"]


@pytest.mark.parametrize("name", ["ar", "spec"])
def test_sp2_streams_equal_jax(inputs, ranks, jax_engines, name):
    cfg, params = jax_model(inputs, "main")
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("sp",))
    kw = R.STREAMS[name]
    want = jax_stream(jax_engines["main"][0], inputs["prompt"], **kw)
    assert jax_stream(JEngine(params, cfg, mesh=mesh, kv_shard_axis="sp"),
                      inputs["prompt"], **kw) == want
    for r in ranks:
        assert r["sp2"][name] == want


def test_sampled_spec_stream_is_the_same_on_every_rank(ranks):
    assert len(ranks[0]["sampled"]) == 12
    assert ranks[0]["sampled"] == ranks[1]["sampled"]


def _jax_serve(eng, inputs, name):
    g, kw, chunked = R.SESSIONS[name]
    sess = eng.continuous_session(
        JGenerationConfig(**{**dict(max_steps=12, sample=False), **g}), 2, 16, R.EOS, **kw)
    return R.serve(sess, inputs["session_prompts"], inputs["budgets"], chunked)


@pytest.mark.parametrize("name", ["paged_tree_prefix", "paged_tree_prefix_q8", "chunked"])
def test_tp2_sessions_equal_jax_served_streams(inputs, ranks, jax_engines, name):
    """Paged + prefix cache + tree (fp32 and int8 pools) and a chunked
    insert into a contiguous session: every request's stream and counters
    equal the JAX package's session's; the chunked one also equals a JAX
    session over tp 2 sharded weights."""
    single, sharded = jax_engines["main"]
    want = _jax_serve(single, inputs, name)
    if name == "chunked":
        assert _jax_serve(sharded, inputs, name)[0] == want[0]
    for r in ranks:
        assert r["sessions"][name] == want
