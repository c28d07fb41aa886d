"""The port's entry points against the JAX package's, on the CPU in fp32:
checkpoints in both directions, the generator facade, streaming, the CLI
apps (generate, benchmark, correctness), data, metrics, args, streamers,
the loader and the serving command line.

One fp32 checkpoint written by the JAX package's ``save_params`` is loaded
by both packages' loaders; greedy tokens, decoded text, acceptance and the
per-round streaming lists must be EQUAL. Metrics on the same predictions
agree within 1e-12; checkpoints and readers are bit-exact.
"""

import dataclasses
import io
import json
import os
import re
import socket
import sys
import threading
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from layerskip_tpu import data as jdata
from layerskip_tpu import metrics as jmetrics
from layerskip_tpu.cli import args as jargs
from layerskip_tpu.cli.loading import load_model_and_tokenizer as jload
from layerskip_tpu.config import GenerationConfig as JGenerationConfig
from layerskip_tpu.config import ModelConfig as JModelConfig
from layerskip_tpu.config import tiny_config as jax_tiny_config
from layerskip_tpu.generation import streamer as jstreamer
from layerskip_tpu.generation.generator import LlamaGenerator as JLlamaGenerator
from layerskip_tpu.models import params as jparams
from layerskip_tpu.models.llama import LayerParams as JLayerParams
from layerskip_tpu.models.llama import LlamaParams as JLlamaParams
from layerskip_tpu_torch import data as tdata
from layerskip_tpu_torch import metrics as tmetrics
from layerskip_tpu_torch import serving
from layerskip_tpu_torch.cli import args as targs
from layerskip_tpu_torch.cli.loading import SimpleTokenizer
from layerskip_tpu_torch.cli.loading import load_model_and_tokenizer as tload
from layerskip_tpu_torch.config import GenerationConfig, tiny_config
from layerskip_tpu_torch.generation import streamer as tstreamer
from layerskip_tpu_torch.generation.engine import Engine, postprocess_output
from layerskip_tpu_torch.generation.generator import LlamaGenerator
from layerskip_tpu_torch.models import params as tparams
from layerskip_tpu_torch.models import safetensors_io
from layerskip_tpu_torch.ops.linear import QuantTensor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L, D, F, V, HQ, HKV, DH = 4, 128, 128, 256, 2, 1, 64
SIZES = dict(hidden_size=D, num_attention_heads=HQ, num_key_value_heads=HKV,
             intermediate_size=F, vocab_size=V)
FIELDS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate", "w_up", "w_down")
PROMPTS = ["question one: what", "a second prompt here", "and a third, last one"]
STEPS = 24
STRATEGIES = {"ar": dict(generation_strategy="autoregressive"),
              "spec": dict(generation_strategy="self_speculative", exit_layer=2,
                           num_speculations=3)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Thousands of tiny torch ops: one intra-op thread keeps them fast, also
    when the suite runs several workers per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(seed=0):
    """Random dense-Llama JAX params (head_dim 64, so prompt prefills take
    the flash-prefill route); std 0.15 keeps the greedy streams varied, and
    layers >= 2 have output projections shrunk to 0.3 so early exits agree
    with the full model part of the time."""
    rng = np.random.default_rng(seed)
    n = lambda *s: (rng.standard_normal(s) * 0.15).astype(np.float32)  # noqa: E731
    tail = np.ones((L, 1, 1), np.float32)
    tail[2:] = 0.3
    layers = dict(attn_norm=np.ones((L, D), np.float32), wq=n(L, HQ * DH, D),
                  wk=n(L, HKV * DH, D), wv=n(L, HKV * DH, D), wo=n(L, HQ * DH, D) * tail,
                  mlp_norm=np.ones((L, D), np.float32), w_gate=n(L, D, F), w_up=n(L, D, F),
                  w_down=n(L, F, D) * tail)
    return JLlamaParams(
        embed=jnp.asarray(n(V, D) * 2),
        layers=JLayerParams(**{k: jnp.asarray(v) for k, v in layers.items()}),
        final_norm=jnp.ones((D,), jnp.float32), lm_head=jnp.asarray(n(D, V)))


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """(directory of a JAX-written fp32 checkpoint, the JAX params in it)."""
    d = str(tmp_path_factory.mktemp("ckpt"))
    jp = _jax_params()
    jparams.save_params(jp, d, jax_tiny_config(**SIZES))
    return d, jp


@pytest.fixture(scope="module")
def generators(jax_ckpt):
    """The JAX and the port's ``LlamaGenerator`` over the same checkpoint,
    each loaded by its package's loader in fp32."""
    d, _ = jax_ckpt
    jp, jcfg, jtok = jload(d, dtype=jnp.float32)
    tp, tcfg, ttok = tload(d, dtype=torch.float32, device="cpu")
    return JLlamaGenerator(jtok, jp, jcfg), LlamaGenerator(ttok, tp, tcfg, device="cpu")


@pytest.fixture(scope="module")
def cli_generator(jax_ckpt):
    """The port's generator over the checkpoint as the CLI apps load it
    (their loader's default dtype, bf16)."""
    tp, tcfg, ttok = tload(jax_ckpt[0], device="cpu")
    assert tcfg.dtype == torch.bfloat16
    return LlamaGenerator(ttok, tp, tcfg, device="cpu")


def _assert_same_params(a, b):
    """Two port params, bit for bit."""
    for f in FIELDS:
        x, y = getattr(a.layers, f), getattr(b.layers, f)
        assert x.dtype == y.dtype and torch.equal(x, y), f
    for f in ("embed", "final_norm", "lm_head"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.uint32)


# --- the port's sources -------------------------------------------------------


def test_port_imports_neither_jax_nor_the_jax_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|layerskip_tpu)\b", re.M)
    root = os.path.join(REPO, "layerskip_tpu_torch")
    offenders = []
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                with open(path) as f:
                    if pat.search(f.read()):
                        offenders.append(os.path.relpath(path, REPO))
    assert not offenders


# --- checkpoints ----------------------------------------------------------------


ST_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
             "I8": torch.int8, "U8": torch.uint8, "F64": torch.float64,
             "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
             "BOOL": torch.bool}


def _st_tensors(dtype):
    g = torch.Generator().manual_seed(3)
    if dtype.is_floating_point:
        make = lambda *s: torch.randn(s, generator=g).to(dtype)  # noqa: E731
    else:
        lo, hi = {torch.int8: (-128, 128), torch.uint8: (0, 256),
                  torch.bool: (0, 2)}.get(dtype, (-30000, 30000))
        make = lambda *s: torch.randint(lo, hi, s, generator=g).to(dtype)  # noqa: E731
    return {"model.a": make(3, 5), "model.b": make(7), "c": make(2, 1, 4), "s": make()}


@pytest.mark.parametrize("tag", list(ST_DTYPES))
def test_safetensors_reader_and_writer_match_the_library(tmp_path, tag):
    """The port's reader gives the library's tensors (numpy's where it has
    the dtype; torch's for BF16), and the library reads the port's files."""
    import safetensors.numpy
    import safetensors.torch

    tensors = _st_tensors(ST_DTYPES[tag])
    lib_file, port_file = str(tmp_path / "lib.safetensors"), str(tmp_path / "port.safetensors")
    safetensors.torch.save_file(tensors, lib_file)
    mine = safetensors_io.load_file(lib_file)
    if tag == "BF16":
        ref = safetensors.torch.load_file(lib_file)
        assert all(torch.equal(mine[k], ref[k]) and mine[k].dtype == torch.bfloat16
                   for k in ref)
    else:
        ref = safetensors.numpy.load_file(lib_file)
        assert all(np.array_equal(mine[k].numpy(), ref[k]) and mine[k].numpy().dtype == ref[k].dtype
                   and mine[k].shape == ref[k].shape for k in ref)
    assert set(mine) == set(tensors)
    safetensors_io.save_file(tensors, port_file, metadata={"format": "pt"})
    back = safetensors.torch.load_file(port_file)
    assert set(back) == set(tensors)
    assert all(back[k].dtype == tensors[k].dtype and torch.equal(back[k], tensors[k])
               for k in tensors)


def test_jax_checkpoint_loads_bit_exactly(jax_ckpt):
    d, jp = jax_ckpt
    cfg = tiny_config(**SIZES)
    _assert_same_params(tparams.load_params(d, cfg, device="cpu"),
                        tparams.params_from_numpy(jp, device="cpu"))


def test_jax_checkpoint_with_an_unread_int64_tensor_loads(jax_ckpt, tmp_path):
    """A checkpoint that also holds a tensor the model never reads, in a
    dtype outside the model's (an int64 ``model.extra_position_ids``), loads
    as the JAX package loads it: the extra name is decoded and ignored, and
    every model tensor is bit-equal to the JAX load."""
    import safetensors.numpy

    d, _ = jax_ckpt
    tensors = safetensors.numpy.load_file(os.path.join(d, "model.safetensors"))
    tensors["model.extra_position_ids"] = np.arange(12, dtype=np.int64).reshape(1, 12)
    safetensors.numpy.save_file(tensors, str(tmp_path / "model.safetensors"),
                                metadata={"format": "pt"})
    with open(os.path.join(d, "config.json")) as src:
        (tmp_path / "config.json").write_text(src.read())
    jcfg = JModelConfig.from_pretrained(str(tmp_path), dtype=jnp.float32)
    want = jparams.load_params(str(tmp_path), jcfg)
    got = tparams.load_params(str(tmp_path), tiny_config(**SIZES), device="cpu")
    for f in FIELDS:
        assert np.array_equal(_bits(getattr(got.layers, f).numpy()),
                              _bits(getattr(want.layers, f))), f
    for f in ("embed", "final_norm", "lm_head"):
        assert np.array_equal(_bits(getattr(got, f).numpy()), _bits(getattr(want, f))), f
    read = safetensors_io.load_file(str(tmp_path / "model.safetensors"))
    assert read["model.extra_position_ids"].dtype == torch.int64
    assert read["model.extra_position_ids"].tolist() == [list(range(12))]


def test_port_checkpoint_loads_bit_exactly_in_jax(jax_ckpt, tmp_path):
    d, _ = jax_ckpt
    tp, tcfg, _ = tload(d, dtype=torch.float32, device="cpu")
    tparams.save_params(tp, str(tmp_path), tcfg)
    jcfg = JModelConfig.from_pretrained(str(tmp_path), dtype=jnp.float32)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(jax_tiny_config(**SIZES))
    back = jparams.load_params(str(tmp_path), jcfg)
    for f in FIELDS:
        assert np.array_equal(_bits(getattr(back.layers, f)),
                              _bits(getattr(tp.layers, f).numpy())), f
    for f in ("embed", "final_norm", "lm_head"):
        assert np.array_equal(_bits(getattr(back, f)), _bits(getattr(tp, f).numpy())), f
    # and the port reads its own checkpoint back as it was
    _assert_same_params(tparams.load_params(str(tmp_path), tcfg, device="cpu"), tp)


def test_save_refuses_quantized_params(tmp_path):
    params, cfg, _ = tload("random:tiny", quantize="int8", device="cpu")
    with pytest.raises(ValueError, match="quantized"):
        tparams.save_params(params, str(tmp_path), cfg)


def test_params_from_torch_state_dict_equals_jax():
    from transformers import LlamaConfig, LlamaForCausalLM

    hf_cfg = LlamaConfig(vocab_size=V, hidden_size=D, intermediate_size=F,
                         num_hidden_layers=L, num_attention_heads=HQ,
                         num_key_value_heads=HKV, head_dim=DH, max_position_embeddings=256,
                         attention_bias=False, tie_word_embeddings=False)
    torch.manual_seed(0)
    sd = LlamaForCausalLM(hf_cfg).eval().state_dict()
    cfg_dict = hf_cfg.to_dict()
    from layerskip_tpu_torch.config import ModelConfig

    tp = tparams.params_from_torch_state_dict(
        sd, ModelConfig.from_hf_dict(cfg_dict, dtype=torch.float32), device="cpu")
    jp = jparams.params_from_torch_state_dict(
        sd, JModelConfig.from_hf_dict(cfg_dict, dtype=jnp.float32))
    _assert_same_params(tp, tparams.params_from_numpy(jp, device="cpu"))


# --- generation through the facade ------------------------------------------------


@pytest.mark.parametrize("name", list(STRATEGIES))
def test_generator_equals_jax(generators, name):
    jgen, tgen = generators
    jcfg = JGenerationConfig(max_steps=STEPS, sample=False, **STRATEGIES[name])
    tcfg = GenerationConfig(max_steps=STEPS, sample=False, **STRATEGIES[name])
    accs = []
    for prompt in PROMPTS:
        j, t = jgen.generate(prompt, jcfg), tgen.generate(prompt, tcfg)
        assert t.generation_strategy_result.predicted_tokens == \
            j.generation_strategy_result.predicted_tokens
        assert t.decoded_prediction == j.decoded_prediction
        assert t.num_tokens_generated == j.num_tokens_generated
        assert t.generation_strategy_result.acceptance_rate == \
            j.generation_strategy_result.acceptance_rate
        accs.append(t.generation_strategy_result.acceptance_rate)
    if name == "spec":  # the drafts are neither all accepted nor all rejected
        assert any(0 < a < 1 for a in accs), accs


def test_generator_stop_words_equal_jax(generators):
    """The stop-word trim keeps the shortest prefix whose text holds a stop
    word, in both packages."""
    jgen, tgen = generators
    full = tgen.generate(PROMPTS[0], GenerationConfig(max_steps=STEPS, sample=False))
    words = full.decoded_prediction.split()
    stop = " ".join(words[5:7])
    j = jgen.generate(PROMPTS[0], JGenerationConfig(max_steps=STEPS, sample=False,
                                                    stop_words=[stop]))
    t = tgen.generate(PROMPTS[0], GenerationConfig(max_steps=STEPS, sample=False,
                                                   stop_words=[stop]))
    assert t.generation_strategy_result.predicted_tokens == \
        j.generation_strategy_result.predicted_tokens
    assert stop in t.decoded_prediction and len(t.decoded_prediction.split()) == 7


def test_strategies_equal_the_engine(generators):
    from layerskip_tpu_torch.generation.strategies import (
        AutoRegressiveGenerationStrategy,
        PromptLookupGenerationStrategy,
        SelfSpeculativeGenerationStrategy,
    )

    _, tgen = generators
    ids, eos = tgen._encode(PROMPTS[1]), tgen.eos_ids
    for strategy, name in ((AutoRegressiveGenerationStrategy(), "ar"),
                           (SelfSpeculativeGenerationStrategy(), "spec")):
        cfg = GenerationConfig(max_steps=STEPS, sample=False, **STRATEGIES[name])
        res = strategy.generate_token_ids(tgen.engine, ids, eos, cfg)
        assert res.predicted_tokens == tgen.generate(
            PROMPTS[1], cfg).generation_strategy_result.predicted_tokens
    # prompt lookup (which raised before this port carried it) equals the
    # engine and the JAX package's class, and reports its acceptance
    from layerskip_tpu.generation.strategies import (
        PromptLookupGenerationStrategy as JPromptLookupGenerationStrategy,
    )

    jgen = generators[0]
    cfg = GenerationConfig(max_steps=STEPS, sample=False, num_speculations=3, pld_ngram=1)
    res = PromptLookupGenerationStrategy().generate_token_ids(tgen.engine, ids, eos, cfg)
    want = JPromptLookupGenerationStrategy().generate_token_ids(
        jgen.engine, ids, eos, JGenerationConfig(max_steps=STEPS, sample=False,
                                                 num_speculations=3, pld_ngram=1),
        jax.random.PRNGKey(0))
    assert res.predicted_tokens == want.predicted_tokens
    assert res.acceptance_rate == want.acceptance_rate is not None
    assert res.predicted_tokens == tgen.generate(PROMPTS[1], dataclasses.replace(
        cfg, generation_strategy="prompt_lookup")).generation_strategy_result.predicted_tokens


# --- streaming ------------------------------------------------------------------


def test_stream_generate_equals_generate_and_jax_rounds(generators):
    """The accepted lists of the port's rounds concatenate to ``generate``'s
    tokens with the same counters, and each round's (drafted, accepted)
    lists equal the JAX ``stream_generate``'s."""
    jgen, tgen = generators
    spec = STRATEGIES["spec"]
    tcfg = GenerationConfig(max_steps=STEPS, sample=False, **spec)
    for prompt in PROMPTS[:2]:
        ids = tgen._encode(prompt)
        eos = tgen.eos_ids
        trounds, jrounds = [], []
        tout = tgen.engine.stream_generate(ids, tcfg, None, eos,
                                           on_round=lambda d, a: trounds.append((d, a)))
        jout = jgen.engine.stream_generate(
            ids, JGenerationConfig(max_steps=STEPS, sample=False, **spec),
            jax.random.PRNGKey(0), eos, on_round=lambda d, a: jrounds.append((d, a)))
        assert trounds == jrounds
        gout = tgen.engine.generate(ids, tcfg, None, eos)
        committed = sum((a for _, a in trounds), [])
        n = int(gout.num_tokens[0])
        assert committed[:n] == gout.tokens[0, :n].tolist()
        assert postprocess_output(tout, eos, STEPS) == postprocess_output(gout, eos, STEPS)
        for k in ("num_tokens", "matches", "drafts"):
            assert torch.equal(getattr(tout, k), getattr(gout, k)), k
        assert int(tout.matches) == int(jout.matches) and int(tout.drafts) == int(jout.drafts)


def test_stream_generate_refuses_what_generate_refuses(generators):
    """AR, and tree or hybrid drafting with adaptive drafting, are refused;
    prompt lookup and hybrid (refused before this port carried them) stream
    the JAX package's rounds."""
    jgen, tgen = generators
    spec = STRATEGIES["spec"]
    for cfg in (GenerationConfig(generation_strategy="autoregressive"),
                GenerationConfig(**spec, spec_tree_width=2, draft_exit_prob=0.5),
                GenerationConfig(**dict(spec, generation_strategy="hybrid"),
                                 draft_exit_prob=0.5)):
        with pytest.raises(ValueError):
            tgen.engine.stream_generate([3, 4, 5], cfg)
    ids, eos = tgen._encode(PROMPTS[0]), tgen.eos_ids
    for strategy in ("prompt_lookup", "hybrid"):
        kw = dict(spec, generation_strategy=strategy, pld_ngram=1, max_steps=STEPS,
                  sample=False)
        trounds, jrounds = [], []
        tgen.engine.stream_generate(ids, GenerationConfig(**kw), None, eos,
                                    on_round=lambda d, a: trounds.append((d, a)))
        jgen.engine.stream_generate(ids, JGenerationConfig(**kw), jax.random.PRNGKey(0), eos,
                                    on_round=lambda d, a: jrounds.append((d, a)))
        assert trounds == jrounds and len(trounds) > 1, strategy


# --- the CLI apps ---------------------------------------------------------------


def _jsonl(path, rows):
    path.write_text("\n".join(json.dumps(r) for r in rows))
    return str(path)


def test_correctness_cli_on_the_checkpoint(jax_ckpt, tmp_path):
    from layerskip_tpu_torch.cli.benchmark import BenchmarkArguments
    from layerskip_tpu_torch.cli.correctness import main

    d, _ = jax_ckpt
    data = _jsonl(tmp_path / "d.jsonl", [{"prompt": p, "response": "x"} for p in PROMPTS])
    out_dir = tmp_path / "out"
    result = main(targs.Arguments(model=d, model_args="dtype=float32",
                                  output_dir=str(out_dir), device="cpu"),
                  BenchmarkArguments(dataset="custom_jsonl", data_path=data),
                  GenerationConfig(max_steps=STEPS, exit_layer=2, num_speculations=3))
    assert result == {"total_errors": 0, "error_pct": 0.0}
    (name,) = os.listdir(out_dir)
    assert json.loads((out_dir / name).read_text()) == result


def test_benchmark_cli_schema_and_metrics(cli_generator, jax_ckpt, tmp_path):
    """One valid JSON file with the four sections; ``metric_result`` has the
    JAX package's keys, and its text metrics equal the JAX
    ``EvaluationMetrics`` fed the same predictions."""
    from layerskip_tpu_torch.cli.benchmark import BenchmarkArguments, main

    tgen = cli_generator
    d, _ = jax_ckpt
    gen_cfg = GenerationConfig(max_steps=STEPS, sample=False, **STRATEGIES["spec"])
    preds = [tgen.generate(p, gen_cfg) for p in PROMPTS]
    # targets that share most of each prediction, so every metric is nonzero
    rows = [{"prompt": p, "response": " ".join(r.decoded_prediction.split()[:-3] + ["7", "8"])}
            for p, r in zip(PROMPTS, preds)]
    data = _jsonl(tmp_path / "d.jsonl", rows)
    args = targs.Arguments(model=d, output_dir=str(tmp_path / "out"), device="cpu")
    bench_args = BenchmarkArguments(dataset="custom_jsonl", data_path=data,
                                    random_shuffle=False)
    result = main(args, bench_args, gen_cfg)
    (name,) = os.listdir(tmp_path / "out")
    dumped = json.loads((tmp_path / "out" / name).read_text())
    assert set(dumped) == {"args", "benchmark_arguments", "generation_config", "metric_result"}
    assert dumped["metric_result"] == result and dumped["args"]["device"] == "cpu"

    ref = jmetrics.EvaluationMetrics.build_metrics()
    for row, pred in zip(rows, preds):
        ref.update(jdata.EvaluationExample(input=row["prompt"], output=row["response"]), pred)
    want = ref.compute()
    assert {k: set(v) for k, v in result.items()} == {k: set(v) for k, v in want.items()}
    for k, v in want["predicted_text"].items():
        assert v > 0 and abs(result["predicted_text"][k] - v) <= 1e-12, k
    assert result["acceptance_rate"]["mean"] == want["acceptance_rate"]["mean"]
    assert result["tokens_per_second"]["mean"] > 0


def _visible(out: str) -> str:
    """What a terminal shows of ``out``: colours dropped, each
    backspace-space-backspace erasing the character before it."""
    text, shown, i = re.sub(r"\x1b\[\d+m", "", out), [], 0
    while i < len(text):
        if text.startswith("\b \b", i):
            shown.pop()
            i += 3
        else:
            shown.append(text[i])
            i += 1
    return "".join(shown)


@pytest.mark.parametrize("streamer", ["none", "standard", "speculative"])
def test_generate_cli_prints_the_predictions(cli_generator, jax_ckpt, monkeypatch, capsys,
                                             streamer):
    from layerskip_tpu_torch.cli.generate import GenerateArguments, main

    tgen = cli_generator
    d, _ = jax_ckpt
    gen_cfg = GenerationConfig(max_steps=STEPS, sample=False, **STRATEGIES["spec"])
    monkeypatch.setattr(sys, "stdin", io.StringIO(f"{PROMPTS[0]}\n\n{PROMPTS[1]}\n"))
    main(targs.Arguments(model=d, device="cpu"),
         GenerateArguments(streamer=streamer, warmup=False), gen_cfg)
    out, err = capsys.readouterr()
    want = [tgen.generate(p, gen_cfg).decoded_prediction for p in PROMPTS[:2]]
    if streamer == "speculative":  # drafts painted, erased, then accepted in green
        assert _visible(out).split("\n")[:2] == want
    else:
        assert out.split("\n")[:2] == want
    assert err.count("acceptance:") == 2


# --- data, metrics, args, streamers ------------------------------------------------


@pytest.mark.parametrize("shuffle", [False, True])
def test_get_data_equals_jax(tmp_path, shuffle):
    jsonl = _jsonl(tmp_path / "c.jsonl", [{"prompt": f"q{i}", "response": f"a{i}"}
                                          for i in range(9)])
    chat = _jsonl(tmp_path / "chat.jsonl", [{"data": [
        {"role": "SYS", "message": "s"}, {"role": "USER", "message": f"u{i}"},
        {"role": "PARSER", "message": f"p{i}"}, {"role": "USER", "message": "more"},
        {"role": "PARSER", "message": "again"}]} for i in range(3)])
    for dataset, path in (("custom_jsonl", jsonl), ("chat_format", chat)):
        kw = dict(random_shuffle=shuffle, num_samples=5, dataset=dataset, data_path=path,
                  seed=11, template="<<{message}>>")
        j, t = jdata.get_data(**kw), tdata.get_data(**kw)
        assert [dataclasses.astuple(x) for x in t] == [dataclasses.astuple(x) for x in j]
    assert tdata.get_valid_dataset_formats() == jdata.get_valid_dataset_formats()


PAIRS = [("the cat sat on the mat", "the cat sat on a mat"),
         ("Hello, World! 123", "hello world 123"),
         ("a b c d e f", "f e d c b a"),
         ("", "nothing here"),
         ("same same same", "same same same"),
         ("kitten sitting", "sitting kitten on a long line of words")]


@pytest.mark.parametrize("pred,target", PAIRS)
def test_metrics_equal_jax(pred, target):
    for n in (1, 2, 3):
        assert tmetrics.rouge_n(pred, target, n) == jmetrics.rouge_n(pred, target, n)
    assert tmetrics.rouge_l(pred, target) == jmetrics.rouge_l(pred, target)
    assert tmetrics.edit_distance(pred, target) == jmetrics.edit_distance(pred, target)
    tb, jb = tmetrics.BleuMetric(4), jmetrics.BleuMetric(4)
    for a, b in PAIRS:  # corpus-level: the same stream of updates
        tb.update(b, a)
        jb.update(b, a)
    tb.update(target, pred)
    jb.update(target, pred)
    assert tb.compute() == jb.compute()


def test_parse_dataclasses_equals_jax():
    from layerskip_tpu.cli.benchmark import BenchmarkArguments as JBench

    from layerskip_tpu_torch.cli.benchmark import BenchmarkArguments as TBench

    argv = ["--model", "random:tiny", "--seed", "3", "--quantize", "int8",
            "--max_steps", "17", "--sample", "false", "--temperature", "0.7",
            "--stop_words", "a", "b", "--dataset", "custom_jsonl", "--num_samples", "4",
            "--generation_strategy", "self_speculative", "--exit_layer", "2"]
    j = jargs.parse_dataclasses((jargs.Arguments, JBench, JGenerationConfig), argv)
    t = targs.parse_dataclasses((targs.Arguments, TBench, GenerationConfig), argv + [
        "--device", "cpu"])
    tdicts = [dataclasses.asdict(x) for x in t]
    assert tdicts[0].pop("device") == "cpu"
    assert tdicts == [dataclasses.asdict(x) for x in j]
    assert targs.simple_parse_args_string("a=1,b=true,c=x") == \
        jargs.simple_parse_args_string("a=1,b=true,c=x")


class FakeTokenizer:
    def decode(self, ids, skip_special_tokens=True):
        return "".join(f"<{i}>" if i != 9 else "\n" for i in ids)


def _script(pkg, tensors):
    """Bytes a scripted put/delete sequence writes through ``pkg``'s
    streamers; the port's also takes tensors."""
    ids = (lambda x: torch.tensor(x)) if tensors else (lambda x: x)  # noqa: E731
    plain_buf, spec_buf = io.StringIO(), io.StringIO()
    plain = pkg.TextStreamer(FakeTokenizer(), out=plain_buf)
    plain.put(ids([1]))
    plain.put(ids([2, 9, 3]))
    plain.end()
    s = pkg.SpeculativeTextStreamer(FakeTokenizer(), out=spec_buf)
    s.put(ids([1, 2]))
    s.put(ids([3, 9, 4]), is_draft=True)
    s.delete(2)
    s.put(ids([5]))
    s.put(ids([6, 7, 8]), is_draft=True)
    s.delete(1)
    s.put(ids([6, 7]))
    s.put(ids([10]), is_draft=True)
    s.end()
    return plain_buf.getvalue(), spec_buf.getvalue()


@pytest.mark.parametrize("tensors", [False, True])
def test_streamers_write_the_jax_bytes(tensors):
    assert _script(tstreamer, tensors) == _script(jstreamer, False)


# --- the loader -----------------------------------------------------------------


def test_random_loader_tail_eps_knob():
    p0, cfg, tok = tload("random:tiny", seed=0, device="cpu")
    assert isinstance(tok, SimpleTokenizer) and cfg.dtype == torch.bfloat16
    p1, _, _ = tload("random:tiny?tail_eps=0.5&tail_from=2", seed=0, device="cpu")
    for f in ("wo", "w_down"):
        w0, w1 = getattr(p0.layers, f), getattr(p1.layers, f)
        assert torch.equal(w1[:2], w0[:2]) and torch.equal(w1[2:], w0[2:] * 0.5), f
    assert torch.equal(p0.layers.wq, p1.layers.wq)
    p2, _, _ = tload("random:tiny?tail_eps=0", seed=0, device="cpu")  # tail_from L/4
    assert torch.all(p2.layers.wo[1:] == 0) and torch.all(p2.layers.w_down[1:] == 0)
    assert torch.equal(p2.layers.wo[:1], p0.layers.wo[:1])


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantized_loader_keeps_spec_equal_to_ar(quant):
    params, cfg, _ = tload("random:tiny", seed=3, quantize=quant, device="cpu")
    for f in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        assert isinstance(getattr(params.layers, f), QuantTensor), f
    if quant == "int4":
        assert params.layers.wq.q.dtype == torch.uint8  # nibble-packed
    eng = Engine(params, cfg, device="cpu")
    runs = [postprocess_output(eng.generate([3, 5, 9], GenerationConfig(
        max_steps=8, sample=False, **STRATEGIES[s])), (), 8) for s in ("ar", "spec")]
    assert runs[0] == runs[1] and len(runs[0]) == 8


@pytest.mark.parametrize("kw,err", [
    (dict(model="random:tiny", dp=2), ValueError),  # one process is no 2-rank mesh
    (dict(model="random:tiny", tp=2), ValueError),
    (dict(model="random:nope"), ValueError),
    (dict(model="/no/such/checkpoint"), FileNotFoundError),
    (dict(model="random:tiny", quantize="int3"), ValueError),
])
def test_loader_refuses(kw, err):
    with pytest.raises(err):
        tload(device="cpu", **kw)


_JAX_PRESETS = ("tiny", "1b", "7b", "qwen3", "gemma2", "gemma2-2b", "gemma3", "moe",
                "qwen3moe", "moe-3b")


@pytest.mark.parametrize("preset", _JAX_PRESETS)
def test_random_presets_equal_the_jax_loaders(preset):
    """Every ``random:`` preset of the JAX loader has the same config in the
    port (both bf16); the bench's ``moe-3b`` is the loader's."""
    from layerskip_tpu.cli.loading import _preset_config as jax_preset
    from layerskip_tpu_torch.bench import build_config
    from layerskip_tpu_torch.cli.loading import _preset_config

    got, want = dataclasses.asdict(_preset_config(preset)), dataclasses.asdict(jax_preset(preset))
    assert (got.pop("dtype"), want.pop("dtype")) == (torch.bfloat16, jnp.bfloat16)
    assert got == want
    if preset in ("7b", "1b", "moe-3b"):
        assert build_config(preset) == _preset_config(preset)


@pytest.mark.parametrize("model", ["random:gemma2", "random:moe?tail_eps=0&tail_from=2"])
def test_family_presets_load_and_generate(model):
    """The presets the port once refused load (here the tiny Gemma-2 and
    Mixtral shapes; their full-width siblings only differ in size), and
    greedy spec == AR on them. The tail dial zeroes every expert's w_down."""
    params, cfg, tok = tload(model, device="cpu")
    assert cfg.dtype == torch.bfloat16 and isinstance(tok, SimpleTokenizer)
    if cfg.is_moe:
        assert params.layers.w_down.shape[:2] == (4, 4)
        assert params.layers.w_down[2:].abs().max() == 0 < params.layers.w_down[:2].abs().max()
    else:
        assert params.layers.post_attn_norm is not None and params.final_norm.abs().max() == 0
    eng = Engine(params, cfg, device="cpu")
    runs = [postprocess_output(eng.generate([3, 5, 9, 11, 13, 17, 19, 23, 29, 31], GenerationConfig(
        max_steps=8, sample=False, **STRATEGIES[s])), (), 8) for s in ("ar", "spec")]
    assert runs[0] == runs[1] and len(runs[0]) == 8


@pytest.mark.parametrize("model_args", ["dtype=int8", "dtype=float32,extra=1"])
def test_cli_model_args_refuse_what_they_do_not_take(model_args):
    from layerskip_tpu_torch.cli.loading import load_from_args

    with pytest.raises(ValueError, match="model_args"):
        load_from_args(targs.Arguments(model="random:tiny", model_args=model_args,
                                       device="cpu"))


def _cli_main(module, device, tmp_path):
    import importlib

    from layerskip_tpu_torch.cli.benchmark import BenchmarkArguments

    mod = importlib.import_module(f"layerskip_tpu_torch.cli.{module}")
    args = targs.Arguments(model="random:tiny", device=device, output_dir=str(tmp_path))
    extra = (mod.GenerateArguments() if module == "generate" else
             BenchmarkArguments(dataset="custom_jsonl", data_path=_jsonl(
                 tmp_path / "d.jsonl", [{"prompt": "hi", "response": "yo"}])))
    mod.main(args, extra, GenerationConfig(max_steps=2, sample=False, exit_layer=2,
                                           num_speculations=2))


ENTRY_POINTS = {
    "load_model_and_tokenizer": lambda dev, tmp: tload("random:tiny", device=dev),
    "LlamaGenerator": lambda dev, tmp: LlamaGenerator(
        SimpleTokenizer(V), *tload("random:tiny", device="cpu")[:2], device=dev),
    "cli.generate": lambda dev, tmp: _cli_main("generate", dev, tmp),
    "cli.benchmark": lambda dev, tmp: _cli_main("benchmark", dev, tmp),
    "cli.correctness": lambda dev, tmp: _cli_main("correctness", dev, tmp),
    "serving": lambda dev, tmp: serving.build_from_args(serving.parse_args(
        ["--model", "random:tiny", "--device", dev, "--port", "0"])),
}  # the bench's is in tests/test_torch_bench.py, beside its other runs


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_points_need_a_gpu_unless_the_cpu_is_asked_for(entry, tmp_path, monkeypatch):
    """The default device is the card: without one every entry point raises
    before doing any work; with ``cpu`` it runs."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[entry]("cuda", tmp_path)
    monkeypatch.setattr(sys, "stdin", io.StringIO(""))
    got = ENTRY_POINTS[entry]("cpu", tmp_path)
    if entry == "serving":
        sched, server = got
        server.server_close()
        sched.stop()


# --- the serving command line --------------------------------------------------------


def test_serving_cli_builds_a_paged_continuous_server():
    args = serving.parse_args([
        "--model", "random:tiny", "--device", "cpu", "--continuous",
        "--paged-pool-pages", "8", "--page-size", "16", "--port", "0",
        "--batch-size", "2", "--prompt-bucket", "64", "--max_steps", "10",
        "--exit_layer", "2", "--num_speculations", "3", "--sample", "false"])
    sched, server = serving.build_from_args(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = "http://%s:%d" % server.server_address[:2]
    try:
        with urllib.request.urlopen(f"{url}/healthz", timeout=120) as r:
            assert json.load(r)["ok"] is True
        req = urllib.request.Request(f"{url}/generate",
                                     data=json.dumps({"prompt": "hello there"}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            payload = json.load(r)
        assert isinstance(sched, serving.ContinuousBatchScheduler)
        assert sched.session.allocator.pool_pages == 8
        ids = SimpleTokenizer(V).encode("hello there")
        eos = sched.engine.cfg.eos_token_ids
        solo = postprocess_output(sched.engine.generate(ids, sched.gen_cfg), eos, 10)
        assert payload["tokens"] == solo and payload["text"] == SimpleTokenizer(V).decode(solo)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        sched.stop()
    assert not thread.is_alive()


def test_serving_cli_port_in_use_stops_the_scheduler():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        s.listen()
        port = s.getsockname()[1]
        before = threading.active_count()
        with pytest.raises(OSError):
            serving.build_from_args(serving.parse_args(
                ["--model", "random:tiny", "--device", "cpu", "--port", str(port)]))
    assert threading.active_count() == before
