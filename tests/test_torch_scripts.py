"""The port's measurement scripts (``scripts/bench_torch_*.py``) on the CPU at
the tiny config: each ``main(argv)`` prints one JSON line whose keys are the
JAX package's script's (written out below from ``scripts/bench_*.py``),
every scheduler serves the same token total, and a context past the model's
``max_position_embeddings`` decodes greedy spec == AR.
"""

import importlib.util
import json
import os

import pytest

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the keys of the JAX scripts' stdout lines, in their order
SERVING_KEYS = ["metric", "continuous", "gather", "unit", "paged", "paged_prefix_cache",
                "prefix_stats"]
SERVING_SKIP_GATHER_KEYS = ["metric", "continuous", "unit", "paged", "paged_prefix_cache",
                            "prefix_stats"]
CHUNKED_KEYS = ["metric", "value", "unit", "vs_baseline", "stall_ms_plain",
                "agg_tok_per_s_plain", "stall_ms_chunked", "agg_tok_per_s_chunked",
                "chunk_tokens", "long_prompt", "backend"]
LONGCTX_KEYS = ["metric", "unit", "ar_tokens_per_s", "spec_tokens_per_s", "spec_speedup"]
ADAPTIVE_KEYS = ["metric", "ar_tokens_per_s", "unit", "points"]
ADAPTIVE_POINT_KEYS = ["tail_eps", "tau", "acceptance", "spec_tokens_per_s", "speedup",
                       "total_drafts"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(name, argv, capsys):
    """(main's result, the one JSON line printed on stdout)."""
    result = _script(name).main(argv + ["--config", "tiny", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1, out
    return result, json.loads(out[0])


SERVE = ["--batch", "2", "--requests", "4", "--max-steps", "16", "--page-size", "16"]


def test_serving_line_and_token_totals(capsys):
    result, line = _run("bench_torch_serving",
                        SERVE + ["--paged", "--prefix-cache", "--system-len", "16"], capsys)
    assert list(line) == SERVING_KEYS
    assert line["metric"] == "serving_tokens_per_s_tiny_b2" and line["unit"] == "tok/s"
    assert line["prefix_stats"]["hits"] > 0
    served = result["served"]
    assert set(served) == {"paged", "paged_prefix_cache", "continuous", "gather"}
    assert set(served.values()) == {4 * 16}  # 4 requests x 16 tokens, every scheduler


def test_serving_skip_gather_quantized(capsys):
    result, line = _run("bench_torch_serving", SERVE + [
        "--paged", "--prefix-cache", "--system-len", "16", "--kv-quant", "--quant",
        "--skip-gather"], capsys)
    assert list(line) == SERVING_SKIP_GATHER_KEYS
    assert len(set(result["served"].values())) == 1
    _, line = _run("bench_torch_serving", SERVE + ["--varied", "--budget-min", "4",
                                                   "--skip-gather", "--skip-static",
                                                   "--paged"], capsys)
    assert list(line) == ["metric", "unit", "paged"]
    assert line["metric"] == "serving_tokens_per_s_tiny_b2_varied"


def test_chunked_line(capsys):
    result, line = _run("bench_torch_chunked", [
        "--prompt-bucket", "128", "--long-prompt", "100", "--chunk", "32",
        "--max-steps", "64"], capsys)
    assert list(line) == CHUNKED_KEYS
    assert line["metric"] == "admission_stall_ms_tiny" and line["backend"] == "cpu"
    assert line["stall_ms_plain"] > 0 and line["stall_ms_chunked"] > 0
    assert line["value"] == line["stall_ms_chunked"] and line["chunk_tokens"] == 32


def test_longctx_past_max_positions_spec_equals_ar(capsys):
    from layerskip_tpu_torch.bench import build_config

    ctx = 1024
    assert ctx > build_config("tiny").max_position_embeddings
    result, line = _run("bench_torch_longctx", ["--ctx", str(ctx), "--max-steps", "16",
                                                "--repeats", "1"], capsys)
    assert list(line) == LONGCTX_KEYS
    assert line["metric"] == f"longctx_decode_tiny_ctx{ctx}"
    assert result["ar_tokens"] == result["spec_tokens"] and len(result["ar_tokens"]) == 16
    assert result["peak_bytes"] is None  # no device memory on the CPU


def test_adaptive_line(capsys):
    _, line = _run("bench_torch_adaptive", ["--eps", "0", "0.05", "--taus", "0", "0.5",
                                            "--max-steps", "24", "--repeats", "1"], capsys)
    assert list(line) == ADAPTIVE_KEYS and line["metric"] == "adaptive_draft_tiny"
    assert [(p["tail_eps"], p["tau"]) for p in line["points"]] == \
        [(0.0, 0.0), (0.0, 0.5), (0.05, 0.0), (0.05, 0.5)]
    for p in line["points"]:
        assert list(p) == ADAPTIVE_POINT_KEYS and p["total_drafts"] > 0
    # identity tail: every draft accepted; adaptive drafting drafts less
    assert line["points"][0]["acceptance"] == 1.0
    assert line["points"][1]["total_drafts"] <= line["points"][0]["total_drafts"]

