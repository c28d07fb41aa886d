"""The port's exit x W sweep (``cli/sweep.py``) against the JAX package's,
on the CPU in fp32 over one JAX-written checkpoint: the rows' grid and
acceptance are equal (times are not compared), the CSV is on disk after
every cell, and the contour plot is written, or skipped with its message
where matplotlib is missing (as on the card's machine).
"""

import csv
import dataclasses
import json
import os
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from layerskip_tpu.cli import sweep as jsweep
from layerskip_tpu.cli.args import Arguments as JArguments
from layerskip_tpu.cli.benchmark import BenchmarkArguments as JBenchmarkArguments
from layerskip_tpu.cli.loading import load_model_and_tokenizer as jload
from layerskip_tpu.config import GenerationConfig as JGenerationConfig
from layerskip_tpu.config import tiny_config as jax_tiny_config
from layerskip_tpu.models import params as jparams
from layerskip_tpu.models.llama import LayerParams as JLayerParams
from layerskip_tpu.models.llama import LlamaParams as JLlamaParams
from layerskip_tpu_torch.cli import sweep as tsweep
from layerskip_tpu_torch.cli.args import Arguments
from layerskip_tpu_torch.cli.benchmark import BenchmarkArguments
from layerskip_tpu_torch.config import GenerationConfig

L, D, F, V, HQ, HKV, DH = 4, 128, 128, 256, 2, 1, 64
SIZES = dict(hidden_size=D, num_attention_heads=HQ, num_key_value_heads=HKV,
             intermediate_size=F, vocab_size=V, num_hidden_layers=L)
GRID = dict(exit_layer_first=1, exit_layer_last=3, exit_layer_step=2,
            num_speculations_first=2, num_speculations_last=3)
STEPS = 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """(a JAX-written fp32 checkpoint of a dense Llama whose layers >= 2 are
    shrunk, so drafts are accepted part of the time; a 2-prompt dataset)."""
    d = tmp_path_factory.mktemp("sweep_ckpt")
    rng = np.random.default_rng(5)
    n = lambda *s: (rng.standard_normal(s) * 0.15).astype(np.float32)  # noqa: E731
    tail = np.ones((L, 1, 1), np.float32)
    tail[2:] = 0.3
    layers = dict(attn_norm=np.ones((L, D), np.float32), wq=n(L, HQ * DH, D),
                  wk=n(L, HKV * DH, D), wv=n(L, HKV * DH, D), wo=n(L, HQ * DH, D) * tail,
                  mlp_norm=np.ones((L, D), np.float32), w_gate=n(L, D, F), w_up=n(L, D, F),
                  w_down=n(L, F, D) * tail)
    params = JLlamaParams(
        embed=jnp.asarray(n(V, D) * 2),
        layers=JLayerParams(**{k: jnp.asarray(v) for k, v in layers.items()}),
        final_norm=jnp.ones((D,), jnp.float32), lm_head=jnp.asarray(n(D, V)))
    jparams.save_params(params, str(d / "model"), jax_tiny_config(**SIZES))
    data = d / "d.jsonl"
    data.write_text("\n".join(json.dumps({"prompt": p, "response": "x"})
                              for p in ("question one: what", "a second prompt here")))
    return str(d / "model"), str(data)


def _port_sweep(ckpt, out_dir):
    model, data = ckpt
    return tsweep.sweep(
        Arguments(model=model, model_args="dtype=float32", device="cpu", output_dir=out_dir),
        BenchmarkArguments(dataset="custom_jsonl", data_path=data, random_shuffle=False),
        tsweep.SweepArguments(**GRID), GenerationConfig(max_steps=STEPS, sample=False))


def _csv_rows(out_dir):
    (name,) = [n for n in os.listdir(out_dir) if n.endswith(".csv")]
    with open(os.path.join(out_dir, name)) as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def port_run(ckpt, tmp_path_factory):
    """The port's sweep with matplotlib hidden: (rows, output dir, stdout,
    the CSV's row count seen at the start of each cell)."""
    out_dir = str(tmp_path_factory.mktemp("sweep_out"))
    seen, real = [], tsweep.benchmark

    def counting(*a, **kw):
        seen.append(len(_csv_rows(out_dir)) if any(
            n.endswith(".csv") for n in os.listdir(out_dir)) else 0)
        return real(*a, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(tsweep, "benchmark", counting)
    mp.setitem(sys.modules, "matplotlib", None)  # import matplotlib -> ImportError
    buf = []
    mp.setattr("builtins.print", lambda *a, **kw: buf.append(" ".join(str(x) for x in a)))
    try:
        rows = _port_sweep(ckpt, out_dir)
    finally:
        mp.undo()
    return rows, out_dir, buf, seen


def test_rows_equal_jax_sweep(ckpt, port_run, tmp_path, monkeypatch):
    rows, _, _, _ = port_run
    model, data = ckpt
    monkeypatch.setattr(jsweep, "load_model_and_tokenizer",
                        lambda m, **kw: jload(m, **dict(kw, dtype=jnp.float32)))
    want = jsweep.sweep(
        JArguments(model=model, output_dir=str(tmp_path)),
        JBenchmarkArguments(dataset="custom_jsonl", data_path=data, random_shuffle=False),
        jsweep.SweepArguments(**GRID), JGenerationConfig(max_steps=STEPS, sample=False))
    keys = ("exit_layer", "num_speculations", "acceptance_rate")
    assert [{k: r[k] for k in keys} for r in rows] == [{k: r[k] for k in keys} for r in want]
    assert [(r["exit_layer"], r["num_speculations"]) for r in rows] == \
        [(1, 2), (1, 3), (3, 2), (3, 3)]
    assert len({r["acceptance_rate"] for r in rows}) > 1
    assert all(r["tokens_per_second"] > 0 for r in rows)
    assert tsweep.FIELDS == jsweep.FIELDS
    assert dataclasses.asdict(tsweep.SweepArguments()) == \
        dataclasses.asdict(jsweep.SweepArguments())


def test_csv_is_written_after_every_cell(port_run):
    rows, out_dir, _, seen = port_run
    assert seen == [0, 1, 2, 3]  # cell i starts with i rows on disk
    got = _csv_rows(out_dir)
    assert list(got[0]) == tsweep.FIELDS
    assert [(int(r["exit_layer"]), int(r["num_speculations"]), float(r["acceptance_rate"]))
            for r in got] == [(r["exit_layer"], r["num_speculations"], r["acceptance_rate"])
                              for r in rows]


def test_plot_skipped_with_its_message_without_matplotlib(port_run):
    _, out_dir, printed, _ = port_run
    skipped = [ln for ln in printed if ln.startswith("contour plot skipped:")]
    assert len(skipped) == 1 and "matplotlib" in skipped[0]
    assert not any(n.endswith(".pdf") for n in os.listdir(out_dir))
    assert printed[-1].startswith("wrote ") and printed[-1].endswith(".csv")


def test_plot_contour_writes_a_pdf(tmp_path):
    rows = [{"exit_layer": e, "num_speculations": w, "tokens_per_second": float(e * w + e)}
            for e in (1, 2, 3) for w in (2, 4, 6)]
    path = str(tmp_path / "grid.pdf")
    tsweep.plot_contour(rows, path)
    with open(path, "rb") as f:
        assert f.read(5) == b"%PDF-"
