"""The port's train CLI (``cli/train.py``) on the training mesh, on the CPU
in fp32: ranks started by the port's launcher over gloo against the same
CLI in one process.

A tiny fp32 checkpoint (``save_params``, loaded with ``--model_args
dtype=float32``) trains 4 steps with layer dropout on (the global keep mask
drawn alike on every rank). The loss history printed by rank 0 at ``--fsdp
2`` and at ``--dp 2 --tp 2`` equals the one-process history to its printed
4 decimals (within 1e-4); the gathered export equals the one-process
export within Adam's own bound (lr a step: a weight whose fp32 gradients
differ near 0 may move by up to lr in either direction) and loads into the
inference engine. A checkpoint written at fsdp 2 resumes at fsdp 1 and
one written at fsdp 1 resumes at fsdp 2, each resumed history equal to the
one-process resume of the one-process checkpoint within 1e-4.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from layerskip_tpu_torch.cli import train
from layerskip_tpu_torch.cli.args import Arguments
from layerskip_tpu_torch.cli.loading import load_model_and_tokenizer
from layerskip_tpu_torch.config import GenerationConfig, tiny_config
from layerskip_tpu_torch.generation.engine import Engine, postprocess_output
from layerskip_tpu_torch.models.params import init_params, save_params
from layerskip_tpu_torch.training import recipe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRINTED = 1e-4  # the CLI prints losses to 4 decimals
LR = 1e-3
STEPS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(an fp32 checkpoint of a tiny model, a corpus)."""
    root = tmp_path_factory.mktemp("cli_mesh")
    cfg = tiny_config()
    ckpt = str(root / "model")
    save_params(init_params(cfg, seed=3, device="cpu"), ckpt, cfg)
    corpus = root / "corpus.jsonl"
    corpus.write_text("\n".join(json.dumps({"prompt": f"ab cd ef {i} ", "response": "gh ij"})
                                for i in range(8)))
    return ckpt, str(corpus)


def _flags(files, **kw):
    ckpt, corpus = files
    base = dict(model=ckpt, model_args="dtype=float32", device="cpu", dataset="custom_jsonl",
                data_path=corpus, steps=STEPS, batch_size=4, seq_len=16, log_every=1,
                early_exit_layers="1,2", e_scale=0.5, learning_rate=LR, p_max=0.3)
    return {**base, **kw}


def _one_process(flags):
    """``train.main`` in this process: (params, history)."""
    a = {k: flags[k] for k in ("model", "model_args", "device")}
    t = {k: v for k, v in flags.items() if k not in a}
    return train.main(Arguments(**a), train.TrainArguments(**t))


def _launched(nproc, flags):
    """The CLI as ``nproc`` gloo ranks of the launcher: rank 0's standard
    output and its (step, loss) lines."""
    argv = [sys.executable, "-m", "layerskip_tpu_torch.parallel.launch", "--nproc",
            str(nproc), "--backend", "gloo", "--", "-m", "layerskip_tpu_torch.cli.train"]
    for k, v in flags.items():
        argv += [f"--{k}", str(v)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run(argv, cwd=REPO, capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    rows = [line.split() for line in out.stdout.splitlines() if line.startswith("step ")]
    return out.stdout, [(int(r[1].split("/")[0]), float(r[2].split("=")[1])) for r in rows]


def _same_history(got, want):
    assert [s for s, _ in got] == [s for s, _ in want]
    np.testing.assert_allclose([x for _, x in got], [x for _, x in want], atol=PRINTED, rtol=0)


def _exported(path):
    params, cfg, _ = load_model_and_tokenizer(path, dtype=torch.float32, device="cpu")
    return params, cfg


@pytest.fixture(scope="module")
def runs(files, tmp_path_factory):
    root = tmp_path_factory.mktemp("runs")
    out = {"one": _one_process(_flags(files, export_dir=str(root / "one")))[1]}
    for name, nproc, kw in (("fsdp2", 2, dict(fsdp=2)), ("dp2tp2", 4, dict(dp=2, tp=2))):
        out[name] = _launched(nproc, _flags(files, export_dir=str(root / name), **kw))[1]
    return root, out


@pytest.mark.parametrize("name", ["fsdp2", "dp2tp2"])
def test_mesh_history_and_export_equal_one_process(runs, name):
    root, hist = runs
    _same_history(hist[name], hist["one"])
    assert len(hist[name]) == STEPS
    got, _ = _exported(str(root / name))
    want, _ = _exported(str(root / "one"))
    want = recipe.trainable_tensors(want)
    for k, w in recipe.trainable_tensors(got).items():
        assert w.shape == want[k].shape, k
        bound = LR * STEPS * 2 + 1e-6
        assert float((w - want[k]).abs().max()) <= bound, k
        # all but the weights whose gradients sit near 0 agree far closer
        close = np.isclose(w.numpy(), want[k].numpy(), atol=1e-5, rtol=1e-4)
        assert close.mean() > 0.99, (k, close.mean())


def test_gathered_export_loads_into_the_engine(runs):
    """The fsdp 2 run's export (the whole weights, gathered) generates:
    greedy self-speculative == greedy AR, the reference's bar."""
    root, _ = runs
    params, cfg = _exported(str(root / "fsdp2"))
    assert params.layers.wq.shape[0] == cfg.num_hidden_layers
    eng = Engine(params, cfg, device="cpu")
    streams = [postprocess_output(eng.generate([3, 5, 7, 9], GenerationConfig(
        max_steps=8, sample=False, **kw)), (), 8)
        for kw in (dict(generation_strategy="autoregressive"),
                   dict(generation_strategy="self_speculative", exit_layer=2,
                        num_speculations=3))]
    assert streams[0] == streams[1] and len(streams[0]) == 8


def test_checkpoint_resumes_across_meshes(files, tmp_path):
    """fsdp 2 writes, one process resumes; one process writes, fsdp 2
    resumes; each against one process resuming its own checkpoint."""
    ck2, ck1 = str(tmp_path / "ck_fsdp2"), str(tmp_path / "ck_one")
    _launched(2, _flags(files, fsdp=2, save_every=2, checkpoint_dir=ck2))
    _one_process(_flags(files, save_every=2, checkpoint_dir=ck1))
    assert train.checkpoint_steps(ck2) == train.checkpoint_steps(ck1) == [2, 4]
    a = torch.load(os.path.join(ck2, "4", "state.pt"), weights_only=True)
    b = torch.load(os.path.join(ck1, "4", "state.pt"), weights_only=True)
    assert a["step"] == b["step"] == 4
    for k, w in b["params"].items():
        assert a["params"][k].shape == w.shape, k
        assert float((a["params"][k] - w).abs().max()) <= LR * STEPS * 2 + 1e-6, k
    for idx, st in b["opt_state"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            assert a["opt_state"]["state"][idx][key].shape == st[key].shape

    more = dict(steps=STEPS + 2, save_every=100)
    copies = {}
    for label, src in (("ref", ck1), ("two_to_one", ck2), ("one_to_two", ck1)):
        copies[label] = str(tmp_path / label)
        shutil.copytree(src, copies[label])
    _, ref = _one_process(_flags(files, checkpoint_dir=copies["ref"], **more))
    _, two_to_one = _one_process(_flags(files, checkpoint_dir=copies["two_to_one"], **more))
    out, one_to_two = _launched(2, _flags(files, fsdp=2, checkpoint_dir=copies["one_to_two"],
                                          **more))
    assert "resumed from checkpoint step 4" in out
    assert [s for s, _ in ref] == [5, 6]
    _same_history(two_to_one, ref)
    _same_history(one_to_two, ref)
