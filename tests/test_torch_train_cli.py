"""The PyTorch port's train CLI (``cli/train.py``) on the CPU: training,
checkpoints, resume and export, against the JAX package's train CLI.

The port's loss history on a JAX-written checkpoint (loaded in bf16 by
both CLIs, as they load checkpoints; layer dropout off) agrees
with the JAX CLI's at rtol 1e-2: bf16 weights updated by bf16 AdamW
steps, where the two packages' fp32 reductions may round a weight to
neighbouring bf16 values. Checkpoints and the export are bit-exact.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from layerskip_tpu.cli.args import Arguments as JArguments
from layerskip_tpu.cli.train import TrainArguments as JTrainArguments
from layerskip_tpu.cli.train import main as jmain
from layerskip_tpu.config import ModelConfig as JModelConfig
from layerskip_tpu.models import params as jparams
from layerskip_tpu_torch.cli import train
from layerskip_tpu_torch.cli.args import Arguments
from layerskip_tpu_torch.cli.loading import load_model_and_tokenizer
from layerskip_tpu_torch.config import GenerationConfig
from layerskip_tpu_torch.generation.engine import Engine, postprocess_output
from layerskip_tpu_torch.training import recipe
from test_torch_apps import jax_ckpt  # noqa: F401 (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HISTORY_TOL = dict(rtol=1e-2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("data") / "corpus.jsonl"
    rows = [{"prompt": f"ab cd ef {i} ", "response": "gh ij kl"} for i in range(8)]
    path.write_text("\n".join(json.dumps(r) for r in rows))
    return str(path)


def _targs(corpus, **kw):
    base = dict(dataset="custom_jsonl", data_path=corpus, batch_size=2, seq_len=32,
                early_exit_layers="1,2", e_scale=0.5)
    return train.TrainArguments(**{**base, **kw})


def test_train_cli_with_checkpoint_resume(tmp_path, corpus, capsys):
    """6 steps with a checkpoint every 3 and an export, then a resume from
    step 6 to step 8 with a checkpoint every step: the resume line, at most
    3 checkpoints kept, a checkpoint restores the params and the optimizer
    bit for bit, and the export loads bit-equal into the JAX package and
    generates through the port's self-speculative engine."""
    args = Arguments(model="random:tiny", device="cpu", output_dir=str(tmp_path))
    ckpt, export = str(tmp_path / "ckpt"), str(tmp_path / "export")
    params, history = train.main(args, _targs(corpus, steps=6, checkpoint_dir=ckpt,
                                              save_every=3, log_every=2, export_dir=export))
    assert [s for s, _ in history] == [1, 2, 4, 6]
    assert all(np.isfinite(loss) and loss > 0 for _, loss in history)
    assert train.checkpoint_steps(ckpt) == [3, 6]
    assert os.path.exists(os.path.join(export, "model.safetensors"))

    # the step-6 checkpoint holds the returned params and the optimizer
    fresh, cfg, _ = load_model_and_tokenizer("random:tiny", seed=args.seed, device="cpu")
    _, init_opt = recipe.make_train_step(cfg, recipe.TrainConfig())
    opt = init_opt(fresh)
    train.restore_checkpoint(ckpt, 6, fresh, opt)
    trained = recipe.trainable_tensors(params)
    for name, w in recipe.trainable_tensors(fresh).items():
        assert torch.equal(w, trained[name]), name
    assert all(int(st["step"]) == 6 for st in opt.state.values())

    # the export: bit-equal in the JAX package, and it generates
    jcfg = JModelConfig.from_pretrained(export, dtype=jnp.float32)
    loaded = jparams.load_params(export, jcfg)
    for name, w in trained.items():
        obj = loaded.layers if name.startswith("layers.") else loaded
        want = np.asarray(getattr(obj, name.split(".")[-1]))
        assert np.array_equal(want, w.detach().float().numpy()), name
    p32, cfg32, _ = load_model_and_tokenizer(export, dtype=torch.float32, device="cpu")
    toks = postprocess_output(Engine(p32, cfg32, device="cpu").generate(
        [3, 5, 7], GenerationConfig(max_steps=6, sample=False,
                                    generation_strategy="self_speculative", exit_layer=2,
                                    num_speculations=2)), (), 6)
    assert len(toks) == 6

    capsys.readouterr()
    _, history2 = train.main(args, _targs(corpus, steps=8, checkpoint_dir=ckpt,
                                          save_every=1, log_every=1))
    assert "resumed from checkpoint step 6" in capsys.readouterr().out
    assert [s for s, _ in history2] == [7, 8]
    assert train.checkpoint_steps(ckpt) == [6, 7, 8]  # step 3 deleted: 3 kept


def test_loss_history_equals_the_jax_cli(tmp_path, corpus, jax_ckpt):  # noqa: F811
    """Both CLIs on one JAX-written checkpoint (each loads it in bf16),
    the same corpus, seed and flags, layer dropout off: the same logged
    steps, and losses within HISTORY_TOL."""
    d, _ = jax_ckpt
    flags = dict(dataset="custom_jsonl", data_path=corpus, steps=4, batch_size=2,
                 seq_len=16, p_max=0.0, early_exit_layers="1,2", e_scale=0.5,
                 ce_chunk_tokens=16, log_every=1, learning_rate=1e-3)
    _, want = jmain(JArguments(model=d), JTrainArguments(**flags))
    _, got = train.main(Arguments(model=d, device="cpu"), train.TrainArguments(**flags))
    assert [s for s, _ in got] == [s for s, _ in want] == [1, 2, 3, 4]
    np.testing.assert_allclose([x for _, x in got], [x for _, x in want], **HISTORY_TOL)


def test_moe_router_trains(tmp_path, corpus):
    """A tiny Mixtral-style model (``random:moe``): one CLI step changes the
    router's weights; the load-balancing term is >= ~1, reaches the total
    and gives the router a gradient (the JAX package's
    test_moe_train_step_and_aux_loss)."""
    args = Arguments(model="random:moe", device="cpu", seed=3)
    params, history = train.main(args, _targs(corpus, steps=1, seq_len=16))
    before, cfg, _ = load_model_and_tokenizer("random:moe", seed=3, device="cpu")
    assert np.isfinite(history[0][1])
    assert not torch.equal(params.layers.w_router.detach(), before.layers.w_router)
    assert not torch.equal(params.layers.w_gate.detach(), before.layers.w_gate)

    ids = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16)))
    labels = torch.roll(ids, -1, dims=1)
    keep = torch.ones((cfg.num_hidden_layers, 2), dtype=torch.bool)
    for w in recipe.trainable_tensors(before).values():
        w.requires_grad_(True)
    tcfg = recipe.TrainConfig(early_exit_layers=(2,), moe_aux_coef=0.02)
    total, aux = recipe.layerskip_loss(before, cfg, tcfg, ids, labels, keep=keep)
    total.backward()
    assert float(aux["moe_aux"].detach()) >= 0.99  # 1.0 when perfectly balanced
    assert float(before.layers.w_router.grad.abs().sum()) > 0.0
    with torch.no_grad():
        total0, _ = recipe.layerskip_loss(before, cfg,
                                          dataclasses.replace(tcfg, moe_aux_coef=0.0),
                                          ids, labels, keep=keep)
    assert float(total.detach()) > float(total0)


def test_mesh_flags_and_the_default_device_refuse(corpus):
    """The mesh flags need their ranks (the mesh itself runs in
    tests/test_torch_train_cli_mesh.py): one process is no world of 2."""
    with pytest.raises(ValueError, match="!= #devices=1"):
        train.main(Arguments(model="random:tiny", device="cpu"),
                   _targs(corpus, steps=1, fsdp=2))
    with pytest.raises(ValueError, match="!= #devices=1"):
        train.main(Arguments(model="random:tiny", device="cpu", dp=2),
                   _targs(corpus, steps=1))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(Arguments(model="random:tiny"), _targs(corpus, steps=1))


def test_command_line(tmp_path, corpus):
    """``python -m layerskip_tpu_torch.cli.train`` parses its flags, trains
    and exports."""
    out = subprocess.run(
        [sys.executable, "-m", "layerskip_tpu_torch.cli.train", "--model", "random:tiny",
         "--device", "cpu", "--dataset", "custom_jsonl", "--data_path", corpus,
         "--steps", "2", "--batch_size", "2", "--seq_len", "16", "--log_every", "1",
         "--export_dir", str(tmp_path / "export")],
        cwd=REPO, capture_output=True, text=True, timeout=300, check=True).stdout
    assert "step 1/2 loss=" in out and "step 2/2 loss=" in out
    assert "exported HF-compatible checkpoint" in out
