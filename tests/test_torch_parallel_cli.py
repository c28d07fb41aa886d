"""The two-host rehearsal and the CLI apps under tp 2, on the CPU.

``python -m layerskip_tpu_torch.parallel.multihost_smoke`` (two launchers
of two gloo ranks) must exit 0, and ``cli.generate`` (prompts on stdin) and
``cli.benchmark`` (a ``custom_jsonl`` file) as two gloo ranks of the port's
launcher at ``--tp 2`` must give what they give in one process.
"""

import json
import os
import subprocess
import sys

import pytest

import torch_parallel_ranks as R
from layerskip_tpu_torch.config import tiny_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_multihost_smoke_exits_0():
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-m", "layerskip_tpu_torch.parallel.multihost_smoke"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "multihost smoke: PASS" in proc.stdout


# ------------------------------------------------------------ the CLI apps


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """The main model as an fp32 checkpoint the CLI apps load."""
    from layerskip_tpu_torch.models.params import params_from_numpy, save_params

    d = str(tmp_path_factory.mktemp("ckpt"))
    inputs = R.build_inputs()
    save_params(params_from_numpy(inputs["trees"]["main"], device="cpu"), d,
                tiny_config(**R.MAIN))
    return d


def _cli(module, args, nproc, stdin=None, cwd=None):
    """stdout of ``python -m module args`` alone (nproc 1) or as gloo ranks
    of the port's launcher."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    cmd = [sys.executable, "-m", module, *args]
    if nproc > 1:
        cmd = [sys.executable, "-m", "layerskip_tpu_torch.parallel.launch", "--nproc",
               str(nproc), "--backend", "gloo", "--timeout", "600", "--", "-m", module,
               *args, "--tp", str(nproc)]
    proc = subprocess.run(cmd, input=stdin, capture_output=True, text=True, env=env, cwd=cwd,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


_GEN = ["--device", "cpu", "--model_args", "dtype=float32", "--max_steps", "10",
        "--sample", "false", "--generation_strategy", "self_speculative", "--exit_layer", "2",
        "--num_speculations", "3"]


def test_cli_generate_tp2_equals_tp1(checkpoint):
    """Rank 0 reads stdin and broadcasts each prompt; only rank 0 prints."""
    args = ["--model", checkpoint, *_GEN, "--warmup", "false"]
    stdin = "hello there\nthe quick brown fox\n"
    want = _cli("layerskip_tpu_torch.cli.generate", args, 1, stdin)
    got = _cli("layerskip_tpu_torch.cli.generate", args, 2, stdin)
    assert got == want and len(want.strip().splitlines()) == 2


def test_cli_benchmark_tp2_equals_tp1(checkpoint, tmp_path):
    data = tmp_path / "d.jsonl"
    data.write_text("".join(json.dumps({"prompt": p, "response": "a b c"}) + "\n"
                            for p in ("hello there", "one two three four", "xyz")))
    results = []
    for nproc in (1, 2):
        out = tmp_path / f"out{nproc}"
        _cli("layerskip_tpu_torch.cli.benchmark",
             ["--model", checkpoint, *_GEN, "--dataset", "custom_jsonl", "--data_path",
              str(data), "--num_samples", "3", "--output_dir", str(out)], nproc)
        (name,) = os.listdir(out)  # only rank 0 writes
        metrics = json.load(open(out / name))["metric_result"]
        results.append({k: v for k, v in metrics.items()
                        if k not in ("total_time", "time_per_token", "tokens_per_second")})
    assert results[0] == results[1]
    assert results[0]["acceptance_rate"]["mean"] > 0
