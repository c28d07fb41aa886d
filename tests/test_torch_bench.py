"""The port's bench (``python -m layerskip_tpu_torch.bench``) prints one valid
JSON line: when it completes, and when SIGTERM cuts its curve after the
first speculative point (the line so far, from memory). Run as a subprocess
on the CPU at the tiny config."""

import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REQUIRED_KEYS = {"metric", "value", "unit", "vs_baseline"}
CMD = [sys.executable, "-m", "layerskip_tpu_torch.bench", "--config", "tiny",
       "--device", "cpu", "--repeats", "1"]


def _env():
    return dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
                OMP_NUM_THREADS="1")


def _one_line(stdout: bytes) -> dict:
    lines = stdout.decode().strip().splitlines()
    assert len(lines) == 1, lines
    d = json.loads(lines[0])
    assert REQUIRED_KEYS <= set(d) and d["value"] > 0, d
    return d


def test_bench_completes_with_one_valid_line(tmp_path):
    sidecar = tmp_path / "partial.json"
    proc = subprocess.run(CMD + ["--no-curve", "--max-steps", "16", "--sidecar", str(sidecar)],
                          stdout=subprocess.PIPE,
                          stderr=subprocess.DEVNULL, timeout=300, cwd=str(tmp_path),
                          env=_env())
    assert proc.returncode == 0
    d = _one_line(proc.stdout)
    assert d["metric"] == "selfspec_speedup_vs_ar_tiny_exit2_spec6"
    assert d["unit"] == "x" and d["backend"] == "cpu" and d["spec_backed"] is True
    assert 0 < d["acceptance"] <= 1 and d["ar_tokens_per_s"] > 0
    assert not sidecar.exists()


@pytest.mark.parametrize("flags,metric", [
    (["--tree-width", "2"], "selfspec_speedup_vs_ar_tiny_tree2_exit2_spec6"),
    (["--draft-exit-prob", "0.5"], "selfspec_speedup_vs_ar_tiny_exit2_spec6"),
])
def test_bench_strategy_flags(tmp_path, flags, metric):
    """``--tree-width`` and ``--draft-exit-prob`` carry the JAX bench's
    meaning and metric name: a tree point names its width."""
    sidecar = tmp_path / "partial.json"
    proc = subprocess.run(CMD + ["--no-curve", "--max-steps", "16", "--sidecar", str(sidecar)]
                          + flags, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                          timeout=300, cwd=str(tmp_path), env=_env())
    assert proc.returncode == 0
    d = _one_line(proc.stdout)
    assert d["metric"] == metric and 0 < d["acceptance"] <= 1
    assert not sidecar.exists()


def test_bench_sigterm_prints_the_line_so_far(tmp_path):
    sidecar = tmp_path / "partial.json"
    proc = subprocess.Popen(CMD + ["--max-steps", "32", "--sidecar", str(sidecar)],
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                            cwd=str(tmp_path), env=_env())
    try:
        deadline = time.time() + 300
        while time.time() < deadline and proc.poll() is None:
            try:
                with open(sidecar) as f:
                    if json.load(f).get("spec_backed"):
                        break
            except (OSError, ValueError):
                pass
            time.sleep(0.05)
        interrupted = proc.poll() is None
        if interrupted:
            proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0
    d = _one_line(out)
    assert d["spec_backed"] is True
    assert d.get("interrupted", False) == interrupted


def test_bench_needs_a_gpu_unless_the_cpu_is_asked_for(tmp_path):
    """Without ``--device`` the bench runs on the card: with none it exits
    non-zero and prints no line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    proc = subprocess.run([a for a in CMD if a not in ("--device", "cpu")] + ["--no-curve"],
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE, timeout=300,
                          cwd=str(tmp_path), env=_env())
    assert proc.returncode != 0 and proc.stdout == b""
    assert b"no CUDA device" in proc.stderr
