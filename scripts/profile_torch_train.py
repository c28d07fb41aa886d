"""Where the time goes in one LayerSkip training step of the PyTorch port on
one NVIDIA GPU.

    python3 scripts/profile_torch_train.py [--config 1b] [--batch 4] [--seq 1024]
        [--ce-chunk 1024] [--steps 3]

Random bf16 weights of a preset shape (``random:<config>``, seed 0), the
recipe's defaults (quarter-depth exits, p_max 0.1) and random token
batches. After ``--steps`` unprofiled steps (the first one a warm-up), it
prints one JSON line with the median step ms, tokens/s, peak memory, and,
from ``torch.profiler`` over one more step: the device's busy time, its
idle share of the window, kernels launched, and device time by kernel
class and by kernel name (top 12), the same summary as
``scripts/profile_torch_spec.py``. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from layerskip_tpu_torch.cli.loading import load_model_and_tokenizer  # noqa: E402
from layerskip_tpu_torch.config import PRESETS  # noqa: E402
from layerskip_tpu_torch.training.recipe import TrainConfig, make_train_step  # noqa: E402
from profile_torch_spec import _device_summary  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="1b", choices=sorted(PRESETS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--ce-chunk", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    params, cfg, _ = load_model_and_tokenizer(f"random:{args.config}", device="cuda")
    train_step, init_opt = make_train_step(cfg, TrainConfig(ce_chunk_tokens=args.ce_chunk))
    opt = init_opt(params)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)

    def step(i):
        ids = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(args.batch, args.seq)))
        ids = ids.cuda()
        train_step(params, opt, ids, torch.roll(ids, -1, dims=1), gen, i)

    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(args.steps)
        torch.cuda.synchronize()
        wall_prof = (time.perf_counter() - t0) * 1e3
    med = float(np.median(times[1:])) if len(times) > 1 else times[0]
    rec = {"config": args.config, "device": card, "batch": args.batch, "seq": args.seq,
           "ce_chunk_tokens": args.ce_chunk, "step_ms": times, "step_ms_median": med,
           "tok_s": args.batch * args.seq / med * 1e3,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "step_ms_profiled": wall_prof}
    rec.update(_device_summary(prof, 1))
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
