"""Where the time goes in the PyTorch port's main path on one NVIDIA GPU.

    python3 scripts/profile_torch_spec.py [--config 7b] [--steps 128]
        [--quantize none|int8|int4] [--draft-quant 0|8|4] [--serve-batch 4]

Random weights of a preset shape (bf16, identity tail past the exit layer,
as chip_smoke.py builds them), optionally quantized (``--quantize``: an int8
or int4 base; ``--draft-quant``: a quantized drafter for the spec run), a
right-sized random prompt, greedy decoding.
For AR and for self-spec (and, with ``--serve-batch B``, for 8 rounds of a
paged continuous session with B slots of that prompt, pages of 128) it
prints one JSON line each with:

  * wall seconds and tok/s of a whole ``Engine.generate`` (host clock around
    work that ends in a synchronize), with and without the profiler;
  * from ``torch.profiler`` over a second, profiled generate: the device's
    busy time (union of kernel intervals), its idle share of the window,
    kernels launched per generated token, and device time by kernel class
    and by kernel name (top 12).

``--trace DIR`` also writes each run's Chrome trace there (tens of MB
each at 7B). Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from layerskip_tpu_torch.config import PRESETS, GenerationConfig  # noqa: E402
from layerskip_tpu_torch.generation.engine import Engine  # noqa: E402
from layerskip_tpu_torch.models.params import make_random_params  # noqa: E402
from layerskip_tpu_torch.quant import quantize_llama_params  # noqa: E402

# kernel name -> class, first match wins
_CLASSES = (
    ("flash_prefill", re.compile(r"flash_prefill")),
    ("paged_decode", re.compile(r"paged_decode")),
    ("quant_matmul", re.compile(r"qmm_")),
    ("gemm", re.compile(r"gemm|gemv|nvjet|sm90_xmma|cutlass|cublas|splitKreduce", re.I)),
    ("copy/cast", re.compile(r"copy|cast|convert|direct_copy|CatArray", re.I)),
    ("reduce", re.compile(r"reduce|softmax|argmax|max|sum|mean|cumprod|cumsum", re.I)),
    ("index/scatter", re.compile(r"index|scatter|gather|embedding", re.I)),
    ("elementwise", re.compile(r"elementwise|vectorized|unrolled", re.I)),
)


def _classify(name: str) -> str:
    for cls, pat in _CLASSES:
        if pat.search(name):
            return cls
    return "other"


def _device_summary(prof, n_tokens: int) -> dict:
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return {"device_time": "not measured (the profiler saw no device events)"}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    cpu = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    t0 = min([spans[0][0]] + [e.time_range.start for e in cpu])
    t1 = max([spans[-1][1]] + [e.time_range.end for e in cpu])
    by_class, by_name, count = defaultdict(float), defaultdict(float), defaultdict(int)
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        by_class[_classify(e.name)] += dur
        by_name[e.name[:90]] += dur
        count[e.name[:90]] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {
        "window_ms": (t1 - t0) / 1e3,
        "device_busy_ms": busy / 1e3,
        "device_idle_share": 1.0 - busy / max(t1 - t0, 1e-9),
        "kernels": len(kernels),
        "kernels_per_token": len(kernels) / max(n_tokens, 1),
        "device_ms_by_class": {k: v / 1e3 for k, v in
                               sorted(by_class.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms": [{"name": n, "ms": v / 1e3, "count": count[n]} for n, v in top],
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="7b", choices=sorted(PRESETS))
    ap.add_argument("--prompt", type=int, default=200)
    ap.add_argument("--steps", type=int, default=128)
    ap.add_argument("--exit-layer", type=int, default=8)
    ap.add_argument("--spec", type=int, default=6)
    ap.add_argument("--quantize", default="none", choices=("none", "int8", "int4"))
    ap.add_argument("--draft-quant", type=int, default=0, choices=(0, 8, 4))
    ap.add_argument("--serve-batch", type=int, default=0,
                    help="also profile rounds of a paged continuous session")
    ap.add_argument("--trace", default="", help="directory for Chrome traces")
    args = ap.parse_args()

    cfg = PRESETS[args.config]()
    params = make_random_params(cfg, exit_layer=args.exit_layer, tail_eps=0.0, seed=0,
                                device="cuda")
    if args.quantize != "none":
        bits = int(args.quantize[3:])
        params = quantize_llama_params(params, bits=bits, group=128 if bits == 4 else 0)
    eng = Engine(params, cfg, device="cuda")
    prompt = np.random.default_rng(2).integers(3, cfg.vocab_size, size=args.prompt).tolist()
    eos = (cfg.vocab_size + 7,)  # unreachable: every run makes all its steps
    modes = {
        "ar": GenerationConfig(max_steps=args.steps, sample=False,
                               generation_strategy="autoregressive"),
        "spec": GenerationConfig(max_steps=args.steps, sample=False,
                                 generation_strategy="self_speculative",
                                 exit_layer=args.exit_layer, num_speculations=args.spec,
                                 draft_quant=args.draft_quant),
    }
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    # every unprofiled timing comes before the first profiler session, which
    # may leave the host slower for the rest of the process
    timed = {}
    for mode, gcfg in modes.items():
        eng.generate(prompt, gcfg, eos_ids=eos)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.generate(prompt, gcfg, eos_ids=eos)
        n = int(out.num_tokens[0])
        timed[mode] = (out, n, time.perf_counter() - t0)
    for mode, gcfg in modes.items():
        out, n, wall = timed[mode]
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            eng.generate(prompt, gcfg, eos_ids=eos)
            torch.cuda.synchronize()
            wall_prof = time.perf_counter() - t0
        if args.trace:
            os.makedirs(args.trace, exist_ok=True)
            prof.export_chrome_trace(os.path.join(args.trace, f"{args.config}_{mode}.json"))
        rec = {"mode": mode, "config": args.config, "quantize": args.quantize,
               "draft_quant": args.draft_quant if mode == "spec" else 0,
               "device": card, "prompt": args.prompt,
               "tokens": n, "wall_s": wall, "tok_s": n / wall,
               "wall_s_profiled": wall_prof,
               "matches": int(out.matches), "drafts": int(out.drafts)}
        rec.update(_device_summary(prof, n))
        print(json.dumps(rec), flush=True)
    if args.serve_batch:
        _profile_serving(eng, modes["spec"], prompt, args, card)
    return 0


def _profile_serving(eng, gcfg, prompt, args, card, rounds: int = 8):
    """Rounds of a paged session with ``--serve-batch`` slots all decoding
    (8 unprofiled, then 8 profiled; with W 6 at acceptance 1 no row runs out
    of its --steps budget), after one insert of every slot."""
    b = args.serve_batch
    bucket = -(-args.prompt // 64) * 64
    page = 128
    pages = b * -(-(bucket + args.steps + args.spec + 2) // page)
    session = eng.continuous_session(gcfg, b, bucket, eos_ids=(eng.cfg.vocab_size + 7,),
                                     paged_pool_pages=pages, page_size=page)
    session.insert(list(range(b)), [prompt] * b, max_tokens=[args.steps] * b)
    session.step()  # warm-up round
    runs = {}
    for profiled in (False, True):
        before = int(session.state.out_len.sum())
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        ctx = torch.profiler.profile(activities=acts) if profiled else contextlib.nullcontext()
        with ctx as prof:
            t0 = time.perf_counter()
            for _ in range(rounds):
                session.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        runs[profiled] = (int(session.state.out_len.sum()) - before, wall, prof)
    n, wall, _ = runs[False]
    n_prof, wall_prof, prof = runs[True]
    rec = {"mode": f"serve_b{b}", "config": args.config, "quantize": args.quantize,
           "device": card, "prompt": args.prompt, "rounds": rounds, "tokens": n,
           "wall_s": wall, "tok_s": n / wall, "round_ms": wall / rounds * 1e3,
           "wall_s_profiled": wall_prof}
    rec.update(_device_summary(prof, n_prof))
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    sys.exit(main())
