"""Time K4-K7 (the int8/int4 products) on the card against other builds of their source.

    python3 scripts/bench_quant_matmul.py [--baseline [LABEL=]DIR/quant_matmul.cu ...]
                                          [--kernels quant_matmul_t,...] [--m 1,7,256]
                                          [--ttft]

Builds ``layerskip_tpu_torch/csrc/quant_matmul.cu`` and, with
``--baseline`` (repeatable), other sources with the same C interface (for
example the parent commit's, unpacked with ``git archive`` into a
git-ignored directory), each with nvcc into ``build/kernels/``, all at once.
Then, for each kernel of ``--kernels`` (default all four) at each M, in
bf16 with N(0, 0.02) weights: K5 (int8) and K6 (int4, G 128) on the 7B
[K, N] layer shapes wo [4096, 4096], w_gate [4096, 11008] and w_down
[11008, 4096], K4 (int8) and K7 (int4, G 128) on the [N, K] shapes of the
7B wq [4096, 4096] and the Llama-3.2-1B wk [512, 2048]. It checks each
build against the plain version (one bf16 ulp of the largest output,
``chip_smoke.py``'s tolerance) and times it in turns (baselines, current,
current, baselines in reverse; twice) with L2 flushed before each call
(``chip_smoke.time_cold_ms``), beside one bf16 ``torch.matmul`` (or
``F.linear`` for [N, K]) on the weight dequantized ahead of time and the
card's bound (``chip_smoke.quant_bound``). With ``--ttft`` it also builds the random
Llama-2-7B of ``chip_smoke.py`` phase 5, quantizes it to int8 and to int4,
and times ``generate(max_steps=1)`` of a 200- and a 2000-token prompt with
each build in the same turns (wall ms after a warm-up). Prints the card's
name and power limit, one line per measurement, a JSON summary, and
``{"ok": ..., "device": ...}`` last. Needs a CUDA device and nvcc; about
two minutes, four with ``--ttft``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from layerskip_tpu_torch.ops.cuda import build  # noqa: E402

ROUNDS = 2
KERNELS = ("quant_matmul_t", "quant_matmul", "int4_matmul", "int4_matmul_t")


def compile_sources(sources: dict) -> dict:
    """label -> loaded library of each source, one nvcc each, all started
    together."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, src in sources.items():
        out = build.BUILD_DIR / f"libbench_quant_{label}.so"
        procs[label] = (out, subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                                               src], stdout=subprocess.DEVNULL))
    for label, (out, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on {sources[label]}")
    return {label: ctypes.CDLL(str(out)) for label, (out, _) in procs.items()}


def bench_products(libs, order, kernels, ms_list):
    import torch.nn.functional as F

    from layerskip_tpu_torch.ops.cuda import quant_matmul as qmm
    from layerskip_tpu_torch.quant import quantize_tensor

    gen = torch.Generator(device="cuda").manual_seed(1)
    summary, ok = {}, True
    for kern in kernels:
        fn, plain = getattr(qmm, kern), getattr(qmm, f"{kern}_plain")
        bits, k_last = 4 if kern.startswith("int4") else 8, kern.endswith("_t")
        layers = (chip_smoke.NK_LAYERS if k_last else
                  [(f"7b_{layer}", k, n) for layer, k, n in chip_smoke.KN_LAYERS])
        for layer, k, n in layers:
            w = torch.randn((n, k) if k_last else (k, n), generator=gen, device="cuda") * 0.02
            qt = quantize_tensor(w, k_last=k_last, bits=bits, group=128 if bits == 4 else 0)
            del w
            w_deq = qt.dequantize(torch.bfloat16)
            kw = dict(group=qt.group) if bits == 4 else {}
            for m in ms_list:
                name = f"{kern}_{layer}_m{m}"
                x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
                want = plain(x, qt.q, qt.scale, **kw).float()
                tol = 2.0 ** -7 * want.abs().max().item()
                call = lambda: fn(x, qt.q, qt.scale, **kw)  # noqa: E731
                row = {"ms": {label: [] for label in libs}, "max_abs_err": {}}
                for label, lib in libs.items():
                    build._LIBS["quant_matmul"] = lib
                    err = (call().float() - want).abs().max().item()
                    row["max_abs_err"][label] = err
                    ok &= err <= tol
                for rnd in range(ROUNDS):
                    for label in order:
                        build._LIBS["quant_matmul"] = libs[label]
                        ms = chip_smoke.time_cold_ms(call)
                        row["ms"][label].append(ms)
                        print(f"[bench] {name} round {rnd} {label}: {ms:.4f} ms", flush=True)
                lib = F.linear if k_last else torch.matmul
                row["library_ms"] = chip_smoke.time_cold_ms(lambda: lib(x, w_deq))
                row["bound_ms"], row["bound_by"] = chip_smoke.quant_bound(
                    m, k, n, bits, torch.bfloat16)
                row["tol"] = tol
                print(f"[bench] {name}: cuBLAS bf16 {row['library_ms']:.4f} ms, bound "
                      f"{row['bound_ms']:.5f} ms ({row['bound_by']}), max_abs_err "
                      f"{row['max_abs_err']} (tol {tol:.3g})", flush=True)
                summary[name] = row
            del qt, w_deq
    return ok, summary


def bench_ttft(libs, order):
    """Wall ms of generate(max_steps=1) on the int8 and int4 7B bases, per
    build, in the same turns."""
    from layerskip_tpu_torch.config import GenerationConfig, llama2_7b_config
    from layerskip_tpu_torch.generation.engine import Engine
    from layerskip_tpu_torch.models.params import make_random_params
    from layerskip_tpu_torch.quant import quantize_llama_params

    cfg = llama2_7b_config()
    params = make_random_params(cfg, exit_layer=chip_smoke.FULL_EXIT, tail_eps=0.0, seed=0,
                                device="cuda")
    eos = (cfg.vocab_size + 7,)
    gen_cfg = GenerationConfig(max_steps=1, sample=False, generation_strategy="autoregressive")
    rng = np.random.default_rng(4)
    prompts = {n: rng.integers(3, cfg.vocab_size, size=n).tolist()
               for n, _, _ in chip_smoke.TTFT_PROMPTS}
    summary = {}
    for bits in (8, 4):
        eng = Engine(quantize_llama_params(params, bits=bits, group=128 if bits == 4 else 0),
                     cfg, device="cuda")
        for n, prompt in prompts.items():
            row = {label: [] for label in libs}
            for rnd in range(ROUNDS):
                for label in order:
                    build._LIBS["quant_matmul"] = libs[label]
                    eng.generate(prompt, gen_cfg, eos_ids=eos)  # warm-up
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    eng.generate(prompt, gen_cfg, eos_ids=eos)
                    torch.cuda.synchronize()
                    ms = (time.perf_counter() - t0) * 1e3
                    row[label].append(ms)
                    print(f"[ttft] int{bits} base, {n}-token prompt, round {rnd} {label}: "
                          f"{ms:.2f} ms", flush=True)
            summary[f"int{bits}_base_{n}"] = row
        del eng
        torch.cuda.empty_cache()
    return summary


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", action="append", default=[],
                    help="[LABEL=]PATH of another quant_matmul.cu with the same C interface")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="comma-separated wrappers to time (default: all four)")
    ap.add_argument("--m", default="1,7,256", help="comma-separated M (rows of x)")
    ap.add_argument("--ttft", action="store_true",
                    help="also time the first token of the int8 and int4 7B bases per build")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_quant_matmul: no CUDA device", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    print(card, flush=True)
    sources = {}
    for i, spec in enumerate(args.baseline):
        label, _, path = spec.rpartition("=")
        sources[label or ("baseline" if len(args.baseline) == 1 else f"baseline{i}")] = path
    others = list(sources)
    sources["current"] = str(build.CSRC_DIR / "quant_matmul.cu")
    libs = compile_sources(sources)
    order = others + ["current", "current"] + others[::-1]

    ok, products = bench_products(libs, order, args.kernels.split(","),
                                  [int(m) for m in args.m.split(",")])
    ttft = bench_ttft(libs, order) if args.ttft else {}
    build._LIBS.pop("quant_matmul", None)
    print(json.dumps({"card": card, "ok": ok, "cases": products, "ttft": ttft}))
    print(json.dumps({"ok": ok, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
