"""Time K2/K3 (paged decode attention) on the card against another build of their source.

    python3 scripts/bench_paged_decode.py [--baseline [LABEL=]DIR/paged_decode.cu ...]
                                          [--cases NAME,...]

Builds ``layerskip_tpu_torch/csrc/paged_decode.cu`` and, with
``--baseline`` (repeatable), other sources with the same C interface (for
example the parent commit's, unpacked with ``git archive`` into a
git-ignored directory), each with nvcc into ``build/kernels/``. Then, at the 7B decode
shapes of ``chip_smoke.py`` phase 3 (B 4, Hkv 32, Dh 128, pages of 128; T 1
and 7 at ~400 keys of context, T 1 at ~2000 keys, and B 1 at 2047 keys;
bf16 pools for K2, int8 for K3), it checks each build against the plain
version (``chip_smoke.py``'s tolerance, 0.02) and times it in turns
(baselines, current, current, baselines in reverse; twice) with L2 flushed before each
call (``chip_smoke.time_cold_ms``), beside one
``scaled_dot_product_attention`` call over a view gathered ahead of time
and the card's bound (``chip_smoke.paged_bound``). Prints the card's name
and power limit, one line per measurement, and a JSON summary last. Needs
a CUDA device and nvcc; about a minute.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from layerskip_tpu_torch.ops.cuda import build  # noqa: E402

ROUNDS = 2
CASES = ("paged_decode_7b_t1_bf16", "paged_decode_7b_t7_bf16",
         "paged_decode_q8_7b_t1_bf16", "paged_decode_q8_7b_t7_bf16",
         "paged_decode_7b_long_t1_bf16", "paged_decode_q8_7b_long_t1_bf16",
         "paged_decode_7b_b1_long_t1_bf16")


def compile_sources(sources: dict) -> dict:
    """label -> loaded library of each source, one nvcc each, all started
    together."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, src in sources.items():
        out = build.BUILD_DIR / f"libbench_paged_{label}.so"
        procs[label] = (out, subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                                               src], stdout=subprocess.DEVNULL))
    for label, (out, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on {sources[label]}")
    return {label: ctypes.CDLL(str(out)) for label, (out, _) in procs.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", action="append", default=[],
                    help="[LABEL=]PATH of another paged_decode.cu with the same C interface")
    ap.add_argument("--cases", help="comma-separated case names (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_paged_decode: no CUDA device", file=sys.stderr)
        return 2
    print(chip_smoke.card_line(), flush=True)
    sources = {}
    for i, spec in enumerate(args.baseline):
        label, _, path = spec.rpartition("=")
        sources[label or ("baseline" if len(args.baseline) == 1 else f"baseline{i}")] = path
    others = list(sources)
    sources["current"] = str(build.CSRC_DIR / "paged_decode.cu")
    libs = compile_sources(sources)
    order = others + ["current", "current"] + others[::-1]

    gen = torch.Generator(device="cuda").manual_seed(3)
    summary, ok = {}, True
    cases = {c[0]: c[1:] for c in chip_smoke.paged_cases()}
    for name in args.cases.split(",") if args.cases else CASES:
        b, t, g, hkv, dh, page, rows, dtype, quant, window, scale, cap, tree, tol = cases[name]
        k, v, _, _, q, pos, tree_kw = chip_smoke.paged_case_tensors(
            b, t, g, hkv, dh, page, rows, dtype, quant, tree, gen,
            chip_smoke.paged_capacity(rows))
        kw = dict(q_heads_per_kv=g, sliding_window=window, score_scale=scale,
                  logit_softcap=cap, **tree_kw)
        fn, plain = chip_smoke.paged_calls(q, k, v, pos, kw)
        want = plain().float()
        row = {"ms": {label: [] for label in libs}, "max_abs_err": {}}
        for label, lib in libs.items():
            build._LIBS["paged_decode"] = lib
            err = (fn().float() - want).abs().max().item()
            row["max_abs_err"][label] = err
            ok &= err <= tol
        for rnd in range(ROUNDS):
            for label in order:
                build._LIBS["paged_decode"] = libs[label]
                ms = chip_smoke.time_cold_ms(fn)
                row["ms"][label].append(ms)
                print(f"[bench] {name} round {rnd} {label}: {ms:.4f} ms", flush=True)
        row["sdpa_ms"] = chip_smoke.time_cold_ms(
            chip_smoke.paged_sdpa_call(q, k, v, pos, window, scale))
        row["bound_ms"], row["bound_by"] = chip_smoke.paged_bound(
            q, hkv, k.max_pages * page, pos, window, tree_kw, quant)
        print(f"[bench] {name}: sdpa {row['sdpa_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
              f"({row['bound_by']}), max_abs_err {row['max_abs_err']}", flush=True)
        summary[name] = row
        del k, v, q
    build._LIBS.pop("paged_decode", None)
    print(json.dumps({"card": chip_smoke.card_line(), "ok": ok, "cases": summary}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
