"""Time K1 (flash prefill, bf16) on the card against another build of its source.

    python3 scripts/bench_flash_prefill.py [--baseline DIR/flash_prefill.cu]

Builds ``layerskip_tpu_torch/csrc/flash_prefill.cu`` and, with
``--baseline``, another source with the same C interface (for example the
parent commit's, unpacked with ``git archive`` into a git-ignored
directory), each with nvcc into ``build/kernels/``. Then, at the main
paths' bf16 prefill shapes (the 7B 256-token prefill over the engine's
512-key cache, and 2048-token prompts over 2560 keys with the 7B and the
Llama-3.2-1B heads), it checks each build against the plain version and
times it in turns (baseline, current, current, baseline, twice) with
``chip_smoke.time_ms``, beside one ``scaled_dot_product_attention`` call
(``is_causal``) and the card's bound (``chip_smoke.flash_bound``). Prints
the card's name and power limit, one line per measurement, and a JSON
summary last. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from layerskip_tpu_torch.ops.cuda import build  # noqa: E402
from layerskip_tpu_torch.ops.cuda import flash_prefill as k1  # noqa: E402

ROUNDS = 2
# (name, B, T, S, Hkv, G, Dh): causal, past 0
SHAPES = (("7b_t256", 1, 256, 512, 32, 1, 128),
          ("7b_t2048", 1, 2048, 2560, 32, 1, 128),
          ("1b_t2048", 1, 2048, 2560, 8, 4, 64))


def compile_source(src: str, name: str) -> ctypes.CDLL:
    out = build.BUILD_DIR / f"libbench_{name}.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), src], check=True,
                   stdout=subprocess.DEVNULL)
    return ctypes.CDLL(str(out))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", help="another flash_prefill.cu with the same C interface")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_flash_prefill: no CUDA device", file=sys.stderr)
        return 2
    print(chip_smoke.card_line(), flush=True)
    libs = {"current": compile_source(str(build.CSRC_DIR / "flash_prefill.cu"), "current")}
    if args.baseline:
        libs["baseline"] = compile_source(args.baseline, "baseline")
    order = ["baseline", "current", "current", "baseline"] if args.baseline else ["current"]

    gen = torch.Generator(device="cuda").manual_seed(0)
    summary, ok = {}, True
    for name, b, t, s, hkv, g, dh in SHAPES:
        q = torch.randn(b, t, hkv * g, dh, generator=gen, device="cuda").bfloat16()
        k = torch.randn(b, s, hkv, dh, generator=gen, device="cuda").bfloat16()
        v = torch.randn(b, s, hkv, dh, generator=gen, device="cuda").bfloat16()
        want = k1.flash_prefill_attention_plain(q, k, v, 0, q_heads_per_kv=g).float()
        row = {"ms": {label: [] for label in libs}, "max_abs_err": {}}
        for label, lib in libs.items():
            build._LIBS["flash_prefill"] = lib
            got = k1.flash_prefill_attention(q, k, v, 0, q_heads_per_kv=g)
            err = (got.float() - want).abs().max().item()
            row["max_abs_err"][label] = err
            ok &= err <= 0.02
        for rnd in range(ROUNDS):
            for label in order:
                build._LIBS["flash_prefill"] = libs[label]
                ms = chip_smoke.time_ms(lambda: k1.flash_prefill_attention(
                    q, k, v, 0, q_heads_per_kv=g))
                row["ms"][label].append(ms)
                print(f"[bench] {name} round {rnd} {label}: {ms:.4f} ms", flush=True)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k[:, :t], v[:, :t]))
        row["sdpa_ms"] = chip_smoke.time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        row["bound_ms"], row["bound_by"] = chip_smoke.flash_bound(
            b, t, s, 0, hkv * g, hkv, dh, 0, torch.bfloat16)
        print(f"[bench] {name}: sdpa {row['sdpa_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
              f"({row['bound_by']}), max_abs_err {row['max_abs_err']}", flush=True)
        summary[name] = row
    build._LIBS.pop("flash_prefill", None)
    print(json.dumps({"card": chip_smoke.card_line(), "ok": ok, "shapes": summary}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
