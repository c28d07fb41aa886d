"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check exits non-zero, without the final ``ok`` line):
  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build: every CUDA kernel of the main path, from csrc/, one nvcc each;
  3. each kernel against its plain PyTorch version on the card, with its
     time, the plain version's, a library call's and the card's bound;
  4. exact greedy AR == self-spec in fp32 at a small width, through the
     kernel (4 launches per prefill);
  5. the main path at full width: random Llama-2-7B-shaped weights in bf16
     (identity tail past the exit layer), greedy AR then self-spec with
     exit 8 and W=6, tok/s, acceptance, and launches per prefill;
  6. a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}`` last.

Without a CUDA device, or outside a checkout of the repository, it fails
before printing anything.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOP_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, no TF32

FULL_PROMPT, FULL_STEPS, FULL_EXIT, FULL_W = 200, 128, 8, 6


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------ phase 3


def flash_bound(b, t, s, past, hq, hkv, dh, window, dtype):
    """(bound_ms, bound_by): the larger of the bytes the function must move
    (q and o once, each visible key/value once) over the memory rate, and
    its flops on the visible keys over the peak rate for the input type."""
    q_pos = past + np.arange(t)
    hi = np.minimum(q_pos, s - 1)
    lo = np.maximum(q_pos - window + 1, 0) if window > 0 else np.zeros_like(q_pos)
    per_query = np.maximum(hi - lo + 1, 0)
    n_keys = max(int(hi.max()) - int(lo.min()) + 1, 0)
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = esize * (2 * b * t * hq * dh + 2 * b * hkv * n_keys * dh)
    flops = 4.0 * b * hq * dh * float(per_query.sum())
    t_mem, t_ops = nbytes / MEM_BYTES_PER_S, flops / PEAK_FLOP_PER_S[dtype]
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops else "operations")


def flash_cases(full_cache_len):
    # (name, B, T, S, past, Hkv, G, Dh, window, scale, softcap, dtype, tol)
    # fp32 tolerances are the TPU kernel gate's (scripts/kernel_gate.py);
    # the bf16 output is one rounding of an fp32 value, within one bf16 ulp
    # (2^-7 relative) of outputs below 2 in size, so 0.02.
    f32, bf16 = torch.float32, torch.bfloat16
    return [
        ("flash_prefill", 1, 256, 512, 100, 2, 2, 128, 0, 0.0, 0.0, f32, 0.005),
        ("flash_prefill_sliding", 1, 256, 512, 100, 2, 2, 128, 64, 0.0, 0.0, f32, 0.005),
        ("flash_prefill_gemma", 1, 256, 512, 100, 2, 2, 128, 64, 32.0 ** -0.5, 50.0,
         f32, 0.01),
        ("flash_prefill_ragged", 2, 200, 700, 37, 2, 2, 128, 0, 0.0, 0.0, f32, 0.005),
        ("flash_prefill_dh64", 1, 256, 512, 100, 2, 2, 64, 0, 0.0, 0.0, f32, 0.005),
        ("flash_prefill_7b_bf16", 1, 256, full_cache_len, 0, 32, 1, 128, 0, 0.0, 0.0,
         bf16, 0.02),
    ]


def check_flash_prefill(full_cache_len):
    import torch.nn.functional as F

    from layerskip_tpu_torch.ops.cuda.flash_prefill import (
        flash_prefill_attention,
        flash_prefill_attention_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    results, ok = {}, True
    for (name, b, t, s, past, hkv, g, dh, window, scale, cap, dtype,
         tol) in flash_cases(full_cache_len):
        hq = hkv * g
        q = torch.randn(b, t, hq, dh, generator=gen, device="cuda").to(dtype)
        # k/v are one layer of a stacked cache, read through its strides
        kc = torch.randn(2, b, s, hkv, dh, generator=gen, device="cuda").to(dtype)
        vc = torch.randn(2, b, s, hkv, dh, generator=gen, device="cuda").to(dtype)
        k, v = kc[1], vc[1]
        kw = dict(q_heads_per_kv=g, sliding_window=window, score_scale=scale,
                  logit_softcap=cap)
        got = flash_prefill_attention(q, k, v, past, **kw)
        torch.cuda.synchronize()
        want = flash_prefill_attention_plain(q, k, v, past, **kw)
        err = (got.float() - want.float()).abs().max().item()
        finite = bool(torch.isfinite(got).all())
        ms = time_ms(lambda: flash_prefill_attention(q, k, v, past, **kw))
        plain_ms = time_ms(lambda: flash_prefill_attention_plain(q, k, v, past, **kw), 5)
        library_ms = None
        if not cap:
            qt = q.transpose(1, 2)
            sc = scale or dh ** -0.5
            if past == 0 and window == 0:
                kt, vt = k[:, :t].transpose(1, 2), v[:, :t].transpose(1, 2)
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    qt, kt, vt, is_causal=True, scale=sc, enable_gqa=True)
            else:
                qp = past + torch.arange(t, device="cuda")[:, None]
                kp = torch.arange(s, device="cuda")[None, :]
                mask = (kp <= qp) & ((kp > qp - window) if window else True)
                kt, vt = k.transpose(1, 2), v.transpose(1, 2)
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    qt, kt, vt, attn_mask=mask, scale=sc, enable_gqa=True)
            library_ms = time_ms(lib)
        bound_ms, bound_by = flash_bound(b, t, s, past, hq, hkv, dh, window, dtype)
        passed = finite and err <= tol
        ok &= passed
        results[name] = dict(max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
        log(f"[kernel] {name}: {'PASS' if passed else 'FAIL'} max_abs_err={err:.3g} "
            f"tol={tol} ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms="
            f"{'null' if library_ms is None else f'{library_ms:.4f}'} "
            f"bound_ms={bound_ms:.5f} ({bound_by}) shape=B{b} T{t} S{s} past{past} "
            f"Hq{hq} Hkv{hkv} Dh{dh} win{window} {str(dtype).split('.')[-1]}")
    return ok, results


# ------------------------------------------------------------ phase 4


def exact_fp32_greedy():
    from layerskip_tpu_torch.config import GenerationConfig, tiny_config
    from layerskip_tpu_torch.generation.engine import Engine, postprocess_output
    from layerskip_tpu_torch.models.params import init_params
    from layerskip_tpu_torch.ops.cuda.flash_prefill import flash_prefill_attention

    cfg = tiny_config(num_hidden_layers=4, hidden_size=256, num_attention_heads=4,
                      num_key_value_heads=2, intermediate_size=512, vocab_size=512,
                      max_position_embeddings=1024, dtype=torch.float32)
    params = init_params(cfg, seed=7, device="cuda")
    # std 0.02 weights make this narrow model repeat one token; at std 0.15
    # its greedy stream varies, so equality is checked on real choices
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        getattr(params.layers, name).mul_(7.5)
    params.embed.mul_(15.0)
    params.lm_head.mul_(7.5)
    eng = Engine(params, cfg, device="cuda")
    prompt = np.random.default_rng(1).integers(3, cfg.vocab_size, size=200).tolist()
    eos = (cfg.vocab_size + 7,)  # unreachable: every run makes all 48 steps

    def run(**kw):
        before = flash_prefill_attention.launches
        out = eng.generate(prompt, GenerationConfig(max_steps=48, sample=False, **kw),
                           eos_ids=eos)
        toks = postprocess_output(out, eos, 48)
        return toks, flash_prefill_attention.launches - before

    ok = True
    ar, ar_launches = run(generation_strategy="autoregressive")
    ok &= ar_launches == cfg.num_hidden_layers and len(ar) == 48
    log(f"[fp32] AR: {len(ar)} tokens ({len(set(ar))} distinct), prefill launches "
        f"{ar_launches} (want {cfg.num_hidden_layers}), head {ar[:12]}")
    for e, w in ((1, 3), (2, 4), (3, 6)):
        sp, launches = run(generation_strategy="self_speculative", exit_layer=e,
                           num_speculations=w)
        same = sp == ar
        ok &= same and launches == cfg.num_hidden_layers
        log(f"[fp32] spec exit={e} W={w}: equal_to_AR={same} prefill launches {launches}")
    return ok


# ------------------------------------------------------------ phase 5


def full_width():
    from layerskip_tpu_torch.config import GenerationConfig, llama2_7b_config
    from layerskip_tpu_torch.generation.engine import Engine
    from layerskip_tpu_torch.models import llama
    from layerskip_tpu_torch.models.params import make_random_params
    from layerskip_tpu_torch.ops.cuda.flash_prefill import flash_prefill_attention
    from layerskip_tpu_torch.ops.kv_cache import init_kv_cache

    cfg = llama2_7b_config()
    t0 = time.time()
    params = make_random_params(cfg, exit_layer=FULL_EXIT, tail_eps=0.0, seed=0,
                                device="cuda")
    torch.cuda.synchronize()
    log(f"[7b] random weights built in {time.time() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    eng = Engine(params, cfg, device="cuda")
    prompt = np.random.default_rng(2).integers(3, cfg.vocab_size, size=FULL_PROMPT).tolist()
    eos = (cfg.vocab_size + 7,)  # unreachable: every run makes all its steps
    ar_cfg = GenerationConfig(max_steps=FULL_STEPS, sample=False,
                              generation_strategy="autoregressive")
    sp_cfg = GenerationConfig(max_steps=FULL_STEPS, sample=False,
                              generation_strategy="self_speculative",
                              exit_layer=FULL_EXIT, num_speculations=FULL_W)
    for warm in (ar_cfg, sp_cfg):  # cuBLAS handles and workspaces
        eng.generate(prompt, dataclasses.replace(warm, max_steps=8),
                     eos_ids=eos)
    torch.cuda.synchronize()

    # the main path: launch counts start at 0 here and are read right after
    flash_prefill_attention.launches = 0
    t0 = time.perf_counter()
    ar = eng.generate(prompt, ar_cfg, eos_ids=eos)
    ar_toks = ar.tokens[0, :int(ar.num_tokens[0])].tolist()
    t_ar = time.perf_counter() - t0
    t0 = time.perf_counter()
    sp = eng.generate(prompt, sp_cfg, eos_ids=eos)
    sp_toks = sp.tokens[0, :int(sp.num_tokens[0])].tolist()[:FULL_STEPS]
    t_sp = time.perf_counter() - t0
    launches = flash_prefill_attention.launches

    matches, drafts = int(sp.matches), int(sp.drafts)
    acceptance = matches / max(drafts, 1)
    ar_tps, sp_tps = len(ar_toks) / t_ar, len(sp_toks) / t_sp
    log(f"[7b] AR: {len(ar_toks)} tokens in {t_ar:.3f}s = {ar_tps:.2f} tok/s")
    log(f"[7b] spec exit={FULL_EXIT} W={FULL_W}: {len(sp_toks)} tokens in {t_sp:.3f}s = "
        f"{sp_tps:.2f} tok/s, speedup {sp_tps / ar_tps:.3f}x, acceptance "
        f"{matches}/{drafts} = {acceptance:.4f}")
    log(f"[7b] flash_prefill launches in AR + spec: {launches} "
        f"(want {2 * cfg.num_hidden_layers}: one per layer per prefill)")

    # near-ties: one teacher-forced forward over prompt + AR tokens gives the
    # top-2 logit gap at every generated position
    ids = torch.tensor([prompt + ar_toks], device="cuda")
    with torch.inference_mode():
        cache = init_kv_cache(cfg, 1, ids.shape[1], device="cuda")
        logits = llama.forward(params, cfg, ids, cache, 0).logits[0, FULL_PROMPT - 1:-1]
    finite = bool(torch.isfinite(logits).all())
    top2 = logits.topk(2, dim=-1).values
    gaps = (top2[:, 0] - top2[:, 1]).tolist()
    first_tie = next((j for j, gap in enumerate(gaps) if gap < 0.05), len(gaps))
    agree = next((j for j, (a, b) in enumerate(zip(ar_toks, sp_toks)) if a != b),
                 min(len(ar_toks), len(sp_toks)))
    tf_agree = next((j for j, (a, b) in enumerate(zip(ar_toks, logits.argmax(-1).tolist()))
                     if a != b), len(ar_toks))
    log(f"[7b] spec == AR for the first {agree} tokens; first AR top-2 gap < 0.05 at "
        f"{first_tie}; teacher-forced argmax == AR for the first {tf_agree}; "
        f"logits finite={finite}")
    ok = (finite and acceptance >= 0.9 and agree >= first_tie
          and len(ar_toks) == FULL_STEPS and len(sp_toks) == FULL_STEPS
          and launches == 2 * cfg.num_hidden_layers)
    stats = dict(ar_tok_s=ar_tps, spec_tok_s=sp_tps, speedup=sp_tps / ar_tps,
                 acceptance=acceptance, launches=launches)
    return ok, stats


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from layerskip_tpu_torch.ops.cuda.build import build_libraries, library_path

    card = card_line()
    log(f"[env] {card}")
    log(f"[env] torch {torch.__version__} CUDA {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    t0 = time.time()
    build_libraries(["flash_prefill"])
    log(f"[build] flash_prefill.cu in {time.time() - t0:.1f}s")
    for line in library_path("flash_prefill").with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build]   {line.strip()}")

    # the engine's cache for a 200-token prompt: bucket 256 + 128 steps +
    # W + 2, rounded up to 512
    full_cache_len = -(-(256 + FULL_STEPS + FULL_W + 2) // 512) * 512
    ok_kernel, kres = check_flash_prefill(full_cache_len)
    ok_fp32 = exact_fp32_greedy()
    ok_full, stats = full_width()
    log(f"[summary] kernels={ok_kernel} fp32_exact={ok_fp32} full_width={ok_full} "
        f"{json.dumps(stats)}")
    if not (ok_kernel and ok_fp32 and ok_full):
        return 1

    main_shape = kres["flash_prefill_7b_bf16"]
    kernels = [dict(
        name="flash_prefill", route="cuda",
        source="layerskip_tpu_torch/csrc/flash_prefill.cu",
        replaces="layerskip_tpu/ops/pallas/flash_prefill.py:122",
        launches=stats["launches"], max_abs_err=main_shape["max_abs_err"],
        ms=main_shape["ms"], plain_ms=main_shape["plain_ms"],
        bound_ms=main_shape["bound_ms"], bound_by=main_shape["bound_by"],
        library_ms=main_shape["library_ms"],
    )]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
