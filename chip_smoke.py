"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check exits non-zero, without the final ``ok`` line):
  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build: every CUDA kernel of the main paths, from csrc/, one nvcc each,
     all started together;
  3. each kernel against its plain PyTorch version on the card, with its
     time, the plain version's, a library call's and the card's bound:
     K1 (flash prefill) and K4-K7 (quantized products) at the TPU kernel
     gate's shapes and at the 7B shapes of the main paths;
  4. exact greedy AR == self-spec in fp32 at a small width, through the
     kernels: the dense base (K1, 4 launches per prefill), int8 and int4
     bases, int8 and int4 drafters over the dense base (== dense AR), and
     the int8 KV cache;
  5. the main path at full width: random Llama-2-7B-shaped weights in bf16
     (identity tail past the exit layer), greedy AR then self-spec with
     exit 8 and W=6, tok/s, acceptance, and launches per prefill;
  6. the quantized paths at full width, from phase 5's weights: int8 and
     int4 bases (AR and spec) and int8 and int4 drafters over the bf16 base
     (spec), with tok/s, acceptance, launches and greedy agreement;
then a ``{"kernels": [...]}`` line, and ``{"ok": true, "device": ...}`` last.
Every kernel count is set to 0 just before each run of phases 5 and 6 and
read just after it.

Without a CUDA device, or outside a checkout of the repository, it fails
before printing anything.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
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


def time_cold_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` with the 50 MB L2 flushed before each call,
    as a decode step finds a layer's weights: CUDA events around each call
    only, the flush outside them. Nothing waits on the device until the
    last call, and each flush (a 256 MiB memset, ~0.1 ms) outlasts the
    host's time to enqueue a call, so the events time the device work and
    not the host's launch overhead."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def kernel_counters():
    """name -> wrapper, for every kernel of the main paths (K1, K4-K7)."""
    from layerskip_tpu_torch.ops.cuda import quant_matmul as qmm
    from layerskip_tpu_torch.ops.cuda.flash_prefill import flash_prefill_attention

    return {"flash_prefill": flash_prefill_attention, "quant_matmul_t": qmm.quant_matmul_t,
            "quant_matmul": qmm.quant_matmul, "int4_matmul": qmm.int4_matmul,
            "int4_matmul_t": qmm.int4_matmul_t}


def reset_counts():
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in kernel_counters().items()}


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


def quant_bound(m, k, n, bits, dtype):
    """(bound_ms, bound_by) of a quantized product: x, the packed weight,
    its scales and the output each moved once over the memory rate, against
    2*M*N*K flops at the peak rate for x's dtype."""
    esize = torch.tensor([], dtype=dtype).element_size()
    w_bytes = k * n if bits == 8 else k * n // 2
    s_bytes = 4 * n if bits == 8 else 4 * n * (k // 128)
    nbytes = esize * (m * k + m * n) + w_bytes + s_bytes
    t_mem, t_ops = nbytes / MEM_BYTES_PER_S, 2.0 * m * n * k / PEAK_FLOP_PER_S[dtype]
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops else "operations")


# the K4-K7 main-path entries of the kernels line: the M = 1 (decode) case
QUANT_MAIN = {"quant_matmul_t": "quant_matmul_t_7b_wq_m1",
              "quant_matmul": "quant_matmul_7b_wgate_m1",
              "int4_matmul": "int4_matmul_7b_wgate_m1",
              "int4_matmul_t": "int4_matmul_t_7b_wq_m1"}


def quant_cases():
    """(name, kernel, M, K, N, x dtype, tol). The gate cases and their
    tolerances are the TPU kernel gate's (scripts/kernel_gate.py, N(0, 1)
    weights). The 7B cases are the main paths' products (wq [N, K] =
    [4096, 4096]; wo, w_gate and w_down [K, N] = [4096, 4096], [4096, 11008]
    and [11008, 4096]) at M = 1 (AR step), 7 (verify window) and 256
    (prefill) in bf16, with N(0, 0.02) weights; tol None there means one
    bf16 ulp (2^-7) of the largest output: kernel and plain version round
    the same fp32 sum, taken in another order, once."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        ("quant_matmul_gate", "quant_matmul", 64, 256, 384, f32, 0.05),
        ("quant_matmul_t_gate", "quant_matmul_t", 16, 256, 192, f32, 0.05),
        ("int4_matmul_gate", "int4_matmul", 1, 1792, 768, bf16, 1.5),
        ("int4_matmul_t_gate", "int4_matmul_t", 7, 1024, 512, bf16, 1.5),
    ]
    for m in (1, 7, 256):
        for kern in ("quant_matmul_t", "int4_matmul_t"):
            cases.append((f"{kern}_7b_wq_m{m}", kern, m, 4096, 4096, bf16, None))
        for kern in ("quant_matmul", "int4_matmul"):
            for layer, k, n in (("wo", 4096, 4096), ("wgate", 4096, 11008),
                                ("wdown", 11008, 4096)):
                cases.append((f"{kern}_7b_{layer}_m{m}", kern, m, k, n, bf16, None))
    return cases


def check_quant_kernels():
    import torch.nn.functional as F

    from layerskip_tpu_torch.ops.cuda import quant_matmul as qmm
    from layerskip_tpu_torch.quant import quantize_tensor

    gen = torch.Generator(device="cuda").manual_seed(1)
    results, ok = {}, True
    for name, kern, m, k, n, dtype, tol in quant_cases():
        k_last, bits = kern.endswith("_t"), 4 if kern.startswith("int4") else 8
        w_std = 1.0 if name.endswith("_gate") else 0.02
        x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
        w = torch.randn((n, k) if k_last else (k, n), generator=gen, device="cuda") * w_std
        qt = quantize_tensor(w, k_last=k_last, bits=bits, group=128 if bits == 4 else 0)
        del w
        kw = dict(group=qt.group) if bits == 4 else {}
        fn, plain = getattr(qmm, kern), getattr(qmm, f"{kern}_plain")
        got = fn(x, qt.q, qt.scale, **kw)
        torch.cuda.synchronize()
        want = plain(x, qt.q, qt.scale, **kw)
        err = (got.float() - want.float()).abs().max().item()
        if tol is None:
            tol = 2.0 ** -7 * want.float().abs().max().item()
        finite = bool(torch.isfinite(got).all())
        ms = time_cold_ms(lambda: fn(x, qt.q, qt.scale, **kw))
        plain_ms = time_cold_ms(lambda: plain(x, qt.q, qt.scale, **kw), 5)
        w_deq = qt.dequantize(dtype)  # the library call's weight, made ahead of time
        if k_last:
            library_ms = time_cold_ms(lambda: F.linear(x, w_deq))
        else:
            library_ms = time_cold_ms(lambda: torch.matmul(x, w_deq))
        del w_deq
        bound_ms, bound_by = quant_bound(m, k, n, bits, dtype)
        passed = finite and err <= tol
        ok &= passed
        results[name] = dict(max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
        log(f"[kernel] {name}: {'PASS' if passed else 'FAIL'} max_abs_err={err:.3g} "
            f"tol={tol:.3g} ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
            f"bound_ms={bound_ms:.5f} ({bound_by}) shape=M{m} K{k} N{n} "
            f"{'int4 G128' if bits == 4 else 'int8'} {str(dtype).split('.')[-1]}")
    return ok, results


# ------------------------------------------------------------ phase 4


def exact_fp32_greedy():
    from layerskip_tpu_torch.config import GenerationConfig, tiny_config
    from layerskip_tpu_torch.generation.engine import Engine, postprocess_output
    from layerskip_tpu_torch.models.params import init_params
    from layerskip_tpu_torch.quant import quantize_llama_params

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
    nl = cfg.num_hidden_layers
    quant = ("quant_matmul_t", "quant_matmul", "int4_matmul", "int4_matmul_t")

    def run(engine, **kw):
        before = read_counts()
        out = engine.generate(prompt, GenerationConfig(max_steps=48, sample=False, **kw),
                              eos_ids=eos)
        toks = postprocess_output(out, eos, 48)
        after = read_counts()
        return toks, {k: after[k] - before[k] for k in after}

    def launched(n, want):
        """Exact counts for the kernels in ``want`` (None: at least one), 0
        for every other quantized product, one K1 launch per layer."""
        return n["flash_prefill"] == nl and all(
            (n[k] > 0 if want.get(k, 0) is None else n[k] == want.get(k, 0))
            for k in quant)

    ok = True
    ar, n = run(eng, generation_strategy="autoregressive")
    ok &= launched(n, {}) and len(ar) == 48
    log(f"[fp32] AR: {len(ar)} tokens ({len(set(ar))} distinct), prefill launches "
        f"{n['flash_prefill']} (want {nl}), head {ar[:12]}")
    for e, w in ((1, 3), (2, 4), (3, 6)):
        sp, n = run(eng, generation_strategy="self_speculative", exit_layer=e,
                    num_speculations=w)
        same = sp == ar
        ok &= same and launched(n, {})
        log(f"[fp32] spec exit={e} W={w}: equal_to_AR={same} prefill launches "
            f"{n['flash_prefill']}")

    # quantized bases: an AR token is one pass of 3 [N, K] and 4 [K, N]
    # products per layer; 48 tokens are the prefill and 47 steps
    spec = dict(generation_strategy="self_speculative", exit_layer=2, num_speculations=4)
    for bits, (k_nk, k_kn) in ((8, quant[:2]), (4, quant[3:1:-1])):
        qeng = Engine(quantize_llama_params(params, bits=bits), cfg, device="cuda")
        qar, n_ar = run(qeng, generation_strategy="autoregressive")
        qsp, n_sp = run(qeng, **spec)
        good = (len(qar) == 48 and qsp == qar
                and launched(n_ar, {k_nk: 3 * nl * 48, k_kn: 4 * nl * 48})
                and launched(n_sp, {k_nk: None, k_kn: None}))
        ok &= good
        log(f"[fp32] int{bits} base: spec exit=2 W=4 equal_to_AR={qsp == qar}, "
            f"{len(set(qar))} distinct, AR launches {k_nk}={n_ar[k_nk]} {k_kn}={n_ar[k_kn]} "
            f"(want {3 * nl * 48}, {4 * nl * 48}), spec launches {k_nk}={n_sp[k_nk]} "
            f"{k_kn}={n_sp[k_kn]} -> {'PASS' if good else 'FAIL'}")

    # quantized drafters over the fp32 base: the verify is the base's, so
    # greedy output equals the base AR
    for bits, mlp_only, (k_nk, k_kn) in ((8, False, quant[:2]), (4, False, quant[3:1:-1]),
                                         (4, True, quant[3:1:-1])):
        sp, n = run(eng, **spec, draft_quant=bits, draft_quant_mlp_only=mlp_only)
        want = {k_kn: None, k_nk: 0 if mlp_only else None}
        good = sp == ar and launched(n, want)
        ok &= good
        log(f"[fp32] draft_quant={bits} mlp_only={mlp_only}: equal_to_base_AR={sp == ar}, "
            f"launches {k_nk}={n[k_nk]} {k_kn}={n[k_kn]} -> {'PASS' if good else 'FAIL'}")

    kar, n_ar = run(eng, generation_strategy="autoregressive", kv_quant=True)
    ksp, n_sp = run(eng, **spec, kv_quant=True)
    good = len(kar) == 48 and ksp == kar and launched(n_ar, {}) and launched(n_sp, {})
    ok &= good
    log(f"[fp32] kv_quant: spec exit=2 W=4 equal_to_AR={ksp == kar}, equal to the "
        f"bf16-cache AR for the first {first_diff(kar, ar)} tokens -> "
        f"{'PASS' if good else 'FAIL'}")
    return ok


# ------------------------------------------------------------ phase 5


def first_diff(a, b) -> int:
    return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))


def near_tie(params, cfg, prompt, toks):
    """(first position whose top-2 logit gap is under 0.05, the teacher-
    forced argmax's agreement with ``toks``, all logits finite) from one
    forward over prompt + toks."""
    from layerskip_tpu_torch.models import llama
    from layerskip_tpu_torch.ops.kv_cache import init_kv_cache

    ids = torch.tensor([prompt + toks], device="cuda")
    with torch.inference_mode():
        cache = init_kv_cache(cfg, 1, ids.shape[1], device="cuda")
        logits = llama.forward(params, cfg, ids, cache, 0).logits[0, len(prompt) - 1:-1]
    top2 = logits.topk(2, dim=-1).values
    gaps = (top2[:, 0] - top2[:, 1]).tolist()
    tie = next((j for j, gap in enumerate(gaps) if gap < 0.05), len(gaps))
    return tie, first_diff(toks, logits.argmax(-1).tolist()), bool(torch.isfinite(logits).all())


def generate_timed(eng, prompt, gen_cfg, eos):
    """(tokens, seconds, matches, drafts, launch counts) of one run, with
    every kernel count set to 0 just before it and read just after."""
    reset_counts()
    t0 = time.perf_counter()
    out = eng.generate(prompt, gen_cfg, eos_ids=eos)
    toks = out.tokens[0, :int(out.num_tokens[0])].tolist()[:gen_cfg.max_steps]
    secs = time.perf_counter() - t0
    return toks, secs, int(out.matches), int(out.drafts), read_counts()


def full_width():
    from layerskip_tpu_torch.config import GenerationConfig, llama2_7b_config
    from layerskip_tpu_torch.generation.engine import Engine
    from layerskip_tpu_torch.models.params import make_random_params

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

    # the main path: launch counts start at 0 before each run, read right after
    ar_toks, t_ar, _, _, n_ar = generate_timed(eng, prompt, ar_cfg, eos)
    sp_toks, t_sp, matches, drafts, n_sp = generate_timed(eng, prompt, sp_cfg, eos)
    counts = {k: n_ar[k] + n_sp[k] for k in n_ar}
    launches = counts["flash_prefill"]

    acceptance = matches / max(drafts, 1)
    ar_tps, sp_tps = len(ar_toks) / t_ar, len(sp_toks) / t_sp
    log(f"[7b] AR: {len(ar_toks)} tokens in {t_ar:.3f}s = {ar_tps:.2f} tok/s")
    log(f"[7b] spec exit={FULL_EXIT} W={FULL_W}: {len(sp_toks)} tokens in {t_sp:.3f}s = "
        f"{sp_tps:.2f} tok/s, speedup {sp_tps / ar_tps:.3f}x, acceptance "
        f"{matches}/{drafts} = {acceptance:.4f}")
    log(f"[7b] flash_prefill launches in AR + spec: {launches} "
        f"(want {2 * cfg.num_hidden_layers}: one per layer per prefill); {counts}")

    # near-ties: the top-2 logit gap at every generated position
    first_tie, tf_agree, finite = near_tie(params, cfg, prompt, ar_toks)
    agree = first_diff(ar_toks, sp_toks)
    log(f"[7b] spec == AR for the first {agree} tokens; first AR top-2 gap < 0.05 at "
        f"{first_tie}; teacher-forced argmax == AR for the first {tf_agree}; "
        f"logits finite={finite}")
    ok = (finite and acceptance >= 0.9 and agree >= first_tie
          and len(ar_toks) == FULL_STEPS and len(sp_toks) == FULL_STEPS
          and launches == 2 * cfg.num_hidden_layers
          and sum(counts.values()) == launches)  # no quantized product
    stats = dict(ar_tok_s=ar_tps, spec_tok_s=sp_tps, speedup=sp_tps / ar_tps,
                 acceptance=acceptance, launches=launches)
    return ok, stats, counts, (params, cfg, prompt, ar_toks, first_tie)


# ------------------------------------------------------------ phase 6


def quantized_full_width(params, cfg, prompt, bf16_ar, bf16_tie):
    """int8 and int4 bases (AR and spec) and int8 and int4 drafters over the
    bf16 base (spec) at full width. Returns (ok, per-run stats, launch
    counts summed over the runs)."""
    from layerskip_tpu_torch.config import GenerationConfig
    from layerskip_tpu_torch.generation.engine import Engine
    from layerskip_tpu_torch.quant import quantize_llama_params

    eos = (cfg.vocab_size + 7,)
    ar_cfg = GenerationConfig(max_steps=FULL_STEPS, sample=False,
                              generation_strategy="autoregressive")
    sp_cfg = GenerationConfig(max_steps=FULL_STEPS, sample=False,
                              generation_strategy="self_speculative",
                              exit_layer=FULL_EXIT, num_speculations=FULL_W)
    nl = cfg.num_hidden_layers
    kinds = {8: ("quant_matmul_t", "quant_matmul"), 4: ("int4_matmul_t", "int4_matmul")}
    ok, stats, total = True, {}, {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    for bits in (8, 4):
        t0 = time.time()
        qparams = quantize_llama_params(params, bits=bits, group=128 if bits == 4 else 0)
        torch.cuda.synchronize()
        t_quant = time.time() - t0
        eng = Engine(qparams, cfg, device="cuda")
        for warm in (ar_cfg, sp_cfg):
            eng.generate(prompt, dataclasses.replace(warm, max_steps=8), eos_ids=eos)
        ar_toks, t_ar, _, _, n_ar = generate_timed(eng, prompt, ar_cfg, eos)
        sp_toks, t_sp, matches, drafts, n_sp = generate_timed(eng, prompt, sp_cfg, eos)
        add(n_ar)
        add(n_sp)
        tie, tf_agree, finite = near_tie(qparams, cfg, prompt, ar_toks)
        agree, acceptance = first_diff(ar_toks, sp_toks), matches / max(drafts, 1)
        k_nk, k_kn = kinds[bits]
        others = [k for k in kinds[12 - bits]]
        good = (finite and acceptance >= 0.9 and agree >= tie
                and len(ar_toks) == FULL_STEPS and len(sp_toks) == FULL_STEPS
                and n_ar[k_nk] == 3 * nl * FULL_STEPS and n_ar[k_kn] == 4 * nl * FULL_STEPS
                and n_sp[k_nk] > 0 and n_sp[k_kn] > 0
                and all(n_ar[k] == n_sp[k] == 0 for k in others))
        ok &= good
        name = f"int{bits}_base"
        stats[name] = dict(ar_tok_s=len(ar_toks) / t_ar, spec_tok_s=len(sp_toks) / t_sp,
                           acceptance=acceptance, spec_eq_ar=agree, first_tie=tie,
                           ar_launches={k_nk: n_ar[k_nk], k_kn: n_ar[k_kn]},
                           spec_launches={k_nk: n_sp[k_nk], k_kn: n_sp[k_kn]},
                           quantize_s=t_quant)
        log(f"[7b {name}] quantized in {t_quant:.1f}s, "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card; AR {len(ar_toks)} "
            f"tokens in {t_ar:.3f}s = {len(ar_toks) / t_ar:.2f} tok/s; spec "
            f"{len(sp_toks) / t_sp:.2f} tok/s, acceptance {matches}/{drafts} = "
            f"{acceptance:.4f}; spec == AR for {agree}, first top-2 gap < 0.05 at {tie}, "
            f"teacher-forced == AR for {tf_agree}; AR launches {k_nk}={n_ar[k_nk]} "
            f"{k_kn}={n_ar[k_kn]} (want {3 * nl * FULL_STEPS}, {4 * nl * FULL_STEPS}), "
            f"spec launches {k_nk}={n_sp[k_nk]} {k_kn}={n_sp[k_kn]} -> "
            f"{'PASS' if good else 'FAIL'}")
        del eng, qparams
        torch.cuda.empty_cache()

    eng = Engine(params, cfg, device="cuda")
    for bits in (8, 4):
        dq_cfg = dataclasses.replace(sp_cfg, draft_quant=bits)
        t0 = time.time()
        eng.generate(prompt, dataclasses.replace(dq_cfg, max_steps=8), eos_ids=eos)
        t_warm = time.time() - t0  # includes quantizing the drafter
        sp_toks, t_sp, matches, drafts, n_sp = generate_timed(eng, prompt, dq_cfg, eos)
        add(n_sp)
        agree, acceptance = first_diff(bf16_ar, sp_toks), matches / max(drafts, 1)
        k_nk, k_kn = kinds[bits]
        good = (agree >= bf16_tie and len(sp_toks) == FULL_STEPS
                and n_sp[k_nk] > 0 and n_sp[k_kn] > 0)
        ok &= good
        name = f"draft_quant{bits}"
        stats[name] = dict(spec_tok_s=len(sp_toks) / t_sp, acceptance=acceptance,
                           eq_bf16_ar=agree, spec_launches={k_nk: n_sp[k_nk], k_kn: n_sp[k_kn]},
                           warm_s=t_warm)
        log(f"[7b {name}] drafter built and warmed in {t_warm:.1f}s; spec {len(sp_toks)} "
            f"tokens in {t_sp:.3f}s = {len(sp_toks) / t_sp:.2f} tok/s, acceptance "
            f"{matches}/{drafts} = {acceptance:.4f} (recorded, not gated); == bf16 AR for "
            f"the first {agree} (bf16 first top-2 gap < 0.05 at {bf16_tie}); launches "
            f"{k_nk}={n_sp[k_nk]} {k_kn}={n_sp[k_kn]} -> {'PASS' if good else 'FAIL'}")
    return ok, stats, total


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

    t_start = t0 = time.time()
    sources = ("flash_prefill", "quant_matmul")
    build_libraries(sources)
    log(f"[build] {', '.join(s + '.cu' for s in sources)} in {time.time() - t0:.1f}s")
    for src in sources:  # the compiler's report, one line per source
        report = library_path(src).with_suffix(".log").read_text()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", report)]
        spills = sorted({int(b) for b in re.findall(r"(\d+) bytes spill stores", report)})
        log(f"[build]   {src}: {len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
            f"spill stores {spills} bytes")

    # the engine's cache for a 200-token prompt: bucket 256 + 128 steps +
    # W + 2, rounded up to 512
    full_cache_len = -(-(256 + FULL_STEPS + FULL_W + 2) // 512) * 512
    t0 = time.time()
    ok_kernel, kres = check_flash_prefill(full_cache_len)
    ok_quant_kernel, qres = check_quant_kernels()
    log(f"[phase 3] {time.time() - t0:.1f}s")
    t0 = time.time()
    ok_fp32 = exact_fp32_greedy()
    log(f"[phase 4] {time.time() - t0:.1f}s")
    t0 = time.time()
    ok_full, stats, counts, ctx = full_width()
    log(f"[phase 5] {time.time() - t0:.1f}s")
    t0 = time.time()
    ok_quant, qstats, qcounts = quantized_full_width(*ctx)
    log(f"[phase 6] {time.time() - t0:.1f}s")
    for k, v in qcounts.items():
        counts[k] += v
    log(f"[summary] kernels={ok_kernel and ok_quant_kernel} fp32_exact={ok_fp32} "
        f"full_width={ok_full} quantized_full_width={ok_quant} {json.dumps(stats)} "
        f"{json.dumps(qstats)} launches={json.dumps(counts)} "
        f"total {time.time() - t_start:.1f}s")
    if not (ok_kernel and ok_quant_kernel and ok_fp32 and ok_full and ok_quant):
        return 1

    main_shape = kres["flash_prefill_7b_bf16"]
    kernels = [dict(
        name="flash_prefill", route="cuda",
        source="layerskip_tpu_torch/csrc/flash_prefill.cu",
        replaces="layerskip_tpu/ops/pallas/flash_prefill.py:122",
        launches=counts["flash_prefill"], max_abs_err=main_shape["max_abs_err"],
        ms=main_shape["ms"], plain_ms=main_shape["plain_ms"],
        bound_ms=main_shape["bound_ms"], bound_by=main_shape["bound_by"],
        library_ms=main_shape["library_ms"],
    )]
    replaces = {"quant_matmul_t": 117, "quant_matmul": 159, "int4_matmul": 436,
                "int4_matmul_t": 571}
    for name, line in replaces.items():
        r = qres[QUANT_MAIN[name]]
        kernels.append(dict(
            name=name, route="cuda", source="layerskip_tpu_torch/csrc/quant_matmul.cu",
            replaces=f"layerskip_tpu/ops/pallas/quant_matmul.py:{line}",
            launches=counts[name], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"],
        ))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
