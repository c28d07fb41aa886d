"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check exits non-zero, without the final ``ok`` line):
  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build: every CUDA kernel of the main paths, from csrc/, one nvcc each,
     all started together;
  3. each kernel against its plain PyTorch version on the card, with its
     time, the plain version's, a library call's and the card's bound:
     K1 (flash prefill; fp32 on the CUDA cores, bf16 on the tensor cores),
     K2/K3 (paged decode attention, bf16/fp32 and int8 pools) and K4-K7
     (quantized products; in bf16 on the tensor cores) at the TPU kernel
     gate's shapes and at the 7B shapes of the main paths, K1 also at
     2048-token prompts with the 7B and the Llama-3.2-1B heads, K2/K3 also
     at ~2000-key contexts (B 4, and B 1 with one live slot), K4-K7 also at
     M = 2048 (a 2000-token prompt's prefill), K4/K7 also on the
     Llama-3.2-1B wk at M = 1; with a softcap (Gemma) the library call is
     a compiled ``flex_attention`` with that score_mod and the same mask
     (SDPA has no softcap), its error against the plain version logged;
     K1 also at phase 14's 30720-token prefill with the Llama-3.2-1B heads,
     held against the plain version on its first and last 512 query rows
     (each within 2 bf16 ulps of its largest output);
  4. exact greedy AR == self-spec in fp32 at a small width, through the
     kernels: the dense base (K1, 4 launches per prefill), int8 and int4
     bases, int8 and int4 drafters over the dense base (== dense AR), and
     the int8 KV cache; then paged continuous sessions (K2, K3 at pages of
     16 and 12, and K2 on an int8 base with K4/K5) == solo ``generate``,
     with K2/K3 launched a multiple of W*E + L times;
  5. the main path at full width: random Llama-2-7B-shaped weights in bf16
     (identity tail past the exit layer), greedy AR then self-spec with
     exit 8 and W=6, tok/s, acceptance, and launches per prefill; then the
     time to first token (``generate(max_steps=1)``) of a 200- and a
     2000-token prompt;
  6. the quantized paths at full width, from phase 5's weights: int8 and
     int4 bases (AR and spec, then the time to first token of a 200- and a
     2000-token prompt with K4/K7's and K5/K6's launches and shares) and
     int8 and int4 drafters over the bf16 base (spec), with tok/s,
     acceptance, launches and greedy agreement;
  7. paged continuous serving at full width, from phase 5's weights:
     ``ContinuousBatchScheduler`` with 4 slots, pages of 128 and a pool
     that makes requests wait for pages, eight requests over a bf16 pool
     (K2) and over the int8 pool (K3), and four sharing a prefix through
     the prefix cache; aggregate tok/s, latency, acceptance, launches,
     each request == its solo stream up to its first near tie (found on
     fp32 logits of the same weights; at least two tokens compared per
     request), and every served token within the solo
     streams' own bf16 noise of the teacher-forced greedy choice;
  8. the entry points a user calls: phase 4's fp32 model through
     ``save_params`` and ``load_model_and_tokenizer`` (bit-equal), greedy
     AR == spec through ``LlamaGenerator``, ``cli.correctness`` (no
     errors) and ``cli.benchmark`` on that checkpoint; then at 7B in bf16
     (``random:7b?tail_eps=0&tail_from=8``, phase 5-7's weights freed
     first) ``cli.benchmark`` over four 200-byte prompts (acceptance >=
     0.9), AR against spec through ``LlamaGenerator`` (equal up to the
     first near tie), ``stream_generate`` through the speculative streamer
     (== ``generate``), the int8 loader (K4/K5), the serving command line's
     builder (paged continuous batching on port 0: two POSTs and /healthz,
     K2, each answer == its solo stream up to its first near tie), and
     ``python -m layerskip_tpu_torch.bench --config 7b`` in a subprocess
     (one JSON line, value > 0);
  9. the other drafting strategies: (a) phase 4's fp32 model, greedy prompt
     lookup, hybrid, adaptive drafting (also with an int8 drafter), tree
     speculation (k 2 and 3, and over the int8 cache) each == greedy AR
     exactly, then 4-slot paged tree sessions (fp32 and int8 pools) ==
     solo with K2's and K3's tree clause launched; (b) at 7B in bf16 (phase
     5's weights built again) AR, static spec, prompt lookup, hybrid,
     adaptive and tree at batch 1 (tok/s, acceptance, tokens a round), and
     a 4-slot paged tree session (k 2, verifies of 13 queries through
     K2/K3) over the bf16 and the int8 pool; each stream == AR (each
     request its solo stream) up to its first gap within the bf16 paths'
     measured noise, every token within that noise of the teacher-forced
     argmax, and the tree exact on the same weights in fp32;
  10. the model families and MoE: (a) one narrow fp32 model (Dh 64) of each
     of Qwen2, Qwen3, Mistral, Gemma, Gemma-2, Gemma-3, Phi-3 (loaded from
     its fused names), Mixtral and Qwen3-MoE, with greedy AR == spec ==
     tree (k 2) exactly after a prompt longer than the 32-token window, a
     4-slot paged session == solo over the fp32 (K2) and int8 (K3) pools,
     and int8 (K4/K5) and int4 (K6/K7) bases AR == spec, each kernel
     launched; (b) Gemma-2-2B at full width in bf16
     (``random:gemma2-2b?tail_eps=0&tail_from=8``, exit 8, W 6): AR and
     spec at batch 1 (tok/s, acceptance, launches per token; == up to the
     first near tie, and exactly in fp32), the time to first token of a
     200- and a 6000-token prompt (past the 4096 window), the int8 base
     (K4/K5 at K 2304), and a 4-slot paged session over the bf16 and int8
     pools with a 4200-token prompt (K2/K3 at Dh 256 under the window) ==
     solo up to the first near tie; (c) moe-3b at full width in bf16
     (``random:moe-3b?tail_eps=0&tail_from=4``): AR and spec at batch 1
     with the MoE path of every call counted (few in decode and drafts,
     dense in verify windows; exact in fp32), the grouped path at a
     2048-token prefill, and a 4-slot paged session, == solo on the fp32
     copy up to the first fp32 near tie (at least two tokens a request)
     and timed in bf16. Phase 3
     holds K1 and K2/K3 at Gemma-2-2B's shapes (Hq 8, Hkv 4, Dh 256,
     softcap 50, scale 1/16, window 4096; K1 at 256, 2048 and 6144-token
     prompts, K2/K3 at ~400 and ~5000 keys), K4-K7 at its products (K
     2304 and 9216; M 1, 7 and 256) and K1 at moe-3b's heads (Hkv 8, G 2,
     Dh 128; T 256 and 2048);
  11. training, the LayerSkip recipe (``training/recipe.py``): (a) phase 4's
     Llama and phase 10 (a)'s Gemma-2 and Mixtral-style MoE in fp32, one
     ``layerskip_loss`` and backward on the card == the same call on the
     CPU (losses within 1e-5 relative, every gradient within atol 2e-5 /
     rtol 2e-3) and the chunked CE == the dense one; (b) Llama-3.2-1B at
     full width and depth in bf16 (``random:1b``) trained for 10 steps at B
     4 x 1024 through ``cli.train.main`` (checkpoints every 5 steps, an
     export), with median step ms, tokens/s, peak memory and MFU, the
     chunked and the dense CE's peak memory, and the export loaded back
     (bit-equal) generating greedy spec == AR up to the first near tie; (c)
     moe-3b at full width in bf16, 3 steps at B 2 x 1024 on the grouped MoE
     path, a positive load-balancing term, the router trained; no K1-K7
     launch in any training run (they have no backward);
  12. inference parallelism (``layerskip_tpu_torch/parallel``): ranks
     started by the port's launcher as processes of this script
     (``--phase12 SUITE DIR``), sharing the one card over gloo: (a) phase
     4's fp32 model at tp 2 (AR, spec, tree k 3, the int8 and int4
     drafters, 2-slot paged + prefix + tree sessions over the fp32 (K2) and
     int8 (K3) pools, a chunked insert) and at sp 2 (AR, spec), then over
     four ranks a dp 2 x tp 2 forward over B 2, AR at sp 2 x tp 2 and
     phase 10 (a)'s Mixtral-style MoE at ep 2 x tp 2 (AR, spec): every
     stream == the single-process stream exactly, and K1, K2 (tree clause),
     K3 and K4-K7 launched on each rank; (b) ``random:7b?tail_eps=0&
     tail_from=8`` at tp 2 (AR, spec; phase 5's prompt, 64 steps), a
     2000-token prompt at sp 2 and moe-3b at ep 2, each == the
     single-device stream up to its first near tie, with tok/s, launches
     and peak memory per rank (not a speed of parallelism: both ranks share
     the card and the collectives cross the host); (c) a world-size-1 NCCL
     group running the tp 1 path with its collectives issued, and, with two
     cards or more, (b)'s tp 2 leg over NCCL, one rank a card;
  13. the training mesh (``parallel/mesh.make_train_mesh``,
     ``training/recipe.py`` on it, ``ops/ring_attention.py``): ranks of
     this script (``--phase13 SUITE DIR``) sharing the card over gloo: (a)
     four ranks, a narrow fp32 Qwen2-style model at fsdp 2 x tp 2, dp 2 x
     fsdp 2 and dp 2 x fsdp 2 with ring attention, and a Mixtral-style MoE
     at fsdp 2 x tp 2: loss, aux and whole gradients of a step, and params
     after two AdamW steps, == the single device on the card; (b)
     ``random:1b`` through ``cli.train.run`` at ``--fsdp 2`` (phase 11
     (b)'s corpus, seed and B 4 x 1024, 3 steps): first loss == phase 11
     (b)'s within 1e-2 relative, step ms, peak memory a rank, and each
     rank's resident weights, gradients and AdamW state 0.606 of the single
     device's (±1%); (c) ``random:1b`` at fsdp 2 with ring attention over
     8192 tokens, one step, its peak under 30 GB a rank; (d) with two cards
     or more, (b) and (c) at fsdp 4 (or 2) over NCCL, one rank a card; no
     K1-K7 launch;
  14. the remaining apps and the native runtime: (a) ``random:1b``'s bf16
     weights written as 4 shards and read by ``load_params`` with the
     native (C++, built with g++ from ``native/``) and the Python reader,
     both == the weights bit for bit, each timed after a page drop request
     and with the pages cached (the share of pages resident logged), and
     the native Levenshtein and LCS == the plain loops on 1000 seeded
     pairs; (b) ``cli.eval.main --tasks local:`` at 7B in bf16 over 16
     four-choice docs (buckets 512 and 2048; K1 on the tensor cores), acc
     and acc_norm in [0, 1] and the result JSON, a batch's scores == the
     rows alone (1e-3 relative), ``loglikelihood_rolling`` over 5000 tokens
     == its windows' sum, and phase 4's fp32 model scored on the card == on
     the CPU (1e-4 relative, greedy flags equal, three rows continuing with
     the model's own greedy tokens); (c) ``cli.sweep`` at 7B, exit {4, 8} x
     W {2, 6}: a CSV of 4 rows; (d) the measurement scripts in this
     process: ``bench_torch_serving`` at 7B (paged, prefix cache; then the
     int8 pool: K2, then K3, launched, every scheduler serving all 8 x 64
     tokens: the seed's streams meet no EOS), ``bench_torch_chunked`` at 1B,
     ``bench_torch_longctx`` at 1B over 30720 tokens (K1 >= 16 launches a
     prefill, greedy spec == AR, peak memory) and ``bench_torch_adaptive``
     at 7B, each JSON line logged;
then a ``{"kernels": [...]}`` line, and ``{"ok": true, "device": ...}`` last.
Every kernel count is set to 0 just before each run of phases 5 to 14 and
read just after it (in phases 12 and 13 on every rank) (K2's and K3's tree-clause launches
too; phase 11's and 13's must stay 0); every K1 and
K4-K7 launch of the bf16 runs must have taken the tensor-core route, and
every one of phase 4, phase 8's fp32 checkpoint, phase 9 (a) and phase 10
(a) (fp32) the CUDA-core route.

Without a CUDA device, or outside a checkout of the repository, it fails
before printing anything.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tempfile
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


def time_ms(fn, iters: int = 20, cold: bool = False) -> float:
    """Mean device time of one call of ``fn``: CUDA events around each call
    only. Nothing waits on the device until the last call, and before each
    call the device spins for ~1 ms, longer than the host takes to enqueue
    a call and its wrapper's checks, so the events time the device work of
    the call and not the host's launch overhead. With ``cold`` the 50 MB
    L2 is flushed (a 256 MiB memset, outside the events) before each call,
    as a decode step finds a layer's weights."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda") if cold else None
    for _ in range(1 if cold else 3):
        fn()
    events = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(2_000_000)  # cycles
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def time_cold_ms(fn, iters: int = 20) -> float:
    return time_ms(fn, iters, cold=True)


def kernel_counters():
    """name -> wrapper, for every kernel of the main paths (K1-K7)."""
    from layerskip_tpu_torch.ops.cuda import paged_decode as pd
    from layerskip_tpu_torch.ops.cuda import quant_matmul as qmm
    from layerskip_tpu_torch.ops.cuda.flash_prefill import flash_prefill_attention

    return {"flash_prefill": flash_prefill_attention,
            "paged_decode_attention": pd.paged_decode_attention,
            "paged_decode_attention_q8": pd.paged_decode_attention_q8,
            "quant_matmul_t": qmm.quant_matmul_t,
            "quant_matmul": qmm.quant_matmul, "int4_matmul": qmm.int4_matmul,
            "int4_matmul_t": qmm.int4_matmul_t}


TENSOR_CORE_ROUTES = ("flash_prefill", "quant_matmul_t", "quant_matmul", "int4_matmul",
                      "int4_matmul_t")  # K1, K4-K7
TREE_ROUTES = ("paged_decode_attention", "paged_decode_attention_q8")  # K2, K3


def reset_counts():
    for fn in kernel_counters().values():
        fn.launches = 0
    for name in TENSOR_CORE_ROUTES:
        kernel_counters()[name].tensor_core_launches = 0
    for name in TREE_ROUTES:
        kernel_counters()[name].tree_launches = 0


def read_counts():
    """Launches per kernel, of K1's and K4-K7's those of their tensor-core
    (bf16) routes as ``<name>_tensor_core``, and of K2's and K3's those
    that ran the tree clause as ``<name>_tree``."""
    counts = {name: fn.launches for name, fn in kernel_counters().items()}
    for name in TENSOR_CORE_ROUTES:
        counts[f"{name}_tensor_core"] = kernel_counters()[name].tensor_core_launches
    for name in TREE_ROUTES:
        counts[f"{name}_tree"] = kernel_counters()[name].tree_launches
    return counts


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


G2B_SCALE, G2B_SOFTCAP, G2B_WINDOW = 256.0 ** -0.5, 50.0, 4096  # Gemma-2-2B's score math


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
        # long prompts: the 7B heads, and the Llama-3.2-1B preset's (G 4, Dh 64);
        # S is the engine's cache for a 2000-token prompt (bucket 2048)
        ("flash_prefill_7b_long_bf16", 1, 2048, 2560, 0, 32, 1, 128, 0, 0.0, 0.0,
         bf16, 0.02),
        ("flash_prefill_1b_long_bf16", 1, 2048, 2560, 0, 8, 4, 64, 0, 0.0, 0.0,
         bf16, 0.02),
        # moe-3b's heads (Hkv 8, G 2, Dh 128) at phase 10 (c)'s 200- and
        # 2000-token prefills
        ("flash_prefill_moe3b_bf16", 1, 256, full_cache_len, 0, 8, 2, 128, 0, 0.0, 0.0,
         bf16, 0.02),
        ("flash_prefill_moe3b_long_bf16", 1, 2048, 2560, 0, 8, 2, 128, 0, 0.0, 0.0,
         bf16, 0.02),
    ] + [  # Gemma-2-2B's heads and score math at its prefills (phase 10 (b)): global
        # layers (window 0) and sliding ones (4096); S is the engine's cache
        (f"flash_prefill_g2b_t{t}{'_win' if win else ''}_bf16", 1, t, s, 0, 4, 2, 256, win,
         G2B_SCALE, G2B_SOFTCAP, bf16, 0.02)
        for t, s in ((256, full_cache_len), (2048, 2560), (6144, 6656)) for win in (0, 4096)
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
        # the library call: SDPA, or with a softcap (which SDPA lacks) flex_attention
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        sc = scale or dh ** -0.5
        qp = past + torch.arange(t, device="cuda")[:, None]
        kp = torch.arange(s, device="cuda")[None, :]
        mask = (kp <= qp) & ((kp > qp - window) if window else True)
        if cap:
            lib, lib_err = flex_call(qt, kt, vt, mask, sc, cap, want)
        elif past == 0 and window == 0:
            lib, lib_err = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt[:, :, :t], vt[:, :, :t], is_causal=True, scale=sc,
                enable_gqa=True), None
        else:
            lib, lib_err = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=mask, scale=sc, enable_gqa=True), None
        library_ms = time_ms(lib)
        bound_ms, bound_by = flash_bound(b, t, s, past, hq, hkv, dh, window, dtype)
        passed = finite and err <= tol
        ok &= passed
        results[name] = dict(max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                             library_err=lib_err)
        log(f"[kernel] {name}: {'PASS' if passed else 'FAIL'} max_abs_err={err:.3g} "
            f"tol={tol} ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f}"
            f"{f' (flex_attention, max_abs_err {lib_err:.3g})' if cap else ''} "
            f"bound_ms={bound_ms:.5f} ({bound_by}) shape=B{b} T{t} S{s} past{past} "
            f"Hq{hq} Hkv{hkv} Dh{dh} win{window} {str(dtype).split('.')[-1]}")
    return ok, results


LONG_CTX, LONG_ROWS = 30720, 512  # phase 14's long context; K1 checked on its first and last rows
LONG_ULPS = 2  # tolerance in bf16 ulps of the slice's largest |want|


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at ``x`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(max(abs(x), 2.0 ** -126))) - 7)


def check_flash_prefill_long():
    """K1 at ``bench_torch_longctx.py``'s prefill: T = S = 30720 with the
    Llama-3.2-1B heads (Hkv 8, G 4, Dh 64) in bf16. The plain version of the
    whole call would hold a 121 GB fp32 score tensor, so it runs on two
    slices of the kernel's rows: the last 512 (``past`` 30208 over all
    30720 keys; ``plain_ms`` is this slice's) and the first 512 (over their
    own 512 keys, where the causal edge cuts every tile). Each is held to
    LONG_ULPS bf16 ulps of its largest |want|: both sides round one fp32
    value to bf16, so they differ by at most about one ulp, while a lost key
    tile or split shifts an output of the last rows (typical size
    sqrt(e / S) ~ 0.01) by ~1e-3. The library call is SDPA's causal form
    without its math backend (which would also materialize the scores)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from layerskip_tpu_torch.ops.cuda.flash_prefill import (
        flash_prefill_attention,
        flash_prefill_attention_plain,
    )

    t0 = time.time()
    name, t, hkv, g, dh = "flash_prefill_1b_ctx30720_bf16", LONG_CTX, 8, 4, 64
    hq, past = hkv * g, LONG_CTX - LONG_ROWS
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(1, t, hq, dh, generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn(1, t, hkv, dh, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(1, t, hkv, dh, generator=gen, device="cuda").to(torch.bfloat16)
    kw = dict(q_heads_per_kv=g)
    got = flash_prefill_attention(q, k, v, 0, **kw)
    torch.cuda.synchronize()
    q_tail = q[:, past:].contiguous()
    slices = {"last": (got[:, past:], flash_prefill_attention_plain(q_tail, k, v, past, **kw)),
              "first": (got[:, :LONG_ROWS], flash_prefill_attention_plain(
                  q[:, :LONG_ROWS], k[:, :LONG_ROWS], v[:, :LONG_ROWS], 0, **kw))}
    errs, tols, typical = {}, {}, {}
    for part, (have, want) in slices.items():
        want = want.float()
        errs[part] = (have.float() - want).abs().max().item()
        tols[part] = LONG_ULPS * bf16_ulp(want.abs().max().item())
        typical[part] = want.abs().mean().item()
    err, tol = errs["last"], tols["last"]
    finite = bool(torch.isfinite(got).all())
    ms = time_ms(lambda: flash_prefill_attention(q, k, v, 0, **kw), 3)
    plain_ms = time_ms(lambda: flash_prefill_attention_plain(q_tail, k, v, past, **kw), 1)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    try:
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                          SDPBackend.CUDNN_ATTENTION]):
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), 3)
    except RuntimeError as exc:  # no fused backend takes the call: not timed
        log(f"[kernel] {name}: SDPA without its math backend refused: {exc}")
        library_ms = None
    bound_ms, bound_by = flash_bound(1, t, t, 0, hq, hkv, dh, 0, torch.bfloat16)
    del got, slices, q, k, v, q_tail, qt, kt, vt
    free_cuda()
    passed = finite and all(errs[p] <= tols[p] for p in errs)
    log(f"[kernel] {name}: {'PASS' if passed else 'FAIL'} max_abs_err={err:.3g} (last "
        f"{LONG_ROWS} rows; mean |want| {typical['last']:.3g}) tol={tol:.3g} ({LONG_ULPS} "
        f"bf16 ulps of max |want|), first {LONG_ROWS} rows {errs['first']:.3g} (mean |want| "
        f"{typical['first']:.3g}, tol {tols['first']:.3g}) ms={ms:.4f} plain_ms="
        f"{plain_ms:.4f} (last {LONG_ROWS} rows) library_ms={library_ms} bound_ms="
        f"{bound_ms:.5f} ({bound_by}) shape=B1 T{t} S{t} past0 Hq{hq} Hkv{hkv} Dh{dh} win0 "
        f"bfloat16; the case took {time.time() - t0:.1f}s")
    return passed, {name: dict(max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                               library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                               library_err=None)}


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
    weights). The 7B cases are the main paths' products (wq, wk and wv
    [N, K] = [4096, 4096]; wo, w_gate and w_down [K, N] = [4096, 4096],
    [4096, 11008] and [11008, 4096]) at M = 1 (AR step), 7 (verify window),
    256 (a 200-token prefill) and 2048 (a 2000-token prefill) in bf16, with
    N(0, 0.02) weights, and the Llama-3.2-1B wk [N, K] = [512, 2048] at
    M = 1, and Gemma-2-2B's (wq and wk [N, K] = [2048, 2304] and [1024,
    2304]; wo, w_gate and w_down [K, N] = [2048, 2304], [2304, 9216] and
    [9216, 2304]) at M = 1, 7 and 256; tol None there means one bf16 ulp
    (2^-7) of the largest output:
    kernel and plain version round the same fp32 sum, taken in another
    order, once."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        ("quant_matmul_gate", "quant_matmul", 64, 256, 384, f32, 0.05),
        ("quant_matmul_t_gate", "quant_matmul_t", 16, 256, 192, f32, 0.05),
        ("int4_matmul_gate", "int4_matmul", 1, 1792, 768, bf16, 1.5),
        ("int4_matmul_t_gate", "int4_matmul_t", 7, 1024, 512, bf16, 1.5),
    ]
    for m in (1, 7, 256, 2048):
        for kern in ("quant_matmul_t", "int4_matmul_t"):
            for layer, k, n in NK_LAYERS if m == 1 else NK_LAYERS[:1]:
                cases.append((f"{kern}_{layer}_m{m}", kern, m, k, n, bf16, None))
        for kern in ("quant_matmul", "int4_matmul"):
            for layer, k, n in KN_LAYERS:
                cases.append((f"{kern}_7b_{layer}_m{m}", kern, m, k, n, bf16, None))
    for m in (1, 7, 256):  # Gemma-2-2B's products (phase 10 (b)'s int8 base)
        for kern in ("quant_matmul_t", "int4_matmul_t"):
            for layer, k, n in G2B_NK_LAYERS:
                cases.append((f"{kern}_g2b_{layer}_m{m}", kern, m, k, n, bf16, None))
        for kern in ("quant_matmul", "int4_matmul"):
            for layer, k, n in G2B_KN_LAYERS:
                cases.append((f"{kern}_g2b_{layer}_m{m}", kern, m, k, n, bf16, None))
    return cases


# the [K, N] products of a 7B layer: (name, K, N), called once per layer
# (KN_CALLS times); w_up has w_gate's shape
KN_LAYERS = (("wo", 4096, 4096), ("wgate", 4096, 11008), ("wdown", 11008, 4096))
KN_CALLS = {"wo": 1, "wgate": 2, "wdown": 1}
# the [N, K] products: the 7B wq (wk and wv have its shape: three calls a
# layer) and the Llama-3.2-1B wk (and wv), whose N of 512 gives few blocks
NK_LAYERS = (("7b_wq", 4096, 4096), ("1b_wk", 2048, 512))
NK_CALLS = 3
# Gemma-2-2B's (D 2304, Hq*Dh 2048, Hkv*Dh 1024, F 9216): K 2304 is 36
# tiles of 64 and 18 int4 groups of 128
G2B_NK_LAYERS = (("wq", 2304, 2048), ("wk", 2304, 1024))  # wv has wk's shape
G2B_KN_LAYERS = (("wo", 2048, 2304), ("wgate", 2304, 9216), ("wdown", 9216, 2304))


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


def paged_cases():
    """(name, B, T, G, Hkv, Dh, page, row positions, dtype, int8 pool, window,
    scale, softcap, tree (depths, fanout) or None, tol). The gate's ten paged
    cases and tolerances
    (scripts/kernel_gate.py: fp32, pages of 128, capacity 256, 200 written
    keys, rows at 150 and 90; tol 0.005, 0.01 with the Gemma score math,
    0.2 for an int8 pool), pages of 16 and 256, the 7B decode shapes of
    phase 7 (B 4, Hkv 32, G 1, Dh 128, page 128, about 400 keys of context,
    T 1 and 7, bf16 and int8 pools; tol one bf16 rounding of an output
    below 2, 0.02), the same at the context of phase 5's 2000-token
    prompts (rows of 1904-2047 keys; B 4, and B 1 with one live slot), and
    phase 9's tree verify at those shapes (W 6 depths of fanout 2: T 13),
    and Gemma-2-2B's (B 4, Hkv 4, G 2, Dh 256, page 128, scale 1/16, softcap
    50, window 4096; T 1, 7 and the tree's 13; at ~400 and ~5000 keys)."""
    f32, bf16 = torch.float32, torch.bfloat16
    gate = (150, 90)
    g33, t62 = (3, 3), (6, 2)  # the gate's tree (T 10), phase 9's 7B tree (T 13)
    ctx7b = (391, 350, 300, 377)
    long7b = (2046, 1987, 1903, 2011)
    g2b_long = (5046, 4987, 4903, 5011)
    return [
        ("paged_decode_t1", 2, 1, 2, 2, 128, 128, gate, f32, False, 0, 0.0, 0.0, None, 5e-3),
        ("paged_decode_t7", 2, 7, 2, 2, 128, 128, gate, f32, False, 0, 0.0, 0.0, None, 5e-3),
        ("paged_decode_sliding", 2, 4, 1, 2, 128, 128, gate, f32, False, 9, 0.0, 0.0, None,
         5e-3),
        ("paged_decode_gemma", 2, 4, 2, 2, 128, 128, gate, f32, False, 48, 32.0 ** -0.5, 50.0,
         None, 0.01),
        ("paged_decode_q8_t1", 2, 1, 2, 2, 128, 128, gate, f32, True, 0, 0.0, 0.0, None, 0.2),
        ("paged_decode_q8_t7", 2, 7, 2, 2, 128, 128, gate, f32, True, 0, 0.0, 0.0, None, 0.2),
        ("paged_decode_tree", 2, 10, 2, 2, 128, 128, gate, f32, False, 0, 0.0, 0.0, g33, 5e-3),
        ("paged_decode_tree_q8", 2, 10, 2, 2, 128, 128, gate, f32, True, 0, 0.0, 0.0, g33,
         0.2),
        ("paged_decode_tree_gemma", 2, 10, 2, 2, 128, 128, gate, f32, False, 64,
         32.0 ** -0.5, 50.0, g33, 0.01),
        ("paged_decode_tree_gemma_q8", 2, 10, 2, 2, 128, 128, gate, f32, True, 64,
         32.0 ** -0.5, 50.0, g33, 0.2),
        ("paged_decode_page16", 2, 7, 2, 2, 128, 16, gate, f32, False, 0, 0.0, 0.0, None,
         5e-3),
        ("paged_decode_page256_q8", 2, 7, 2, 2, 128, 256, gate, f32, True, 0, 0.0, 0.0, None,
         0.2),
        ("paged_decode_7b_t1_bf16", 4, 1, 1, 32, 128, 128, ctx7b, bf16, False, 0, 0.0, 0.0,
         None, 0.02),
        ("paged_decode_7b_t7_bf16", 4, 7, 1, 32, 128, 128, ctx7b, bf16, False, 0, 0.0, 0.0,
         None, 0.02),
        ("paged_decode_q8_7b_t1_bf16", 4, 1, 1, 32, 128, 128, ctx7b, bf16, True, 0, 0.0, 0.0,
         None, 0.02),
        ("paged_decode_q8_7b_t7_bf16", 4, 7, 1, 32, 128, 128, ctx7b, bf16, True, 0, 0.0, 0.0,
         None, 0.02),
        ("paged_decode_7b_tree_t13_bf16", 4, 13, 1, 32, 128, 128, ctx7b, bf16, False, 0, 0.0,
         0.0, t62, 0.02),
        ("paged_decode_q8_7b_tree_t13_bf16", 4, 13, 1, 32, 128, 128, ctx7b, bf16, True, 0,
         0.0, 0.0, t62, 0.02),
        ("paged_decode_7b_long_t1_bf16", 4, 1, 1, 32, 128, 128, long7b, bf16, False, 0, 0.0,
         0.0, None, 0.02),
        ("paged_decode_q8_7b_long_t1_bf16", 4, 1, 1, 32, 128, 128, long7b, bf16, True, 0, 0.0,
         0.0, None, 0.02),
        ("paged_decode_7b_b1_long_t1_bf16", 1, 1, 1, 32, 128, 128, long7b[:1], bf16, False, 0,
         0.0, 0.0, None, 0.02),
    ] + [  # Gemma-2-2B's heads and score math under its window (phase 10 (b)): ~400
        # keys (the window cuts nothing) and ~5000 (it cuts ~900), T 1 and 7 and
        # the tree's 13
        (f"paged_decode{'_q8' if quant else ''}_g2b{'_long' if long else ''}"
         f"{'_tree' if tree else ''}_t{t}_bf16", 4, t, 2, 4, 256, 128,
         g2b_long if long else ctx7b, bf16, quant, G2B_WINDOW, G2B_SCALE, G2B_SOFTCAP,
         t62 if tree else None, 0.02)
        for long in (False, True) for t, tree in ((1, False), (7, False), (13, True))
        for quant in (False, True)
    ]


def paged_capacity(rows):
    """Keys per slot of a paged case: the gate's 256, phase 7's slots (392)
    for the 7B decode shapes, 2048 at the long context, 5120 past it."""
    if max(rows) < 256:
        return 256
    if max(rows) < 392:
        return 392
    return 2048 if max(rows) < 2048 else 5120


def paged_case_tensors(b, t, g, hkv, dh, page, rows, dtype, quant, tree, gen, cap):
    """Pools of one layer (of a two-layer stack) with each row mapped to
    scrambled pages of ``cap`` keys a slot, written up to each row's
    frontier, plus, for a tree (depths, fanout), its chains past it.
    Returns the k and v buffers, the same keys and values unquantized in an
    fp32 pool, q, the positions and the tree arguments."""
    from layerskip_tpu_torch.config import tiny_config
    from layerskip_tpu_torch.ops.paged_kv import init_paged_group, paged_geometry

    cap_pages, _, maxp = paged_geometry(cap, page, 256)
    pool_pages = b * cap_pages + 3
    table = torch.full((b, maxp), pool_pages, dtype=torch.int32)
    perm = torch.randperm(pool_pages, generator=torch.Generator().manual_seed(5))
    for r in range(b):
        table[r, :cap_pages] = perm[r * cap_pages:(r + 1) * cap_pages]
    table = table.cuda()
    cfg = tiny_config(num_key_value_heads=hkv, num_attention_heads=hkv * g,
                      hidden_size=hkv * g * dh, dtype=dtype)
    group, ref = (init_paged_group(dataclasses.replace(cfg, dtype=dt), 2, b, pool_pages,
                                   page, cap, 256, quant=quantized, table=table,
                                   device="cuda")
                  for quantized, dt in ((quant, dtype), (False, torch.float32)))
    # ref holds the same keys and values unquantized
    k, v, rk, rv = group.k[1], group.v[1], ref.k[1], ref.v[1]
    ctx = torch.tensor(rows, device="cuda")
    front = int(ctx.max()) + (1 if tree else t)

    def write(n, pos):
        for dst, src in ((k, rk), (v, rv)):
            x = torch.randn(b, n, hkv, dh, generator=gen, device="cuda")
            dst.write(x.to(dtype), pos)
            src.write(x.to(dtype).float(), pos)

    write(front, 0)
    tree_kw = {}
    if tree:  # t = 1 + depths * fanout
        depths, fanout = tree
        scratch = ctx + 1
        for d in range(depths):
            write(fanout, scratch + fanout * d)
        offs = torch.tensor([0] + [1 + d for d in range(depths) for _ in range(fanout)],
                            device="cuda")
        pos = ctx[:, None] + offs
        chain = torch.tensor([-1] + [c for _ in range(depths) for c in range(fanout)],
                             device="cuda")
        tree_kw = dict(tree_chain=chain.expand(b, t), tree_scratch=scratch,
                       tree_fanout=fanout)
    else:
        pos = ctx[:, None] + torch.arange(t, device="cuda")
    q = torch.randn(b, t, hkv * g, dh, generator=gen, device="cuda").to(dtype)
    return k, v, rk, rv, q, pos, tree_kw


def paged_bound(q, hkv, n_slots, pos, window, tree_kw, quant):
    """(bound_ms, bound_by): q and o once, and the K and V (with their
    scales) of every key that some query row of a batch row can see (the
    causal, window and tree clauses, as ``flash_bound`` counts them), once,
    over the memory rate; against 4 * Dh flops per visible (query head,
    key) pair at the peak rate for q's dtype."""
    from layerskip_tpu_torch.ops.cuda.paged_decode import _rows, _visible

    b, t, hq, dh = q.shape
    q_pos, chain, scratch, fanout, window = _rows(
        q, pos, tree_kw.get("tree_chain"), tree_kw.get("tree_scratch"),
        tree_kw.get("tree_fanout", 0), window)
    vis = _visible(q_pos.long(), n_slots, window, chain, scratch, fanout)  # [B, T, S]
    keys, pairs = int(vis.any(dim=1).sum()), int(vis.sum()) * hq
    esize = q.element_size()
    per_key = hkv * (dh + 2) if quant else hkv * dh * esize  # K or V bytes per key
    nbytes = 2 * b * t * hq * dh * esize + 2 * keys * per_key
    t_mem, t_ops = nbytes / MEM_BYTES_PER_S, 4.0 * dh * pairs / PEAK_FLOP_PER_S[q.dtype]
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops else "operations")


def paged_calls(q, k, v, pos, kw):
    """(kernel, plain version) of K2, or K3 for an int8 pair, as callables."""
    from layerskip_tpu_torch.ops.cuda import paged_decode as pd

    if hasattr(k, "scale"):
        return (lambda: pd.paged_decode_attention_q8(
                    q, k.pool, k.scale, v.pool, v.scale, k.table, pos, **kw),
                lambda: pd.paged_decode_attention_q8_plain(
                    q, k.pool, k.scale, v.pool, v.scale, k.table, pos, **kw))
    return (lambda: pd.paged_decode_attention(q, k.pool, v.pool, k.table, pos, **kw),
            lambda: pd.paged_decode_attention_plain(q, k.pool, v.pool, k.table, pos, **kw))


def paged_library_call(q, k, v, pos, window, scale, cap, tree_kw, want):
    """(callable, its max error against ``want`` or None): one
    ``scaled_dot_product_attention`` call, or with a softcap one
    ``flex_attention`` call (``flex_call``), over a contiguous view of the
    pair gathered (and dequantized to q's dtype) ahead of time, with an
    explicit mask of the causal, window and tree clauses: the library
    yardstick of K2/K3."""
    import torch.nn.functional as F

    from layerskip_tpu_torch.ops.cuda.paged_decode import _rows, _visible

    kd, vd = (x.gather_view(q.dtype).transpose(1, 2) for x in (k, v))
    q_pos, chain, scratch, fanout, window = _rows(
        q, pos, tree_kw.get("tree_chain"), tree_kw.get("tree_scratch"),
        tree_kw.get("tree_fanout", 0), window)
    mask = _visible(q_pos.long(), kd.shape[2], window, chain, scratch, fanout)  # [B, T, S]
    qt, sc = q.transpose(1, 2), scale or q.shape[-1] ** -0.5
    if cap:
        return flex_call(qt, kd, vd, mask, sc, cap, want)
    return lambda: F.scaled_dot_product_attention(
        qt, kd, vd, attn_mask=mask[:, None], scale=sc, enable_gqa=True), None


_FLEX = {"fn": None, "compile_s": 0.0, "score_mods": {}}


def flex_call(q, k, v, mask, scale, cap, want):
    """(callable, its max error against ``want`` [B, T, H, Dh]): the
    library call of an attention with a softcap, which SDPA lacks: one
    compiled ``flex_attention`` over q [B, Hq, T, Dh] and k, v [B, Hkv, S,
    Dh] with the score_mod ``cap * tanh(s / cap)`` and a block mask of
    ``mask`` ([T, S] or [B, T, S]), both made ahead of time. Compiled once
    per shape (its compile time is logged, outside the timings)."""
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    if _FLEX["fn"] is None:
        for limit in ("recompile_limit", "cache_size_limit"):  # one compile per shape
            if hasattr(torch._dynamo.config, limit):
                setattr(torch._dynamo.config, limit, 64)
        _FLEX["fn"] = torch.compile(flex_attention, dynamic=False)
    if cap not in _FLEX["score_mods"]:
        def softcap(score, b, h, q_idx, kv_idx):
            return cap * torch.tanh(score / cap)
        _FLEX["score_mods"][cap] = softcap
    if mask.dim() == 2:
        block = create_block_mask(lambda b, h, qi, ki: mask[qi, ki], None, None,
                                  *mask.shape, device="cuda")
    else:
        block = create_block_mask(lambda b, h, qi, ki: mask[b, qi, ki], mask.shape[0], None,
                                  *mask.shape[1:], device="cuda")
    fn, score_mod = _FLEX["fn"], _FLEX["score_mods"][cap]

    def call():
        return fn(q, k, v, score_mod=score_mod, block_mask=block, scale=scale,
                  enable_gqa=True)

    t0 = time.time()
    got = call()
    torch.cuda.synchronize()
    _FLEX["compile_s"] += time.time() - t0
    err = (got.transpose(1, 2).float() - want.float()).abs().max().item()
    return call, err


def check_paged_kernels():
    """K2/K3 against their plain versions at paged_cases(); for an int8 pool
    also against the same function over the unquantized keys (the gate's
    0.2 is that error), while K3 against its plain version must stay within
    fp32 rounding (5e-3). ``library_ms`` is SDPA over a contiguous view
    gathered ahead of time and timed alone: no single PyTorch call reads
    through a page table."""
    from layerskip_tpu_torch.ops.cuda import paged_decode as pd

    gen = torch.Generator(device="cuda").manual_seed(3)
    results, ok = {}, True
    for (name, b, t, g, hkv, dh, page, rows, dtype, quant, window, scale, cap, tree,
         tol) in paged_cases():
        k, v, rk, rv, q, pos, tree_kw = paged_case_tensors(
            b, t, g, hkv, dh, page, rows, dtype, quant, tree, gen, paged_capacity(rows))
        kw = dict(q_heads_per_kv=g, sliding_window=window, score_scale=scale,
                  logit_softcap=cap, **tree_kw)
        fn, plain = paged_calls(q, k, v, pos, kw)
        got = fn()
        torch.cuda.synchronize()
        want = plain()
        err = (got.float() - want.float()).abs().max().item()
        finite = bool(torch.isfinite(got).all())
        passed = finite
        extra = ""
        if quant:
            # the gate's comparison: against unquantized keys, at its tol
            full = pd.paged_decode_attention_plain(q.float(), rk.pool, rv.pool, rk.table, pos,
                                                   **kw)
            err_full = (got.float() - full).abs().max().item()
            # fp32: the gate's tol is for the unquantized keys, fp32
            # rounding (5e-3) for K3's own function; bf16: one rounding
            # (tol) for K3's function, the gate's 0.2 for the unquantized
            tol, full_tol = (5e-3, tol) if dtype == torch.float32 else (tol, 0.2)
            passed &= err_full <= full_tol
            extra = f" vs_unquantized={err_full:.3g} (tol {full_tol})"
        passed &= err <= tol
        ms = time_cold_ms(fn)
        plain_ms = time_cold_ms(plain, 5)
        lib, lib_err = paged_library_call(q, k, v, pos, window, scale, cap, tree_kw, want)
        library_ms = time_cold_ms(lib)
        bound_ms, bound_by = paged_bound(q, hkv, k.max_pages * page, pos, window, tree_kw,
                                         quant)
        ok &= passed
        results[name] = dict(max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                             library_err=lib_err)
        log(f"[kernel] {name}: {'PASS' if passed else 'FAIL'} max_abs_err={err:.3g} "
            f"tol={tol}{extra} ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f}"
            f"{f' (flex_attention, max_abs_err {lib_err:.3g})' if cap else ''} "
            f"bound_ms={bound_ms:.5f} ({bound_by}) shape=B{b} T{t} Hq{hkv * g} Hkv{hkv} "
            f"Dh{dh} page{page} rows{rows} win{window} tree(depths, fanout)={tree} "
            f"{'int8' if quant else str(dtype).split('.')[-1]} pool, q "
            f"{str(dtype).split('.')[-1]}")
    return ok, results


# ------------------------------------------------------------ phase 4


def small_fp32_model():
    """(cfg, params) of phase 4's narrow fp32 model (Dh 64)."""
    from layerskip_tpu_torch.config import tiny_config
    from layerskip_tpu_torch.models.params import init_params

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
    return cfg, params


def exact_fp32_greedy():
    from layerskip_tpu_torch.config import GenerationConfig
    from layerskip_tpu_torch.generation.engine import Engine, postprocess_output
    from layerskip_tpu_torch.quant import quantize_llama_params

    cfg, params = small_fp32_model()
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
        for every other quantized product, one K1 launch per layer, and
        every K1 and K4-K7 launch on its fp32 (CUDA-core) route."""
        return n["flash_prefill"] == nl and all(
            n[f"{k}_tensor_core"] == 0 for k in TENSOR_CORE_ROUTES) and all(
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


def serve_session(session, prompts, budgets):
    """Feed ``prompts`` through a continuous session's free slots as they
    open, two rounds per step; returns {request: tokens}."""
    got, owner, queue = {}, {}, list(range(len(prompts)))
    while queue or session.has_active():
        slots = session.free_slots()[:len(queue)]
        if slots:
            take = [queue.pop(0) for _ in slots]
            session.insert(slots, [prompts[i] for i in take],
                           max_tokens=[budgets[i] for i in take])
            owner.update(zip(slots, take))
        for row, toks, _ in session.step(max_rounds=2):
            got[owner[row]] = toks
    return got


def exact_fp32_paged():
    """Paged continuous sessions (4 slots, six requests joining as slots
    free, pages of 16, prompt bucket 64) emit exactly the solo ``generate``
    streams in fp32, over the model-dtype pool (K2) and the int8 pool (K3,
    also at pages of 12), and on an int8 base (K4/K5 beside K2). With no tree and a bucket above
    16 the insert prefill runs K1 over the gathered view of its rows, not
    K2, so the session launches K2 (K3) a positive multiple of W*E + L
    times (one round: W drafts over E layers, then the verify over L)."""
    import dataclasses as dc

    from layerskip_tpu_torch.config import GenerationConfig
    from layerskip_tpu_torch.generation.engine import Engine, postprocess_output
    from layerskip_tpu_torch.quant import quantize_llama_params

    cfg, params = small_fp32_model()
    rng = np.random.default_rng(5)
    prompts = [rng.integers(3, cfg.vocab_size, size=n).tolist() for n in (40, 7, 60, 23, 51, 12)]
    budgets = [40, 9, 33, 48, 5, 20]
    eos = (cfg.vocab_size + 7,)
    e, w, nl = 2, 4, cfg.num_hidden_layers
    per_round = w * e + nl
    gen = GenerationConfig(max_steps=48, sample=False, generation_strategy="self_speculative",
                           exit_layer=e, num_speculations=w)
    ok = True
    for label, base, kv_quant, page in (
            ("fp32 pool", params, False, 16), ("int8 pool", params, True, 16),
            ("int8 pool, pages of 12", params, True, 12),
            ("int8 base, fp32 pool", quantize_llama_params(params), False, 16)):
        eng = Engine(base, cfg, device="cuda")
        g = dc.replace(gen, kv_quant=kv_quant)
        kernel = "paged_decode_attention_q8" if kv_quant else "paged_decode_attention"
        session = eng.continuous_session(g, batch=4, prompt_bucket=64, eos_ids=eos,
                                         paged_pool_pages=640 // page, page_size=page)
        reset_counts()
        got = serve_session(session, prompts, budgets)
        n = read_counts()
        want = [postprocess_output(eng.generate(p, dc.replace(g, max_steps=m), eos_ids=eos),
                                   eos, m) for p, m in zip(prompts, budgets)]
        same = [got[i] == want[i] for i in range(len(prompts))]
        quant_ok = (n["quant_matmul_t"] > 0 and n["quant_matmul"] > 0
                    and n["quant_matmul_t_tensor_core"] == n["quant_matmul_tensor_core"] == 0) \
            if base is not params else n["quant_matmul_t"] == n["quant_matmul"] == 0
        other = "paged_decode_attention" if kv_quant else "paged_decode_attention_q8"
        good = (all(same) and n[kernel] > 0 and n[kernel] % per_round == 0
                and n[other] == 0 and quant_ok)
        ok &= good
        log(f"[fp32 paged] {label}: session == solo for {sum(same)}/{len(same)} requests "
            f"({sum(len(t) for t in got.values())} tokens), launches {kernel}={n[kernel]} "
            f"(a multiple of W*E+L={per_round}: {n[kernel] % per_round == 0}) "
            f"quant_matmul_t={n['quant_matmul_t']} quant_matmul={n['quant_matmul']} -> "
            f"{'PASS' if good else 'FAIL'}")
    return ok


# ------------------------------------------------------------ phase 5


def first_diff(a, b) -> int:
    return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))


NEAR_TIE = 0.05  # a top-2 logit gap below this is a near tie in bf16
# and in fp32, where another path or batch moves the logits only by fp32
# rounding (an MoE layer's expert products summed in another order; the
# fp32 solo streams' shortfall, logged, measures it)
FP32_TIE = 1e-3


def teacher_forced(params, cfg, prompt, toks, kv_quant=False):
    """Logits [len(toks), V] that predict each of ``toks`` from one forward
    over prompt + toks, through the int8 cache with ``kv_quant``."""
    from layerskip_tpu_torch.models import llama
    from layerskip_tpu_torch.ops.kv_cache import init_kv_cache, init_quant_kv_cache

    ids = torch.tensor([prompt + toks], device="cuda")
    with torch.inference_mode():
        init = init_quant_kv_cache if kv_quant else init_kv_cache
        cache = init(cfg, 1, ids.shape[1], device="cuda")
        return llama.forward(params, cfg, ids, cache, 0).logits[0, len(prompt) - 1:-1]


def same_tensor(a, b) -> bool:
    """Both absent (a family's optional field), or equal tensors."""
    return a is None and b is None or (a is not None and b is not None
                                       and torch.equal(a, b))


def fp32_model(params, cfg):
    """The same weights in fp32 (bf16 to fp32 is exact) and an fp32 config:
    a forward free of bf16 rounding in its activations."""
    layers = dataclasses.replace(params.layers, **{
        f.name: getattr(params.layers, f.name).float()
        for f in dataclasses.fields(params.layers)
        if getattr(params.layers, f.name) is not None})
    lm_head = None if params.lm_head is None else params.lm_head.float()
    return (dataclasses.replace(params, embed=params.embed.float(), layers=layers,
                                final_norm=params.final_norm.float(), lm_head=lm_head),
            dataclasses.replace(cfg, dtype=torch.float32))


def near_tie(params, cfg, prompt, toks, kv_quant=False, threshold=NEAR_TIE):
    """(first position whose top-2 logit gap is under ``threshold``, the
    teacher-forced argmax's agreement with ``toks``, all logits finite) from
    one forward over prompt + toks (through the path's own cache type)."""
    logits = teacher_forced(params, cfg, prompt, toks, kv_quant)
    top2 = logits.topk(2, dim=-1).values
    gaps = (top2[:, 0] - top2[:, 1]).tolist()
    tie = next((j for j, gap in enumerate(gaps) if gap < threshold), len(gaps))
    return tie, first_diff(toks, logits.argmax(-1).tolist()), bool(torch.isfinite(logits).all())


def greedy_shortfall(params, cfg, prompt, toks, kv_quant=False):
    """(tokens that are the teacher-forced argmax, the largest gap between
    the teacher-forced top logit and the logit of the token chosen) over
    every token of a greedy stream: each choice is checked against the
    model given the stream's own history, so a stream that left the solo
    one at a near tie is still checked to its end."""
    if not toks:
        return 0, 0.0
    logits = teacher_forced(params, cfg, prompt, toks, kv_quant)
    chosen = logits.gather(1, torch.tensor(toks, device="cuda")[:, None])[:, 0]
    short = logits.max(dim=-1).values - chosen
    return int((short == 0).sum()), float(short.max())


def generate_timed(eng, prompt, gen_cfg, eos):
    """(tokens, seconds, matches, drafts, launch counts) of one run, with
    every kernel count set to 0 just before it and read just after."""
    reset_counts()
    t0 = time.perf_counter()
    out = eng.generate(prompt, gen_cfg, eos_ids=eos)
    toks = out.tokens[0, :int(out.num_tokens[0])].tolist()[:gen_cfg.max_steps]
    secs = time.perf_counter() - t0
    return toks, secs, int(out.matches), int(out.drafts), read_counts()


# (prompt tokens, prefill bucket, phase-3 K1 case of that prefill)
TTFT_PROMPTS = ((200, 256, "flash_prefill_7b_bf16"), (2000, 2048, "flash_prefill_7b_long_bf16"))


def time_to_first_token(eng, cfg, eos, kres, qres=None, kerns=None, label="7b ttft"):
    """Wall ms of ``generate(max_steps=1)`` (the prompt's prefill and one
    token) for a 200- and a 2000-token prompt, each after a warm-up run of
    the same prompt, with K1's launches and their device time at phase 3's
    time for that prefill shape (buckets 256 and 2048). With ``kerns`` =
    (K4 or K7, K5 or K6) on a quantized base also each one's launches,
    their device time at phase 3's times of the layer's [N, K] (wq, wk,
    wv) or [K, N] products at M = the bucket, and that time's share of the
    wall. Returns (stats, launch counts summed over the timed runs)."""
    from layerskip_tpu_torch.config import GenerationConfig

    rng = np.random.default_rng(4)
    gen_cfg = GenerationConfig(max_steps=1, sample=False, generation_strategy="autoregressive")
    stats, total = {}, {}
    for n, bucket, case in TTFT_PROMPTS:
        prompt = rng.integers(3, cfg.vocab_size, size=n).tolist()
        eng.generate(prompt, gen_cfg, eos_ids=eos)
        torch.cuda.synchronize()
        toks, secs, _, _, counts = generate_timed(eng, prompt, gen_cfg, eos)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        k1 = counts["flash_prefill"]
        st = dict(ms=secs * 1e3, tokens=len(toks), k1_launches=k1,
                  k1_device_ms=k1 * kres[case]["ms"], k1_case=case)
        if kerns:
            nk, kn = kerns
            nk_ms = NK_CALLS * qres[f"{nk}_7b_wq_m{bucket}"]["ms"]
            kn_ms = sum(KN_CALLS[name] * qres[f"{kn}_7b_{name}_m{bucket}"]["ms"]
                        for name, _, _ in KN_LAYERS)
            st.update(nk_launches=counts[nk], nk_device_ms=cfg.num_hidden_layers * nk_ms,
                      kn_launches=counts[kn], kn_device_ms=cfg.num_hidden_layers * kn_ms)
            st["nk_share"] = st["nk_device_ms"] / st["ms"]
            st["kn_share"] = st["kn_device_ms"] / st["ms"]
        stats[n] = st
    log(f"[{label}] generate(max_steps=1), wall ms after a warm-up: " + "; ".join(
        f"{n}-token prompt {s['ms']:.2f} ms, K1 {s['k1_launches']} launches x "
        f"{kres[s['k1_case']]['ms']:.4f} ms ({s['k1_case']}) = {s['k1_device_ms']:.3f} ms"
        + "".join(f", {k} {s[f'{p}_launches']} launches = {s[f'{p}_device_ms']:.3f} ms at "
                  f"phase 3's M = {bucket} times ({s[f'{p}_share']:.1%} of the wall)"
                  for p, k in zip(("nk", "kn"), kerns or ()))
        for (n, s), (_, bucket, _) in zip(stats.items(), TTFT_PROMPTS)))
    return stats, total


def full_width(kres):
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
          and counts["flash_prefill_tensor_core"] == launches  # bf16: tensor cores
          and all(v == 0 for k, v in counts.items()  # no quantized product
                  if not k.startswith("flash_prefill")))
    ttft, ttft_counts = time_to_first_token(eng, cfg, eos, kres)
    ok &= all(s["k1_launches"] == cfg.num_hidden_layers and s["tokens"] == 1
              for s in ttft.values())
    for k, v in ttft_counts.items():
        counts[k] += v
    stats = dict(ar_tok_s=ar_tps, spec_tok_s=sp_tps, speedup=sp_tps / ar_tps,
                 acceptance=acceptance, launches=launches, ttft=ttft)
    return ok, stats, counts, (params, cfg, prompt, ar_toks, first_tie)


# ------------------------------------------------------------ phase 6


def quantized_full_width(params, cfg, prompt, bf16_ar, bf16_tie, kres, qres):
    """int8 and int4 bases (AR and spec, then the time to first token of a
    200- and a 2000-token prompt) and int8 and int4 drafters over the bf16
    base (spec) at full width. Returns (ok, per-run stats, launch counts
    summed over the runs)."""
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
        name = f"int{bits}_base"
        ttft, ttft_counts = time_to_first_token(eng, cfg, eos, kres, qres, (k_nk, k_kn),
                                                f"7b {name} ttft")
        add(ttft_counts)
        good &= all(s["tokens"] == 1 and s["nk_launches"] == 3 * nl
                    and s["kn_launches"] == 4 * nl for s in ttft.values())
        ok &= good
        stats[name] = dict(ar_tok_s=len(ar_toks) / t_ar, spec_tok_s=len(sp_toks) / t_sp,
                           acceptance=acceptance, spec_eq_ar=agree, first_tie=tie,
                           ar_launches={k_nk: n_ar[k_nk], k_kn: n_ar[k_kn]},
                           spec_launches={k_nk: n_sp[k_nk], k_kn: n_sp[k_kn]},
                           quantize_s=t_quant, ttft=ttft)
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


# ------------------------------------------------------------ phase 7


SERVE_BATCH, SERVE_BUCKET, SERVE_PAGE = 4, 256, 128


def serve_run(eng, gen_cfg, prompts, budgets, pool_pages, prefix_cache=False):
    """One ``ContinuousBatchScheduler`` run of every request, submitted at
    once (with the prefix cache, the first alone, then the rest once it is
    in: a batch admitted together publishes its pages only after its
    insert), with every kernel count set to 0 just before it and read just
    after. Returns (tokens per request, wall seconds, scheduler, counts)."""
    from layerskip_tpu_torch.serving import ContinuousBatchScheduler

    sched = ContinuousBatchScheduler(
        eng, gen_cfg, batch_size=SERVE_BATCH, prompt_bucket=SERVE_BUCKET,
        eos_ids=(eng.cfg.vocab_size + 7,), paged_pool_pages=pool_pages,
        page_size=SERVE_PAGE, prefix_cache=prefix_cache)
    reset_counts()
    t0 = time.perf_counter()
    sched.start()
    try:
        futs = [sched.submit(prompts[0], max_tokens=budgets[0])]
        while prefix_cache and not sched.session.has_active() and not futs[0].done():
            time.sleep(0.001)
        futs += [sched.submit(p, max_tokens=m) for p, m in zip(prompts[1:], budgets[1:])]
        toks = [f.result(timeout=600) for f in futs]
    finally:
        sched.stop()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return toks, secs, sched, read_counts()


def round_costs(eng, gen_cfg, prompts):
    """Where a served token's time goes: wall ms (synchronized) of one
    insert of ``batch`` 256-bucket prompts, of one round after it and, at
    batch 4, of a one-request insert beside three live rows, for a paged
    bf16 pool at batch 4 and 1 and a contiguous cache at batch 4 (whose
    insert still runs every row)."""
    out = {}
    for label, batch, paged in (("paged_b4", 4, dict(paged_pool_pages=16)),
                                ("contiguous_b4", 4, {}),
                                ("paged_b1", 1, dict(paged_pool_pages=4))):
        if paged:
            paged["page_size"] = SERVE_PAGE
        session = eng.continuous_session(gen_cfg, batch, SERVE_BUCKET,
                                         eos_ids=(eng.cfg.vocab_size + 7,), **paged)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        session.insert(list(range(batch)), prompts[:batch], max_tokens=[FULL_STEPS] * batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        session.step()
        t2 = time.perf_counter()
        for _ in range(8):
            session.step()
        t3 = time.perf_counter()
        out[label] = dict(insert_ms=(t1 - t0) * 1e3, first_round_ms=(t2 - t1) * 1e3,
                          round_ms=(t3 - t2) / 8 * 1e3)
        if batch > 1:  # one request replacing another beside three live ones
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            session.insert([0], prompts[batch:batch + 1], max_tokens=[FULL_STEPS])
            torch.cuda.synchronize()
            out[label]["insert_one_ms"] = (time.perf_counter() - t0) * 1e3
    log(f"[serve rounds] one insert and one round, wall ms (synchronized): "
        f"{json.dumps(out)}")
    return out


def serving_full_width(params, cfg, spec_tok_s):
    """Continuous serving at full width from phase 5's bf16 weights: batch
    4, prompt bucket 256, pages of 128, exit 8, W 6, greedy. Eight requests
    (prompts of 60-200 tokens, budgets of 32-128) over a pool of about 60%
    of four slots' worst case, so some wait for pages: once with a bf16
    pool (K2) and once with the int8 pool (K3); then four requests sharing
    a 128-token prefix with the prefix cache (three hits). Every request
    must equal its solo ``generate`` stream up to its first near tie (by
    the logits of its own cache type, below), and each run must compare at least
    two tokens per request that way. Since this random model's first near
    ties come within a few tokens, every served token is also held to the
    teacher-forced logits given the served history: its shortfall from the
    top logit may be at most twice the larger of NEAR_TIE and the solo
    streams' own worst shortfall (the bf16 noise between the decode and
    prefill paths, which the reference path shows too; a wrong KV read or
    a mixed-up row falls whole logits short). Near ties are found on the
    teacher-forced logits of the same weights in fp32, since a bf16
    teacher-forced pass is itself off by a few hundredths, enough to lift a
    true near tie past NEAR_TIE; over the int8 pool also on the bf16 pass,
    since the fp32 pass quantizes its own fp32 keys and values, whose int8
    codes differ from the pool's at rounding edges."""
    import dataclasses as dc

    from layerskip_tpu_torch.config import GenerationConfig
    from layerskip_tpu_torch.generation.engine import Engine

    eng = Engine(params, cfg, device="cuda")
    rng = np.random.default_rng(7)
    lens = [60, 200, 137, 95, 181, 72, 160, 118]
    budgets = [128, 96, 128, 32, 80, 128, 96, 100]
    prompts = [rng.integers(3, cfg.vocab_size, size=n).tolist() for n in lens]
    prefix = rng.integers(3, cfg.vocab_size, size=128).tolist()
    shared = [prefix + rng.integers(3, cfg.vocab_size, size=n).tolist()
              for n in (20, 45, 70, 33)]
    shared_budgets = [64, 128, 32, 96]
    worst = -(-(SERVE_BUCKET + FULL_STEPS + FULL_W + 2) // SERVE_PAGE)  # pages per slot
    pool = int(0.6 * SERVE_BATCH * worst)
    gen = GenerationConfig(max_steps=FULL_STEPS, sample=False,
                           generation_strategy="self_speculative", exit_layer=FULL_EXIT,
                           num_speculations=FULL_W)
    eos = (cfg.vocab_size + 7,)
    solo_cache = {}
    params32, cfg32 = fp32_model(params, cfg)

    def solo(p, m, kv_quant):
        key = (tuple(p), m, kv_quant)
        if key not in solo_cache:
            out = eng.generate(p, dc.replace(gen, max_steps=m, kv_quant=kv_quant), eos_ids=eos)
            toks = out.tokens[0, :int(out.num_tokens[0])].tolist()[:m]
            tie = near_tie(params32, cfg32, p, toks, kv_quant)[0]
            if kv_quant:
                tie = min(tie, near_tie(params, cfg, p, toks, kv_quant)[0])
            solo_cache[key] = (toks, tie, greedy_shortfall(params, cfg, p, toks, kv_quant))
        return solo_cache[key]

    serve_run(eng, dc.replace(gen, max_steps=8), prompts[:2], [8, 8], pool)  # warm-up
    ok, stats, total = True, {"rounds": round_costs(eng, gen, prompts)}, {}
    for name, kv_quant, ps, ms, pc in (
            ("bf16_pool", False, prompts, budgets, False),
            ("int8_pool", True, prompts, budgets, False),
            ("prefix_cache", False, shared, shared_budgets, True)):
        toks, secs, sched, counts = serve_run(eng, dc.replace(gen, kv_quant=kv_quant), ps, ms,
                                              pool, prefix_cache=pc)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        agree, n_argmax, worst, solo_argmax, solo_worst = [], 0, 0.0, 0, 0.0
        for p, m, got in zip(ps, ms, toks):
            want, tie, (solo_max, solo_short) = solo(p, m, kv_quant)
            agree.append((first_diff(got, want), min(tie, m), len(got) == m))
            n_max, short = greedy_shortfall(params, cfg, p, got, kv_quant)
            n_argmax, worst = n_argmax + n_max, max(worst, short)
            solo_argmax, solo_worst = solo_argmax + solo_max, max(solo_worst, solo_short)
        n_tok = sum(len(t) for t in toks)
        compared = sum(t for _, t, _ in agree)
        limit = 2 * max(NEAR_TIE, solo_worst)
        kernel = "paged_decode_attention_q8" if kv_quant else "paged_decode_attention"
        acceptance = sched.stats["acceptance_sum"] / max(sched.stats["completed"], 1)
        hits = sched.session.prefix_cache.hits if pc else None
        good = (all(a >= t and full for a, t, full in agree) and compared >= 2 * len(ps)
                and worst <= limit and counts[kernel] > 0
                and sched.stats["completed"] == len(ps) and (not pc or hits >= 3))
        ok &= good
        stats[name] = dict(tok_s=n_tok / secs, tokens=n_tok, seconds=secs,
                           vs_single_stream_spec=n_tok / secs / spec_tok_s,
                           acceptance=acceptance, launches={kernel: counts[kernel]},
                           latency=sched.latency.summary(), prefix_hits=hits,
                           pool_pages=pool, rounds=sched.stats["rounds"],
                           held_for_pages=sched.stats["held_for_pages"],
                           compared_to_solo=compared, teacher_forced_argmax=n_argmax,
                           worst_shortfall=worst, solo_teacher_forced_argmax=solo_argmax,
                           solo_worst_shortfall=solo_worst, shortfall_limit=limit)
        log(f"[serve {name}] {len(ps)} requests, {n_tok} tokens in {secs:.3f}s = "
            f"{n_tok / secs:.2f} tok/s aggregate ({n_tok / secs / spec_tok_s:.2f}x the "
            f"single-stream spec rate {spec_tok_s:.2f}), mean acceptance {acceptance:.4f}, "
            f"{sched.stats['rounds']} scheduler steps, pool {pool} pages of {SERVE_PAGE}, "
            f"{sched.stats['held_for_pages']} admissions held for pages, "
            f"prefix hits {hits}; launches {kernel}={counts[kernel]} "
            f"flash_prefill={counts['flash_prefill']}; equal to solo up to "
            f"(first diff, first near tie or budget) {[(a, t) for a, t, _ in agree]}, "
            f"{compared} tokens compared (at least {2 * len(ps)}); latency "
            f"{json.dumps(sched.latency.summary())}; every served token against the "
            f"teacher-forced logits ({'int8' if kv_quant else 'bf16'} cache) given its own "
            f"history: {n_argmax}/{n_tok} the argmax, largest shortfall {worst:.4f} (limit "
            f"{limit:.4f}; the solo streams: {solo_argmax}/{n_tok} the argmax, largest "
            f"shortfall {solo_worst:.4f}) -> {'PASS' if good else 'FAIL'}")
    return ok, stats, total


# ------------------------------------------------------------ phase 8


ENTRY_MODEL = f"random:7b?tail_eps=0&tail_from={FULL_EXIT}"
ENTRY_STEPS = 64


def entry_prompts(n: int, seed: int):
    """``n`` prompts of about 200 bytes (200 tokens of the byte tokenizer:
    prefill bucket 256)."""
    words = np.random.default_rng(seed).integers(0, 10**6, size=(n, 40))
    return [" ".join(str(w) for w in row)[:200] for row in words]


def write_jsonl(path, prompts):
    with open(path, "w") as f:
        for p in prompts:
            f.write(json.dumps({"prompt": p, "response": p[:40]}) + "\n")
    return path


def free_cuda():
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def entry_fp32_exact(card, tmp):
    """Phase 4's fp32 model through a checkpoint: ``save_params``, then
    ``load_model_and_tokenizer(dir, float32)`` (bit-equal to the saved
    weights) and greedy AR == spec through ``LlamaGenerator``, then
    ``cli.correctness.main`` (total_errors 0) and ``cli.benchmark.main``
    (its JSON written) on the same directory with ``--model_args
    dtype=float32``. Every K1 launch on the fp32 (CUDA-core) route."""
    from layerskip_tpu_torch.cli.args import Arguments
    from layerskip_tpu_torch.cli.benchmark import BenchmarkArguments
    from layerskip_tpu_torch.cli.benchmark import main as bench_main
    from layerskip_tpu_torch.cli.correctness import main as correctness_main
    from layerskip_tpu_torch.cli.loading import load_model_and_tokenizer
    from layerskip_tpu_torch.config import GenerationConfig
    from layerskip_tpu_torch.generation.generator import LlamaGenerator
    from layerskip_tpu_torch.models.params import save_params

    cfg, params = small_fp32_model()
    ckpt = os.path.join(tmp, "fp32_ckpt")
    save_params(params, ckpt, cfg)
    loaded, lcfg, tok = load_model_and_tokenizer(ckpt, dtype=torch.float32, device="cuda")
    same = lcfg.dtype == torch.float32 and all(
        same_tensor(getattr(loaded.layers, f.name), getattr(params.layers, f.name))
        for f in dataclasses.fields(params.layers)) and all(
        torch.equal(getattr(loaded, f), getattr(params, f))
        for f in ("embed", "final_norm", "lm_head"))
    prompts = entry_prompts(4, 8)
    spec = GenerationConfig(max_steps=48, sample=False, generation_strategy="self_speculative",
                            exit_layer=2, num_speculations=4)
    gen = LlamaGenerator(tok, loaded, lcfg, device="cuda")
    reset_counts()
    ar_cfg = dataclasses.replace(spec, generation_strategy="autoregressive", exit_layer=-1,
                                 num_speculations=-1)  # the full model, as cli.correctness
    pairs = [(gen.generate(p, ar_cfg), gen.generate(p, spec)) for p in prompts]
    n_gen = read_counts()
    equal = all(a.generation_strategy_result.predicted_tokens
                == s.generation_strategy_result.predicted_tokens for a, s in pairs)
    data = write_jsonl(os.path.join(tmp, "fp32.jsonl"), prompts)
    bench_args = BenchmarkArguments(dataset="custom_jsonl", data_path=data,
                                    random_shuffle=False)
    args = Arguments(model=ckpt, model_args="dtype=float32", device="cuda",
                     output_dir=os.path.join(tmp, "fp32_out"))
    reset_counts()
    corr = correctness_main(args, bench_args, spec)
    metrics = bench_main(dataclasses.replace(args, output_dir=os.path.join(tmp, "fp32_bench")),
                         bench_args, spec)
    n_cli = read_counts()
    written = []
    for name in os.listdir(os.path.join(tmp, "fp32_bench")):
        with open(os.path.join(tmp, "fp32_bench", name)) as f:
            written.append(json.load(f))
    nl = cfg.num_hidden_layers
    routes = all(n[f"{k}_tensor_core"] == 0 for n in (n_gen, n_cli) for k in TENSOR_CORE_ROUTES)
    ok = (same and equal and corr["total_errors"] == 0 and len(written) == 1
          and set(written[0]) == {"args", "benchmark_arguments", "generation_config",
                                  "metric_result"}
          and n_gen["flash_prefill"] == 2 * len(prompts) * nl
          and n_cli["flash_prefill"] == 3 * len(prompts) * nl and routes)
    log(f"[entry fp32] save_params -> load_model_and_tokenizer(float32): bit-equal={same}; "
        f"LlamaGenerator AR == spec on {len(prompts)} prompts: {equal} "
        f"({[len(a.generation_strategy_result.predicted_tokens) for a, _ in pairs]} tokens); "
        f"cli.correctness {json.dumps(corr)}; cli.benchmark acceptance "
        f"{metrics['acceptance_rate']['mean']:.4f}, JSON files {len(written)}; K1 launches "
        f"{n_gen['flash_prefill']} + {n_cli['flash_prefill']} (want {2 * len(prompts) * nl} + "
        f"{3 * len(prompts) * nl}), none on the tensor cores: {routes} -> "
        f"{'PASS' if ok else 'FAIL'} ({card})")
    return ok


def entry_full_width(card, tmp):
    """The entry points at 7B in bf16 (identity tail past exit 8): the CLI
    benchmark, AR against spec and streaming through ``LlamaGenerator``,
    the int8 loader, the serving command line's builder (paged continuous
    batching), then the bench in a subprocess. Returns (ok, stats, launch
    counts of the bf16 runs)."""
    from layerskip_tpu_torch.cli.args import Arguments
    from layerskip_tpu_torch.cli.benchmark import BenchmarkArguments
    from layerskip_tpu_torch.cli.benchmark import main as bench_main
    from layerskip_tpu_torch.cli.loading import load_model_and_tokenizer
    from layerskip_tpu_torch.config import GenerationConfig
    from layerskip_tpu_torch.generation.generator import LlamaGenerator
    from layerskip_tpu_torch.generation.streamer import SpeculativeTextStreamer

    total, stats = {}, {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    spec = GenerationConfig(max_steps=ENTRY_STEPS, sample=False,
                            generation_strategy="self_speculative", exit_layer=FULL_EXIT,
                            num_speculations=FULL_W)
    prompts = entry_prompts(4, 9)

    # the CLI benchmark over a custom_jsonl task
    data = write_jsonl(os.path.join(tmp, "7b.jsonl"), prompts)
    reset_counts()
    t0 = time.perf_counter()
    metrics = bench_main(Arguments(model=ENTRY_MODEL, device="cuda",
                                   output_dir=os.path.join(tmp, "7b_bench")),
                         BenchmarkArguments(dataset="custom_jsonl", data_path=data,
                                            random_shuffle=False), spec)
    secs = time.perf_counter() - t0
    counts = read_counts()
    add(counts)
    free_cuda()
    acc, tps = metrics["acceptance_rate"]["mean"], metrics["tokens_per_second"]["mean"]
    ok_bench = acc >= 0.9 and counts["flash_prefill"] == len(prompts) * 32
    stats["cli_benchmark"] = dict(tok_s=tps, acceptance=acc, seconds=secs,
                                  k1_launches=counts["flash_prefill"])
    log(f"[entry 7b benchmark] cli.benchmark {ENTRY_MODEL}, {len(prompts)} prompts of 200 "
        f"bytes, exit {FULL_EXIT} W {FULL_W}, {ENTRY_STEPS} steps: mean {tps:.2f} tok/s, "
        f"acceptance {acc:.4f} (want >= 0.9), {secs:.1f}s with the load, K1 launches "
        f"{counts['flash_prefill']} -> {'PASS' if ok_bench else 'FAIL'} ({card})")

    # greedy AR against spec, and streaming, through LlamaGenerator
    params, cfg, tok = load_model_and_tokenizer(ENTRY_MODEL, device="cuda")
    gen = LlamaGenerator(tok, params, cfg, device="cuda")
    ar_cfg = dataclasses.replace(spec, generation_strategy="autoregressive", exit_layer=-1,
                                 num_speculations=-1)
    reset_counts()
    ar, sp = gen.generate(prompts[0], ar_cfg), gen.generate(prompts[0], spec)
    add(read_counts())
    ar_t = ar.generation_strategy_result.predicted_tokens
    sp_t = sp.generation_strategy_result.predicted_tokens
    ids = gen._encode(prompts[0])
    tie, _, finite = near_tie(params, cfg, ids, ar_t)
    agree = first_diff(ar_t, sp_t)
    ok_gen = finite and (ar_t == sp_t or agree >= tie)
    stats["generator"] = dict(ar_tok_s=ar.tokens_per_second, spec_tok_s=sp.tokens_per_second,
                              acceptance=sp.generation_strategy_result.acceptance_rate,
                              agree=agree, first_tie=tie, tokens=len(ar_t))
    log(f"[entry 7b generator] AR {ar.tokens_per_second:.2f} tok/s, spec "
        f"{sp.tokens_per_second:.2f} tok/s, acceptance "
        f"{sp.generation_strategy_result.acceptance_rate:.4f}; spec == AR for {agree} of "
        f"{len(ar_t)} tokens, first top-2 gap < {NEAR_TIE} at {tie} -> "
        f"{'PASS' if ok_gen else 'FAIL'} ({card})")

    buf = io.StringIO()
    streamer = SpeculativeTextStreamer(tok, out=buf)
    accepted = []

    def on_round(drafted, acc_toks):
        if drafted:
            streamer.put(drafted, is_draft=True)
            streamer.delete(len(drafted))
        streamer.put(acc_toks)
        accepted.extend(acc_toks)

    reset_counts()
    t0 = time.perf_counter()
    out = gen.engine.stream_generate(ids, spec, None, gen.eos_ids, on_round=on_round)
    n = int(out.num_tokens[0])
    secs = time.perf_counter() - t0
    streamer.end()
    ref = gen.engine.generate(ids, spec, None, gen.eos_ids)
    add(read_counts())
    n_ref = int(ref.num_tokens[0])
    ok_stream = (accepted[:n] == ref.tokens[0, :n_ref].tolist() and n == n_ref
                 and int(out.matches) == int(ref.matches) and len(buf.getvalue()) > 0)
    stats["stream"] = dict(tokens=n, seconds=secs, tok_s=n / secs, bytes=len(buf.getvalue()))
    log(f"[entry 7b stream] stream_generate through SpeculativeTextStreamer: {n} tokens in "
        f"{secs:.3f}s ({n / secs:.2f} tok/s), {len(buf.getvalue())} bytes written; committed "
        f"== generate's {n_ref} tokens and counters: {ok_stream} -> "
        f"{'PASS' if ok_stream else 'FAIL'} ({card})")
    del gen, params, out, ref
    free_cuda()

    # the int8 loader: K4/K5 on the tensor cores
    qparams, qcfg, qtok = load_model_and_tokenizer(ENTRY_MODEL, quantize="int8", device="cuda")
    qgen = LlamaGenerator(qtok, qparams, qcfg, device="cuda")
    reset_counts()
    q = qgen.generate(prompts[1], spec)
    counts = read_counts()
    add(counts)
    kinds = ("quant_matmul_t", "quant_matmul")
    ok_quant = all(counts[f"{k}_tensor_core"] == counts[k] > 0 for k in kinds) and \
        q.num_tokens_generated > 0
    stats["int8"] = dict(tok_s=q.tokens_per_second,
                         acceptance=q.generation_strategy_result.acceptance_rate,
                         **{k: counts[k] for k in kinds})
    log(f"[entry 7b int8] load_model_and_tokenizer(quantize=int8), spec: "
        f"{q.num_tokens_generated} tokens, {q.tokens_per_second:.2f} tok/s, acceptance "
        f"{q.generation_strategy_result.acceptance_rate:.4f}; launches " + ", ".join(
            f"{k} {counts[k]} ({counts[f'{k}_tensor_core']} on the tensor cores)" for k in kinds)
        + f" -> {'PASS' if ok_quant else 'FAIL'} ({card})")
    del qgen, qparams
    free_cuda()

    ok_serve, stats["serving"], counts = entry_serving(card)
    add(counts)
    free_cuda()
    ok_line, stats["bench"] = entry_bench(card)
    ok = ok_bench and ok_gen and ok_stream and ok_quant and ok_serve and ok_line
    return ok, stats, total


def entry_serving(card):
    """``serving.build_from_args`` of ``--continuous --paged-pool-pages 9
    --page-size 128`` on port 0: two concurrent POSTs and a /healthz; each
    answer == its solo stream up to its first near tie, and K2 launched."""
    import threading
    import urllib.request

    from layerskip_tpu_torch import serving
    from layerskip_tpu_torch.cli.loading import SimpleTokenizer
    from layerskip_tpu_torch.generation.engine import postprocess_output

    args = serving.parse_args([
        "--model", ENTRY_MODEL, "--device", "cuda", "--continuous", "--paged-pool-pages", "9",
        "--page-size", "128", "--port", "0", "--max_steps", str(ENTRY_STEPS),
        "--exit_layer", str(FULL_EXIT), "--num_speculations", str(FULL_W), "--sample", "false"])
    sched, server = serving.build_from_args(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = "http://%s:%d" % server.server_address[:2]
    prompts = entry_prompts(2, 10)
    answers = [None, None]

    def post(i):
        req = urllib.request.Request(f"{url}/generate",
                                     data=json.dumps({"prompt": prompts[i]}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            answers[i] = json.load(r)

    try:
        reset_counts()
        t0 = time.perf_counter()
        posts = [threading.Thread(target=post, args=(i,)) for i in range(2)]
        for t in posts:
            t.start()
        for t in posts:
            t.join(timeout=600)
        secs = time.perf_counter() - t0
        counts = read_counts()
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            health = json.load(r)
        eng, tok = sched.engine, SimpleTokenizer(sched.engine.cfg.vocab_size)
        eos = eng.cfg.eos_token_ids
        agree = []
        for p, a in zip(prompts, answers):
            ids = tok.encode(p)
            solo = postprocess_output(eng.generate(ids, sched.gen_cfg), eos, ENTRY_STEPS)
            tie = near_tie(eng.params, eng.cfg, ids, solo)[0]
            got = a["tokens"] if a else []
            agree.append((first_diff(got, solo), min(tie, len(solo)), len(got), len(solo)))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        sched.stop()
    n_tok = sum(g for _, _, g, _ in agree)
    ok = (all(a is not None for a in answers) and health.get("ok") is True
          and all(d >= t for d, t, _, _ in agree)
          and counts["paged_decode_attention"] > 0 and not thread.is_alive())
    stats = dict(tokens=n_tok, seconds=secs, tok_s=n_tok / secs,
                 k2_launches=counts["paged_decode_attention"],
                 completed=health["stats"]["completed"], agree=agree)
    log(f"[entry 7b serving] serving main builder, continuous, pool 9 pages of 128: 2 "
        f"concurrent POSTs, {n_tok} tokens in {secs:.3f}s ({n_tok / secs:.2f} tok/s), /healthz "
        f"ok={health.get('ok')} completed={health['stats']['completed']}; (first diff, first "
        f"near tie, served, solo) {agree}; K2 launches {counts['paged_decode_attention']} -> "
        f"{'PASS' if ok else 'FAIL'} ({card})")
    del sched, server, eng
    return ok, stats, counts


def entry_bench(card):
    """``python -m layerskip_tpu_torch.bench --config 7b`` in a subprocess:
    exit 0, one JSON line with value > 0."""
    cmd = [sys.executable, "-m", "layerskip_tpu_torch.bench", "--config", "7b",
           "--repeats", "1", "--max-steps", "64", "--deadline-s", "120"]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    secs = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    try:
        line = json.loads(lines[-1]) if len(lines) == 1 else {}
    except ValueError:
        line = {}
    ok = (proc.returncode == 0 and {"metric", "value", "unit", "vs_baseline"} <= set(line)
          and line["value"] > 0)
    log(f"[entry 7b bench] {' '.join(cmd[1:])}: rc {proc.returncode} in {secs:.1f}s -> "
        f"{'PASS' if ok else 'FAIL'} ({card})")
    log(f"[entry 7b bench line] {json.dumps(line) if line else proc.stdout[-2000:]}")
    if not ok:
        log(proc.stderr[-4000:])
    return ok, line


# ------------------------------------------------------------ phase 9


class RoundCounter:
    """Counts the draft+verify rounds (linear and tree) that ``spec_generate``
    and continuous sessions run while it is entered."""

    def __enter__(self):
        from layerskip_tpu_torch.generation import continuous, spec

        self.n, self._saved = 0, []
        for mod in (spec, continuous):
            for name in ("_spec_round", "_tree_round"):
                real = getattr(mod, name)
                self._saved.append((mod, name, real))
                setattr(mod, name, self._counting(real))
        return self

    def _counting(self, real):
        def fn(*a, **kw):
            self.n += 1
            return real(*a, **kw)
        return fn

    def __exit__(self, *exc):
        for mod, name, real in self._saved:
            setattr(mod, name, real)


DRAFTING_FP32 = (  # (label, GenerationConfig fields) of phase 9's exact runs
    ("prompt lookup n2", dict(generation_strategy="prompt_lookup", num_speculations=4,
                              pld_ngram=2)),
    ("hybrid n2", dict(generation_strategy="hybrid", exit_layer=2, num_speculations=4,
                       pld_ngram=2)),
    ("adaptive tau 0.3", dict(generation_strategy="self_speculative", exit_layer=2,
                              num_speculations=4, draft_exit_prob=0.3)),
    ("adaptive tau 0.3 draft_quant 8", dict(generation_strategy="self_speculative",
                                            exit_layer=2, num_speculations=4,
                                            draft_exit_prob=0.3, draft_quant=8)),
    ("tree k2 W3", dict(generation_strategy="self_speculative", exit_layer=2,
                        num_speculations=3, spec_tree_width=2)),
    ("tree k3 W3", dict(generation_strategy="self_speculative", exit_layer=2,
                        num_speculations=3, spec_tree_width=3)),
    ("tree k2 W3 kv_quant", dict(generation_strategy="self_speculative", exit_layer=2,
                                 num_speculations=3, spec_tree_width=2, kv_quant=True)),
)


def drafting_fp32_exact():
    """Phase 9 (a): phase 4's narrow fp32 model (Dh 64: K2/K3 on the CUDA
    cores). Greedy prompt lookup, hybrid, adaptive drafting (also with an
    int8 drafter: K4/K5), tree speculation (k 2 and 3; a W 3, k 3 verify
    has 10 queries) and a tree over the int8 cache each equal greedy AR
    token for token (the kv_quant tree against the int8-cache AR), with
    equal num_tokens. Then 4-slot paged tree sessions (k 2, W 4: drafts of
    2 queries, verifies of 9), over the fp32 pool and the int8 pool, emit
    every request's solo stream exactly, with the tree clause launched in
    K2 and in K3. Counts are set to 0 before each run and read after it."""
    import dataclasses as dc

    from layerskip_tpu_torch.config import GenerationConfig
    from layerskip_tpu_torch.generation.engine import Engine, postprocess_output

    cfg, params = small_fp32_model()
    eng = Engine(params, cfg, device="cuda")
    rng = np.random.default_rng(1)
    # a prompt that repeats itself, so lookup drafts find matches
    prompt = (rng.integers(3, cfg.vocab_size, size=50).tolist() * 4)[:200]
    eos = (cfg.vocab_size + 7,)

    def run(**kw):
        reset_counts()
        out = eng.generate(prompt, GenerationConfig(max_steps=48, sample=False, **kw),
                           eos_ids=eos)
        return (postprocess_output(out, eos, 48), int(out.num_tokens[0]), int(out.matches),
                int(out.drafts), read_counts())

    ok, total = True, {}
    want = {kv: run(generation_strategy="autoregressive", kv_quant=kv)[:2]
            for kv in (False, True)}
    for label, kw in DRAFTING_FP32:
        toks, n_tok, matches, drafts, n = run(**kw)
        for k, v in n.items():
            total[k] = total.get(k, 0) + v
        same = (toks, n_tok) == want[kw.get("kv_quant", False)]
        kernels = n["flash_prefill"] == cfg.num_hidden_layers and (
            n["quant_matmul_t"] > 0 and n["quant_matmul"] > 0 if kw.get("draft_quant")
            else n["quant_matmul_t"] == n["quant_matmul"] == 0) and all(
            n[f"{k}_tensor_core"] == 0 for k in TENSOR_CORE_ROUTES)  # fp32: CUDA cores
        good = same and kernels and len(toks) == 48
        ok &= good
        log(f"[fp32 drafting] {label}: equal_to_AR={same} ({n_tok} tokens), acceptance "
            f"{matches}/{drafts}, launches flash_prefill={n['flash_prefill']} "
            f"quant_matmul_t={n['quant_matmul_t']} quant_matmul={n['quant_matmul']} -> "
            f"{'PASS' if good else 'FAIL'}")

    rng = np.random.default_rng(5)
    prompts = [rng.integers(3, cfg.vocab_size, size=n).tolist() for n in (40, 7, 60, 23, 51, 12)]
    budgets = [40, 9, 33, 48, 5, 20]
    gen = GenerationConfig(max_steps=48, sample=False, generation_strategy="self_speculative",
                           exit_layer=2, num_speculations=4, spec_tree_width=2)
    for label, kv_quant in (("fp32 pool", False), ("int8 pool", True)):
        g = dc.replace(gen, kv_quant=kv_quant)
        kernel = "paged_decode_attention_q8" if kv_quant else "paged_decode_attention"
        session = eng.continuous_session(g, batch=4, prompt_bucket=64, eos_ids=eos,
                                         paged_pool_pages=60, page_size=16)
        reset_counts()
        got = serve_session(session, prompts, budgets)
        n = read_counts()
        for k, v in n.items():
            total[k] = total.get(k, 0) + v
        solo = [postprocess_output(eng.generate(p, dc.replace(g, max_steps=m), eos_ids=eos),
                                   eos, m) for p, m in zip(prompts, budgets)]
        same = [got[i] == solo[i] for i in range(len(prompts))]
        good = all(same) and n[f"{kernel}_tree"] > 0
        ok &= good
        log(f"[fp32 drafting] paged tree session, {label}: session == solo for "
            f"{sum(same)}/{len(same)} requests ({sum(len(t) for t in got.values())} tokens), "
            f"launches {kernel}={n[kernel]} of which tree clause {n[kernel + '_tree']} -> "
            f"{'PASS' if good else 'FAIL'}")
    return ok, total


DRAFTING_7B = (  # (label, GenerationConfig fields) of phase 9's 7B batch-1 runs
    ("AR", dict(generation_strategy="autoregressive")),
    ("static spec", dict(generation_strategy="self_speculative", exit_layer=FULL_EXIT,
                         num_speculations=FULL_W)),
    ("prompt lookup n3", dict(generation_strategy="prompt_lookup", exit_layer=FULL_EXIT,
                              num_speculations=FULL_W, pld_ngram=3)),
    ("hybrid n3", dict(generation_strategy="hybrid", exit_layer=FULL_EXIT,
                       num_speculations=FULL_W, pld_ngram=3)),
    ("adaptive tau 0.5", dict(generation_strategy="self_speculative", exit_layer=FULL_EXIT,
                              num_speculations=FULL_W, draft_exit_prob=0.5)),
    ("tree k2", dict(generation_strategy="self_speculative", exit_layer=FULL_EXIT,
                     num_speculations=FULL_W, spec_tree_width=2)),
)


def drafting_full_width(card):
    """Phase 9 (b): the 7B identity-tail model in bf16 (phase 5's weights,
    built again), exit 8, W 6. Batch 1, phase 5's 200-token prompt and 128
    steps, in one call: AR, static spec, prompt lookup (n 3), hybrid,
    adaptive drafting (tau 0.5) and tree speculation (k 2), each after a
    short warm-up, with tok/s, acceptance, rounds and committed tokens a
    round (for adaptive drafting, drafts a round). Then a 4-slot paged tree
    session (k 2, pages of 128, bucket 256: drafts of 2 queries, verifies
    of 13 through K2/K3's tree clause) over the bf16 pool and over the int8
    pool, with the round ms and K2/K3's launches.

    Agreement. Tree drafts run the early layers on 2 queries, not 1, so
    their bf16 roundings differ from AR's, and the AR stream itself is not
    always the teacher-forced argmax (its largest shortfall is the bf16
    noise between the decode and prefill paths). So a near tie here is a
    top-2 gap under twice the larger of NEAR_TIE and that noise: every
    stream must equal AR (every served request its solo stream) up to its
    first such gap, and every token must fall at most that far short of the
    teacher-forced argmax given its own history. The same weights in fp32
    hold the tree exact at full width: greedy tree == AR for 64 tokens,
    and the paged tree session == solo for every request."""
    import dataclasses as dc

    from layerskip_tpu_torch.config import GenerationConfig, llama2_7b_config
    from layerskip_tpu_torch.generation.engine import Engine
    from layerskip_tpu_torch.models.params import make_random_params

    cfg = llama2_7b_config()
    params = make_random_params(cfg, exit_layer=FULL_EXIT, tail_eps=0.0, seed=0,
                                device="cuda")
    eng = Engine(params, cfg, device="cuda")
    prompt = np.random.default_rng(2).integers(3, cfg.vocab_size, size=FULL_PROMPT).tolist()
    eos = (cfg.vocab_size + 7,)
    ok, stats, total = True, {"card": card, "batch1": {}}, {}
    runs = {}
    for label, kw in DRAFTING_7B:
        g = GenerationConfig(max_steps=FULL_STEPS, sample=False, **kw)
        eng.generate(prompt, dc.replace(g, max_steps=8), eos_ids=eos)  # warm-up
        torch.cuda.synchronize()
        with RoundCounter() as rounds:
            toks, secs, matches, drafts, n = generate_timed(eng, prompt, g, eos)
        for k, v in n.items():
            total[k] = total.get(k, 0) + v
        runs[label] = toks
        st = dict(tok_s=len(toks) / secs, tokens=len(toks), seconds=secs,
                  acceptance=matches / max(drafts, 1), matches=matches, drafts=drafts,
                  rounds=rounds.n, tokens_per_round=len(toks) / max(rounds.n, 1))
        if kw.get("draft_exit_prob"):
            st["mean_draft_length"] = drafts / max(rounds.n, 1)
        stats["batch1"][label] = st
    _, ar_short = greedy_shortfall(params, cfg, prompt, runs["AR"])
    limit = 2 * max(NEAR_TIE, ar_short)
    first_tie, _, finite = near_tie(params, cfg, prompt, runs["AR"], threshold=limit)
    stats["noise_limit"] = limit
    for label, st in stats["batch1"].items():
        agree = first_diff(runs["AR"], runs[label])
        n_max, short = greedy_shortfall(params, cfg, prompt, runs[label])
        st.update(equal_to_AR_for=agree, teacher_forced_argmax=n_max, worst_shortfall=short)
        good = (finite and agree >= first_tie and short <= limit
                and st["tokens"] == FULL_STEPS)
        ok &= good
        log(f"[7b drafting] {label}: {st['tokens']} tokens in {st['seconds']:.3f}s = "
            f"{st['tok_s']:.2f} tok/s, acceptance {st['matches']}/{st['drafts']} = "
            f"{st['acceptance']:.4f}, {st['rounds']} rounds ({st['tokens_per_round']:.2f} "
            f"tokens a round"
            + (f", {st['mean_draft_length']:.2f} drafts a round" if "mean_draft_length" in st
               else "")
            + f"), == AR for the first {agree} tokens (first AR gap under {limit:.4f} at "
            f"{first_tie}), teacher-forced argmax {n_max}/{st['tokens']}, largest shortfall "
            f"{short:.4f} (limit {limit:.4f}) -> {'PASS' if good else 'FAIL'} ({card})")
    tree_kw = dict(DRAFTING_7B)["tree k2"]
    params32, cfg32 = fp32_model(params, cfg)
    ok_s, stats["session"], s_total = drafting_session_full_width(
        eng, params, cfg, params32, cfg32, tree_kw, card)
    ok &= ok_s
    for k, v in s_total.items():
        total[k] = total.get(k, 0) + v
    del eng, params
    free_cuda()
    ok_x, stats["fp32"] = drafting_fp32_full_width(params32, cfg32, prompt, tree_kw)
    ok &= ok_x
    return ok, stats, total


SESSION_LENS, SESSION_BUDGETS = (60, 200, 137, 95), (64, 48, 64, 32)


def session_prompts(cfg):
    rng = np.random.default_rng(9)
    return [rng.integers(3, cfg.vocab_size, size=n).tolist() for n in SESSION_LENS]


def run_session(eng, gen, prompts, budgets):
    """4 requests into a 4-slot paged session (pages of 128, bucket 256)
    after a one-request warm-up; (tokens per row, insert s, rounds, round
    s) with every kernel count set to 0 just before the insert and read
    into ``counts`` after the last round."""
    session = eng.continuous_session(gen, batch=SERVE_BATCH, prompt_bucket=SERVE_BUCKET,
                                     eos_ids=(eng.cfg.vocab_size + 7,), paged_pool_pages=16,
                                     page_size=SERVE_PAGE)
    session.insert([0], prompts[:1], max_tokens=[4])  # warm-up
    while session.has_active():
        session.step()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    session.insert(list(range(len(prompts))), prompts, max_tokens=list(budgets))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    got, rounds = {}, 0
    while session.has_active():
        for r, toks, _ in session.step():
            got[r] = toks
        rounds += 1
    t2 = time.perf_counter()
    return [got[r] for r in range(len(prompts))], t1 - t0, rounds, t2 - t1, read_counts()


def drafting_session_full_width(eng, params, cfg, params32, cfg32, tree_kw, card):
    import dataclasses as dc

    from layerskip_tpu_torch.config import GenerationConfig

    prompts, budgets = session_prompts(cfg), SESSION_BUDGETS
    eos = (cfg.vocab_size + 7,)
    gen = GenerationConfig(max_steps=max(budgets), sample=False, **tree_kw)
    ok, stats, total = True, {}, {}
    for label, kv_quant in (("bf16_pool", False), ("int8_pool", True)):
        g = dc.replace(gen, kv_quant=kv_quant)
        kernel = "paged_decode_attention_q8" if kv_quant else "paged_decode_attention"
        got, t_ins, rounds, t_rounds, n = run_session(eng, g, prompts, budgets)
        for k, v in n.items():
            total[k] = total.get(k, 0) + v
        solos = []
        for p, m in zip(prompts, budgets):
            out = eng.generate(p, dc.replace(g, max_steps=m), eos_ids=eos)
            solos.append(out.tokens[0, :int(out.num_tokens[0])].tolist()[:m])
        solo_short = max(greedy_shortfall(params, cfg, p, t, kv_quant)[1]
                         for p, t in zip(prompts, solos))
        limit = 2 * max(NEAR_TIE, solo_short)
        agree, worst = [], 0.0
        for p, m, toks, solo in zip(prompts, budgets, got, solos):
            tie = near_tie(params32, cfg32, p, solo, kv_quant, threshold=limit)[0]
            tie = min(tie, near_tie(params, cfg, p, solo, kv_quant, threshold=limit)[0])
            agree.append((first_diff(toks, solo), min(tie, m), len(toks) == m))
            worst = max(worst, greedy_shortfall(params, cfg, p, toks, kv_quant)[1])
        compared = sum(t for _, t, _ in agree)
        good = (all(a >= t and full for a, t, full in agree) and worst <= limit
                and n[f"{kernel}_tree"] > 0)
        ok &= good
        n_tok = sum(len(t) for t in got)
        stats[label] = dict(insert_ms=t_ins * 1e3, rounds=rounds,
                            round_ms=t_rounds / max(rounds, 1) * 1e3, tokens=n_tok,
                            tok_s=n_tok / (t_ins + t_rounds), launches=n[kernel],
                            tree_launches=n[f"{kernel}_tree"], compared_to_solo=compared,
                            worst_shortfall=worst, limit=limit)
        log(f"[7b drafting session] tree k2, {label}: {SERVE_BATCH} requests, {n_tok} tokens, "
            f"insert {stats[label]['insert_ms']:.2f} ms, {rounds} rounds at "
            f"{stats[label]['round_ms']:.2f} ms, {stats[label]['tok_s']:.2f} tok/s; launches "
            f"{kernel}={n[kernel]} of which tree clause {n[kernel + '_tree']}; equal to solo "
            f"up to (first diff, first gap under {limit:.4f} or budget) "
            f"{[(a, t) for a, t, _ in agree]}, {compared} tokens compared; largest served "
            f"shortfall {worst:.4f} (limit {limit:.4f}) -> {'PASS' if good else 'FAIL'} "
            f"({card})")
    return ok, stats, total


def drafting_fp32_full_width(params32, cfg32, prompt, tree_kw):
    """The 7B weights in fp32: greedy tree (k 2) == AR exactly for 64 tokens,
    and a paged tree session over an fp32 pool == solo for every request."""
    import dataclasses as dc

    from layerskip_tpu_torch.config import GenerationConfig
    from layerskip_tpu_torch.generation.engine import Engine

    eng = Engine(params32, cfg32, device="cuda")
    eos = (cfg32.vocab_size + 7,)

    def run(p, m, **kw):
        out = eng.generate(p, GenerationConfig(max_steps=m, sample=False, **kw), eos_ids=eos)
        return out.tokens[0, :int(out.num_tokens[0])].tolist()[:m]

    ar = run(prompt, 64, generation_strategy="autoregressive")
    tree = run(prompt, 64, **tree_kw)
    prompts, budgets = session_prompts(cfg32), SESSION_BUDGETS
    got, _, _, _, n = run_session(eng, GenerationConfig(max_steps=max(budgets), sample=False,
                                                        **tree_kw), prompts, budgets)
    same = [toks == run(p, m, **tree_kw) for p, m, toks in zip(prompts, budgets, got)]
    ok = tree == ar and len(ar) == 64 and all(same) and n["paged_decode_attention_tree"] > 0
    log(f"[7b drafting fp32] tree k2 == AR for all 64 tokens: {tree == ar} (first diff "
        f"{first_diff(ar, tree)}); paged tree session == solo for {sum(same)}/{len(same)} "
        f"requests, K2 tree-clause launches {n['paged_decode_attention_tree']} -> "
        f"{'PASS' if ok else 'FAIL'}")
    return ok, dict(tree_equal_to_ar=tree == ar, session_equal_to_solo=sum(same))


# ------------------------------------------------------------ phase 10


_GEMMA = dict(hidden_act="gelu_pytorch_tanh", rms_norm_offset=True, scale_embeddings=True,
              tie_word_embeddings=True)
FAMILIES = {  # phase 10 (a): each family's features at phase 4's narrow fp32 shape
    "qwen2": dict(attention_bias=True),
    "qwen3": dict(qk_norm=True, tie_word_embeddings=True),
    "mistral": dict(sliding_window=32),
    "gemma": dict(_GEMMA),
    # Gemma-2/3 untied: at this width a tied head makes their greedy streams
    # repeat one token (their post-normed sublayers swamp the token's own
    # embedding, or, scaled up, the tied head copies it)
    "gemma2": dict(_GEMMA, attn_logit_softcap=50.0, final_logit_softcap=30.0,
                   query_pre_attn_scalar=64.0, sliding_window=32, sliding_window_pattern=2,
                   post_norms=True, tie_word_embeddings=False),
    "gemma3": dict(_GEMMA, num_hidden_layers=6, qk_norm=True, post_norms=True,
                   query_pre_attn_scalar=64.0, sliding_window=32, sliding_window_pattern=6,
                   rope_theta=1e6, rope_local_theta=1e4, tie_word_embeddings=False),
    "phi3": dict(),  # Llama's block, loaded from the fused qkv_proj / gate_up_proj names
    "mixtral": dict(num_local_experts=4, num_experts_per_tok=2),
    "qwen3moe": dict(qk_norm=True, tie_word_embeddings=True, num_local_experts=8,
                     num_experts_per_tok=2, norm_topk_prob=False),
}


FAMILY_STEPS = 24


def family_model(name):
    """(cfg, params) of one family at phase 4's narrow fp32 shape (Dh 64),
    weights at std 0.15 (biases 0.1, routers 0.15, an untied head drawn on
    its own) so streams vary; Phi-3's come back through its fused
    checkpoint names."""
    from layerskip_tpu_torch.config import tiny_config
    from layerskip_tpu_torch.models.params import init_params, params_from_flat_dict

    cfg = tiny_config(**{**dict(num_hidden_layers=4, hidden_size=256, num_attention_heads=4,
                                num_key_value_heads=2, intermediate_size=512,
                                vocab_size=512, max_position_embeddings=1024,
                                dtype=torch.float32), **FAMILIES[name]})
    params = init_params(cfg, seed=11, device="cuda")
    layers = params.layers
    for field in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "w_router"):
        if getattr(layers, field) is not None:
            getattr(layers, field).mul_(7.5)
    gen = torch.Generator(device="cuda").manual_seed(12)
    for field in ("bq", "bk", "bv"):
        if getattr(layers, field) is not None:
            getattr(layers, field).normal_(0.0, 0.1, generator=gen)
    # Gemma scales embeddings by sqrt(D) = 16: std 0.04 keeps their RMS near
    # the other families' 0.3
    params.embed.mul_(2.0 if cfg.scale_embeddings else 15.0)
    if params.lm_head is not None:  # a head of its own, not the embedding's copy
        params.lm_head = torch.randn(params.lm_head.shape, generator=gen,
                                     device="cuda") * 0.15
    if name == "phi3":
        flat = {"model.embed_tokens.weight": params.embed, "model.norm.weight":
                params.final_norm, "lm_head.weight": params.lm_head.T}
        for i in range(cfg.num_hidden_layers):
            pre = f"model.layers.{i}."
            flat[pre + "input_layernorm.weight"] = layers.attn_norm[i]
            flat[pre + "post_attention_layernorm.weight"] = layers.mlp_norm[i]
            flat[pre + "self_attn.qkv_proj.weight"] = torch.cat(
                [layers.wq[i], layers.wk[i], layers.wv[i]])
            flat[pre + "self_attn.o_proj.weight"] = layers.wo[i].T
            flat[pre + "mlp.gate_up_proj.weight"] = torch.cat(
                [layers.w_gate[i].T, layers.w_up[i].T])
            flat[pre + "mlp.down_proj.weight"] = layers.w_down[i].T
        loaded = params_from_flat_dict(flat, cfg, device="cuda")
        assert all(same_tensor(getattr(loaded.layers, f.name), getattr(layers, f.name))
                   for f in dataclasses.fields(layers)), "phi3 fused names"
        params = loaded
    return cfg, params


def same_stream(params, cfg, prompt, toks, solo, kv_quant) -> bool:
    """A served stream against its solo one: equal, for a dense model. An
    MoE model's MLP takes another path when the batch changes (``few``
    alone, ``dense`` beside three other rows), whose fp32 sums round
    differently, so its stream is held equal up to the solo stream's first
    top-2 gap under NEAR_TIE (where such a rounding can flip the choice)."""
    if toks == solo or not cfg.is_moe:
        return toks == solo
    tie = near_tie(params, cfg, prompt, solo, kv_quant)[0]
    agree = first_diff(toks, solo)
    log(f"[family fp32]   MoE session stream == solo for {agree} tokens, first solo top-2 "
        f"gap < {NEAR_TIE} at {tie}")
    return len(toks) == len(solo) and agree >= tie


def families_fp32_exact():
    """Phase 10 (a): each family's narrow fp32 model on the card. Greedy AR
    == self-spec (exit 2, W 4) == tree (k 2, W 3) exactly for 24 tokens
    after a 100-token prompt (past the 32-token window of the windowed families, so K1's
    runtime window and K2/K3's window clause cut keys); a 4-slot paged
    session (pages of 16) == solo over the fp32 pool (K2) and the int8 pool
    (K3), for an MoE model up to the first near tie (``same_stream``); int8
    (K4/K5) and int4 (K6/K7) bases AR == spec. Every kernel the
    family reaches launched, all on the CUDA cores (fp32); the MoE paths
    taken are counted. Returns (ok, launch counts summed over the runs)."""
    import dataclasses as dc

    from layerskip_tpu_torch.config import GenerationConfig
    from layerskip_tpu_torch.generation.engine import Engine, postprocess_output
    from layerskip_tpu_torch.ops import moe
    from layerskip_tpu_torch.quant import quantize_llama_params

    ok, total = True, {}
    rng = np.random.default_rng(21)
    prompt = rng.integers(3, 512, size=100).tolist()
    prompts = [rng.integers(3, 512, size=n).tolist() for n in (90, 7, 60, 41)]
    budgets = [24, 9, 20, 16]
    eos = (512 + 7,)
    spec = dict(generation_strategy="self_speculative", exit_layer=2, num_speculations=4)
    tree = dict(generation_strategy="self_speculative", exit_layer=2, num_speculations=3,
                spec_tree_width=2)
    for name in FAMILIES:
        cfg, params = family_model(name)
        eng = Engine(params, cfg, device="cuda")
        n = {}

        def run(engine, p=prompt, m=FAMILY_STEPS, **kw):
            before = read_counts()
            out = engine.generate(p, GenerationConfig(max_steps=m, sample=False, **kw),
                                  eos_ids=eos)
            after = read_counts()
            for k in after:
                n[k] = n.get(k, 0) + after[k] - before[k]
            return postprocess_output(out, eos, m)

        reset_counts()
        moe.reset_path_calls()
        ar = run(eng, generation_strategy="autoregressive")
        good = {"spec": run(eng, **spec) == ar, "tree": run(eng, **tree) == ar}
        for label, kv_quant in (("fp32 pool", False), ("int8 pool", True)):
            g = GenerationConfig(max_steps=max(budgets), sample=False, kv_quant=kv_quant,
                                 **spec)
            session = eng.continuous_session(g, batch=4, prompt_bucket=128, eos_ids=eos,
                                             paged_pool_pages=64, page_size=16)
            before = read_counts()
            got = serve_session(session, prompts, budgets)
            after = read_counts()
            for k in after:
                n[k] = n.get(k, 0) + after[k] - before[k]
            good[label] = all(same_stream(params, cfg, p, got[i],
                                          run(eng, p, m, kv_quant=kv_quant, **spec),
                                          kv_quant)
                              for i, (p, m) in enumerate(zip(prompts, budgets)))
        for bits in (8, 4):
            qeng = Engine(quantize_llama_params(params, bits=bits), cfg, device="cuda")
            good[f"int{bits}"] = run(qeng, generation_strategy="autoregressive") == \
                run(qeng, **spec)
        reached = ["flash_prefill", "paged_decode_attention", "paged_decode_attention_q8",
                   "quant_matmul_t", "quant_matmul", "int4_matmul", "int4_matmul_t"]
        launched = all(n[k] > 0 for k in reached)
        cuda_cores = all(n[f"{k}_tensor_core"] == 0 for k in TENSOR_CORE_ROUTES)
        paths = dict(moe.PATH_CALLS)
        moe_ok = not cfg.is_moe or (paths["few"] > 0 and paths["dense"] > 0)
        family_ok = (all(good.values()) and len(ar) == FAMILY_STEPS and launched
                     and cuda_cores and moe_ok)
        ok &= family_ok
        for k, v in n.items():
            total[k] = total.get(k, 0) + v
        log(f"[family fp32] {name}: " + ", ".join(f"{k} {v}" for k, v in good.items())
            + f" (AR {len(ar)} tokens, {len(set(ar))} distinct); launches "
            + " ".join(f"{k}={n[k]}" for k in reached) + f"; CUDA cores only {cuda_cores}"
            + (f"; moe paths {paths}" if cfg.is_moe else "")
            + f" -> {'PASS' if family_ok else 'FAIL'}")
        del eng, params
    return ok, total


G2B_EXIT, G2B_TTFT = 8, ((200, "flash_prefill_g2b_t256_bf16"),
                         (6000, "flash_prefill_g2b_t6144_bf16"))
G2B_SESSION_LENS, G2B_SESSION_BUDGETS = (4200, 200, 137, 95), (48, 32, 32, 24)


def batch1_pair(eng, prompt, ar_cfg, sp_cfg, eos):
    """(AR tokens, spec tokens, stats, launch counts of both runs) after a
    short warm-up of each; counts set to 0 before each run, read after."""
    for warm in (ar_cfg, sp_cfg):
        eng.generate(prompt, dataclasses.replace(warm, max_steps=8), eos_ids=eos)
    torch.cuda.synchronize()
    ar, t_ar, _, _, n_ar = generate_timed(eng, prompt, ar_cfg, eos)
    sp, t_sp, matches, drafts, n_sp = generate_timed(eng, prompt, sp_cfg, eos)
    counts = {k: n_ar[k] + n_sp[k] for k in n_ar}
    per_tok = lambda n, toks: {k: v / max(len(toks), 1)  # noqa: E731
                               for k, v in n.items() if v and not k.endswith(("_tree",))}
    stats = dict(ar_tok_s=len(ar) / t_ar, spec_tok_s=len(sp) / t_sp,
                 speedup=(len(sp) / t_sp) / (len(ar) / t_ar),
                 acceptance=matches / max(drafts, 1), matches=matches, drafts=drafts,
                 ar_launches_per_token=per_tok(n_ar, ar),
                 spec_launches_per_token=per_tok(n_sp, sp))
    return ar, sp, stats, counts


def session_vs_solo(eng, params, cfg, gen, prompts, budgets, bucket, pool_pages, kv_quant,
                    floor=NEAR_TIE, min_compared=2):
    """A 4-slot paged session (pages of 128) over ``prompts``: (ok, stats,
    launch counts), each request == its solo stream up to its first top-2
    gap under twice the larger of ``floor`` and the solo streams' own
    shortfall (or its budget), with at least ``min_compared`` tokens so
    compared in each request, and every served token within that of the
    teacher-forced argmax."""
    session = eng.continuous_session(gen, batch=4, prompt_bucket=bucket,
                                     eos_ids=(cfg.vocab_size + 7,),
                                     paged_pool_pages=pool_pages, page_size=128)
    reset_counts()
    t0 = time.perf_counter()
    session.insert(list(range(len(prompts))), prompts, max_tokens=list(budgets))
    got, rounds = {}, 0
    while session.has_active():
        for r, toks, _ in session.step():
            got[r] = toks
        rounds += 1
    secs = time.perf_counter() - t0
    n = read_counts()
    got = [got[r] for r in range(len(prompts))]
    eos = (cfg.vocab_size + 7,)
    solos = []
    for p, m in zip(prompts, budgets):
        out = eng.generate(p, dataclasses.replace(gen, max_steps=m), eos_ids=eos)
        solos.append(out.tokens[0, :int(out.num_tokens[0])].tolist()[:m])
    solo_short = max(greedy_shortfall(params, cfg, p, t, kv_quant)[1]
                     for p, t in zip(prompts, solos))
    limit = 2 * max(floor, solo_short)
    agree, worst = [], 0.0
    for p, m, toks, solo in zip(prompts, budgets, got, solos):
        tie = near_tie(params, cfg, p, solo, kv_quant, threshold=limit)[0]
        agree.append((first_diff(toks, solo), min(tie, m), len(toks) == m))
        worst = max(worst, greedy_shortfall(params, cfg, p, toks, kv_quant)[1])
    kernel = "paged_decode_attention_q8" if kv_quant else "paged_decode_attention"
    ok = (all(a >= t >= min_compared and full for a, t, full in agree) and worst <= limit
          and n[kernel] > 0)
    n_tok = sum(len(t) for t in got)
    stats = dict(tokens=n_tok, seconds=secs, tok_s=n_tok / secs, rounds=rounds,
                 launches=n[kernel], agree=[(a, t) for a, t, _ in agree], limit=limit,
                 worst_shortfall=worst, solo_shortfall=solo_short)
    return ok, stats, n


def gemma2_2b_full_width(card, kres):
    """Phase 10 (b): Gemma-2-2B at full width in bf16, from the loader
    (``random:gemma2-2b?tail_eps=0&tail_from=8``), exit 8, W 6: AR and spec
    at batch 1 (phase 5's 200-token prompt, 128 steps; tok/s, acceptance,
    launches per token; spec == AR up to the first near tie, and the same
    weights in fp32 spec == AR exactly for 48 tokens); the time to first
    token of a 200- and a 6000-token prompt (past the 4096 window: K1 skips
    whole key tiles in the 13 sliding layers); the int8 base (K4/K5 at K
    2304); a 4-slot paged session over the bf16 and the int8 pool with one
    request of 4200 prompt tokens, longer than the window (K2/K3 at Dh 256
    under the window clause)."""
    from layerskip_tpu_torch.cli.loading import load_model_and_tokenizer
    from layerskip_tpu_torch.config import GenerationConfig
    from layerskip_tpu_torch.generation.engine import Engine
    from layerskip_tpu_torch.quant import quantize_llama_params

    t0 = time.time()
    params, cfg, _ = load_model_and_tokenizer(
        f"random:gemma2-2b?tail_eps=0&tail_from={G2B_EXIT}", device="cuda")
    torch.cuda.synchronize()
    log(f"[gemma2-2b] random weights built in {time.time() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    eng = Engine(params, cfg, device="cuda")
    prompt = np.random.default_rng(2).integers(3, cfg.vocab_size, size=FULL_PROMPT).tolist()
    eos = (cfg.vocab_size + 7,)
    ar_cfg = GenerationConfig(max_steps=FULL_STEPS, sample=False,
                              generation_strategy="autoregressive")
    sp_cfg = GenerationConfig(max_steps=FULL_STEPS, sample=False,
                              generation_strategy="self_speculative",
                              exit_layer=G2B_EXIT, num_speculations=FULL_W)
    ar, sp, stats, counts = batch1_pair(eng, prompt, ar_cfg, sp_cfg, eos)
    tie, tf_agree, finite = near_tie(params, cfg, prompt, ar)
    agree = first_diff(ar, sp)
    ok = (finite and agree >= tie and len(ar) == len(sp) == FULL_STEPS
          and stats["acceptance"] >= 0.9
          and counts["flash_prefill"] == counts["flash_prefill_tensor_core"]
          == 2 * cfg.num_hidden_layers)
    stats.update(spec_eq_ar=agree, first_tie=tie, card=card)
    log(f"[gemma2-2b] AR {stats['ar_tok_s']:.2f} tok/s, spec exit={G2B_EXIT} W={FULL_W} "
        f"{stats['spec_tok_s']:.2f} tok/s ({stats['speedup']:.3f}x), acceptance "
        f"{stats['matches']}/{stats['drafts']} = {stats['acceptance']:.4f}; spec == AR for "
        f"{agree} (first top-2 gap < {NEAR_TIE} at {tie}, teacher-forced == AR for "
        f"{tf_agree}); launches per token AR {stats['ar_launches_per_token']} spec "
        f"{stats['spec_launches_per_token']} -> {'PASS' if ok else 'FAIL'} ({card})")

    # time to first token: generate(max_steps=1) after a warm-up of the same prompt
    rng = np.random.default_rng(4)
    gen1 = dataclasses.replace(ar_cfg, max_steps=1)
    stats["ttft"] = {}
    for n_tok, case in G2B_TTFT:
        p = rng.integers(3, cfg.vocab_size, size=n_tok).tolist()
        eng.generate(p, gen1, eos_ids=eos)
        torch.cuda.synchronize()
        toks, secs, _, _, n = generate_timed(eng, p, gen1, eos)
        for k, v in n.items():
            counts[k] += v
        # the 13 sliding layers run phase 3's windowed case, the 13 global the other
        k1_ms = (cfg.num_hidden_layers // 2) * (kres[case]["ms"]
                                                + kres[case.replace("_bf16", "_win_bf16")]["ms"])
        stats["ttft"][n_tok] = dict(ms=secs * 1e3, k1_launches=n["flash_prefill"],
                                    k1_device_ms=k1_ms)
        ok &= len(toks) == 1 and n["flash_prefill"] == cfg.num_hidden_layers
        log(f"[gemma2-2b ttft] {n_tok}-token prompt: {secs * 1e3:.2f} ms, K1 "
            f"{n['flash_prefill']} launches = {k1_ms:.3f} ms at phase 3's times ({case}, "
            f"half windowed) ({card})")

    params32, cfg32 = fp32_model(params, cfg)
    eng32 = Engine(params32, cfg32, device="cuda")
    ar32 = generate_timed(eng32, prompt, dataclasses.replace(ar_cfg, max_steps=48), eos)[0]
    sp32 = generate_timed(eng32, prompt, dataclasses.replace(sp_cfg, max_steps=48), eos)[0]
    good32 = ar32 == sp32 and len(ar32) == 48
    ok &= good32
    stats["fp32_spec_eq_ar"] = first_diff(ar32, sp32)
    log(f"[gemma2-2b fp32] spec == AR for all 48 tokens: {good32} (first diff "
        f"{first_diff(ar32, sp32)}) -> {'PASS' if good32 else 'FAIL'}")
    del eng32, params32
    free_cuda()

    qparams = quantize_llama_params(params, bits=8)
    qeng = Engine(qparams, cfg, device="cuda")
    qar, qsp, qstats, qn = batch1_pair(qeng, prompt, ar_cfg, sp_cfg, eos)
    for k, v in qn.items():
        counts[k] += v
    qtie, _, qfinite = near_tie(qparams, cfg, prompt, qar)
    qagree = first_diff(qar, qsp)
    nl = cfg.num_hidden_layers
    good = (qfinite and qagree >= qtie and qstats["acceptance"] >= 0.9
            and qn["quant_matmul_t"] > 0 and qn["quant_matmul"] > 0
            and qn["quant_matmul_t_tensor_core"] == qn["quant_matmul_t"]
            and qn["quant_matmul_tensor_core"] == qn["quant_matmul"])
    ok &= good
    stats["int8_base"] = dict(qstats, spec_eq_ar=qagree, first_tie=qtie)
    log(f"[gemma2-2b int8_base] AR {qstats['ar_tok_s']:.2f} tok/s, spec "
        f"{qstats['spec_tok_s']:.2f} tok/s, acceptance {qstats['acceptance']:.4f}; spec == "
        f"AR for {qagree} (first gap < {NEAR_TIE} at {qtie}); K4 {qn['quant_matmul_t']} "
        f"K5 {qn['quant_matmul']} launches ({3 * nl} and {4 * nl} a layer pass) -> "
        f"{'PASS' if good else 'FAIL'} ({card})")
    del qeng, qparams
    free_cuda()

    rng = np.random.default_rng(9)
    prompts = [rng.integers(3, cfg.vocab_size, size=n).tolist() for n in G2B_SESSION_LENS]
    gen = dataclasses.replace(sp_cfg, max_steps=max(G2B_SESSION_BUDGETS))
    stats["session"] = {}
    for label, kv_quant in (("bf16_pool", False), ("int8_pool", True)):
        good, st, n = session_vs_solo(eng, params, cfg, dataclasses.replace(
            gen, kv_quant=kv_quant), prompts, G2B_SESSION_BUDGETS, 4224, 144, kv_quant)
        for k, v in n.items():
            counts[k] += v
        ok &= good
        stats["session"][label] = st
        log(f"[gemma2-2b session] {label}: 4 requests (prompts {G2B_SESSION_LENS}), "
            f"{st['tokens']} tokens in {st['seconds']:.3f}s = {st['tok_s']:.2f} tok/s, "
            f"{st['rounds']} rounds, K2/K3 launches {st['launches']}; == solo up to (first "
            f"diff, first gap under {st['limit']:.4f} or budget) {st['agree']}, largest "
            f"shortfall {st['worst_shortfall']:.4f} -> {'PASS' if good else 'FAIL'} ({card})")
    del eng, params
    free_cuda()
    return ok, stats, counts


MOE_EXIT = 4


def moe_3b_full_width(card, kres):
    """Phase 10 (c): moe-3b (Mixtral architecture, 8 experts, top 2) at full
    width in bf16 from ``random:moe-3b?tail_eps=0&tail_from=4``, exit 4, W
    6: AR and spec at batch 1 (tok/s, acceptance, launches per token, spec
    == AR up to the first near tie) with the ``moe_mlp`` path of each call
    counted (few in the decode and draft steps, dense in the verify windows
    and the 200-token prefill; the same weights in fp32 spec == AR exactly
    for 48 tokens), the time to first token of a 2000-token prompt (bucket
    2048: the grouped path), and a 4-slot paged session (bf16 pool): on the
    fp32 copy == solo up to the first gap under FP32_TIE (at least two
    tokens compared a request), in bf16 timed, each token within the bf16
    noise of the teacher-forced argmax."""
    from layerskip_tpu_torch.cli.loading import load_model_and_tokenizer
    from layerskip_tpu_torch.config import GenerationConfig
    from layerskip_tpu_torch.generation.engine import Engine
    from layerskip_tpu_torch.ops import moe

    t0 = time.time()
    params, cfg, _ = load_model_and_tokenizer(
        f"random:moe-3b?tail_eps=0&tail_from={MOE_EXIT}", device="cuda")
    torch.cuda.synchronize()
    log(f"[moe-3b] random weights built in {time.time() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    eng = Engine(params, cfg, device="cuda")
    prompt = np.random.default_rng(2).integers(3, cfg.vocab_size, size=FULL_PROMPT).tolist()
    eos = (cfg.vocab_size + 7,)
    ar_cfg = GenerationConfig(max_steps=FULL_STEPS, sample=False,
                              generation_strategy="autoregressive")
    sp_cfg = GenerationConfig(max_steps=FULL_STEPS, sample=False,
                              generation_strategy="self_speculative",
                              exit_layer=MOE_EXIT, num_speculations=FULL_W)
    for warm in (ar_cfg, sp_cfg):
        eng.generate(prompt, dataclasses.replace(warm, max_steps=8), eos_ids=eos)
    torch.cuda.synchronize()
    paths = {}
    moe.reset_path_calls()
    ar, t_ar, _, _, n_ar = generate_timed(eng, prompt, ar_cfg, eos)
    paths["ar"] = dict(moe.PATH_CALLS)
    moe.reset_path_calls()
    sp, t_sp, matches, drafts, n_sp = generate_timed(eng, prompt, sp_cfg, eos)
    paths["spec"] = dict(moe.PATH_CALLS)
    counts = {k: n_ar[k] + n_sp[k] for k in n_ar}
    nl = cfg.num_hidden_layers
    stats = dict(ar_tok_s=len(ar) / t_ar, spec_tok_s=len(sp) / t_sp,
                 speedup=t_ar / t_sp * len(sp) / len(ar), acceptance=matches / max(drafts, 1),
                 matches=matches, drafts=drafts, paths=paths, card=card,
                 ar_launches_per_token={k: v / len(ar) for k, v in n_ar.items() if v},
                 spec_launches_per_token={k: v / len(sp) for k, v in n_sp.items() if v})
    tie, tf_agree, finite = near_tie(params, cfg, prompt, ar)
    agree = first_diff(ar, sp)
    # AR: one dense prefill per layer, then a few-path step per layer and token;
    # spec: drafts take few, verify windows (7 tokens, 14 assignments) dense
    ok = (finite and agree >= tie and len(ar) == len(sp) == FULL_STEPS
          and stats["acceptance"] >= 0.9 and paths["ar"]["dense"] == nl
          and paths["ar"]["few"] == nl * (FULL_STEPS - 1) and paths["spec"]["few"] > 0
          and paths["spec"]["dense"] > nl and counts["flash_prefill"] == 2 * nl)
    stats.update(spec_eq_ar=agree, first_tie=tie)
    log(f"[moe-3b] AR {stats['ar_tok_s']:.2f} tok/s, spec exit={MOE_EXIT} W={FULL_W} "
        f"{stats['spec_tok_s']:.2f} tok/s ({stats['speedup']:.3f}x), acceptance "
        f"{matches}/{drafts} = {stats['acceptance']:.4f}; spec == AR for {agree} (first "
        f"top-2 gap < {NEAR_TIE} at {tie}, teacher-forced == AR for {tf_agree}); moe_mlp "
        f"paths {paths}; launches per token AR {stats['ar_launches_per_token']} spec "
        f"{stats['spec_launches_per_token']} -> {'PASS' if ok else 'FAIL'} ({card})")

    p = np.random.default_rng(4).integers(3, cfg.vocab_size, size=2000).tolist()
    gen1 = dataclasses.replace(ar_cfg, max_steps=1)
    eng.generate(p, gen1, eos_ids=eos)
    torch.cuda.synchronize()
    moe.reset_path_calls()
    toks, secs, _, _, n = generate_timed(eng, p, gen1, eos)
    grouped = dict(moe.PATH_CALLS)
    for k, v in n.items():
        counts[k] += v
    good = len(toks) == 1 and grouped["grouped"] == nl and n["flash_prefill"] == nl
    ok &= good
    k1_ms = nl * kres["flash_prefill_moe3b_long_bf16"]["ms"]
    stats["ttft_2000"] = dict(ms=secs * 1e3, paths=grouped, k1_device_ms=k1_ms)
    log(f"[moe-3b ttft] 2000-token prompt (bucket 2048): {secs * 1e3:.2f} ms, K1 "
        f"{n['flash_prefill']} launches = {k1_ms:.3f} ms at phase 3's time "
        f"(flash_prefill_moe3b_long_bf16), moe_mlp paths {grouped} (want grouped {nl}) -> "
        f"{'PASS' if good else 'FAIL'} ({card})")

    params32, cfg32 = fp32_model(params, cfg)
    eng32 = Engine(params32, cfg32, device="cuda")
    ar32 = generate_timed(eng32, prompt, dataclasses.replace(ar_cfg, max_steps=48), eos)[0]
    sp32 = generate_timed(eng32, prompt, dataclasses.replace(sp_cfg, max_steps=48), eos)[0]
    good32 = ar32 == sp32 and len(ar32) == 48
    ok &= good32
    stats["fp32_spec_eq_ar"] = first_diff(ar32, sp32)
    log(f"[moe-3b fp32] spec == AR for all 48 tokens: {good32} (first diff "
        f"{first_diff(ar32, sp32)}) -> {'PASS' if good32 else 'FAIL'}")

    # the session == solo is held on the fp32 copy, where only fp32
    # rounding near ties may part them: in bf16 a served row's MoE path
    # differs from its solo run's and this random model's near ties come
    # within a token or two. The bf16 session is timed, and each of its
    # tokens held to the bf16 noise of the teacher-forced argmax.
    prompts = session_prompts(cfg)
    gen = dataclasses.replace(sp_cfg, max_steps=max(SESSION_BUDGETS))
    good, st32, counts32 = session_vs_solo(eng32, params32, cfg32, gen, prompts,
                                           SESSION_BUDGETS, 256, 16, False, floor=FP32_TIE)
    del eng32, params32
    free_cuda()
    good_bf16, st, n = session_vs_solo(eng, params, cfg, gen, prompts, SESSION_BUDGETS, 256,
                                       16, False, min_compared=0)
    for k, v in n.items():
        counts[k] += v
    ok &= good and good_bf16
    stats.update(session_fp32=st32, session=st)
    for label, st_, good_ in (("fp32", st32, good), ("bf16", st, good_bf16)):
        log(f"[moe-3b session] {label}: 4 requests, {st_['tokens']} tokens in "
            f"{st_['seconds']:.3f}s = {st_['tok_s']:.2f} tok/s, {st_['rounds']} rounds, K2 "
            f"launches {st_['launches']}; == solo up to (first diff, first top-2 gap under "
            f"{st_['limit']:.4g} or budget) {st_['agree']}"
            f"{', at least 2 a request' if label == 'fp32' else ' (not required)'}; "
            f"largest shortfall of a served token {st_['worst_shortfall']:.4g} (limit "
            f"{st_['limit']:.4g}; of the solo streams {st_['solo_shortfall']:.4g}) -> "
            f"{'PASS' if good_ else 'FAIL'} ({card})")
    del eng, params
    free_cuda()
    return ok, stats, counts, counts32


# ------------------------------------------------------------ phase 11


TRAIN_LOSS_RTOL = 1e-5  # card == CPU and chunked == dense, fp32 losses
TRAIN_GRAD_TOL = dict(atol=2e-5, rtol=2e-3)  # the JAX suite's chunked-CE bound


def kernels_idle(label, counts) -> bool:
    """No K1-K7 launch in a training run: none of them has a backward."""
    launched = {k: v for k, v in counts.items() if v}
    log(f"[{label} launches] K1-K7 during training: {launched or 'none'}")
    return not launched


def params_on(params, device, grad: bool = True):
    """A copy of ``params`` on ``device``; with ``grad`` its weights are
    leaves that require grad."""
    from layerskip_tpu_torch.training.recipe import trainable_tensors

    def leaf(w):
        return None if w is None else w.detach().to(device).clone().requires_grad_(grad)

    layers = dataclasses.replace(params.layers, **{
        f.name: leaf(getattr(params.layers, f.name)) for f in dataclasses.fields(params.layers)})
    out = dataclasses.replace(params, embed=leaf(params.embed), layers=layers,
                              final_norm=leaf(params.final_norm), lm_head=leaf(params.lm_head))
    if grad:
        trainable_tensors(out)  # dense weights only
    return out


def grad_gap(got, want) -> float:
    """The largest |got - want| over ``atol + rtol * |want|`` of two
    gradient dicts (<= 1 within TRAIN_GRAD_TOL)."""
    tol = TRAIN_GRAD_TOL
    return max(float(((got[k].float().cpu() - want[k].float().cpu()).abs()
                      / (tol["atol"] + tol["rtol"] * want[k].float().cpu().abs())).max())
               for k in want)


def training_fp32_card_vs_cpu():
    """Phase 11 (a): phase 4's Llama and phase 10 (a)'s Gemma-2 and
    Mixtral-style MoE (L 4, D 256, fp32), one ``layerskip_loss`` and its
    backward on the card and on the CPU on the same weights and batch (B 2,
    T 64, exits 1-3, label smoothing 0.1, a 48-token chunked CE over 128
    tokens, an explicit keep mask that drops samples): losses within
    TRAIN_LOSS_RTOL, every gradient within TRAIN_GRAD_TOL; and on the card
    the chunked CE == the dense one within the same bounds."""
    from layerskip_tpu_torch.training import recipe

    ok, b, t = True, 2, 64
    reset_counts()
    for name in ("llama", "gemma2", "mixtral"):
        cfg, params = small_fp32_model() if name == "llama" else family_model(name)
        nl = cfg.num_hidden_layers
        rng = np.random.default_rng(21)
        ids = rng.integers(0, cfg.vocab_size, size=(b, t))
        labels = np.concatenate([ids[:, 1:], np.full((b, 1), -100)], axis=1)
        labels[0, :5] = -100
        keep = rng.random((nl, b)) >= 0.3
        keep[nl - 1, 0] = False  # at least one sample skips a layer
        tcfg = recipe.TrainConfig(p_max=0.3, early_exit_layers=(1, 2, 3), e_scale=0.5,
                                  label_smoothing=0.1, ce_chunk_tokens=48)
        runs = {}
        for label, dev, chunk in (("card", "cuda", 48), ("cpu", "cpu", 48),
                                  ("card dense", "cuda", 0)):
            p = params_on(params, dev)
            loss, aux = recipe.layerskip_loss(
                p, cfg, dataclasses.replace(tcfg, ce_chunk_tokens=chunk),
                torch.from_numpy(ids), torch.from_numpy(labels),
                keep=torch.from_numpy(keep).to(dev))
            loss.backward()
            runs[label] = ({k: v.detach().cpu() for k, v in aux.items()},
                           {k: w.grad for k, w in recipe.trainable_tensors(p).items()})
        for other in ("cpu", "card dense"):
            (aux, grads), (ref, ref_grads) = runs["card"], runs[other]
            rel = max(float(((aux[k] - ref[k]).abs() / ref[k].abs().clamp(min=1e-30)).max())
                      for k in ("loss", "final_loss", "exit_losses"))
            gap = grad_gap(grads, ref_grads)
            good = (rel <= TRAIN_LOSS_RTOL and gap <= 1.0
                    and bool(torch.isfinite(aux["loss"])))
            ok &= good
            log(f"[train fp32] {name}: card (chunked) vs {other}: loss {float(aux['loss']):.6f} "
                f"vs {float(ref['loss']):.6f}, largest loss rel diff {rel:.3g} (limit "
                f"{TRAIN_LOSS_RTOL}), gradients at {gap:.3g} of atol 2e-5 + rtol 2e-3, moe_aux "
                f"{float(aux['moe_aux']):.4f} -> {'PASS' if good else 'FAIL'}")
        del params
    ok &= kernels_idle("train fp32", read_counts())
    free_cuda()
    return ok


TRAIN_1B = dict(steps=10, batch_size=4, seq_len=1024, save_every=5)
TRAIN_EXITS = 3  # default_exit_layers(16) = (4, 8, 12)
H100_BF16_PEAK = PEAK_FLOP_PER_S[torch.bfloat16]


def train_model_flops(cfg, b, t, exits) -> float:
    """Model FLOPs of one training step (forward and backward, 3 x the
    forward's 2 flops a multiply-add): 6 * tokens * (the layers' matmul
    weights + the head once for the final CE and once per exit) plus
    PaLM's attention term 12 * L * tokens * T * Hq * Dh (full T x T
    scores, as the training layer computes them)."""
    d, f, hq, hkv, dh = (cfg.hidden_size, cfg.intermediate_size, cfg.num_attention_heads,
                         cfg.num_key_value_heads, cfg.head_dim)
    layer = d * (hq + 2 * hkv) * dh + hq * dh * d + 3 * d * f
    weights = cfg.num_hidden_layers * layer + (1 + exits) * d * cfg.vocab_size
    tokens = b * t
    return 6.0 * tokens * weights + 12.0 * cfg.num_hidden_layers * tokens * t * hq * dh


def step_ms_from_log(out: str, tokens_per_step: int):
    """Per-step wall ms from the CLI's ``step i/n loss=... (R tok/s)`` lines
    (one a step with ``log_every`` 1): R is tokens since the start over
    seconds since the start, so line i gives the elapsed seconds; the
    differences from step 2 on are the steps' times (step 1 carries the
    first call's set-up)."""
    rows = [(int(m.group(1)), float(m.group(2)), int(m.group(3))) for m in re.finditer(
        r"^step (\d+)/\d+ loss=([-\d.naif]+) \((\d+) tok/s\)$", out, re.M)]
    elapsed = [i * tokens_per_step / rate for i, _, rate in rows]
    return rows, [1e3 * (b - a) for a, b in zip(elapsed, elapsed[1:])]


def llama_1b_training(card, tmp):
    """Phase 11 (b): Llama-3.2-1B at full width and depth in bf16
    (``random:1b``) trained through ``cli.train.main`` for 10 steps at B 4
    x 1024 tokens over a ``custom_jsonl`` corpus (default exits 4/8/12,
    p_max 0.1, a 1024-token chunked CE, a checkpoint every 5 steps, an
    export at the end): finite losses, both checkpoints, median step ms,
    tokens/s, peak memory and MFU against the card's bf16 dense peak; one
    loss and backward on the trained weights with the chunked and with the
    dense CE for their peak memory; then the export loaded back (bit-equal
    to the trained weights) and greedy AR against self-spec (exit 4, W 6),
    equal up to the first near tie."""
    import contextlib

    from layerskip_tpu_torch.cli import train
    from layerskip_tpu_torch.cli.args import Arguments
    from layerskip_tpu_torch.cli.loading import load_model_and_tokenizer
    from layerskip_tpu_torch.config import GenerationConfig, llama32_1b_config
    from layerskip_tpu_torch.generation.engine import Engine
    from layerskip_tpu_torch.training import recipe

    b, t = TRAIN_1B["batch_size"], TRAIN_1B["seq_len"]
    corpus = write_jsonl(os.path.join(tmp, "train.jsonl"), entry_prompts(64, seed=31))
    ckpt, export = os.path.join(tmp, "ckpt"), os.path.join(tmp, "export")
    targs = train.TrainArguments(dataset="custom_jsonl", data_path=corpus, p_max=0.1,
                                 ce_chunk_tokens=1024, checkpoint_dir=ckpt, export_dir=export,
                                 log_every=1, **TRAIN_1B)
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        params, opt, history = train.run(Arguments(model="random:1b", device="cuda", seed=0),
                                         targs)
    torch.cuda.synchronize()
    wall = time.time() - t0
    peak_run = torch.cuda.max_memory_allocated()
    resident = p13_resident(params, opt)  # phase 13 (b)'s single-device reference
    del opt
    ok = kernels_idle("train 1b", read_counts())
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"[train 1b cli] {line}")
    rows, step_ms = step_ms_from_log(out, b * t)
    cfg = llama32_1b_config()
    flops = train_model_flops(cfg, b, t, TRAIN_EXITS)
    med = float(np.median(step_ms)) if step_ms else float("nan")
    losses = [loss for _, loss in history]
    good = (len(rows) == len(history) == TRAIN_1B["steps"] and all(np.isfinite(losses))
            and train.checkpoint_steps(ckpt) == [5, 10]
            and os.path.exists(os.path.join(export, "model.safetensors")))
    ok &= good
    stats = dict(step_ms_median=med, step_ms=step_ms, tok_s=b * t / med * 1e3,
                 mfu=flops / (med * 1e-3) / H100_BF16_PEAK, model_tflop_per_step=flops / 1e12,
                 peak_gb_run=peak_run / 1e9, losses=losses, cli_wall_s=wall, card=card,
                 resident=resident)
    log(f"[train 1b] random:1b bf16 (L 16, D 2048, F 8192, V 128256, tied), B {b} x T {t}, "
        f"exits (4, 8, 12), p_max 0.1, CE chunk 1024: {len(rows)} steps, losses "
        f"{[round(x, 4) for x in losses]}; step ms median {med:.2f} (steps 2-10 "
        f"{[round(x, 2) for x in step_ms]}), {stats['tok_s']:.1f} tok/s, model FLOPs "
        f"(6 tokens (L layer weights + 4 D V) + 12 L tokens T Hq Dh) {flops / 1e12:.2f} "
        f"TFLOP a step = MFU {stats['mfu']:.4f} of {H100_BF16_PEAK / 1e12:.0f} TFLOP/s; peak memory over the CLI run (optimizer, checkpoints, export) "
        f"{peak_run / 1e9:.2f} GB; checkpoints {train.checkpoint_steps(ckpt)}; CLI wall "
        f"{wall:.1f}s -> {'PASS' if good else 'FAIL'} ({card})")

    # peak memory of one loss and backward, chunked against dense CE
    rng = np.random.default_rng(32)
    ids = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(b, t))).cuda()
    labels = torch.roll(ids, -1, dims=1)
    peaks, ms = {}, {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for chunk in (1024, 0):
        for w in recipe.trainable_tensors(params).values():
            w.grad = None
        free_cuda()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts()
        t1 = time.perf_counter()
        loss, _ = recipe.layerskip_loss(params, cfg, recipe.TrainConfig(ce_chunk_tokens=chunk),
                                        ids, labels, gen)
        loss.backward()
        torch.cuda.synchronize()
        ms[chunk] = (time.perf_counter() - t1) * 1e3
        peaks[chunk] = (torch.cuda.max_memory_allocated() - base) / 1e9
        ok &= kernels_idle(f"train 1b ce {chunk}", read_counts()) and bool(torch.isfinite(loss))
    good = peaks[1024] < peaks[0]
    ok &= good
    stats.update(peak_gb_above_weights_chunked=peaks[1024], peak_gb_above_weights_dense=peaks[0],
                 loss_backward_ms_chunked=ms[1024], loss_backward_ms_dense=ms[0])
    log(f"[train 1b ce] one loss + backward on the trained weights, peak memory above the "
        f"weights ({base / 1e9:.2f} GB): chunked CE (1024 tokens) {peaks[1024]:.2f} GB in "
        f"{ms[1024]:.1f} ms, dense CE {peaks[0]:.2f} GB in {ms[0]:.1f} ms -> "
        f"{'PASS' if good else 'FAIL'} ({card})")

    trained = {k: w.detach() for k, w in recipe.trainable_tensors(params).items()}
    del params, loss
    free_cuda()
    loaded, cfg2, _ = load_model_and_tokenizer(export, device="cuda")
    same = all(torch.equal(w, trained[k]) for k, w in recipe.trainable_tensors(loaded).items())
    del trained
    free_cuda()
    eng = Engine(loaded, cfg2, device="cuda")
    prompt = np.random.default_rng(33).integers(3, cfg2.vocab_size, size=64).tolist()
    eos = (cfg2.vocab_size + 7,)
    ar_cfg = GenerationConfig(max_steps=32, sample=False, generation_strategy="autoregressive")
    sp_cfg = GenerationConfig(max_steps=32, sample=False, generation_strategy="self_speculative",
                              exit_layer=4, num_speculations=6)
    ar, t_ar, _, _, _ = generate_timed(eng, prompt, ar_cfg, eos)
    sp, t_sp, matches, drafts, _ = generate_timed(eng, prompt, sp_cfg, eos)
    tie, tf_agree, finite = near_tie(loaded, cfg2, prompt, ar)
    agree = first_diff(ar, sp)
    good = same and finite and len(ar) == len(sp) == 32 and agree >= tie
    ok &= good
    stats.update(export_bit_equal=same, spec_eq_ar=agree, first_tie=tie)
    log(f"[train 1b export] loaded back bit-equal to the trained weights: {same}; greedy AR "
        f"vs spec (exit 4, W 6) over 32 tokens: == for {agree} (first top-2 gap < {NEAR_TIE} "
        f"at {tie}, teacher-forced == AR for {tf_agree}), acceptance {matches}/{drafts} -> "
        f"{'PASS' if good else 'FAIL'} ({card})")
    del eng, loaded
    free_cuda()
    return ok, stats


def moe_3b_training(card):
    """Phase 11 (c): moe-3b (``random:moe-3b``) at full width in bf16, 3
    ``train_step``s at B 2 x 1024 tokens (2048 tokens: every MoE layer on
    the grouped path) with the recipe's defaults (exits 4/8/12, p_max 0.1,
    CE chunk 1024): finite losses, a positive load-balancing term, router
    weights changed, step ms, tokens/s and peak memory."""
    from layerskip_tpu_torch.cli.loading import load_model_and_tokenizer
    from layerskip_tpu_torch.ops import moe
    from layerskip_tpu_torch.training import recipe

    b, t, steps = 2, 1024, 3
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    params, cfg, _ = load_model_and_tokenizer("random:moe-3b", device="cuda")
    router0 = params.layers.w_router.detach().clone()
    train_step, init_opt = recipe.make_train_step(cfg, recipe.TrainConfig())
    opt = init_opt(params)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(41)
    reset_counts()
    moe.reset_path_calls()
    step_ms, auxes = [], []
    for step in range(steps):
        ids = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(b, t))).cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, aux = train_step(params, opt, ids, torch.roll(ids, -1, dims=1), gen, step)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        auxes.append({k: float(aux[k]) for k in ("loss", "final_loss", "moe_aux")})
    peak = torch.cuda.max_memory_allocated()
    ok = kernels_idle("train moe-3b", read_counts())
    paths = dict(moe.PATH_CALLS)
    changed = not torch.equal(router0, params.layers.w_router.detach())
    nl = cfg.num_hidden_layers
    good = (all(np.isfinite(a["loss"]) and np.isfinite(a["moe_aux"]) and a["moe_aux"] > 0
                for a in auxes)
            and changed and paths == {"few": 0, "dense": 0, "grouped": steps * nl})
    ok &= good
    med = float(np.median(step_ms[1:]))
    stats = dict(step_ms=step_ms, step_ms_median=med, tok_s=b * t / med * 1e3,
                 peak_gb=peak / 1e9, aux=auxes, paths=paths, card=card)
    log(f"[train moe-3b] random:moe-3b bf16 (L 16, D 2048, 8 experts top 2, V 32000), B {b} x "
        f"T {t}, 3 steps: {auxes}; moe_mlp paths {paths} (want grouped {steps * nl}); router "
        f"changed: {changed}; step ms {[round(x, 2) for x in step_ms]} (median of steps 2-3 "
        f"{med:.2f}, {stats['tok_s']:.1f} tok/s); peak memory {peak / 1e9:.2f} GB -> "
        f"{'PASS' if good else 'FAIL'} ({card})")
    del params, opt, router0
    free_cuda()
    return ok, stats


# ------------------------------------------------------------ phase 12

# Phase 12 runs its ranks as processes of this script (``--phase12 SUITE
# DIR``) started by the port's launcher: on one card they share it over
# gloo, whose collectives cross the host. Each rank writes its results to
# DIR/rank<r>.json; the main process compares them.

P12_STEPS = 48  # phase 4's fp32 streams
P12_SPEC = dict(generation_strategy="self_speculative", exit_layer=2, num_speculations=4)
P12_STREAMS = (  # (label, GenerationConfig fields) of (a)'s tp 2 streams
    ("ar", dict(generation_strategy="autoregressive")), ("spec", P12_SPEC),
    ("tree3", dict(P12_SPEC, spec_tree_width=3)), ("draft8", dict(P12_SPEC, draft_quant=8)),
    ("draft4", dict(P12_SPEC, draft_quant=4)))
P12_LONG, P12_LONG_STEPS = 2000, 32  # (b)'s sp 2 prompt and steps
P12_TP_STEPS = 64  # (b)'s tp 2 steps: half of phase 5's, for the script's time
P12_MOE_STEPS = 64
SEVEN_B = "random:7b?tail_eps=0&tail_from=8"
MOE_3B = f"random:moe-3b?tail_eps=0&tail_from={MOE_EXIT}"
# every kernel must launch on every rank of (a)'s two-rank run
P12_KERNELS = ("flash_prefill", "paged_decode_attention_tree", "paged_decode_attention_q8",
               "quant_matmul_t", "quant_matmul", "int4_matmul", "int4_matmul_t")


def p12_tokens(eng, prompt, eos, max_steps, **kw):
    from layerskip_tpu_torch.config import GenerationConfig

    out = eng.generate(prompt, GenerationConfig(max_steps=max_steps, sample=False, **kw),
                       eos_ids=eos)
    return out.tokens[0, :int(out.num_tokens[0])].tolist()[:max_steps]


def p12_session(eng, gen, prompts, budgets, chunked, **kw):
    """{request: tokens} of a 2-slot session: requests 0 and 1 (1 through a
    chunked insert when asked), then 2 and 3 into the same slots."""
    eos = (eng.cfg.vocab_size + 7,)
    sess = eng.continuous_session(gen, batch=2, prompt_bucket=64, eos_ids=eos, **kw)
    got = {}
    for wave in (0, 2):
        if chunked:
            sess.insert([0], [prompts[wave]], max_tokens=[budgets[wave]])
            sess.begin_chunked_insert([1], [prompts[wave + 1]], max_tokens=[budgets[wave + 1]],
                                      chunk_tokens=16)
        else:
            sess.insert([0, 1], prompts[wave:wave + 2], max_tokens=budgets[wave:wave + 2])
        while sess.has_active() or sess.has_pending_prefill():
            for r, toks, _ in sess.step(max_rounds=2):
                got[wave + r] = toks
    return got


P12_SESSIONS = (  # (label, GenerationConfig fields, continuous_session keywords, chunked)
    ("paged tree prefix, fp32 pool (K2)", dict(P12_SPEC, spec_tree_width=2),
     dict(paged_pool_pages=40, page_size=16, prefix_cache=True), False),
    ("paged tree prefix, int8 pool (K3)", dict(P12_SPEC, spec_tree_width=2, kv_quant=True),
     dict(paged_pool_pages=40, page_size=16, prefix_cache=True), False),
    ("chunked insert, contiguous", P12_SPEC, {}, True),
)


def p12_fp32_w2(rank):
    """(a) on two ranks: phase 4's model at tp 2 (AR, spec, tree k 3, the
    int8 and int4 drafters, three sessions) and at sp 2 (AR, spec), each
    == the same rank's single-device run; kernel launches of the sharded
    runs."""
    import dataclasses as dc

    from layerskip_tpu_torch.config import GenerationConfig
    from layerskip_tpu_torch.generation.engine import Engine, postprocess_output
    from layerskip_tpu_torch.parallel.mesh import make_mesh, make_sp_mesh
    from layerskip_tpu_torch.parallel.sharding import shard_params

    cfg, params = small_fp32_model()
    prompt = np.random.default_rng(1).integers(3, cfg.vocab_size, size=200).tolist()
    eos = (cfg.vocab_size + 7,)
    solo = Engine(params, cfg, device="cuda")
    want = {label: p12_tokens(solo, prompt, eos, P12_STEPS, **kw) for label, kw in P12_STREAMS}
    rng = np.random.default_rng(6)
    shared = rng.integers(3, cfg.vocab_size, size=32).tolist()  # two pages of 16
    prompts = [shared + rng.integers(3, cfg.vocab_size, size=n).tolist() for n in (9, 20)] + [
        shared + rng.integers(3, cfg.vocab_size, size=14).tolist(),
        rng.integers(3, cfg.vocab_size, size=40).tolist()]
    budgets = [30, 17, 24, 30]
    solo_served = {label: [postprocess_output(solo.generate(p, GenerationConfig(
        max_steps=m, sample=False, **g), eos_ids=eos), eos, m) for p, m in zip(prompts, budgets)]
        for label, g, _, _ in P12_SESSIONS}

    mesh = make_mesh(1, 2)
    local, _ = shard_params(params, mesh, cfg)
    eng = Engine(local, cfg, device="cuda", mesh=mesh)
    reset_counts()
    t0 = time.perf_counter()
    got = {label: p12_tokens(eng, prompt, eos, P12_STEPS, **kw) for label, kw in P12_STREAMS}
    served = {label: p12_session(eng, dc.replace(GenerationConfig(max_steps=max(budgets),
                                                                  sample=False), **g),
                                 prompts, budgets, chunked, **kw)
              for label, g, kw, chunked in P12_SESSIONS}
    tp_secs = time.perf_counter() - t0
    counts = read_counts()
    sp = make_sp_mesh(2)
    speng = Engine(params, cfg, device="cuda", mesh=sp, kv_shard_axis="sp")
    reset_counts()
    sp_got = {label: p12_tokens(speng, prompt, eos, P12_STEPS, **kw)
              for label, kw in P12_STREAMS[:2]}
    sp_counts = read_counts()
    return dict(want=want, got=got, sp_got=sp_got, tp_secs=tp_secs, counts=counts,
                sp_counts=sp_counts, served={k: [v[i] for i in range(4)] for k, v in served.items()},
                solo_served=solo_served)


def p12_fp32_w4(rank):
    """(a) on four ranks: a dp 2 x tp 2 forward over B 2, AR at sp 2 x tp 2
    and phase 10 (a)'s Mixtral-style MoE at ep 2 x tp 2 (AR, spec)."""
    from layerskip_tpu_torch.generation.engine import Engine
    from layerskip_tpu_torch.models import llama
    from layerskip_tpu_torch.ops.kv_cache import init_kv_cache
    from layerskip_tpu_torch.parallel.collectives import all_gather, sharded
    from layerskip_tpu_torch.parallel.mesh import make_mesh, make_sp_mesh
    from layerskip_tpu_torch.parallel.sharding import shard_params

    cfg, params = small_fp32_model()
    ids = torch.from_numpy(np.random.default_rng(3).integers(3, cfg.vocab_size, size=(2, 64)))
    ids = ids.cuda()
    with torch.inference_mode():
        want = llama.forward(params, cfg, ids, init_kv_cache(cfg, 2, 64, device="cuda"),
                             0).logits
        mesh = make_mesh(2, 2)
        local, ctx = shard_params(params, mesh, cfg)
        with sharded(ctx):
            row = ids[ctx.dp.rank:ctx.dp.rank + 1]
            got = all_gather(llama.forward(local, cfg, row, init_kv_cache(cfg, 1, 64,
                                                                          device="cuda"),
                                           0).logits, ctx.dp, 0)
    fwd = dict(max_abs_err=float((got - want).abs().max()),
               argmax_equal=bool(torch.equal(got.argmax(-1), want.argmax(-1))))
    prompt = np.random.default_rng(1).integers(3, cfg.vocab_size, size=200).tolist()
    eos = (cfg.vocab_size + 7,)
    sptp = make_sp_mesh(2, 2)
    local, _ = shard_params(params, sptp, cfg, kv_shard_axis="sp")
    reset_counts()
    sptp_ar = p12_tokens(Engine(local, cfg, device="cuda", mesh=sptp, kv_shard_axis="sp"),
                         prompt, eos, P12_STEPS)
    counts = read_counts()
    sptp_want = p12_tokens(Engine(params, cfg, device="cuda"), prompt, eos, P12_STEPS)
    mcfg, mparams = family_model("mixtral")
    msolo = Engine(mparams, mcfg, device="cuda")
    moe_want = {label: p12_tokens(msolo, prompt, eos, FAMILY_STEPS, **kw)
                for label, kw in P12_STREAMS[:2]}
    eptp = make_mesh(1, 2, ep=2)
    mlocal, _ = shard_params(mparams, eptp, mcfg)
    meng = Engine(mlocal, mcfg, device="cuda", mesh=eptp)
    reset_counts()
    moe_got = {label: p12_tokens(meng, prompt, eos, FAMILY_STEPS, **kw)
               for label, kw in P12_STREAMS[:2]}
    moe_counts = read_counts()
    return dict(forward=fwd, sptp_ar=sptp_ar, sptp_want=sptp_want, counts=counts,
                moe_got=moe_got, moe_want=moe_want, moe_counts=moe_counts,
                moe_shapes=[list(mlocal.layers.w_gate.shape), list(mlocal.layers.w_down.shape)])


def p12_timed(eng, prompt, eos, max_steps, **kw):
    """(tokens, tok/s, launches) of one run, counts from 0, after a warm-up."""
    from layerskip_tpu_torch.config import GenerationConfig

    eng.generate(prompt, GenerationConfig(max_steps=4, sample=False, **kw), eos_ids=eos)
    torch.cuda.synchronize()
    toks, secs, matches, drafts, counts = generate_timed(
        eng, prompt, GenerationConfig(max_steps=max_steps, sample=False, **kw), eos)
    return dict(tokens=toks, tok_s=len(toks) / secs, matches=matches, drafts=drafts,
                counts=counts)


def p12_7b_tp2(rank):
    """(b) 7B (``random:7b?tail_eps=0&tail_from=8``) at tp 2 through the
    loader: AR and spec (exit 8, W 6), phase 5's prompt, P12_TP_STEPS
    steps."""
    from layerskip_tpu_torch.cli.loading import load_model_and_tokenizer, mesh_for
    from layerskip_tpu_torch.generation.engine import Engine

    torch.cuda.reset_peak_memory_stats()
    params, cfg, _ = load_model_and_tokenizer(SEVEN_B, tp=2, device="cuda")
    eng = Engine(params, cfg, device="cuda", mesh=mesh_for(1, 2))
    prompt = np.random.default_rng(2).integers(3, cfg.vocab_size, size=FULL_PROMPT).tolist()
    eos = (cfg.vocab_size + 7,)
    out = dict(ar=p12_timed(eng, prompt, eos, P12_TP_STEPS),
               spec=p12_timed(eng, prompt, eos, P12_TP_STEPS, generation_strategy=
                              "self_speculative", exit_layer=FULL_EXIT,
                              num_speculations=FULL_W),
               wq_rows=int(params.layers.wq.shape[1]), wo_k=int(params.layers.wo.shape[1]))
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def p12_bf16_w2(rank):
    """(b) on two ranks: 7B at tp 2, 7B at sp 2 (a 2000-token prompt, AR)
    and moe-3b at ep 2 (AR, spec; exit 4, W 6)."""
    from layerskip_tpu_torch.cli.loading import load_model_and_tokenizer
    from layerskip_tpu_torch.generation.engine import Engine
    from layerskip_tpu_torch.parallel.mesh import make_mesh, make_sp_mesh
    from layerskip_tpu_torch.parallel.sharding import shard_params

    res = dict(tp=p12_7b_tp2(rank))
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    params, cfg, _ = load_model_and_tokenizer(SEVEN_B, device="cuda")
    eng = Engine(params, cfg, device="cuda", mesh=make_sp_mesh(2), kv_shard_axis="sp")
    long = np.random.default_rng(4).integers(3, cfg.vocab_size, size=P12_LONG).tolist()
    res["sp"] = p12_timed(eng, long, (cfg.vocab_size + 7,), P12_LONG_STEPS)
    res["sp"]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del eng, params
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    params, cfg, _ = load_model_and_tokenizer(MOE_3B, device="cuda")
    mesh = make_mesh(1, 1, ep=2)
    local, _ = shard_params(params, mesh, cfg)
    del params
    free_cuda()
    eng = Engine(local, cfg, device="cuda", mesh=mesh)
    prompt = np.random.default_rng(2).integers(3, cfg.vocab_size, size=FULL_PROMPT).tolist()
    eos = (cfg.vocab_size + 7,)
    res["moe"] = dict(ar=p12_timed(eng, prompt, eos, P12_MOE_STEPS),
                      spec=p12_timed(eng, prompt, eos, P12_MOE_STEPS, generation_strategy=
                                     "self_speculative", exit_layer=MOE_EXIT,
                                     num_speculations=FULL_W),
                      experts=int(local.layers.w_gate.shape[1]))
    res["moe"]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return res


def p12_nccl1(rank):
    """(c) a world-size-1 NCCL group: the collectives on it, then phase 4's
    model on the tp 1 path with every layer's collectives issued over it."""
    import torch.distributed as dist

    from layerskip_tpu_torch.generation.engine import Engine
    from layerskip_tpu_torch.parallel import collectives as coll

    world = coll.Axis(group=dist.group.WORLD, size=1, rank=0)
    x = torch.arange(8, dtype=torch.float32, device="cuda")
    checks = dict(
        sum=bool(torch.equal(coll.all_reduce(x, world), x)),
        max=bool(torch.equal(coll.all_reduce(x, world, "max"), x)),
        gather=bool(torch.equal(coll.all_gather(x[None], world, 0), x[None])),
        backend=dist.get_backend())
    cfg, params = small_fp32_model()
    prompt = np.random.default_rng(1).integers(3, cfg.vocab_size, size=200).tolist()
    eos = (cfg.vocab_size + 7,)
    want = p12_tokens(Engine(params, cfg, device="cuda"), prompt, eos, P12_STEPS, **P12_SPEC)
    eng = Engine(params, cfg, device="cuda")
    eng.shard = coll.ShardContext(tp=world)  # the tp 1 path, collectives issued
    coll.reset_calls()
    got = p12_tokens(eng, prompt, eos, P12_STEPS, **P12_SPEC)
    return dict(checks=checks, equal=got == want, calls=dict(coll.CALLS))


P12_SUITES = {"fp32_w2": p12_fp32_w2, "fp32_w4": p12_fp32_w4, "bf16_w2": p12_bf16_w2,
              "7b_tp2": p12_7b_tp2, "nccl1": p12_nccl1}


def phase12_rank(suite: str, work: str) -> int:
    """A rank of a phase 12 suite (under the port's launcher)."""
    sys.path.insert(0, REPO)
    import torch.distributed as dist

    from layerskip_tpu_torch.parallel.distributed import BACKEND_ENV, INIT_ENV, setup, teardown

    backend = os.environ[BACKEND_ENV]
    if int(os.environ["WORLD_SIZE"]) == 1:  # setup joins no group for a world of one
        dist.init_process_group(backend, init_method=os.environ[INIT_ENV], world_size=1,
                                rank=0)
    setup(backend)
    rank = dist.get_rank()
    res = P12_SUITES[suite](rank)
    res.update(rank=rank, backend=dist.get_backend(), device=torch.cuda.current_device())
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    teardown()
    return 0


def phase12_launch(suite: str, nproc: int, backend: str = "gloo"):
    """Every rank's results of ``suite`` over ``nproc`` ranks of the port's
    launcher; a failing rank fails the phase (its traceback on stderr)."""
    from layerskip_tpu_torch.parallel.launch import launch

    with tempfile.TemporaryDirectory() as work:
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
        t0 = time.time()
        rc = launch([os.path.abspath(__file__), "--phase12", suite, work], nproc, backend,
                    env=env, timeout=600)
        log(f"[phase 12] {suite}: {nproc} ranks over {backend}, exit code {rc}, "
            f"{time.time() - t0:.1f}s")
        if rc != 0:
            raise RuntimeError(f"phase 12 suite {suite} failed with exit code {rc}")
        return [json.load(open(os.path.join(work, f"rank{r}.json"))) for r in range(nproc)]


def phase12_fp32():
    """(a): every sharded stream == the single-process stream exactly, the
    dp x tp forward's argmax == the single device's, and K1, K2 (tree
    clause), K3 and K4-K7 launched on each rank of the two-rank run."""
    ok, total = True, {}
    w2 = phase12_launch("fp32_w2", 2)
    for r in w2:
        same = {k: r["got"][k] == r["want"][k] for k in r["want"]}
        sp_same = {k: r["sp_got"][k] == r["want"][k] for k in r["sp_got"]}
        served = {k: r["served"][k] == r["solo_served"][k] for k in r["served"]}
        launched = {k: r["counts"][k] for k in P12_KERNELS}
        good = (all(same.values()) and all(sp_same.values()) and all(served.values())
                and all(v > 0 for v in launched.values())
                and r["sp_counts"]["flash_prefill"] == 0)
        ok &= good
        for k, v in r["counts"].items():
            total[k] = total.get(k, 0) + v + r["sp_counts"][k]
        log(f"[phase 12 (a)] rank {r['rank']} tp 2: == single process {same}; sessions == "
            f"solo {served}; sp 2: {sp_same} (K1 launches under sp "
            f"{r['sp_counts']['flash_prefill']}, want 0); launches {json.dumps(launched)} "
            f"(each > 0) -> {'PASS' if good else 'FAIL'}")
    w4 = phase12_launch("fp32_w4", 4)
    for r in w4:
        good = (r["forward"]["argmax_equal"] and r["forward"]["max_abs_err"] < 1e-3
                and r["sptp_ar"] == r["sptp_want"] and r["moe_got"] == r["moe_want"]
                and r["moe_shapes"] == [[4, 2, 256, 256], [4, 2, 256, 256]])
        ok &= good
        for counts in (r["counts"], r["moe_counts"]):
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
        log(f"[phase 12 (a)] rank {r['rank']} dp 2 x tp 2 forward: max abs err "
            f"{r['forward']['max_abs_err']:.3g}, argmax equal {r['forward']['argmax_equal']}; "
            f"sp 2 x tp 2 AR == single process {r['sptp_ar'] == r['sptp_want']}; MoE ep 2 x "
            f"tp 2 (local w_gate {r['moe_shapes'][0]}) AR/spec == single process "
            f"{r['moe_got'] == r['moe_want']} -> {'PASS' if good else 'FAIL'}")
    return ok, total


def phase12_full_width(card):
    """(b): the single-device references in this process, then the ranks;
    each sharded stream == its reference up to the reference's first near
    tie (top-2 gap under NEAR_TIE on the teacher-forced fp32 logits)."""
    from layerskip_tpu_torch.cli.loading import load_model_and_tokenizer
    from layerskip_tpu_torch.generation.engine import Engine

    refs = {}
    params, cfg, _ = load_model_and_tokenizer(SEVEN_B, device="cuda")
    eng = Engine(params, cfg, device="cuda")
    eos = (cfg.vocab_size + 7,)
    prompt = np.random.default_rng(2).integers(3, cfg.vocab_size, size=FULL_PROMPT).tolist()
    spec = dict(generation_strategy="self_speculative", exit_layer=FULL_EXIT,
                num_speculations=FULL_W)
    ar = p12_tokens(eng, prompt, eos, P12_TP_STEPS)
    refs["tp"] = dict(ar=ar, spec=p12_tokens(eng, prompt, eos, P12_TP_STEPS, **spec),
                      tie=near_tie(params, cfg, prompt, ar)[0])
    long = np.random.default_rng(4).integers(3, cfg.vocab_size, size=P12_LONG).tolist()
    ar = p12_tokens(eng, long, eos, P12_LONG_STEPS)
    refs["sp"] = dict(ar=ar, tie=near_tie(params, cfg, long, ar)[0])
    del eng, params
    free_cuda()
    params, cfg, _ = load_model_and_tokenizer(MOE_3B, device="cuda")
    eng = Engine(params, cfg, device="cuda")
    ar = p12_tokens(eng, prompt, eos, P12_MOE_STEPS)
    refs["moe"] = dict(ar=ar, spec=p12_tokens(eng, prompt, eos, P12_MOE_STEPS,
                                              **dict(spec, exit_layer=MOE_EXIT)),
                       tie=near_tie(params, cfg, prompt, ar)[0])
    del eng, params
    free_cuda()

    ok, total = True, {}
    ranks = phase12_launch("bf16_w2", 2)
    for r in ranks:
        tp, sp, moe_ = r["tp"], r["sp"], r["moe"]
        agree = dict(
            tp_ar=first_diff(tp["ar"]["tokens"], refs["tp"]["ar"]),
            tp_spec=first_diff(tp["spec"]["tokens"], refs["tp"]["spec"]),
            sp_ar=first_diff(sp["tokens"], refs["sp"]["ar"]),
            moe_ar=first_diff(moe_["ar"]["tokens"], refs["moe"]["ar"]),
            moe_spec=first_diff(moe_["spec"]["tokens"], refs["moe"]["spec"]))
        tie = dict(tp_ar=refs["tp"]["tie"], tp_spec=refs["tp"]["tie"], sp_ar=refs["sp"]["tie"],
                   moe_ar=refs["moe"]["tie"], moe_spec=refs["moe"]["tie"])
        good = (all(agree[k] >= tie[k] for k in agree)
                and len(tp["ar"]["tokens"]) == len(tp["spec"]["tokens"]) == P12_TP_STEPS
                and len(sp["tokens"]) == P12_LONG_STEPS
                and tp["wq_rows"] == 2048 and tp["wo_k"] == 2048 and moe_["experts"] == 4
                and tp["ar"]["counts"]["flash_prefill"] == 32
                and sp["counts"]["flash_prefill"] == 0)
        ok &= good
        for run in (tp["ar"], tp["spec"], sp, moe_["ar"], moe_["spec"]):
            for k, v in run["counts"].items():
                total[k] = total.get(k, 0) + v
        log(f"[phase 12 (b)] rank {r['rank']} ({r['backend']}, card {r['device']}): 7B tp 2 "
            f"(local wq rows {tp['wq_rows']}, wo K {tp['wo_k']}) AR {tp['ar']['tok_s']:.2f} "
            f"tok/s, spec {tp['spec']['tok_s']:.2f} tok/s (acceptance "
            f"{tp['spec']['matches']}/{tp['spec']['drafts']}), peak {tp['peak_gb']:.2f} GB, "
            f"launches AR {json.dumps({k: v for k, v in tp['ar']['counts'].items() if v})} "
            f"spec {json.dumps({k: v for k, v in tp['spec']['counts'].items() if v})}; 7B sp 2 "
            f"{P12_LONG}-token prompt AR {sp['tok_s']:.2f} tok/s, peak {sp['peak_gb']:.2f} GB; "
            f"moe-3b ep 2 ({moe_['experts']} experts a rank) AR {moe_['ar']['tok_s']:.2f} "
            f"tok/s, spec {moe_['spec']['tok_s']:.2f} tok/s, peak {moe_['peak_gb']:.2f} GB; "
            f"== single device for {json.dumps(agree)} tokens (first near tie at "
            f"{json.dumps(tie)}) -> {'PASS' if good else 'FAIL'} ({card}; both ranks share "
            f"this one card and their collectives cross the host over gloo: these times "
            f"are not a speed of tensor, sequence or expert parallelism)")
    return ok, total, refs


def phase12_nccl(card, refs):
    """(c): the NCCL world-size-1 leg; with two cards or more also 7B at tp 2
    over NCCL, one rank a card."""
    (r,) = phase12_launch("nccl1", 1, backend="nccl")
    ok = (r["equal"] and all(v is True for k, v in r["checks"].items() if k != "backend")
          and r["checks"]["backend"] == "nccl" and r["calls"]["all_reduce"] > 0
          and r["calls"]["all_gather"] > 0)
    log(f"[phase 12 (c)] NCCL world of 1: collectives {json.dumps(r['checks'])}, phase 4's "
        f"spec stream on the tp 1 path with its collectives issued ({json.dumps(r['calls'])}) "
        f"== plain: {r['equal']} -> {'PASS' if ok else 'FAIL'}")
    total = {}
    if torch.cuda.device_count() < 2:
        log(f"[phase 12 (c)] 7B tp 2 over NCCL, one rank a card: not run, this machine has "
            f"{torch.cuda.device_count()} card ({card}); multi-rank NCCL stays unverified here")
        return ok, total
    for r in phase12_launch("7b_tp2", 2, backend="nccl"):
        agree = (first_diff(r["ar"]["tokens"], refs["tp"]["ar"]),
                 first_diff(r["spec"]["tokens"], refs["tp"]["spec"]))
        good = min(agree) >= refs["tp"]["tie"] and r["device"] == r["rank"]
        ok &= good
        for run in (r["ar"], r["spec"]):
            for k, v in run["counts"].items():
                total[k] = total.get(k, 0) + v
        log(f"[phase 12 (c)] rank {r['rank']} on card {r['device']} over NCCL: 7B tp 2 AR "
            f"{r['ar']['tok_s']:.2f} tok/s, spec {r['spec']['tok_s']:.2f} tok/s, == single "
            f"device for (AR, spec) {agree} tokens (first near tie {refs['tp']['tie']}) -> "
            f"{'PASS' if good else 'FAIL'} ({card})")
    return ok, total


# ------------------------------------------------------------ phase 13

# Phase 13 runs its ranks as processes of this script (``--phase13 SUITE
# DIR``), as phase 12 does: on one card they share it over gloo, and every
# collective (a layer's broadcast from its fsdp owner, the K/V gathers, the
# gradient sums) crosses the host. Each rank writes DIR/rank<r>.pt.

P13_B, P13_T, P13_V = 4, 16, 128  # (a): rows split over dp, the sequence over fsdp
P13_TCFG = dict(p_max=0.3, early_exit_layers=(1, 2, 3), e_scale=0.5, rotational_r=2,
                label_smoothing=0.1, ce_chunk_tokens=16)
P13_ADAM = dict(learning_rate=1e-3, weight_decay=0.1)
P13_ADAM_TOL = dict(atol=2e-6, rtol=1e-5)  # tests/test_torch_train_mesh.py's
P13_LEGS = {  # leg -> (family, dp, fsdp, tp, ring): __graft_entry__'s meshes, one launch
    "fsdp2_tp2": ("qwen2", 1, 2, 2, False), "dp2_fsdp2": ("qwen2", 2, 2, 1, False),
    "dp2_fsdp2_ring": ("qwen2", 2, 2, 1, True), "moe_fsdp2_tp2": ("mixtral", 1, 2, 2, False)}
P13_1B_STEPS = 3  # (b): steps of random:1b at fsdp 2, phase 11 (b)'s batch
P13_RING_B, P13_RING_T, P13_RING_STEPS = 1, 8192, 1  # (c)
TRAIN_1B_WEIGHTS = 1_235_814_400  # random:1b's trainable weights (tied head)
TRAIN_1B_EMBED = 128_256 * 2048
# the share of the single device's weights, gradients and AdamW state a
# rank holds at fsdp N: the 16 layers split, the tied embedding and the
# final norm whole (0.606 at fsdp 2)
def p13_share(fsdp: int) -> float:
    return ((TRAIN_1B_WEIGHTS - TRAIN_1B_EMBED - 2048) / fsdp + TRAIN_1B_EMBED + 2048) \
        / TRAIN_1B_WEIGHTS


def p13_model(family):
    """(cfg, params) of (a): the CPU tests' width (tests/test_torch_train_mesh.py:
    L 4, D 64, 4 heads over 2 kv heads, F 96, V 128, untied head), fp32,
    every weight normal(0, 0.15) (norms 1 + that, the embedding twice
    that), drawn from a seeded generator on the card, so every rank
    builds the same weights."""
    from layerskip_tpu_torch.config import tiny_config
    from layerskip_tpu_torch.models.params import init_params
    from layerskip_tpu_torch.training.recipe import trainable_tensors

    cfg = tiny_config(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
                      intermediate_size=96, vocab_size=P13_V, dtype=torch.float32,
                      **FAMILIES.get(family, {}))
    params = init_params(cfg, seed=13, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(14)
    with torch.no_grad():
        for name, w in trainable_tensors(params).items():
            w.normal_(0.0, 0.15, generator=gen)
            if "norm" in name:
                w.add_(1.0)
        params.embed.mul_(2.0)
    return cfg, params


def p13_inputs(nl):
    """(ids, labels, keep masks of the gradient step and of two AdamW steps):
    -100 labels at the start of row 0 and at every row's end."""
    rng = np.random.default_rng(51)
    ids = rng.integers(0, P13_V, size=(P13_B, P13_T))
    labels = np.concatenate([ids[:, 1:], np.full((P13_B, 1), -100)], axis=1)
    labels[0, :5] = -100
    keeps = [rng.random((nl, P13_B)) >= 0.3 for _ in range(3)]
    for k in keeps:
        k[nl - 1, 0] = False  # a sample skips a layer
    return ids, labels, keeps


def p13_part(x, ctx):
    """This rank's rows (dp) and positions (fsdp) of a global [B, T] batch."""
    b, t = x.shape
    if ctx is not None and ctx.dp is not None:
        x = x[ctx.dp.rank * b // ctx.dp.size:(ctx.dp.rank + 1) * b // ctx.dp.size]
    if ctx is not None and ctx.fsdp is not None:
        x = x[:, ctx.fsdp.rank * t // ctx.fsdp.size:(ctx.fsdp.rank + 1) * t // ctx.fsdp.size]
    return torch.from_numpy(np.ascontiguousarray(x)).cuda()


def p13_run(family, mesh=None, ring=False):
    """One leg on the card: loss, aux and whole gradients of a step at
    step 1, then two AdamW steps (their losses, the gradients before each
    and the whole params after). ``mesh`` None: the single device."""
    from layerskip_tpu_torch.parallel.collectives import sharded
    from layerskip_tpu_torch.parallel.sharding import gather_params, shard_params
    from layerskip_tpu_torch.training import recipe

    def named(p, grads=False):
        return {k: (w.grad if grads else w).detach().cpu().clone()
                for k, w in recipe.trainable_tensors(p).items()}

    def whole(p, grads=False):
        if ctx is None:
            return named(p, grads)
        with sharded(ctx):
            return named(gather_params(grads_view(p) if grads else p, ctx))

    def grads_view(p):
        g = lambda w: None if w is None else w.grad  # noqa: E731
        return dataclasses.replace(p, embed=g(p.embed), final_norm=g(p.final_norm),
                                   lm_head=g(p.lm_head), layers=dataclasses.replace(
                                       p.layers, **{f.name: g(getattr(p.layers, f.name))
                                                    for f in dataclasses.fields(p.layers)}))

    cfg, params = p13_model(family)
    ids, labels, keeps = p13_inputs(cfg.num_hidden_layers)
    local, ctx = shard_params(params, mesh, cfg)
    act = dict(act_spec=recipe.ACT_SPEC, ring_axis="fsdp" if ring else None) if mesh else {}
    for w in recipe.trainable_tensors(local).values():
        w.requires_grad_(True)
    tcfg = recipe.TrainConfig(**P13_TCFG, **act)
    with sharded(ctx):
        _, aux = recipe.loss_and_grads(local, cfg, tcfg, p13_part(ids, ctx),
                                       p13_part(labels, ctx), step=1,
                                       keep=torch.from_numpy(keeps[0]).cuda())
    out = dict(aux={k: v.cpu() for k, v in aux.items()}, grads=whole(local, grads=True),
               losses=[], step_grads=[], after=[])
    cfg, params = p13_model(family)
    local, _ = shard_params(params, mesh, cfg)
    step_fn, init_opt = recipe.make_train_step(
        cfg, recipe.TrainConfig(**P13_TCFG, **P13_ADAM, **act), mesh)
    opt = init_opt(local)
    for step in range(2):
        local, opt, saux = step_fn(local, opt, p13_part(ids, ctx), p13_part(labels, ctx),
                                   step=step, keep=torch.from_numpy(keeps[1 + step]).cuda())
        out["losses"].append(float(saux["loss"]))
        out["step_grads"].append(whole(local, grads=True))
        out["after"].append(whole(local))
    del local, params, opt
    free_cuda()
    return out


def p13_fp32(work):
    """A rank of (a): every leg on its mesh."""
    from layerskip_tpu_torch.parallel.mesh import make_train_mesh

    res = {}
    for leg, (family, dp, fsdp, tp, ring) in P13_LEGS.items():
        reset_counts()
        res[leg] = p13_run(family, make_train_mesh(dp, fsdp, tp), ring)
        res[leg]["counts"] = read_counts()
    return res


def p13_resident(params, opt) -> dict:
    """Bytes this process holds of the weights, their gradients and the
    AdamW state (both moments and the step counts)."""
    from layerskip_tpu_torch.training import recipe

    ws = list(recipe.trainable_tensors(params).values())
    size = lambda t: t.numel() * t.element_size()  # noqa: E731
    return dict(params=sum(size(w) for w in ws),
                grads=sum(size(w.grad) for w in ws if w.grad is not None),
                adamw=sum(size(v) for st in opt.state.values() for v in st.values()
                          if torch.is_tensor(v)))


def p13_1b_fsdp(work):
    """A rank of (b) and (d): ``random:1b`` through ``cli.train.run`` at
    --fsdp N (N: the world), phase 11 (b)'s corpus and batch,
    ``P13_1B_STEPS`` steps."""
    import contextlib

    import torch.distributed as dist

    from layerskip_tpu_torch.cli import train
    from layerskip_tpu_torch.cli.args import Arguments

    targs = train.TrainArguments(dataset="custom_jsonl",
                                 data_path=os.path.join(work, "train.jsonl"),
                                 steps=P13_1B_STEPS, batch_size=TRAIN_1B["batch_size"],
                                 seq_len=TRAIN_1B["seq_len"], p_max=0.1, ce_chunk_tokens=1024,
                                 log_every=1, fsdp=dist.get_world_size())
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        params, opt, history = train.run(Arguments(model="random:1b", device="cuda", seed=0),
                                         targs)
    torch.cuda.synchronize()
    wall = time.time() - t0
    _, step_ms = step_ms_from_log(buf.getvalue(), targs.batch_size * targs.seq_len)
    res = dict(history=history, log=buf.getvalue(), step_ms=step_ms, wall_s=wall,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               resident=p13_resident(params, opt), counts=read_counts(),
               layers=int(params.layers.wq.shape[0]))
    del params, opt
    free_cuda()
    return res


def p13_1b_ring(work):
    """A rank of (c) and (d): ``random:1b`` at fsdp N (N: the world) with
    ring attention over fsdp, B 1 x 8192 tokens, ``P13_RING_STEPS``
    steps."""
    from layerskip_tpu_torch.cli.loading import load_model_and_tokenizer
    from layerskip_tpu_torch.parallel import collectives
    from layerskip_tpu_torch.parallel.mesh import make_train_mesh
    from layerskip_tpu_torch.parallel.sharding import shard_params
    from layerskip_tpu_torch.training import recipe

    import torch.distributed as dist

    mesh = make_train_mesh(1, dist.get_world_size(), 1)
    params, cfg, _ = load_model_and_tokenizer("random:1b", device="cuda")
    local, ctx = shard_params(params, mesh, cfg)
    del params
    free_cuda()
    tcfg = recipe.TrainConfig(act_spec=recipe.ACT_SPEC, ring_axis="fsdp")
    step_fn, init_opt = recipe.make_train_step(cfg, tcfg, mesh)
    opt = init_opt(local)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(61)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    collectives.reset_calls()
    losses, step_ms = [], []
    for step in range(P13_RING_STEPS):
        ids = rng.integers(3, cfg.vocab_size, size=(P13_RING_B, P13_RING_T))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        local, opt, aux = step_fn(local, opt, p13_part(ids, ctx),
                                  p13_part(np.roll(ids, -1, axis=1), ctx), gen, step)
        losses.append(float(aux["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    res = dict(losses=losses, step_ms=step_ms, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               counts=read_counts(), shifts=collectives.CALLS["ring_shift"])
    del local, opt
    free_cuda()
    return res


P13_SUITES = {"fp32": p13_fp32, "1b_fsdp": p13_1b_fsdp, "1b_ring": p13_1b_ring}


def phase13_rank(suite: str, work: str) -> int:
    """A rank of a phase 13 suite (under the port's launcher)."""
    sys.path.insert(0, REPO)
    import torch.distributed as dist

    from layerskip_tpu_torch.parallel.distributed import BACKEND_ENV, setup, teardown

    setup(os.environ[BACKEND_ENV])
    rank = dist.get_rank()
    res = P13_SUITES[suite](work)
    res.update(rank=rank, backend=dist.get_backend())
    torch.save(res, os.path.join(work, f"rank{rank}.pt"))
    teardown()
    return 0


def phase13_launch(suite: str, nproc: int, work: str, backend: str = "gloo"):
    """Every rank's results of ``suite`` over ``nproc`` ranks; a failing
    rank fails the phase (its traceback on stderr)."""
    from layerskip_tpu_torch.parallel.launch import launch

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    t0 = time.time()
    rc = launch([os.path.abspath(__file__), "--phase13", suite, work], nproc, backend,
                env=env, timeout=600)
    log(f"[phase 13] {suite}: {nproc} ranks over {backend}, exit code {rc}, "
        f"{time.time() - t0:.1f}s")
    if rc != 0:
        raise RuntimeError(f"phase 13 suite {suite} failed with exit code {rc}")
    return [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
            for r in range(nproc)]


def p13_adam_moves(grads, lr):
    """AdamW's summed moves after each step for the per-step gradients
    ``grads`` (torch's AdamW, betas 0.9/0.999, eps 1e-8; the decay term,
    the same on both sides, left out)."""
    m = v = 0.0
    total, out = 0.0, []
    for t, g in enumerate(grads, 1):
        m, v = 0.9 * m + 0.1 * g, 0.999 * v + 0.001 * g * g
        total = total + lr * (m / (1 - 0.9 ** t)) / ((v / (1 - 0.999 ** t)).sqrt() + 1e-8)
        out.append(total)
    return out


def p13_adam_gap(got, ref) -> float:
    """The largest |got - want| over its bound of two AdamW runs' params (<=
    1 within): P13_ADAM_TOL, except where gradients within TRAIN_GRAD_TOL
    of the single device's could move AdamW's update by more than
    P13_ADAM_TOL (the update's sign and size are those of m / sqrt(v): a
    gradient under the gradients' atol may flip, and in step 2 a gradient
    that nearly cancels step 1's leaves m near 0), which are held to Adam's
    own bound, lr a step. The CPU tests' rule (every step's gradient above
    the atol) is the first half of this one."""
    import itertools

    lr, tol, worst = P13_ADAM["learning_rate"], TRAIN_GRAD_TOL, 0.0
    for k in got["after"][0]:
        gs = [ref["step_grads"][step][k].double() for step in range(2)]
        slack = [tol["atol"] + tol["rtol"] * g.abs() for g in gs]
        base = p13_adam_moves(gs, lr)
        for step in range(2):
            want = ref["after"][step][k]
            bound = P13_ADAM_TOL["atol"] + P13_ADAM_TOL["rtol"] * want.abs()
            swing = torch.zeros_like(want, dtype=torch.float64)
            for signs in itertools.product((-1.0, 1.0), repeat=step + 1):
                moved = p13_adam_moves([g + s * d for g, s, d in zip(gs, signs, slack)], lr)
                swing = torch.maximum(swing, (moved[step] - base[step]).abs())
            loose = swing > bound
            diff = (got["after"][step][k] - want).abs()
            ratio = torch.where(loose, diff / (lr * (step + 1) * 2 + P13_ADAM_TOL["atol"]),
                                diff / bound)
            worst = max(worst, float(ratio.max()))
    return worst


def phase13_fp32(work_root):
    """(a): each leg's loss and gradients at step 1 and its params after two
    AdamW steps == the single-device step on the card (losses within
    TRAIN_LOSS_RTOL, gradients within TRAIN_GRAD_TOL, params within the
    CPU tests' AdamW bound); no K1-K7 launch."""
    refs = {}
    for family in ("qwen2", "mixtral"):
        refs[family] = p13_run(family)
    ok, total = True, {}
    work = os.path.join(work_root, "fp32")
    os.makedirs(work)
    for r in phase13_launch("fp32", 4, work):
        for leg, (family, dp, fsdp, tp, ring) in P13_LEGS.items():
            got, ref = r[leg], refs[family]
            rel = max(float(((got["aux"][k] - ref["aux"][k]).abs()
                             / ref["aux"][k].abs().clamp(min=1e-30)).max())
                      for k in ("loss", "final_loss", "exit_losses", "moe_aux")
                      if ref["aux"][k].numel())
            step_rel = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
            gap = grad_gap(got["grads"], ref["grads"])
            adam = p13_adam_gap(got, ref)
            idle = kernels_idle(f"phase 13 (a) rank {r['rank']} {leg}", got["counts"])
            for k, v in got["counts"].items():
                total[k] = total.get(k, 0) + v
            good = (rel <= TRAIN_LOSS_RTOL and step_rel <= TRAIN_LOSS_RTOL and gap <= 1.0
                    and adam <= 1.0 and idle)
            ok &= good
            log(f"[phase 13 (a)] rank {r['rank']} {leg} (dp {dp} x fsdp {fsdp} x tp {tp}"
                f"{', ring' if ring else ''}, {family} fp32): loss "
                f"{float(got['aux']['loss']):.6f} vs single device "
                f"{float(ref['aux']['loss']):.6f}, largest loss rel diff {rel:.3g}, "
                f"AdamW step losses rel diff {step_rel:.3g} (limit {TRAIN_LOSS_RTOL}), "
                f"gradients at {gap:.3g} of atol 2e-5 + rtol 2e-3, params after two "
                f"AdamW steps at {adam:.3g} of their bound -> {'PASS' if good else 'FAIL'}")
    return ok, total


def p13_check_1b(label, ranks, first_loss_1b, single_resident, where):
    """(b) and (d)'s checks on every rank of a ``1b_fsdp`` run: first loss
    within 1e-2 of phase 11 (b)'s, finite losses, ``L/fsdp`` layers a
    rank, resident bytes within 1% of ``p13_share``, no K1-K7 launch.
    Returns (ok, launches, rank 0's stats)."""
    ok, total, stats = True, {}, {}
    single = sum(single_resident.values())
    n = len(ranks)
    for r in ranks:
        first = r["history"][0][1]
        rel = abs(first - first_loss_1b) / abs(first_loss_1b)
        mine = sum(r["resident"].values())
        share, want = mine / single, p13_share(n)
        losses = [x for _, x in r["history"]]
        idle = kernels_idle(f"{label} rank {r['rank']}", r["counts"])
        for k, v in r["counts"].items():
            total[k] = total.get(k, 0) + v
        good = (rel <= 1e-2 and abs(share - want) <= 0.01 * want
                and len(losses) == P13_1B_STEPS and all(np.isfinite(losses)) and idle
                and r["layers"] == 16 // n)
        ok &= good
        if r["rank"] == 0:
            for line in r["log"].splitlines():
                log(f"[{label} cli] {line}")
            med = float(np.median(r["step_ms"])) if r["step_ms"] else float("nan")
            stats = dict(step_ms=r["step_ms"], step_ms_median=med, first_loss=first,
                         peak_gb=r["peak_gb"], resident_share=share)
        log(f"[{label}] rank {r['rank']}: random:1b bf16 at fsdp {n} ({16 // n} of 16 layers "
            f"a rank, the tied embedding whole), B 4 x 1024 ({1024 // n} positions a rank), "
            f"{len(losses)} steps, losses {[round(x, 4) for x in losses]}; first loss "
            f"{first:.4f} vs phase 11 (b)'s single device {first_loss_1b:.4f} (rel diff "
            f"{rel:.3g}, limit 1e-2); step ms {[round(x, 1) for x in r['step_ms']]} (steps "
            f"2-{P13_1B_STEPS}; rank 0's log); peak {r['peak_gb']:.2f} GB; resident weights "
            f"{r['resident']['params'] / 1e9:.3f} GB + gradients "
            f"{r['resident']['grads'] / 1e9:.3f} + AdamW {r['resident']['adamw'] / 1e9:.3f} "
            f"= {mine / 1e9:.3f} GB, {share:.4f} of the single device's {single / 1e9:.3f} "
            f"(reckoned from sizes {want:.4f}) -> {'PASS' if good else 'FAIL'} ({where})")
    return ok, total, stats


def p13_corpus(work_root, name):
    work = os.path.join(work_root, name)
    os.makedirs(work)
    write_jsonl(os.path.join(work, "train.jsonl"), entry_prompts(64, seed=31))  # phase 11 (b)'s
    return work


def phase13_full_width(card, work_root, first_loss_1b, single_resident):
    """(b) ``random:1b`` at --fsdp 2 through ``cli.train`` and (c) its ring
    at 8192 tokens, two gloo ranks on the card; no K1-K7 launch."""
    ranks = phase13_launch("1b_fsdp", 2, p13_corpus(work_root, "1b_fsdp2"))
    ok, total, stats = p13_check_1b(
        "phase 13 (b)", ranks, first_loss_1b, single_resident,
        f"{card}; both ranks share this one card and every collective crosses the host over "
        f"gloo: not a speed of fsdp over NVLink")
    stats["card"] = card

    ok_ring, ring_counts, ring_stats = p13_check_ring(
        "phase 13 (c)", phase13_launch("1b_ring", 2, p13_corpus(work_root, "1b_ring")), card)
    for k, v in ring_counts.items():
        total[k] = total.get(k, 0) + v
    stats.update(ring_stats)
    return ok and ok_ring, total, stats


def p13_check_ring(label, ranks, where):
    """(c) and (d)'s checks on every rank of a ``1b_ring`` run: finite
    losses, K/V shifted around the ring, the peak under 30 GB a rank, no
    K1-K7 launch. Returns (ok, launches, rank 0's stats)."""
    ok, total, stats = True, {}, {}
    n = len(ranks)
    t_loc = P13_RING_T // n
    saved = 32 * t_loc * t_loc * 4 * n  # a layer's fp32 score blocks a rank, B 1
    for r in ranks:
        idle = kernels_idle(f"{label} rank {r['rank']}", r["counts"])
        for k, v in r["counts"].items():
            total[k] = total.get(k, 0) + v
        good = (all(np.isfinite(r["losses"])) and r["shifts"] > 0 and r["peak_gb"] < 30.0
                and idle)
        ok &= good
        if r["rank"] == 0:
            stats = dict(ring_step_ms=r["step_ms"], ring_peak_gb=r["peak_gb"],
                         ring_losses=r["losses"])
        log(f"[{label}] rank {r['rank']}: random:1b bf16 at fsdp {n}, ring attention over "
            f"fsdp, B {P13_RING_B} x {P13_RING_T} tokens ({t_loc} a rank), "
            f"{P13_RING_STEPS} steps: losses {[round(x, 4) for x in r['losses']]}, step ms "
            f"{[round(x, 1) for x in r['step_ms']]}, {r['shifts']} ring shifts; peak "
            f"{r['peak_gb']:.2f} GB (limit 30; a layer's {n} fp32 score blocks are "
            f"{saved / 1e9:.2f} GB, {16 * saved / 1e9:.1f} GB over 16 layers were they all "
            f"kept: under fsdp each layer is recomputed in backward, so one layer's live at a "
            f"time) -> {'PASS' if good else 'FAIL'} ({where})")
    return ok, total, stats


def phase13_nccl(card, work_root, first_loss_1b, single_resident):
    """(d): with two cards or more, ``random:1b`` at --fsdp N (4 with four
    cards, else 2) through ``cli.train`` over NCCL, one rank a card."""
    count = torch.cuda.device_count()
    if count < 2:
        log(f"[phase 13 (d)] random:1b at fsdp N over NCCL, one rank a card: not run, this "
            f"machine has {count} card ({card}); fsdp over NVLink stays unmeasured here")
        return True, {}, {}
    n = 4 if count >= 4 else 2
    where = f"{card} x {n}, one rank a card over NCCL"
    ranks = phase13_launch("1b_fsdp", n, p13_corpus(work_root, f"1b_nccl{n}"), backend="nccl")
    ok, total, stats = p13_check_1b("phase 13 (d)", ranks, first_loss_1b, single_resident,
                                    where)
    ranks = phase13_launch("1b_ring", n, p13_corpus(work_root, f"1b_ring_nccl{n}"),
                           backend="nccl")
    ok_ring, ring_counts, ring_stats = p13_check_ring("phase 13 (d) ring", ranks, where)
    for k, v in ring_counts.items():
        total[k] = total.get(k, 0) + v
    stats.update(ring_stats)
    return ok and ok_ring, total, stats


# ------------------------------------------------------------ phase 14


P14_SHARDS = 4
P14_PAIRS = 1000
P14_EVAL_MODEL = "random:7b"
P14_EVAL_RTOL = 1e-3  # bf16: a row's score batched against alone
P14_FP32_RTOL = 1e-4  # fp32: card against CPU
P14_ROLLING_TOKENS = 5000  # past the 7B preset's 4096 positions: two windows


def hf_shards(params, cfg, n):
    """``params`` (dense Llama) as ``n`` dicts of HF-named tensors in their
    own dtype, the names split in sorted order."""
    from layerskip_tpu_torch.models.params import _key_map

    tensors = {"model.embed_tokens.weight": params.embed,
               "model.norm.weight": params.final_norm}
    if params.lm_head is not None:
        tensors["lm_head.weight"] = params.lm_head.T
    for i in range(cfg.num_hidden_layers):
        for hf_name, (field, transpose) in _key_map(cfg).items():
            w = getattr(params.layers, field)
            if w is not None:
                tensors[f"model.layers.{i}.{hf_name}"] = w[i].T if transpose else w[i]
    names = sorted(tensors)
    step = -(-len(names) // n)
    return [{k: tensors[k].contiguous() for k in names[j:j + step]}
            for j in range(0, len(names), step)]


def drop_page_cache(paths):
    """Ask the kernel to drop the files' cached pages (written back first).
    Only a request: a tmpfs keeps them; ``resident_share`` says what stayed."""
    for p in paths:
        fd = os.open(p, os.O_RDONLY)
        try:
            os.fsync(fd)
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)


def resident_share(paths) -> float:
    """The share of the files' pages in the page cache, by ``mincore`` over a
    read-only mapping of each (mapping reads no page)."""
    import ctypes
    import mmap

    libc = ctypes.CDLL(None, use_errno=True)
    libc.mmap.restype = ctypes.c_void_p
    libc.mmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_long]
    libc.munmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    libc.mincore.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p]
    page = mmap.PAGESIZE
    resident = pages = 0
    for p in paths:
        size = os.path.getsize(p)
        n = -(-size // page)
        fd = os.open(p, os.O_RDONLY)
        try:
            addr = libc.mmap(None, size, mmap.PROT_READ, mmap.MAP_SHARED, fd, 0)
            if addr in (None, ctypes.c_void_p(-1).value):
                raise OSError(ctypes.get_errno(), f"mmap of {p} failed")
            try:
                vec = (ctypes.c_ubyte * n)()
                if libc.mincore(addr, size, vec) != 0:
                    raise OSError(ctypes.get_errno(), f"mincore of {p} failed")
                resident += sum(b & 1 for b in vec)
            finally:
                libc.munmap(addr, size)
        finally:
            os.close(fd)
        pages += n
    return resident / max(pages, 1)


def native_runtime(tmp):
    """Phase 14 (a): ``random:1b``'s bf16 weights as 4 shards; ``load_params``
    with the native reader == the Python reader == the weights, bit for bit,
    each timed after asking the kernel to drop the shards' pages and then
    with them cached, the share of pages resident before each read measured
    (``mincore``); Levenshtein and LCS of the native library == the plain loops on
    1000 seeded pairs."""
    from layerskip_tpu_torch import metrics, native
    from layerskip_tpu_torch.cli.loading import load_model_and_tokenizer
    from layerskip_tpu_torch.models import safetensors_io
    from layerskip_tpu_torch.models.params import load_params

    params, cfg, _ = load_model_and_tokenizer("random:1b", device="cuda")
    ckpt = os.path.join(tmp, "native_1b")
    os.makedirs(ckpt)
    paths = []
    for j, part in enumerate(hf_shards(params, cfg, P14_SHARDS)):
        paths.append(os.path.join(ckpt, f"model-{j + 1:05d}-of-{P14_SHARDS:05d}.safetensors"))
        safetensors_io.save_file(part, paths[-1])
    nbytes = sum(os.path.getsize(p) for p in paths)
    t0 = time.time()
    native.load_library("safetensors_reader")
    native.load_library("text_metrics")
    build_s = time.time() - t0
    read = {"python": lambda: [safetensors_io.load_file(p) for p in paths],
            "native": lambda: native.load_shards(paths)}
    secs, resident, ok = {}, {}, True
    for cache in ("dropped", "cached"):  # the shards read into host tensors
        for reader, fn in read.items():
            if cache == "dropped":
                drop_page_cache(paths)
            resident[f"{reader}_{cache}"] = resident_share(paths)
            t0 = time.time()
            fn()
            secs[f"read_{reader}_{cache}"] = time.time() - t0
    for reader in read:  # the whole load, pages cached: read, stack, copy to the card
        torch.cuda.synchronize()
        t0 = time.time()
        got = load_params(ckpt, cfg, device="cuda", reader=reader)
        torch.cuda.synchronize()
        secs[f"load_params_{reader}"] = time.time() - t0
        ok &= all(same_tensor(getattr(got.layers, f.name), getattr(params.layers, f.name))
                  for f in dataclasses.fields(got.layers)) and all(
            same_tensor(getattr(got, f), getattr(params, f))
            for f in ("embed", "final_norm", "lm_head"))
        del got
    log(f"[phase 14 (a)] random:1b bf16 in {len(paths)} shards, {nbytes / 1e9:.3f} GB under "
        f"{ckpt}: read seconds python/native after posix_fadvise(DONTNEED) "
        f"{secs['read_python_dropped']:.3f} / {secs['read_native_dropped']:.3f} (share of "
        f"pages resident before the read, by mincore: {resident['python_dropped']:.3f} / "
        f"{resident['native_dropped']:.3f}), then cached {secs['read_python_cached']:.3f} / "
        f"{secs['read_native_cached']:.3f} (resident {resident['python_cached']:.3f} / "
        f"{resident['native_cached']:.3f}); load_params (pages cached) "
        f"{secs['load_params_python']:.3f} / {secs['load_params_native']:.3f}; both == the "
        f"weights bit for bit: {ok}; g++ build of the two libraries {build_s:.1f} s")
    del params
    free_cuda()
    rng = np.random.default_rng(14)
    alphabet = list("abcde ") + ["é", "✓", "中"]
    bad = 0
    for _ in range(P14_PAIRS):
        a, b = ("".join(rng.choice(alphabet, size=rng.integers(0, 60))) for _ in range(2))
        ta, tb = a.split(), b.split()
        bad += native.levenshtein(a, b) != metrics.edit_distance_plain(a, b)
        bad += metrics._lcs_len(ta, tb) != metrics.lcs_len_plain(ta, tb)
    log(f"[phase 14 (a)] Levenshtein and LCS on {P14_PAIRS} seeded pairs: {bad} "
        f"differences from the plain loops")
    ok &= bad == 0
    return ok, dict(native_load_s=secs, native_resident=resident, shard_bytes=nbytes)


def eval_docs(seed):
    """16 four-choice docs: 8 contexts of 300-370 bytes (scored in bucket
    512) and 8 of 1100-1800 (bucket 2048), at a byte a token."""
    rng = np.random.default_rng(seed)

    def text(n):
        return " ".join(str(w) for w in rng.integers(10**4, 10**5, size=n // 6 + 1))[:n]

    return [{"query": text(300 + 10 * i if i < 8 else 1100 + 100 * (i - 8)),
             "choices": [" " + text(int(rng.integers(8, 24))) for _ in range(4)],
             "gold": i % 4} for i in range(16)]


def mc_rows(wrap, docs):
    """The (context, continuation) rows ``run_local_mc`` scores for ``docs``."""
    rows = []
    for d in docs:
        ctx_enc = wrap.tok_encode(d["query"])
        for choice in d["choices"]:
            rows.append((ctx_enc, wrap.tok_encode(d["query"] + choice)[len(ctx_enc):]))
    return rows


def eval_full_width(tmp):
    """Phase 14 (b): ``cli.eval.main --tasks local:<16 docs>`` at 7B in bf16
    (K1 on the tensor cores), acc and acc_norm in [0, 1]; the scores of a
    batch == the rows alone; ``loglikelihood_rolling`` over 5000 tokens ==
    its windows' sum; then phase 4's narrow fp32 model, scored on the card
    (K1 on the CUDA cores) == on the CPU."""
    from layerskip_tpu_torch.cli import eval as ev
    from layerskip_tpu_torch.cli import loading
    from layerskip_tpu_torch.cli.args import Arguments
    from layerskip_tpu_torch.config import GenerationConfig
    from layerskip_tpu_torch.generation.generator import LlamaGenerator

    class ByteTokenizer(loading.SimpleTokenizer):
        """The byte tokenizer without its 512-byte cap, so contexts reach
        bucket 2048."""

        def encode(self, text):
            return [1 + (b % (self.vocab_size - 2)) for b in text.encode()]

    docs = eval_docs(14)
    task = os.path.join(tmp, "mc16.jsonl")
    with open(task, "w") as f:
        f.write("\n".join(json.dumps(d) for d in docs))
    kept = {}

    def load(args):
        params, cfg, _ = loading.load_from_args(args)
        kept.update(params=params, cfg=cfg)
        return params, cfg, ByteTokenizer(cfg.vocab_size)

    out_dir = os.path.join(tmp, "eval_out")
    gen_cfg = GenerationConfig(max_steps=8, sample=False)
    ev.load_from_args = load
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    buf = io.StringIO()
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(buf):
            res = ev.main(Arguments(model=P14_EVAL_MODEL, device="cuda", output_dir=out_dir),
                          ev.EvalArguments(tasks=f"local:{task}", batch_size=8), gen_cfg)
    finally:
        ev.load_from_args = loading.load_from_args
    main_s = time.time() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    r = res["results"]["mc16.jsonl"]
    written = [n for n in os.listdir(out_dir) if n.startswith("eval_")]
    ok = (0.0 <= r["acc"] <= 1.0 and 0.0 <= r["acc_norm"] <= 1.0 and r["num_requests"] == 64
          and len(written) == 1)
    k1_ok = counts["flash_prefill"] > 0 and \
        counts["flash_prefill_tensor_core"] == counts["flash_prefill"]
    ok &= k1_ok
    log(f"[phase 14 (b)] cli.eval.main {P14_EVAL_MODEL} bf16, local:mc16.jsonl (16 docs, 64 "
        f"rows, buckets 512 and 2048, batch 8): {json.dumps(r)}; {main_s:.1f} s with the "
        f"load; peak {peak / 1e9:.2f} GB; K1 {counts['flash_prefill']} launches, "
        f"{counts['flash_prefill_tensor_core']} on the tensor cores; wrote {written}")
    for name in written:
        with open(os.path.join(out_dir, name)) as f:
            log(f"[phase 14 (b)] {name}: {json.dumps(json.load(f))}")

    params, cfg = kept.pop("params"), kept.pop("cfg")
    wrap = ev.EvalHarnessLM(LlamaGenerator(ByteTokenizer(cfg.vocab_size), params, cfg,
                                           device="cuda"), gen_cfg, batch_size=8)
    torch.cuda.synchronize()
    t0 = time.time()
    again = ev.run_local_mc(wrap, task)
    torch.cuda.synchronize()
    mc_s = time.time() - t0
    ok &= again == r
    rows = mc_rows(wrap, docs)
    batched = wrap._loglikelihood_tokens([ev._Instance((None, c, k)) for c, k in rows])
    picks = [0, 5, 18, 31, 32, 45, 58, 63]  # rows of both buckets
    alone = [wrap.scorer.score_batch([rows[i]])[0] for i in picks]
    rel = max(abs(batched[i][0] - a[0]) / max(abs(a[0]), 1e-9) for i, a in zip(picks, alone))
    same_greedy = all(batched[i][1] == a[1] for i, a in zip(picks, alone))
    ok &= rel <= P14_EVAL_RTOL and same_greedy
    text = " ".join(str(w) for w in np.random.default_rng(15).integers(
        10**4, 10**5, size=P14_ROLLING_TOKENS // 6 + 1))[:P14_ROLLING_TOKENS]
    toks = wrap.tok_encode(text)
    windows = ev.rolling_token_windows(toks, wrap.eot_token_id, cfg.max_position_embeddings)
    rolling = wrap.loglikelihood_rolling([text])[0]
    parts = sum(wrap.scorer.score_batch([w])[0][0] for w in windows)
    roll_rel = abs(rolling - parts) / max(abs(parts), 1e-9)
    ok &= roll_rel <= P14_EVAL_RTOL and len(windows) > 1
    log(f"[phase 14 (b)] run_local_mc again {mc_s:.3f} s for 64 rows (== main's result: "
        f"{again == r}); {len(picks)} rows batched vs alone: largest relative gap {rel:.3g} "
        f"(<= {P14_EVAL_RTOL}), greedy flags equal {same_greedy}; loglikelihood_rolling over "
        f"{len(toks)} tokens ({len(windows)} windows) {rolling:.4f} vs its windows' sum "
        f"{parts:.4f}: relative gap {roll_rel:.3g}")
    del wrap, params
    free_cuda()

    # phase 4's fp32 model: the card (K1 on the CUDA cores) == the CPU
    cfg32, p32 = small_fp32_model()
    rng = np.random.default_rng(16)
    rows32 = [(rng.integers(1, cfg32.vocab_size, size=n).tolist(),
               rng.integers(1, cfg32.vocab_size, size=m).tolist())
              for n, m in ((20, 3), (45, 1), (90, 6), (130, 2), (250, 5), (300, 1), (600, 4),
                           (700, 8), (1000, 2))]
    cpu_scorer = ev.TokenScorer(params_on(p32, "cpu", grad=False), cfg32, max_batch=4)
    gaps = []
    for n, m in ((20, 3), (130, 2), (600, 4)):  # continuations the CPU model picks greedily
        ctx = rng.integers(1, cfg32.vocab_size, size=n).tolist()
        cont = []
        for _ in range(m):
            lp = cpu_scorer.logprobs(ctx + cont)[-1]
            top2 = np.sort(lp)[-2:]
            gaps.append(float(top2[1] - top2[0]))
            cont.append(int(np.argmax(lp)))
        rows32.append((ctx, cont))
    reset_counts()
    card = ev.TokenScorer(p32, cfg32, max_batch=4).score_batch(rows32)
    c32 = read_counts()
    cpu = cpu_scorer.score_batch(rows32)
    rel32 = max(abs(a[0] - b[0]) / max(abs(b[0]), 1e-9) for a, b in zip(card, cpu))
    greedy32 = [a[1] for a in card] == [b[1] for b in cpu]
    n_true = sum(a[1] for a in card)
    fp32_route = c32["flash_prefill"] > 0 and c32["flash_prefill_tensor_core"] == 0
    ok &= rel32 <= P14_FP32_RTOL and greedy32 and n_true >= 3 and fp32_route
    log(f"[phase 14 (b)] fp32 narrow model, {len(rows32)} rows card vs CPU: largest relative "
        f"gap {rel32:.3g} (<= {P14_FP32_RTOL}), greedy flags equal {greedy32} ({n_true} "
        f"true; the last 3 rows continue with the CPU model's greedy tokens, smallest top-2 "
        f"log-prob gap {min(gaps):.3g}); K1 {c32['flash_prefill']} launches, "
        f"{c32['flash_prefill_tensor_core']} on the tensor cores")
    del p32
    free_cuda()
    return ok, counts, dict(eval_main_s=main_s, eval_rows_s=mc_s, eval_peak_bytes=peak,
                            eval=r)


def sweep_full_width(tmp):
    """Phase 14 (c): ``cli.sweep.sweep`` at 7B over exit {4, 8} x W {2, 6},
    two 200-byte prompts and 32 steps: a CSV of 4 rows; the plot's line."""
    from layerskip_tpu_torch.cli import sweep as sw
    from layerskip_tpu_torch.cli.args import Arguments
    from layerskip_tpu_torch.cli.benchmark import BenchmarkArguments
    from layerskip_tpu_torch.config import GenerationConfig

    out_dir = os.path.join(tmp, "sweep_out")
    data = write_jsonl(os.path.join(tmp, "sweep.jsonl"), entry_prompts(2, 14))
    buf = io.StringIO()
    reset_counts()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        rows = sw.sweep(Arguments(model=ENTRY_MODEL, device="cuda", output_dir=out_dir),
                        BenchmarkArguments(dataset="custom_jsonl", data_path=data,
                                           num_samples=2, random_shuffle=False),
                        sw.SweepArguments(exit_layer_first=4, exit_layer_last=8,
                                          exit_layer_step=4, num_speculations_first=2,
                                          num_speculations_last=6, num_speculations_step=4),
                        GenerationConfig(max_steps=32, sample=False))
    secs = time.time() - t0
    counts = read_counts()
    (csv_name,) = [n for n in os.listdir(out_dir) if n.endswith(".csv")]
    with open(os.path.join(out_dir, csv_name)) as f:
        csv_rows = f.read().strip().splitlines()[1:]
    plot = [ln for ln in buf.getvalue().splitlines()
            if ln.startswith(("contour plot skipped", "wrote"))]
    ok = len(csv_rows) == 4 and len(rows) == 4
    log(f"[phase 14 (c)] cli.sweep {ENTRY_MODEL}, exit {{4, 8}} x W {{2, 6}}, 2 prompts, 32 "
        f"steps: {len(csv_rows)} CSV rows in {secs:.1f} s; " + "; ".join(
            f"exit {r['exit_layer']} W {r['num_speculations']}: acceptance "
            f"{r['acceptance_rate']:.3f}, {r['tokens_per_second']:.2f} tok/s" for r in rows))
    log(f"[phase 14 (c)] {' | '.join(plot)}")
    free_cuda()
    return ok, counts


def script_main(name, argv):
    """(the JSON line's dict, the launch counts) of ``scripts/<name>.py``'s
    ``main(argv)`` run in this process; its stdout line is logged."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts",
                                                                     f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    free_cuda()
    reset_counts()
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        result = mod.main(argv + ["--device", "cuda"])
    counts = read_counts()
    log(f"[phase 14 (d)] {name} {' '.join(argv)} ({time.time() - t0:.1f} s): "
        f"{buf.getvalue().strip()}")
    free_cuda()
    return result, counts


def scripts_full_width():
    """Phase 14 (d): the four measurement scripts in-process: serving at 7B
    (bf16 pool: K2; then the int8 pool: K3), chunked admission at 1B,
    a 30720-token context at 1B (K1 >= 16 launches a prefill), adaptive
    drafting at 7B. Returns (ok, launch counts, stats)."""
    total, stats, ok = {}, {}, True

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    serve = ["--config", "7b", "--batch", "4", "--requests", "8", "--max-steps", "64",
             "--paged", "--prefix-cache", "--system-len", "128", "--prompt-bucket", "256"]
    res, c = script_main("bench_torch_serving", serve)
    add(c)
    ok_serve = c["paged_decode_attention"] > 0 and res["prefix_stats"]["hits"] > 0
    res_q, cq = script_main("bench_torch_serving", serve + ["--kv-quant", "--skip-gather"])
    add(cq)
    ok_serve &= cq["paged_decode_attention_q8"] > 0
    # 8 requests of 64 tokens: the seed's streams meet no EOS, so every
    # scheduler of both runs serves 512 tokens
    want_served = 8 * 64
    ok_serve &= set(res["served"].values()) | set(res_q["served"].values()) == {want_served}
    log(f"[phase 14 (d)] serving: K2 {c['paged_decode_attention']} launches (bf16 pool), K3 "
        f"{cq['paged_decode_attention_q8']} (int8 pool); tokens served per run "
        f"{res['served']} / {res_q['served']} (want {want_served} from each) -> "
        f"{'PASS' if ok_serve else 'FAIL'}")
    stats["serving"], stats["serving_kv_quant"] = res, res_q
    res, c = script_main("bench_torch_chunked", ["--config", "1b", "--long-prompt", "1024",
                                                 "--chunk", "128"])
    add(c)
    stats["chunked"] = res
    log(f"[phase 14 (d)] chunked: victim stall {res['stall_ms_plain']} ms plain, "
        f"{res['stall_ms_chunked']} ms chunked")
    res, c = script_main("bench_torch_longctx", ["--config", "1b", "--ctx", str(LONG_CTX),
                                                 "--max-steps", "64", "--repeats", "1"])
    add(c)
    prefills = 4  # AR and spec, each a warm-up and one timed run
    ok_long = c["flash_prefill"] >= 16 * prefills and \
        c["flash_prefill_tensor_core"] == c["flash_prefill"] and \
        res["ar_tokens"] == res["spec_tokens"] and len(res["ar_tokens"]) == 64
    log(f"[phase 14 (d)] longctx: K1 {c['flash_prefill']} launches over {prefills} prefills "
        f"of {LONG_CTX} tokens (>= 16 each), all on the tensor cores "
        f"{c['flash_prefill_tensor_core'] == c['flash_prefill']}; greedy spec == AR "
        f"{res['ar_tokens'] == res['spec_tokens']} ({len(res['ar_tokens'])} tokens); peak "
        f"{res['peak_bytes'] / 1e9:.2f} GB -> {'PASS' if ok_long else 'FAIL'}")
    stats["longctx"] = {k: res[k] for k in ("ar_tokens_per_s", "spec_tokens_per_s",
                                            "spec_speedup", "peak_bytes")}
    res, c = script_main("bench_torch_adaptive", ["--config", "7b", "--eps", "0.05", "--taus",
                                                  "0", "0.5", "--max-steps", "128",
                                                  "--repeats", "1"])
    add(c)
    stats["adaptive"] = res
    ok_adapt = len(res["points"]) == 2 and res["ar_tokens_per_s"] > 0
    ok &= ok_serve and ok_long and ok_adapt
    return ok, total, stats


def phase14(card, tmp):
    """Phase 14: (a) the native runtime, (b) eval, (c) the sweep, (d) the four
    measurement scripts. Returns (ok, launch counts of the bf16 runs,
    stats)."""
    ok_native, nstats = native_runtime(tmp)
    ok_eval, ecounts, estats = eval_full_width(tmp)
    ok_sweep, scounts = sweep_full_width(tmp)
    ok_scripts, dcounts, dstats = scripts_full_width()
    counts = {k: ecounts[k] + scounts[k] + dcounts.get(k, 0) for k in ecounts}
    log(f"[phase 14 launches] (b) {json.dumps(ecounts)}; (c) {json.dumps(scounts)}; (d) "
        f"{json.dumps(dcounts)}")
    log(f"[phase 14] native={ok_native} eval={ok_eval} sweep={ok_sweep} "
        f"scripts={ok_scripts} ({card})")
    return (ok_native and ok_eval and ok_sweep and ok_scripts), counts, dict(
        **nstats, **estats, scripts=dstats)


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
    sources = ("flash_prefill", "paged_decode", "quant_matmul")
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
    ok_long_kernel, kres_long = check_flash_prefill_long()
    ok_kernel &= ok_long_kernel
    kres.update(kres_long)
    ok_quant_kernel, qres = check_quant_kernels()
    ok_paged_kernel, pres = check_paged_kernels()
    ok_kernel &= ok_quant_kernel and ok_paged_kernel
    log(f"[phase 3] {time.time() - t0:.1f}s, of which {_FLEX['compile_s']:.1f}s "
        f"compiling flex_attention")
    t0 = time.time()
    ok_fp32 = exact_fp32_greedy() & exact_fp32_paged()
    log(f"[phase 4] {time.time() - t0:.1f}s")
    t0 = time.time()
    ok_full, stats, counts, ctx = full_width(kres)
    log(f"[phase 5] {time.time() - t0:.1f}s")
    t0 = time.time()
    ok_quant, qstats, qcounts = quantized_full_width(*ctx, kres, qres)
    log(f"[phase 6] {time.time() - t0:.1f}s")
    t0 = time.time()
    ok_serve, sstats, scounts = serving_full_width(ctx[0], ctx[1], stats["spec_tok_s"])
    log(f"[phase 7] {time.time() - t0:.1f}s")
    del ctx  # phase 8 loads its own weights
    free_cuda()
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        ok_entry = entry_fp32_exact(card, tmp)
        ok_entry_full, estats, ecounts = entry_full_width(card, tmp)
    ok_entry &= ok_entry_full
    log(f"[phase 8] {time.time() - t0:.1f}s")
    free_cuda()
    t0 = time.time()
    ok_draft, dcounts = drafting_fp32_exact()
    ok_draft_full, dstats, dfcounts = drafting_full_width(card)
    ok_draft &= ok_draft_full
    phase9 = {k: dcounts[k] + dfcounts[k] for k in dcounts}
    tree_ok = all(phase9[f"{k}_tree"] > 0 for k in TREE_ROUTES)
    ok_draft &= tree_ok
    log(f"[phase 9 launches] {json.dumps(phase9)}; tree clause launched in K2 and K3: "
        f"{tree_ok}")
    log(f"[phase 9] {time.time() - t0:.1f}s")
    free_cuda()
    t0 = time.time()
    ok_fam, fcounts = families_fp32_exact()
    free_cuda()
    ok_g2b, gstats, gcounts = gemma2_2b_full_width(card, kres)
    ok_moe, mstats, mcounts, m32counts = moe_3b_full_width(card, kres)
    ok_fam &= ok_g2b and ok_moe
    k23_dh256 = all(gcounts[k] > 0 for k in TREE_ROUTES)
    ok_fam &= k23_dh256
    log(f"[phase 10 launches] (a) {json.dumps(fcounts)}; (b) {json.dumps(gcounts)}; "
        f"(c) {json.dumps(mcounts)}; K2 and K3 launched at Dh 256: {k23_dh256}")
    log(f"[phase 10] {time.time() - t0:.1f}s")
    free_cuda()
    t0 = time.time()
    ok_train = training_fp32_card_vs_cpu()
    with tempfile.TemporaryDirectory() as tmp:
        ok_train_1b, tstats = llama_1b_training(card, tmp)
    ok_train_moe, tmstats = moe_3b_training(card)
    ok_train &= ok_train_1b and ok_train_moe
    log(f"[phase 11] {time.time() - t0:.1f}s")
    free_cuda()
    t0 = time.time()
    ok_par, pcounts = phase12_fp32()
    ok_par_full, pfcounts, refs = phase12_full_width(card)
    ok_nccl, pncounts = phase12_nccl(card, refs)
    ok_par &= ok_par_full and ok_nccl
    log(f"[phase 12 launches] (a) {json.dumps(pcounts)}; (b) {json.dumps(pfcounts)}; "
        f"(c) {json.dumps(pncounts)}, summed over the ranks")
    log(f"[phase 12] {time.time() - t0:.1f}s")
    free_cuda()
    t0 = time.time()
    with tempfile.TemporaryDirectory() as work:
        ok_mesh, mcounts13 = phase13_fp32(work)
        ok_mesh_full, fcounts13, p13stats = phase13_full_width(card, work, tstats["losses"][0],
                                                               tstats["resident"])
        ok_nccl13, ncounts13, p13stats["nccl"] = phase13_nccl(card, work, tstats["losses"][0],
                                                              tstats["resident"])
    ok_mesh &= ok_mesh_full and ok_nccl13
    for more in (ncounts13,):
        for k, v in more.items():
            fcounts13[k] = fcounts13.get(k, 0) + v
    log(f"[phase 13 launches] K1-K7 over every rank: (a) {json.dumps(mcounts13)}; (b)-(c) "
        f"{json.dumps(fcounts13)} (all must be 0)")
    log(f"[phase 13] {time.time() - t0:.1f}s")
    free_cuda()
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        ok_apps, acounts, astats = phase14(card, tmp)
    log(f"[phase 14] {time.time() - t0:.1f}s")
    # phases 5-8, 9 (b), 10 (b)-(c) and 14 run in bf16 (9 (b)'s fp32 check
    # only adds K2 launches): every K1 launch must take the tensor-core route
    for more in (qcounts, scounts, ecounts, dfcounts, gcounts, mcounts, acounts):
        for k, v in more.items():
            counts[k] += v
    ok_route = counts["flash_prefill_tensor_core"] == counts["flash_prefill"] > 0
    log(f"[k1 route] phases 5-10 and 14: {counts['flash_prefill']} K1 launches, "
        f"{counts['flash_prefill_tensor_core']} on the tensor-core route -> "
        f"{'PASS' if ok_route else 'FAIL'}")
    ok_full &= ok_route
    # and every K4-K7 launch of them the tensor-core route
    for label, kinds in (("k4/k7", ("quant_matmul_t", "int4_matmul_t")),
                         ("k5/k6", ("quant_matmul", "int4_matmul"))):
        ok_qroute = all(counts[f"{k}_tensor_core"] == counts[k] > 0 for k in kinds)
        log(f"[{label} route] phases 5-10 and 14: " + ", ".join(
            f"{k} {counts[k]} launches, {counts[f'{k}_tensor_core']} on the tensor cores"
            for k in kinds) + f" -> {'PASS' if ok_qroute else 'FAIL'}")
        ok_quant &= ok_qroute
    for more in (dcounts, fcounts, m32counts):  # 9 (a), 10 (a), 10 (c)'s fp32 session
        for k, v in more.items():
            counts[k] += v
    for more in (pcounts, pfcounts, pncounts):  # phase 12, every rank's
        for k, v in more.items():
            counts[k] += v
    log(f"[summary] kernels={ok_kernel} fp32_exact={ok_fp32} full_width={ok_full} "
        f"quantized_full_width={ok_quant} serving={ok_serve} entry_points={ok_entry} "
        f"drafting={ok_draft} families={ok_fam} training={ok_train} parallel={ok_par} "
        f"training_mesh={ok_mesh} apps={ok_apps} {json.dumps(stats)} {json.dumps(p13stats)} "
        f"{json.dumps(qstats)} {json.dumps(sstats)} {json.dumps(estats)} {json.dumps(dstats)} "
        f"{json.dumps(gstats)} {json.dumps(mstats)} {json.dumps(tstats)} {json.dumps(tmstats)} "
        f"{json.dumps(astats, default=str)} "
        f"launches={json.dumps(counts)} total {time.time() - t_start:.1f}s")
    if not (ok_kernel and ok_fp32 and ok_full and ok_quant and ok_serve and ok_entry
            and ok_draft and ok_fam and ok_train and ok_par and ok_mesh and ok_apps):
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
    for name, case, line in (("paged_decode_attention", "paged_decode_7b_t1_bf16", 331),
                             ("paged_decode_attention_q8", "paged_decode_q8_7b_t1_bf16", 238)):
        r = pres[case]
        kernels.append(dict(
            name=name, route="cuda", source="layerskip_tpu_torch/csrc/paged_decode.cu",
            replaces=f"layerskip_tpu/ops/pallas/paged_decode.py:{line}",
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
    if sys.argv[1:2] == ["--phase12"]:
        sys.exit(phase12_rank(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--phase13"]:
        sys.exit(phase13_rank(sys.argv[2], sys.argv[3]))
    sys.exit(main())
