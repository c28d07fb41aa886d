"""Chunked-prefill latency of the port: the worst in-flight stall during
admission.

Measures the largest inter-token gap of a "victim" stream that decodes while
a LONG prompt is admitted into the other slot of a two-slot continuous
session: plain whole-prompt ``insert`` against
``ContinuousSession.begin_chunked_insert``. The chunked stall should be
bounded by one chunk's prefill; the plain stall is the whole prompt's. The
aggregate tokens/s of both rows is reported beside it, since admission by
chunks runs more, smaller passes.

Usage: python scripts/bench_torch_chunked.py [--config 1b] [--prompt-bucket 1024]
       [--chunk 128] [--long-prompt 1024] [--max-steps 96] [--device cuda|cpu]
stdout: one JSON line (the keys of the JAX package's
``scripts/bench_chunked.py``); stderr: progress. ``main(argv)`` runs it
in-process.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def run_once(engine, gen_cfg, bucket, long_prompt, chunk, warm):
    """(victim's largest inter-commit gap s, total tokens, wall s, finished
    rows). Every ``step`` reads the session's counters on the host, so the
    clock between steps covers the device work."""
    sess = engine.continuous_session(gen_cfg, batch=2, prompt_bucket=bucket)
    sess.insert([0], [[5, 9, 13, 17]], seeds=[0])
    for _ in range(3):  # the victim gets going
        sess.step()
    t0 = time.perf_counter()
    if chunk:
        sess.begin_chunked_insert([1], [long_prompt], seeds=[1], chunk_tokens=chunk)
    gaps, last = [], time.perf_counter()
    prev_len = int(sess._out_len[0])
    inserted = bool(chunk)
    done = set()
    total_toks = 0
    t_end = t0
    for _ in range(600):
        if not inserted:
            # a plain insert runs inline before the next round: the stall a
            # scheduler imposes
            sess.insert([1], [long_prompt], seeds=[1])
            inserted = True
        for r, toks, _ in sess.step():
            done.add(r)
            total_toks += len(toks)
            t_end = time.perf_counter()
        now = time.perf_counter()
        cur = int(sess._out_len[0])
        if cur > prev_len and 0 not in done:
            gaps.append((now - last) / max(cur - prev_len, 1))
            prev_len = cur
            last = now
        if len(done) == 2:
            break
    if warm:
        print(f"[chunked] chunk={chunk}: victim gaps ms "
              f"{[round(g * 1e3, 1) for g in gaps[:12]]}", file=sys.stderr)
    return (max(gaps) if gaps else 0.0), total_toks, t_end - t0, done


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="1b")
    ap.add_argument("--prompt-bucket", type=int, default=1024)
    ap.add_argument("--chunk", type=int, default=128)
    ap.add_argument("--long-prompt", type=int, default=1024)
    ap.add_argument("--max-steps", type=int, default=96)
    ap.add_argument("--exit-layer", type=int, default=8)
    ap.add_argument("--spec", type=int, default=6)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from layerskip_tpu_torch.bench import build_config
    from layerskip_tpu_torch.config import GenerationConfig
    from layerskip_tpu_torch.generation.engine import Engine
    from layerskip_tpu_torch.models.params import make_random_params

    cfg = build_config(args.config)
    exit_layer = min(args.exit_layer, max(cfg.num_hidden_layers // 2, 1))
    engine = Engine(make_random_params(cfg, exit_layer, seed=0, device=args.device), cfg,
                    device=args.device)
    gen_cfg = GenerationConfig(
        generation_strategy="self_speculative", exit_layer=exit_layer,
        num_speculations=args.spec, max_steps=args.max_steps, sample=False)
    long_prompt = [7 + (i % 97) for i in range(args.long_prompt)]

    results = {}
    for chunk in (0, args.chunk):
        # a cold run first, then the measured one
        run_once(engine, gen_cfg, args.prompt_bucket, long_prompt, chunk, warm=False)
        stall, toks, wall, done = run_once(engine, gen_cfg, args.prompt_bucket,
                                           long_prompt, chunk, warm=True)
        key = "chunked" if chunk else "plain"
        results[f"stall_ms_{key}"] = round(stall * 1e3, 2)
        results[f"agg_tok_per_s_{key}"] = round(toks / max(wall, 1e-9), 1)
        print(f"[chunked] {key}: worst victim inter-token gap {stall * 1e3:.1f} ms, "
              f"aggregate {results[f'agg_tok_per_s_{key}']} tok/s "
              f"(finished rows: {sorted(done)})", file=sys.stderr)
    line = {
        "metric": f"admission_stall_ms_{args.config}",
        "value": results["stall_ms_chunked"],
        "unit": "ms",
        "vs_baseline": (round(results["stall_ms_plain"] / results["stall_ms_chunked"], 3)
                        if results["stall_ms_chunked"] else 0.0),
        **results,
        "chunk_tokens": args.chunk,
        "long_prompt": args.long_prompt,
        "backend": engine.device.type,
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
