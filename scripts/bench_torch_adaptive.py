"""Adaptive drafting of the port: spec tok/s against ``draft_exit_prob`` at
fixed acceptance operating points.

For each ``--eps`` (``tail_eps``: the output projections past the exit layer
scaled by it, which dials acceptance; ``make_random_params``, seed 0) and
each ``--taus`` threshold it measures the self-speculative rate with
confidence-adaptive drafting (tau 0 is static drafting), beside the AR
baseline on the first eps's weights. Prints one JSON line with the keys of
the JAX package's ``scripts/bench_adaptive.py``; stderr carries the
progress. ``main(argv)`` runs it in-process.

Usage: python scripts/bench_torch_adaptive.py [--config 7b] [--eps 0.021 0.05]
       [--taus 0 0.4 0.7] [--max-steps 512] [--device cuda|cpu]
"""

import argparse
import gc
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="7b")
    ap.add_argument("--exit-layer", type=int, default=8)
    ap.add_argument("--spec", type=int, default=6)
    ap.add_argument("--max-steps", type=int, default=512)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--eps", type=float, nargs="+", default=[0.021, 0.05])
    ap.add_argument("--taus", type=float, nargs="+", default=[0.0, 0.4, 0.7])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    import torch

    from layerskip_tpu_torch.bench import build_config, timed_generate
    from layerskip_tpu_torch.config import GenerationConfig
    from layerskip_tpu_torch.generation.engine import Engine
    from layerskip_tpu_torch.models.params import make_random_params

    cfg = build_config(args.config)
    exit_layer = min(args.exit_layer, max(cfg.num_hidden_layers // 2, 1))

    def build(eps):
        return make_random_params(cfg, exit_layer, tail_eps=eps, seed=0, device=args.device)

    engine = Engine(build(args.eps[0]), cfg, device=args.device)
    prompt = list(range(5, 5 + args.prompt_len))

    def timed(gen_cfg):
        tps, out = timed_generate(engine, prompt, gen_cfg, args.repeats)
        return tps, float(int(out.matches)) / max(int(out.drafts), 1), int(out.drafts)

    ar_tps, _, _ = timed(GenerationConfig(max_steps=args.max_steps, sample=False,
                                          generation_strategy="autoregressive"))
    print(f"[adaptive] AR {ar_tps:.1f} tok/s", file=sys.stderr)

    points = []
    for eps in args.eps:
        engine.params = None  # two sets of weights need not fit side by side
        gc.collect()
        if engine.device.type == "cuda":
            torch.cuda.empty_cache()
        engine.params = build(eps)
        for tau in args.taus:
            tps, acc, drafts = timed(GenerationConfig(
                max_steps=args.max_steps, sample=False,
                generation_strategy="self_speculative", exit_layer=exit_layer,
                num_speculations=args.spec, draft_exit_prob=tau))
            points.append({"tail_eps": eps, "tau": tau, "acceptance": round(acc, 4),
                           "spec_tokens_per_s": round(tps, 2),
                           "speedup": round(tps / ar_tps, 4), "total_drafts": drafts})
            print(f"[adaptive] eps={eps} tau={tau}: {tps:.1f} tok/s acc={acc:.3f} "
                  f"drafts={drafts} ({tps / ar_tps:.2f}x)", file=sys.stderr)

    line = {"metric": f"adaptive_draft_{args.config}", "ar_tokens_per_s": round(ar_tps, 2),
            "unit": "tok/s", "points": points}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
