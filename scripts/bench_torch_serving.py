"""Serving throughput of the port: continuous against gather batching.

Usage: python scripts/bench_torch_serving.py [--config 1b] [--batch 8]
       [--requests 32] [--max-steps 128] [--quant] [--paged] [--prefix-cache]
       [--system-len N] [--kv-quant] [--skip-gather] [--device cuda|cpu]

Streams N requests through the port's schedulers (``serving.py``) over a
random-weights model of the config (``make_random_params``, seed 0,
identity tail past the exit layer) and prints aggregate tokens/s for each:
stderr carries the progress, stdout one JSON line whose keys and metric name
are those of the JAX package's ``scripts/bench_serving.py``. ``--paged``
also runs paged-KV continuous batching at twice the slots inside the static
scheduler's KV token budget (and ``--prefix-cache`` once more with prompt
prefixes shared). Runs on the card unless ``--device cpu``; ``main(argv)``
runs it in-process.
"""

import argparse
import dataclasses
import json
import os
import random
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="1b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--max-steps", type=int, default=128)
    ap.add_argument("--exit-layer", type=int, default=8)
    ap.add_argument("--spec", type=int, default=6)
    ap.add_argument("--tree-width", type=int, default=0,
                    help="multi-candidate speculation width (composes with "
                         "--paged/--kv-quant; greedy)")
    ap.add_argument("--quant", action="store_true", help="int8 weight-only base")
    ap.add_argument("--draft-quant", type=int, default=0, choices=(0, 8, 4),
                    help="draft with an int8/int4 copy of the early layers; "
                         "verify stays full precision")
    ap.add_argument("--varied", action="store_true",
                    help="heterogeneous per-request token budgets (32..max)")
    ap.add_argument("--paged", action="store_true",
                    help="also run paged-KV continuous at 2x the slots inside the "
                         "SAME KV token budget as the static continuous scheduler")
    ap.add_argument("--page-size", type=int, default=128)
    ap.add_argument("--paged-pool-tokens", type=int, default=0,
                    help="override the paged pool size (tokens); default = the "
                         "static scheduler's total KV token capacity")
    ap.add_argument("--skip-gather", action="store_true")
    ap.add_argument("--skip-static", action="store_true",
                    help="paged only (e.g. when static slots cannot fit)")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache (composes with --paged)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="paged runs also measured with prompt-prefix KV sharing "
                         "(requires --paged)")
    ap.add_argument("--system-len", type=int, default=0,
                    help="shared system-prompt tokens prepended to every request "
                         "(the prefix-cache target)")
    ap.add_argument("--prompt-bucket", type=int, default=64)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--budget-min", type=int, default=32)
    ap.add_argument("--paged-slots", type=int, default=0,
                    help="paged slot count (default 2x --batch)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from layerskip_tpu_torch.bench import build_config
    from layerskip_tpu_torch.config import GenerationConfig
    from layerskip_tpu_torch.generation.engine import Engine
    from layerskip_tpu_torch.models.params import make_random_params
    from layerskip_tpu_torch.quant import quantize_llama_params
    from layerskip_tpu_torch.serving import BatchScheduler, ContinuousBatchScheduler

    cfg = build_config(args.config)
    exit_layer = min(args.exit_layer, max(cfg.num_hidden_layers // 2, 1))
    params = make_random_params(cfg, exit_layer, seed=0, device=args.device)
    if args.quant:
        params = quantize_llama_params(params, bits=8)
    engine = Engine(params, cfg, device=args.device)
    gen = GenerationConfig(
        max_steps=args.max_steps, sample=False, generation_strategy="self_speculative",
        exit_layer=exit_layer, num_speculations=args.spec, kv_quant=args.kv_quant,
        spec_tree_width=args.tree_width, draft_quant=args.draft_quant)
    system = list(range(7, 7 + args.system_len))  # shared across requests
    prompts = [system + list(range(5 + i % 7, 5 + i % 7 + args.prompt_len))
               for i in range(args.requests)]
    if args.varied:
        rnd = random.Random(0)
        budgets = [rnd.randrange(args.budget_min, args.max_steps + 1) for _ in prompts]
    else:
        budgets = [0] * len(prompts)  # 0 => full max_steps

    def run(submit):
        submit(prompts[0], 0).result(timeout=2400)  # warm-up
        t0 = time.time()
        futs = [submit(p, bdg) for p, bdg in zip(prompts, budgets)]
        total = sum(len(f.result(timeout=2400)) for f in futs)
        return total, total / (time.time() - t0)

    pb = args.prompt_bucket
    served = {}  # scheduler -> tokens served in its timed run
    paged_tps = prefix_tps = prefix_stats = None
    if args.paged:
        # more slots, the pool capped at the token capacity the static
        # continuous scheduler reserves (batch x (2*pb + steps + W + 2))
        spec_slack = args.spec * max(args.tree_width, 1)
        static_tokens = args.batch * (2 * pb + args.max_steps + spec_slack + 2)
        pool_pages = (args.paged_pool_tokens or static_tokens) // args.page_size
        slots = args.paged_slots or 2 * args.batch

        def run_paged(prefix_cache):
            sched = ContinuousBatchScheduler(
                engine, gen, batch_size=slots, prompt_bucket=pb,
                paged_pool_pages=pool_pages, page_size=args.page_size,
                prefix_cache=prefix_cache).start()
            try:
                total, tps = run(lambda p, bdg: sched.submit(p, max_tokens=bdg))
                pc = sched.session.prefix_cache
                stats = {"hits": pc.hits, "hit_tokens": pc.hit_tokens} if pc else None
            finally:
                sched.stop()
            return total, tps, stats

        served["paged"], paged_tps, _ = run_paged(False)
        print(f"[serve] paged({slots} slots): {paged_tps:.1f} tok/s "
              f"(pool={pool_pages}x{args.page_size})", file=sys.stderr)
        if args.prefix_cache:
            served["paged_prefix_cache"], prefix_tps, prefix_stats = run_paged(True)
            print(f"[serve] paged+prefix-cache: {prefix_tps:.1f} tok/s {prefix_stats}",
                  file=sys.stderr)

    cont_tps = gather_tps = None
    if not args.skip_static:
        cont = ContinuousBatchScheduler(engine, gen, batch_size=args.batch,
                                        prompt_bucket=pb).start()
        try:
            served["continuous"], cont_tps = run(
                lambda p, bdg: cont.submit(p, max_tokens=bdg))
            print(f"[serve] continuous: {cont_tps:.1f} tok/s", file=sys.stderr)
        finally:
            cont.stop()

    if not args.skip_gather:
        gather = BatchScheduler(engine, batch_size=args.batch).start()
        try:
            # gather expresses per-request budgets as distinct configs (its
            # only mechanism): heterogeneous budgets fragment its batches
            served["gather"], gather_tps = run(lambda p, bdg: gather.submit(
                p, dataclasses.replace(gen, max_steps=bdg) if bdg else gen))
            print(f"[serve] gather:     {gather_tps:.1f} tok/s", file=sys.stderr)
        finally:
            gather.stop()

    print(f"[serve] tokens served per timed run: {json.dumps(served)}", file=sys.stderr)
    line = {
        "metric": (f"serving_tokens_per_s_{args.config}_b{args.batch}"
                   + ("_varied" if args.varied else "")),
        **({"continuous": round(cont_tps, 1)} if cont_tps is not None else {}),
        **({"gather": round(gather_tps, 1)} if gather_tps is not None else {}),
        "unit": "tok/s",
        **({"paged": round(paged_tps, 1)} if paged_tps is not None else {}),
        **({"paged_prefix_cache": round(prefix_tps, 1), "prefix_stats": prefix_stats}
           if prefix_tps is not None else {}),
    }
    print(json.dumps(line), flush=True)
    return dict(line, served=served)


if __name__ == "__main__":
    main()
