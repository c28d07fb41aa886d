"""Long-context generation of the port: AR and self-speculative decoding
after a ~30k-token prompt.

The prompt's prefill runs through the flash-prefill kernel (K1) in one
block of ``--ctx`` queries over the whole cache; without it the masked path
would need an fp32 score tensor of ctx x ctx per head. The sequence cap is
``ctx + max_steps + W + 64``, past the model's ``max_position_embeddings``
where ``--ctx`` is (``GenerationConfig.max_seq_len`` sets the cap, as in the
JAX package's engine).

Prints one JSON line with the keys of the JAX package's
``scripts/bench_longctx.py`` (best tok/s of ``--repeats`` runs after a
warm-up run); stderr carries the progress and, on the card, the peak device
memory. ``main(argv)`` runs it in-process.

Usage: python scripts/bench_torch_longctx.py [--config 1b] [--ctx 30720]
       [--max-steps 128] [--repeats 2] [--device cuda|cpu]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="1b")
    ap.add_argument("--ctx", type=int, default=30720)
    ap.add_argument("--max-steps", type=int, default=128)
    ap.add_argument("--exit-layer", type=int, default=8)
    ap.add_argument("--spec", type=int, default=6)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    import numpy as np
    import torch

    from layerskip_tpu_torch.bench import build_config, timed_generate
    from layerskip_tpu_torch.config import GenerationConfig
    from layerskip_tpu_torch.generation.engine import Engine, postprocess_output
    from layerskip_tpu_torch.models.params import make_random_params

    cfg = build_config(args.config)
    exit_layer = min(args.exit_layer, max(cfg.num_hidden_layers // 2, 1))
    engine = Engine(make_random_params(cfg, exit_layer, seed=0, device=args.device), cfg,
                    device=args.device)
    prompt = (np.arange(args.ctx) % (cfg.vocab_size - 7) + 3).tolist()
    seq_cap = args.ctx + args.max_steps + args.spec + 64
    on_card = engine.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    def timed(gen_cfg):
        tps, out = timed_generate(engine, prompt, gen_cfg, args.repeats)
        return tps, postprocess_output(out, (), gen_cfg.max_steps)

    ar, ar_toks = timed(GenerationConfig(
        max_steps=args.max_steps, sample=False, generation_strategy="autoregressive",
        max_seq_len=seq_cap))
    sp, sp_toks = timed(GenerationConfig(
        max_steps=args.max_steps, sample=False, generation_strategy="self_speculative",
        exit_layer=exit_layer, num_speculations=args.spec, max_seq_len=seq_cap))
    peak = torch.cuda.max_memory_allocated() if on_card else None
    print(f"[longctx] AR {ar:.1f} / spec {sp:.1f} tok/s; greedy spec == AR: "
          f"{sp_toks == ar_toks} ({len(ar_toks)} tokens); peak device memory "
          f"{'not measured (cpu)' if peak is None else f'{peak / 1e9:.2f} GB'}",
          file=sys.stderr)
    line = {
        "metric": f"longctx_decode_{args.config}_ctx{args.ctx}",
        "unit": "tok/s",
        "ar_tokens_per_s": round(ar, 2),
        "spec_tokens_per_s": round(sp, 2),
        "spec_speedup": round(sp / max(ar, 1e-9), 3),
    }
    print(json.dumps(line), flush=True)
    return dict(line, ar_tokens=ar_toks, spec_tokens=sp_toks, peak_bytes=peak)


if __name__ == "__main__":
    main()
