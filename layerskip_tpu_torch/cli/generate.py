"""Interactive generation REPL (port of ``layerskip_tpu/cli/generate.py``).

Reads prompts from stdin until EOF, generates with the chosen strategy and
prints timing and acceptance to stderr. ``--streamer none|standard|
speculative``: the speculative streamer paints each round's drafts and
repaints the accepted tokens, through ``Engine.stream_generate``'s
per-round callback. ``--warmup`` (default on) runs one generation before
the first prompt; on the card that builds the kernels and warms cuBLAS.

Usage:
  python -m layerskip_tpu_torch.cli.generate --model <dir|random:preset> \
      --generation_strategy self_speculative --exit_layer 8 --num_speculations 6
  (add --device cpu to run on the CPU)

With ``--tp`` / ``--dp`` above 1 it runs as that many ranks (``torchrun
--nproc-per-node N -m layerskip_tpu_torch.cli.generate ...``, or the
port's launcher): rank 0 reads stdin and broadcasts each prompt, and only
rank 0 prints.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import torch
import torch.distributed as dist

from layerskip_tpu_torch.cli.args import Arguments, parse_dataclasses
from layerskip_tpu_torch.cli.loading import coordinator_only, load_from_args, mesh_from_args
from layerskip_tpu_torch.config import GenerationConfig
from layerskip_tpu_torch.generation.engine import postprocess_output
from layerskip_tpu_torch.generation.generator import LlamaGenerator, make_result
from layerskip_tpu_torch.generation.streamer import SpeculativeTextStreamer, TextStreamer
from layerskip_tpu_torch.parallel.collectives import broadcast_object
from layerskip_tpu_torch.parallel.distributed import is_coordinator


@dataclasses.dataclass
class GenerateArguments:
    streamer: str = "none"  # none | standard | speculative
    chat: bool = False  # wrap prompts with the tokenizer's chat template
    warmup: bool = True  # one generation before the REPL


def _apply_chat_template(tokenizer, user_message: str) -> str:
    """Wrap a raw message with the model's chat template when it has one."""
    if hasattr(tokenizer, "apply_chat_template"):
        try:
            return tokenizer.apply_chat_template(
                [{"role": "user", "content": user_message}],
                tokenize=False, add_generation_prompt=True,
            )
        except (ValueError, TypeError):  # a tokenizer without a template
            pass
    return user_message


def _prompts():
    """stdin's lines; with several ranks rank 0's, broadcast line by line."""
    if not dist.is_initialized():
        yield from sys.stdin
        return
    while True:
        line = broadcast_object(sys.stdin.readline() if is_coordinator() else None)
        if not line:
            return
        yield line


def main(args: Arguments, gen_args: GenerateArguments, gen_cfg: GenerationConfig):
    params, cfg, tokenizer = load_from_args(args)
    generator = LlamaGenerator(tokenizer, params, cfg, device=args.device,
                               mesh=mesh_from_args(args))
    coordinator_only()

    use_spec_stream = (gen_args.streamer == "speculative"
                       and gen_cfg.generation_strategy == "self_speculative")
    if gen_args.warmup:
        t0 = time.time()
        print("warming up (one generation)...", file=sys.stderr)
        generator.generate("warmup", gen_cfg, seed=args.seed)
        print(f"warmup done in {time.time() - t0:.1f}s", file=sys.stderr)
    print("Enter a prompt (Ctrl-D to exit):", file=sys.stderr)
    for line in _prompts():
        prompt = line.rstrip("\n")
        if not prompt:
            continue
        if gen_args.chat:
            prompt = _apply_chat_template(tokenizer, prompt)
        if use_spec_stream:
            result = _stream_speculative(generator, prompt, gen_cfg, args.seed)
        else:
            streamer = TextStreamer(tokenizer) if gen_args.streamer == "standard" else None
            result = generator.generate(prompt, gen_cfg, streamer=streamer, seed=args.seed)
            if streamer is None:
                print(result.decoded_prediction)
        acc = result.generation_strategy_result.acceptance_rate
        print(
            f"\n[time: {result.total_time:.2f}s  tokens: "
            f"{result.num_tokens_generated}  tok/s: {result.tokens_per_second:.2f}"
            + (f"  acceptance: {acc:.3f}]" if acc is not None else "]"),
            file=sys.stderr,
        )


def _stream_speculative(generator: LlamaGenerator, prompt: str,
                        gen_cfg: GenerationConfig, seed: int):
    """Draft paint / repaint streaming through per-round callbacks."""
    streamer = SpeculativeTextStreamer(generator.tokenizer)
    engine = generator.engine
    eos = generator.eos_ids

    def on_round(drafted, accepted):
        if drafted:
            streamer.put(drafted, is_draft=True)
            streamer.delete(len(drafted))
        streamer.put(accepted)

    start = time.time()
    out = engine.stream_generate(
        generator._encode(prompt), gen_cfg,
        torch.Generator(device=engine.device).manual_seed(seed), eos, on_round=on_round)
    tokens = postprocess_output(out, eos, gen_cfg.max_steps)
    total = time.time() - start
    streamer.end()
    return make_result(generator.tokenizer, tokens,
                       int(out.matches) / max(int(out.drafts), 1), total)


def process_cli_arguments():
    return parse_dataclasses((Arguments, GenerateArguments, GenerationConfig))


if __name__ == "__main__":
    main(*process_cli_arguments())
