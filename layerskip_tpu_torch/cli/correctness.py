"""Greedy equivalence check: self-speculative output against autoregressive
(port of ``layerskip_tpu/cli/correctness.py``).

Runs every prompt through greedy self-spec and through greedy AR forced to
the full model, counts the decoded texts that differ, and writes
``{total_errors, error_pct}`` as JSON to ``--output_dir``. Takes the
benchmark's flags (``--dataset``, ``--data_path``, ...). With ``--tp`` /
``--dp`` above 1 rank 0 reads the dataset and broadcasts it, and only rank 0
prints and writes.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time

from layerskip_tpu_torch.cli.args import Arguments, parse_dataclasses
from layerskip_tpu_torch.cli.benchmark import BenchmarkArguments
from layerskip_tpu_torch.cli.loading import coordinator_only, load_from_args, mesh_from_args
from layerskip_tpu_torch.config import GenerationConfig
from layerskip_tpu_torch.data import get_data
from layerskip_tpu_torch.generation.generator import LlamaGenerator
from layerskip_tpu_torch.parallel.collectives import broadcast_object
from layerskip_tpu_torch.parallel.distributed import is_coordinator

log = logging.getLogger(__name__)


def main(args: Arguments, bench_args: BenchmarkArguments, gen_cfg: GenerationConfig):
    params, cfg, tokenizer = load_from_args(args)
    generator = LlamaGenerator(tokenizer, params, cfg, device=args.device,
                               mesh=mesh_from_args(args))
    coordinator_only()

    spec_cfg = dataclasses.replace(gen_cfg, generation_strategy="self_speculative",
                                   sample=False)
    ar_cfg = dataclasses.replace(gen_cfg, generation_strategy="autoregressive",
                                 sample=False, exit_layer=-1, num_speculations=-1)

    evaluation_set = broadcast_object(get_data(
        random_shuffle=bench_args.random_shuffle,
        num_samples=bench_args.num_samples,
        dataset=bench_args.dataset,
        data_path=bench_args.data_path,
        n_shot=bench_args.n_shot,
        seed=args.seed,
        template=bench_args.template,
    ) if is_coordinator() else None)
    errors = 0
    for i, example in enumerate(evaluation_set):
        spec = generator.generate(example.input, spec_cfg, seed=args.seed)
        ar = generator.generate(example.input, ar_cfg, seed=args.seed)
        if spec.decoded_prediction != ar.decoded_prediction:
            errors += 1
            log.error("mismatch on sample %d:\n  spec: %r\n  ar:   %r",
                      i, spec.decoded_prediction, ar.decoded_prediction)
    n = len(evaluation_set)
    result = {"total_errors": errors, "error_pct": 100.0 * errors / max(n, 1)}
    if not is_coordinator():
        return result
    os.makedirs(args.output_dir, exist_ok=True)
    out_path = os.path.join(args.output_dir, f"correctness_{int(time.time())}.json")
    with open(out_path, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main(*parse_dataclasses((Arguments, BenchmarkArguments, GenerationConfig)))
