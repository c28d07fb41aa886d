"""Dataset benchmark: generate over a task set, aggregate quality and speed
(port of ``layerskip_tpu/cli/benchmark.py``).

The same flags, flow and metric schema: get_data -> one ``generate`` per
example -> ``EvaluationMetrics`` -> one valid JSON file with four sections
(``args``, ``benchmark_arguments``, ``generation_config``,
``metric_result``) in ``--output_dir``.

Usage:
  python -m layerskip_tpu_torch.cli.benchmark --model <dir|random:preset> \
      --dataset custom_jsonl --data_path prompts.jsonl --num_samples 4 \
      --generation_strategy self_speculative --exit_layer 8 --num_speculations 6
  (add --device cpu to run on the CPU)

With ``--tp`` / ``--dp`` above 1 it runs as that many ranks: rank 0 reads
the dataset and broadcasts it, and only rank 0 prints and writes.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Optional

from layerskip_tpu_torch.cli.args import Arguments, parse_dataclasses
from layerskip_tpu_torch.cli.loading import coordinator_only, load_from_args, mesh_from_args
from layerskip_tpu_torch.config import GenerationConfig
from layerskip_tpu_torch.data import get_data
from layerskip_tpu_torch.generation.generator import LlamaGenerator
from layerskip_tpu_torch.metrics import EvaluationMetrics
from layerskip_tpu_torch.parallel.collectives import broadcast_object
from layerskip_tpu_torch.parallel.distributed import is_coordinator

log = logging.getLogger(__name__)


@dataclasses.dataclass
class BenchmarkArguments:
    dataset: str = "cnn_dm_summarization"
    data_path: Optional[str] = None
    random_shuffle: bool = True
    num_samples: Optional[int] = None
    n_shot: int = 0
    template: Optional[str] = None
    profile_dir: Optional[str] = None  # write a torch.profiler trace here


def benchmark(generator: LlamaGenerator, benchmark_arguments: BenchmarkArguments,
              generation_config: GenerationConfig, seed: int = 42):
    """(metrics dict, metrics object) of one pass over the dataset (rank
    0's, broadcast to every rank of a sharded run)."""
    evaluation_set = broadcast_object(get_data(
        random_shuffle=benchmark_arguments.random_shuffle,
        num_samples=benchmark_arguments.num_samples,
        dataset=benchmark_arguments.dataset,
        data_path=benchmark_arguments.data_path,
        n_shot=benchmark_arguments.n_shot,
        seed=seed,
        template=benchmark_arguments.template,
    ) if is_coordinator() else None)
    metrics = EvaluationMetrics.build_metrics()
    profiling = None
    if benchmark_arguments.profile_dir:
        from layerskip_tpu_torch.utils.profiling import trace

        profiling = trace(benchmark_arguments.profile_dir)
        profiling.__enter__()
    try:
        for i, example in enumerate(evaluation_set):
            result = generator.generate(prompt=example.input,
                                        generation_config=generation_config, seed=seed)
            print(f"[{i + 1}/{len(evaluation_set)}] tokens={result.num_tokens_generated} "
                  f"tok/s={result.tokens_per_second:.2f}")
            if not result.decoded_prediction:
                log.warning("skipping empty generation for metrics")
                continue
            metrics.update(example, result)
    finally:
        if profiling is not None:
            profiling.__exit__(None, None, None)
            print(f"profiler trace written to {benchmark_arguments.profile_dir}")
    return metrics.compute(), metrics


def main(args: Arguments, bench_args: BenchmarkArguments, gen_cfg: GenerationConfig):
    params, cfg, tokenizer = load_from_args(args)
    generator = LlamaGenerator(tokenizer, params, cfg, device=args.device,
                               mesh=mesh_from_args(args))
    coordinator_only()
    metric_result, _ = benchmark(generator, bench_args, gen_cfg, args.seed)
    if not is_coordinator():
        return metric_result

    os.makedirs(args.output_dir, exist_ok=True)
    out_path = os.path.join(args.output_dir, f"benchmark_{int(time.time())}.json")
    with open(out_path, "w") as f:
        json.dump({
            "args": dataclasses.asdict(args),
            "benchmark_arguments": dataclasses.asdict(bench_args),
            "generation_config": dataclasses.asdict(gen_cfg),
            "metric_result": metric_result,
        }, f, indent=2)
    print(json.dumps(metric_result, indent=2))
    print(f"wrote {out_path}")
    return metric_result


if __name__ == "__main__":
    main(*parse_dataclasses((Arguments, BenchmarkArguments, GenerationConfig)))
