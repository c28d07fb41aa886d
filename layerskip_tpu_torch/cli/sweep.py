"""Grid sweep over exit_layer x num_speculations (port of
``layerskip_tpu/cli/sweep.py``): how LayerSkip picks the exit layer and W.

Each cell runs the dataset benchmark (``cli/benchmark.py``) with
self-speculative decoding; the CSV is rewritten after every cell, so an
interrupted sweep keeps its rows. At the end a table (when ``tabulate`` is
installed) and a contour PDF of tokens/s (matplotlib's Agg backend and
scipy's ``griddata``; skipped, with the reason printed, where they are
missing). The model is loaded once.

Usage:
  python -m layerskip_tpu_torch.cli.sweep --model <dir|random:preset> \
      --dataset custom_jsonl --data_path prompts.jsonl --num_samples 2 \
      --exit_layer_first 4 --exit_layer_last 8 --exit_layer_step 4 \
      --num_speculations_first 2 --num_speculations_last 6 \
      --num_speculations_step 4 --max_steps 32
  (add --device cpu to run on the CPU)
"""

from __future__ import annotations

import csv
import dataclasses
import os
import time

from layerskip_tpu_torch.cli.args import Arguments, parse_dataclasses
from layerskip_tpu_torch.cli.benchmark import BenchmarkArguments, benchmark
from layerskip_tpu_torch.cli.loading import coordinator_only, load_from_args, mesh_from_args
from layerskip_tpu_torch.config import GenerationConfig
from layerskip_tpu_torch.generation.generator import LlamaGenerator
from layerskip_tpu_torch.parallel.distributed import is_coordinator


@dataclasses.dataclass
class SweepArguments:
    """LayerSkip sweep.py:27-34 (the same flag names and defaults)."""

    exit_layer_first: int = 1
    exit_layer_last: int = 15
    exit_layer_step: int = 1
    num_speculations_first: int = 1
    num_speculations_last: int = 6
    num_speculations_step: int = 1


FIELDS = [
    "exit_layer", "num_speculations", "acceptance_rate", "total_time",
    "time_per_token", "tokens_per_second",
]


def sweep(args: Arguments, bench_args: BenchmarkArguments, sweep_args: SweepArguments,
          gen_cfg: GenerationConfig):
    params, cfg, tokenizer = load_from_args(args)
    generator = LlamaGenerator(tokenizer, params, cfg, device=args.device,
                               mesh=mesh_from_args(args))
    coordinator_only()
    coordinator = is_coordinator()

    os.makedirs(args.output_dir, exist_ok=True)
    csv_path = os.path.join(args.output_dir, f"sweep_{int(time.time())}.csv")
    rows = []
    gen_cfg = dataclasses.replace(gen_cfg, generation_strategy="self_speculative")
    max_exit = min(sweep_args.exit_layer_last, cfg.num_hidden_layers - 1)
    for exit_layer in range(sweep_args.exit_layer_first, max_exit + 1,
                            sweep_args.exit_layer_step):
        for num_spec in range(sweep_args.num_speculations_first,
                              sweep_args.num_speculations_last + 1,
                              sweep_args.num_speculations_step):
            cell_cfg = dataclasses.replace(gen_cfg, exit_layer=exit_layer,
                                           num_speculations=num_spec)
            metric_result, _ = benchmark(generator, bench_args, cell_cfg, args.seed)
            row = {"exit_layer": exit_layer, "num_speculations": num_spec,
                   **{k: metric_result[k]["mean"] for k in FIELDS[2:]}}
            rows.append(row)
            if coordinator:  # the whole CSV again after every cell
                with open(csv_path, "w", newline="") as f:
                    w = csv.DictWriter(f, fieldnames=FIELDS)
                    w.writeheader()
                    w.writerows(rows)
            print(f"exit={exit_layer} spec={num_spec}: "
                  f"{row['tokens_per_second']:.2f} tok/s")
    if not coordinator:
        return rows

    try:
        from tabulate import tabulate

        print(tabulate(rows, headers="keys", floatfmt=".3f"))
    except ImportError:
        pass
    pdf_path = csv_path.replace(".csv", ".pdf")
    try:
        plot_contour(rows, pdf_path)
        print(f"wrote {pdf_path}")
    except Exception as e:  # noqa: BLE001 - the plot is optional; the CSV is the result
        print(f"contour plot skipped: {e}")
    print(f"wrote {csv_path}")
    return rows


def plot_contour(rows, pdf_path: str):
    """tokens/s contour over the grid (LayerSkip sweep.py:76-95)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np
    from scipy.interpolate import griddata

    x = np.array([r["exit_layer"] for r in rows], float)
    y = np.array([r["num_speculations"] for r in rows], float)
    z = np.array([r["tokens_per_second"] for r in rows], float)
    xi = np.linspace(x.min(), x.max(), 100)
    yi = np.linspace(y.min(), y.max(), 100)
    zi = griddata((x, y), z, (xi[None, :], yi[:, None]), method="cubic")
    fig, ax = plt.subplots()
    c = ax.contourf(xi, yi, zi, levels=14)
    fig.colorbar(c, label="tokens/s")
    ax.set_xlabel("exit_layer")
    ax.set_ylabel("num_speculations")
    fig.savefig(pdf_path)
    plt.close(fig)


if __name__ == "__main__":
    sweep(*parse_dataclasses((Arguments, BenchmarkArguments, SweepArguments,
                              GenerationConfig)))
