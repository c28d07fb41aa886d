"""Readings for setting a cell's rate, ``tail_eps`` and limits, many in one
process (the kernels built and loaded once), one JSON line each:

    python3 -m loadbench.tools.calibrate --workload <cell> --seeds 1,2,3 \
        --seconds 20 [--rates 2,3,4] [--tail-eps 0.01,0.0124] [--control] \
        [--out chiprun_out/<file>.jsonl]

For every tail_eps x rate x seed it makes the seed's weights, runs the
cell's entry over the cell's traffic at that rate (ramp, window, tail, as a
benchmark run does) and prints the end-to-end metrics, the acceptance, the
backlog's growth (the median latency of the window's last third over its
first third) and the numbers compared. ``--control`` also judges the
control in the program's place (the family's plain reference computed in
float8 puts the tokens first, ``check.control_tokens``) through the same
``judge`` and ``result_line``, and prints its ``correct`` and numbers
under ``control``. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
import time

from loadbench import catalog
from loadbench import run as bench


def _floats(s: str) -> list:
    return [float(x) for x in s.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", default="")
    ap.add_argument("--tail-eps", default="")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    bench.pin_caches()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = catalog.cell(args.workload)
    rates = _floats(args.rates) or [float(cell.settings.get("rate_rps", 0.0))]
    epss = _floats(args.tail_eps) or [cell.tail_eps]
    family = catalog.load_module("families", cell.family)
    kind = catalog.load_module("traffic/kinds", cell.traffic["kind"])
    entry = catalog.load_module("entries", cell.entry)
    sink = open(args.out, "a") if args.out else None
    for eps in epss:
        cell.config["layerskip"]["tail_eps"] = eps
        for rate in rates:
            cell.settings["rate_rps"] = rate
            for seed in [int(x) for x in args.seeds.split(",")]:
                t0 = time.perf_counter()
                weights = family.make_weights(cell.config, cell.exit_layer, eps, seed,
                                              device)
                plan = kind.schedule(cell.traffic, cell.settings, seed, args.seconds,
                                     int(cell.config["vocab_size"]))
                torch.cuda.reset_peak_memory_stats(device)
                run = entry.run(cell, weights, device, args.seconds, False, t0, plan)
                peak = torch.cuda.max_memory_allocated(device)
                gc.collect()
                torch.cuda.empty_cache()
                compared = bench.judge(cell, run, weights, seed)
                line = bench.result_line(cell, run, peak, compared, False, device)
                if args.control:
                    ctl = bench.judge(cell, run, weights, seed, control=True)
                    ctl_line = bench.result_line(cell, run, peak, ctl, False, device)
                    line["control"] = {"correct": ctl_line["correct"],
                                       "check": ctl_line["check"]}
                lat = [r.latency_s for r in run.window_requests]
                third = max(len(lat) // 3, 1)
                line.update(seed=seed, rate_rps=rate, tail_eps=eps,
                            acceptance=run.acceptance, round_ms=(
                                run.measured.step_s / run.measured.rounds * 1e3
                                if run.measured.rounds else None),
                            backlog_growth=statistics.median(lat[-third:])
                            / statistics.median(lat[:third]),
                            offered_tok_s=sum(r.budget for r in run.window_requests)
                            / args.seconds,
                            wall_s=time.perf_counter() - t0)
                text = json.dumps(line)
                print(text, flush=True)
                if sink:
                    sink.write(text + "\n")
                    sink.flush()
                del weights, run
                gc.collect()
                torch.cuda.empty_cache()
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
