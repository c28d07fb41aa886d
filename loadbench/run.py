"""Run one cell of the benchmark once and print its result line.

    python3 -m loadbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (timed as ``setup_s``, from the process's start to the window's
opening) makes the weights on the card from the seed (the configuration's
family, ``families/<family>.py``), loads the port's kernels from the build
cache inside the checkout, builds the program and runs the cell's ramp:
the traffic's first seconds at the cell's own load, which launch every
shape the window will. Then the window of ``--seconds``; with ``--trace
1`` its last ``trace_s`` seconds are profiled. Once the load has stopped,
the peak memory is read, the program's state freed, and a sample of the
served requests judged by the cell's check against the family's plain
reference (``check.py``). The numbers compared, each beside its limit, are
the last lines on standard error and the ``check`` key, last, of the
result line: the last line on standard output.

Exits 2 without a result when no card (or fewer than the cell's) is
present, and 3 when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from loadbench import catalog  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "layerskip_tpu")
NOTHING_SERVED = 1e9


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def pin_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = catalog.ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def judge(cell, run, weights, seed: int, control: bool = False) -> dict:
    """The numbers compared, each ``{"value", "limit"}``: requests due in the
    window that never came back or failed, those whose length is not their
    budget, and the cell's ``limits`` on what its check
    (``checks/<check>.py``) reads of a sample against the family's
    reference (``reference/<family>.py``). With ``control``, the float8
    reference's tokens are judged in the program's place
    (``check.control_tokens``)."""
    from loadbench import check

    reference = catalog.load_module("reference", cell.family)
    comparison = catalog.load_module("checks", cell.check)
    window = run.window_requests
    missing = sum(1 for r in window if r.tokens is None or r.error is not None)
    wrong_length = sum(1 for r in window if r.tokens is not None and len(r.tokens) != r.budget)
    served = [check.Served(r.prompt, r.tokens, records=r.records)
              for r in window if r.tokens]
    picked = check.sample(served, seed, int(cell.settings["check_tokens"]))
    if control and picked:
        picked = check.control_tokens(reference, weights, cell.config, picked)
    read = comparison.read(reference, weights, cell.config, picked) if picked else {}
    out = {"missing": {"value": missing, "limit": 0},
           "wrong_length": {"value": wrong_length, "limit": 0}}
    for name, limit in cell.settings["limits"].items():
        # with nothing served there is nothing to judge: the run is not correct
        out[name] = {"value": read.get(name, NOTHING_SERVED), "limit": limit}
    return out


def measure(cell, seed: int, seconds: float, trace: bool, device):
    """(the run's record, peak bytes, the numbers compared)."""
    import torch

    family = catalog.load_module("families", cell.family)
    weights = family.make_weights(cell.config, cell.exit_layer, cell.tail_eps, seed, device)
    kind = catalog.load_module("traffic/kinds", cell.traffic["kind"])
    plan = kind.schedule(cell.traffic, cell.settings, seed, seconds,
                         int(cell.config["vocab_size"]))
    entry = catalog.load_module("entries", cell.entry)
    run = entry.run(cell, weights, device, seconds, trace, T_PROCESS, plan)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    compared = judge(cell, run, weights, seed)
    return run, peak, compared


def result_line(cell, run, peak: int, compared: dict, trace: bool, device) -> dict:
    import torch

    from loadbench import spans

    table = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in catalog.metrics_for(cell.name, table):
        value = catalog.load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    window = run.window_requests
    correct = all(c["value"] <= c["limit"] for c in compared.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak),
           "power_limit": power_limit() if device.type == "cuda" else "none"}
    out = {"correct": bool(correct), "attempted": len(window),
           "failed": compared["missing"]["value"], "metrics": metrics, "device": dev}
    if trace and run.device is not None:
        dev["busy_s"] = run.device.busy_s
        dev["window_s"] = run.device.window_s
        out["trace_extent"] = dict(run.device.extent, traced_host_s=run.traced_host_s,
                                   calls_recorded=spans.records_count(),
                                   k2_kernels=run.device.kernel_count("paged_decode_kernel"),
                                   k1_kernels=run.device.kernel_count("flash_prefill"))
        out["breakdown"] = run.device.breakdown()
    out["late_ms"] = run.late_s * 1e3
    out["check"] = compared
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = catalog.cell(args.workload)
    pin_caches()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"loadbench: the cell needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    run, peak, compared = measure(cell, args.seed, args.seconds, bool(args.trace), device)
    out = result_line(cell, run, peak, compared, bool(args.trace), device)
    bad = forbidden_modules()
    if bad:
        print(f"loadbench: loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in compared.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
