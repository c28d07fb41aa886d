"""Time the port's ``dense`` MoE path (``ops/moe.py`` ``_moe_dense``) alone
on one NVIDIA GPU at Mixtral-8x7B's widths (8 experts of D 4096, F 14336,
top 2, bf16), beside the call's least time (``moe_bound``,
``loadbench/yardstick/moe_bound.py``).

    python3 scripts/time_moe_dense.py [--root DIR]

``--root`` imports the port from another checkout (a parent commit's), so
that two versions of the path are timed by one script on one card; the
bound comes from this checkout. For each token count it prints one JSON
line: ms a call (CUDA events around 50 calls after a warm-up, the routing
computed before), the bound's ms and what bounds it, the share of
the bound reached, the experts hit, the peak bytes a call allocates beyond
its inputs, and the card's name and power limit. Needs a CUDA device;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
E, D, F, K = 8, 4096, 14336, 2
TOKENS = (32, 224)  # a draft pass and a verify pass of 32 slots (W 6 + 1)
ITERS = 50


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="the checkout whose layerskip_tpu_torch is timed")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.abspath(args.root))
    from layerskip_tpu_torch.ops import moe
    from loadbench.run import power_limit
    from loadbench.yardstick.moe_bound import moe_bound

    dev, dt = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    mk = lambda *s: torch.randn(s, generator=g, device=dev, dtype=dt) * 0.02  # noqa: E731
    w_gate, w_up, w_down, w_router = mk(E, D, F), mk(E, D, F), mk(E, F, D), mk(D, E)
    for n in TOKENS:
        x2 = torch.randn((n, D), generator=g, device=dev, dtype=dt)
        topv, topi, _ = moe.route(x2, w_router, K)
        call = lambda: moe._moe_dense(x2, topv, topi, w_gate, w_up, w_down, E)  # noqa: E731
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        call()
        torch.cuda.synchronize()
        transient = torch.cuda.max_memory_allocated() - base
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ITERS):
            call()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / ITERS
        hit = int(torch.unique(topi).numel())
        bound_s, what = moe_bound(n, K, E, D, F, hit, x2.element_size())
        print(json.dumps({
            "path": "dense", "root": os.path.abspath(args.root), "tokens": n,
            "ms": round(ms, 4), "bound_ms": round(bound_s * 1e3, 4), "bound": what,
            "roofline_pct": round(bound_s * 1e3 / ms * 100, 2), "hit": hit,
            "transient_bytes": transient, "iters": ITERS,
            "device": power_limit()}),
            flush=True)


if __name__ == "__main__":
    main()
