"""Per-block phase times of K2/K3 on the card, from clock stamps in an instrumented build.

    python3 scripts/trace_paged_decode.py [--cases NAME,...]

Copies ``layerskip_tpu_torch/csrc/paged_decode.cu`` into ``build/kernels/``
with ``clock64`` and ``%globaltimer`` stamps added at fixed points of the
kernel (each point found by its source line; the script stops if one is
missing), builds it with nvcc, and runs each case of ``chip_smoke.py``
phase 3 once warm and three times with L2 flushed, as
``chip_smoke.time_cold_ms`` times it. Thread 0 of every block records when
the block started and ended on the card's clock, and its cycles in each
phase: init (q, positions and table entries loaded), the wait for its
first chunk, each chunk's scores, softmax (with its barriers) and PV (with
its barrier) summed over the block's chunks, the stores of its partials,
the cluster barrier, the merge and the last barrier. Prints the card's
name and power limit, then per case and repetition one JSON line of 10th,
50th, 90th and 100th percentiles over the blocks (microseconds; ``chunks``
in chunks; ``score_us`` etc. per chunk). Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import bench_paged_decode  # noqa: E402
import chip_smoke  # noqa: E402
from layerskip_tpu_torch.ops.cuda import build  # noqa: E402

CASES = ("paged_decode_7b_t1_bf16", "paged_decode_7b_t7_bf16", "paged_decode_q8_7b_t1_bf16",
         "paged_decode_7b_long_t1_bf16", "paged_decode_7b_b1_long_t1_bf16")
SLOTS = 16  # int64 values a block records

# (source line, the same line with stamps): stamps tr[0..7] bound the phases,
# tr[8..11] sum the chunk phases
STAMPS = (
    ("namespace cg = cooperative_groups;\n",
     "namespace cg = cooperative_groups;\n__device__ long long* g_trace = nullptr;\n"),
    ("  cg::cluster_group cluster = cg::this_cluster();\n",
     "  long long tr[12] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  unsigned long long g0, g1;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g0));\n"
     "  tr[0] = clock64();\n"
     "  cg::cluster_group cluster = cg::this_cluster();\n"),
    ("  __syncthreads();\n\n  int pos_min", "  __syncthreads();\n  tr[1] = clock64();\n\n  int pos_min"),
    ("    mbar_wait(smem_addr(bars + stage), (n_done / kStages) & 1);\n",
     "    mbar_wait(smem_addr(bars + stage), (n_done / kStages) & 1);\n"
     "    if (n_done == 0) tr[2] = clock64();\n    const long long ta = clock64();\n"),
    ("    __syncthreads();\n\n    // online softmax",
     "    const long long tb = clock64();\n    __syncthreads();\n\n    // online softmax"),
    ("    __syncthreads();\n\n    // acc = acc", "    __syncthreads();\n    const long long tc = clock64();\n\n    // acc = acc"),
    ("    __syncthreads();  // the stage and sp are free again\n",
     "    __syncthreads();  // the stage and sp are free again\n"
     "    tr[8] += tb - ta; tr[9] += tc - tb; tr[10] += clock64() - tc; tr[11] += 1;\n"),
    ("  while (n_fin < nslots) finalize(n_fin++);\n",
     "  tr[3] = clock64();\n  while (n_fin < nslots) finalize(n_fin++);\n"),
    ("  cluster.sync();\n  const int total",
     "  tr[4] = clock64();\n  cluster.sync();\n  tr[5] = clock64();\n  const int total"),
    ("  cluster.sync();  // no block leaves while another still reads its shared memory\n}",
     "  tr[6] = clock64();\n"
     "  cluster.sync();  // no block leaves while another still reads its shared memory\n"
     "  tr[7] = clock64();\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g1));\n"
     "  if (threadIdx.x == 0 && g_trace != nullptr) {\n"
     "    long long* o = g_trace + (((long long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x"
     " + blockIdx.x) * 16;\n"
     "    for (int i = 0; i < 8; ++i) o[i] = tr[i];\n"
     "    o[8] = (long long)g0; o[9] = (long long)g1; o[10] = n_done;\n"
     "    for (int i = 8; i < 12; ++i) o[i + 4] = tr[i];\n  }\n}"),
)


def instrumented_source() -> str:
    src = (build.CSRC_DIR / "paged_decode.cu").read_text()
    for old, new in STAMPS:
        if src.count(old) != 1:
            raise SystemExit(f"trace_paged_decode: no unique stamp point {old.strip()!r}")
        src = src.replace(old, new)
    return src + ('\nextern "C" int paged_decode_set_trace(void* p) {\n'
                  '  return (int)cudaMemcpyToSymbol(g_trace, &p, sizeof(p));\n}\n')


def pct(x):
    x = x[np.isfinite(x)]
    if x.size == 0:
        return None
    return [round(float(np.percentile(x, p)), 3) for p in (10, 50, 90, 100)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", help="comma-separated case names (default: the 7B cases)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_paged_decode: no CUDA device", file=sys.stderr)
        return 2
    print(chip_smoke.card_line(), flush=True)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / "paged_decode_trace.cu"
    src.write_text(instrumented_source())
    lib = bench_paged_decode.compile_sources({"trace": str(src)})["trace"]
    lib.paged_decode_set_trace.argtypes = [ctypes.c_void_p]
    build._LIBS["paged_decode"] = lib
    cases = {c[0]: c[1:] for c in chip_smoke.paged_cases()}
    gen = torch.Generator(device="cuda").manual_seed(3)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for name in args.cases.split(",") if args.cases else CASES:
        b, t, g, hkv, dh, page, rows, dtype, quant, window, scale, cap, tree, _ = cases[name]
        k, v, _, _, q, pos, tree_kw = chip_smoke.paged_case_tensors(
            b, t, g, hkv, dh, page, rows, dtype, quant, tree, gen, chip_smoke.paged_capacity(rows))
        kw = dict(q_heads_per_kv=g, sliding_window=window, score_scale=scale,
                  logit_softcap=cap, **tree_kw)
        fn, _ = chip_smoke.paged_calls(q, k, v, pos, kw)
        for _ in range(3):
            fn()
        # room for the largest grid: 8 blocks per (row block, KV head, batch row)
        n_max = -(-t * g // (1 if t * g == 1 else 8 if t * g <= 8 else 16)) * 8 * hkv * b
        buf = torch.zeros(n_max * SLOTS, dtype=torch.int64, device="cuda")
        lib.paged_decode_set_trace(buf.data_ptr())
        for rep in range(3):
            buf.zero_()
            flush.zero_()
            torch.cuda._sleep(2_000_000)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            a = buf.view(n_max, SLOTS).cpu().numpy().astype(np.float64)
            a = a[a[:, 9] > 0]  # the blocks of this launch
            ghz = float(np.median((a[:, 7] - a[:, 0]) / (a[:, 9] - a[:, 8])))
            us = lambda cycles: cycles / ghz / 1e3  # noqa: E731
            has = a[:, 10] > 0
            per_chunk = lambda col: np.where(has, us(a[:, col]) / np.maximum(a[:, 15], 1),  # noqa: E731
                                             np.nan)
            row = dict(case=name, rep=rep, event_ms=start.elapsed_time(end), blocks=len(a),
                       clock_ghz=round(ghz, 4), chunks=pct(a[:, 10]),
                       start_us=pct((a[:, 8] - a[:, 8].min()) / 1e3),
                       end_us=pct((a[:, 9] - a[:, 8].min()) / 1e3),
                       init_us=pct(us(a[:, 1] - a[:, 0])),
                       first_wait_us=pct(np.where(has, us(a[:, 2] - a[:, 1]), np.nan)),
                       score_us=pct(per_chunk(12)), softmax_us=pct(per_chunk(13)),
                       pv_us=pct(per_chunk(14)), store_us=pct(us(a[:, 4] - a[:, 3])),
                       cluster_wait_us=pct(us(a[:, 5] - a[:, 4])),
                       merge_us=pct(us(a[:, 6] - a[:, 5])), last_sync_us=pct(us(a[:, 7] - a[:, 6])))
            print(json.dumps(row), flush=True)
        lib.paged_decode_set_trace(None)
        del k, v, q
    build._LIBS.pop("paged_decode", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
