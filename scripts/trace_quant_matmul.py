"""Per-block phase times of K4-K7's tensor-core route, from clock stamps in an instrumented build.

    python3 scripts/trace_quant_matmul.py [--m 1,256] [--kernels quant_matmul_t,...]
                                          [--layers 7b_wq,wo,...]

Copies ``layerskip_tpu_torch/csrc/quant_matmul.cu`` into ``build/kernels/``
with ``clock64`` and ``%globaltimer`` stamps added at fixed points of
``qmm_tc_kernel`` (each point found by its source line; the script stops
if one is missing; both weight layouts share them), builds it with nvcc,
and runs each kernel of ``--kernels`` (default all four; int4 at G 128) in
bf16 on the layer shapes of ``chip_smoke.py`` (``NK_LAYERS`` for K4/K7,
``KN_LAYERS`` for K5/K6; ``--layers`` picks among them) at each M, once
warm and three times with L2 flushed (``chip_smoke.time_cold_ms``'s
flush). Thread 0 of every block records when the block started and ended
on the card's clock, and its cycles in each phase: init (barriers, first
copies issued), the wait for its first tile, the rest of its K slice's
tiles, the stores of its partial sums with the cluster barrier, the merge
and the last barrier. Prints the card's name and power limit, then per
case and repetition one JSON line of 10th, 50th, 90th and 100th
percentiles over the blocks, in microseconds (``start_us`` from the
kernel's first block start; ``tile_us`` per tile after the first). Needs a
CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from layerskip_tpu_torch.ops.cuda import build  # noqa: E402

SLOTS = 10  # int64 values a block records: 2 globaltimer, 7 clock64, tiles

# (source line, the same line with stamps)
STAMPS = (
    ("namespace cg = cooperative_groups;\n",
     "namespace cg = cooperative_groups;\n__device__ long long* g_trace = nullptr;\n"
     "#define QMM_CLK(i) if (threadIdx.x == 0) tr[i] = clock64();\n"),
    ("  const int cb = NK ? wn * 16 * FR + g : wn * 32 + 4 * g;\n",
     "  const int cb = NK ? wn * 16 * FR + g : wn * 32 + 4 * g;\n"
     "  long long tr[7] = {0, 0, 0, 0, 0, 0, 0};\n  unsigned long long g0, g1;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g0));\n  QMM_CLK(0)\n"),
    ("  float acc[FR][NI][4];\n", "  QMM_CLK(1)\n  float acc[FR][NI][4];\n"),
    ("    const unsigned char* wtile = sp;\n",
     "    if (i == 0) { QMM_CLK(2) }\n    const unsigned char* wtile = sp;\n"),
    ("  float* red = reinterpret_cast<float*>(ring);\n",
     "  QMM_CLK(3)\n  float* red = reinterpret_cast<float*>(ring);\n"),
    ("  cluster.sync();\n\n  // rank r finishes its share",
     "  cluster.sync();\n  QMM_CLK(4)\n\n  // rank r finishes its share"),
    ("  cluster.sync();  // no block leaves while another still reads its shared memory\n}\n",
     "  QMM_CLK(5)\n"
     "  cluster.sync();  // no block leaves while another still reads its shared memory\n"
     "  QMM_CLK(6)\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g1));\n"
     "  if (threadIdx.x == 0 && g_trace != nullptr) {\n"
     "    long long* o = g_trace + ((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * 10;\n"
     "    o[0] = (long long)g0; o[1] = (long long)g1;\n"
     "    for (int j = 0; j < 7; ++j) o[2 + j] = tr[j];\n    o[9] = nt;\n  }\n}\n"),
)
TAIL = ('\nextern "C" int quant_matmul_set_trace(long long* p) {\n'
        "  return (int)cudaMemcpyToSymbol(g_trace, &p, sizeof(p));\n}\n")


def instrumented_library() -> ctypes.CDLL:
    src = (build.CSRC_DIR / "quant_matmul.cu").read_text()
    for line, stamped in STAMPS:
        if src.count(line) != 1:
            raise SystemExit(f"trace_quant_matmul: source line not found once: {line!r}")
        src = src.replace(line, stamped)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = build.BUILD_DIR / "quant_matmul_trace.cu"
    so = build.BUILD_DIR / "libquant_matmul_trace.so"
    cu.write_text(src + TAIL)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)], check=True,
                   stdout=subprocess.DEVNULL)
    lib = ctypes.CDLL(str(so))
    lib.quant_matmul_set_trace.argtypes = [ctypes.c_void_p]
    return lib


def summarize(rec: np.ndarray) -> dict:
    """Percentiles over the blocks of one launch's records [blocks, SLOTS]."""
    g0, g1, clk, nt = rec[:, 0], rec[:, 1], rec[:, 2:9].astype(np.float64), rec[:, 9]
    ns_per_cycle = (g1 - g0) / np.maximum(clk[:, 6] - clk[:, 0], 1)
    us = lambda a, b: (clk[:, b] - clk[:, a]) * ns_per_cycle / 1e3  # noqa: E731
    phases = {
        "start_us": (g0 - g0.min()) / 1e3, "total_us": (g1 - g0) / 1e3,
        "init_us": us(0, 1), "first_tile_us": us(1, 2),
        "tile_us": us(2, 3) / np.maximum(nt - 1, 1), "tiles": nt.astype(np.float64),
        "partials_and_sync_us": us(3, 4), "merge_us": us(4, 5), "last_sync_us": us(5, 6),
    }
    out = {"blocks": int(rec.shape[0]), "kernel_us": float((g1.max() - g0.min()) / 1e3)}
    for name, v in phases.items():
        out[name] = [round(float(np.percentile(v, p)), 3) for p in (10, 50, 90, 100)]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", default="1,256", help="comma-separated M (rows of x)")
    ap.add_argument("--kernels", default="quant_matmul_t,quant_matmul,int4_matmul,int4_matmul_t")
    ap.add_argument("--layers", default=None, help="comma-separated layer names (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_quant_matmul: no CUDA device", file=sys.stderr)
        return 2
    from layerskip_tpu_torch.ops.cuda import quant_matmul as qmm
    from layerskip_tpu_torch.quant import quantize_tensor

    print(chip_smoke.card_line(), flush=True)
    lib = instrumented_library()
    build._LIBS["quant_matmul"] = lib
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    for kern in args.kernels.split(","):
        fn = getattr(qmm, kern)
        bits, k_last = 4 if kern.startswith("int4") else 8, kern.endswith("_t")
        layers = chip_smoke.NK_LAYERS if k_last else chip_smoke.KN_LAYERS
        for layer, k, n in layers:
            if args.layers and layer not in args.layers.split(","):
                continue
            w = torch.randn((n, k) if k_last else (k, n), generator=gen, device="cuda") * 0.02
            qt = quantize_tensor(w, k_last=k_last, bits=bits, group=128 if bits == 4 else 0)
            kw = dict(group=qt.group) if bits == 4 else {}
            for m in (int(v) for v in args.m.split(",")):
                x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
                bt = 8 if m <= 8 else 32 if m <= 32 else 128
                blocks = -(-n // 128) * qmm.tc_slices(k) * -(-m // bt)
                buf = torch.zeros(blocks, SLOTS, dtype=torch.int64, device="cuda")
                if lib.quant_matmul_set_trace(buf.data_ptr()) != 0:
                    raise SystemExit("trace_quant_matmul: could not set the trace buffer")
                for rep, cold in enumerate((False, True, True, True)):
                    if cold:
                        flush.zero_()
                    torch.cuda._sleep(2_000_000)
                    buf.zero_()
                    fn(x, qt.q, qt.scale, **kw)
                    torch.cuda.synchronize()
                    line = dict(case=f"{kern}_{layer}_m{m}", rep=rep, cold=cold,
                                **summarize(buf.cpu().numpy()))
                    print(json.dumps(line), flush=True)
            del qt, w
    lib.quant_matmul_set_trace(None)
    build._LIBS.pop("quant_matmul", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
