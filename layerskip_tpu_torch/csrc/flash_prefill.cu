// Flash prefill attention for Hopper (sm_90a), exposed through a plain C
// interface and loaded with ctypes (layerskip_tpu_torch/ops/cuda/flash_prefill.py).
//
// Replaces: layerskip_tpu/ops/pallas/flash_prefill.py::flash_prefill_attention
// (kernel body _flash_kernel). Same function: causal GQA attention of a
// prompt block q [B, T, Hq, Dh] over the KV cache k, v [B, S, Hkv, Dh] with
// a scalar past offset. Query head h reads KV head h / G. Query row i sits
// at position past + i and sees key j when j <= past + i and, with a window
// w > 0, j > past + i - w. Scores are scale * q.k (then cap * tanh(s / cap)
// with a softcap); the softmax is online with fp32 running max, denominator
// and accumulator; masked lanes give p = 0 and the denominator is clamped
// at 1e-30, so a fully masked row returns 0; p is rounded to the value
// dtype before the PV product. Q, K, V and O are read and written in their
// native [B, S, H, Dh] layout through strides: K and V may be one layer of
// a stacked cache, with no copy and no transpose.
//
// What bounds it on this card. The work is 4 * Dh flops per visible
// (query head, key) pair against reading Q, the visible K/V once and
// writing O. At the 7B 256-token prefill (32 heads, Dh 128) that is 0.54
// GFLOP against 8.4 MB: 2.5 us of HBM traffic and 0.55 us of bf16 tensor
// cores, so bytes bound it. At a 2048-token prompt the flops grow with the
// square of the length (34.4 GFLOP, 35 us at 989 TFLOP/s) and the bytes
// linearly (67 MB, 20 us): operations bound it, and only the tensor cores
// can come near that bound.
//
// Two routes, chosen by dtype:
//
// * bfloat16: the tensor-core kernel (flash_prefill_tc_kernel). One block
//   of one warpgroup (4 warps, 128 threads) per (64-query tile, query head,
//   batch row); each warp owns 16 query rows. Both products run on the
//   tensor cores with fp32 accumulation, as Hopper's wgmma: S = Q K^T with
//   Q and K read from shared memory (m64nBKk16), and O += P V with P
//   converted to bf16 in registers and V read from shared memory as an
//   MN-major operand (m64nDHk16), so no transpose is made. The bf16
//   rounding of P is exactly the function's "p rounded to v's dtype", and
//   bf16 x bf16 products are exact in fp32, so scores are still fp32 sums
//   of the operands' exact products.
//   Copies are TMA's: one thread asks for Q once and for each K and V tile
//   (boxes of 64 head dims x rows, read through the cache's strides, 128-
//   byte swizzle, rows past S read as 0), and mbarriers report their
//   arrival. K and V each have a ring of two stages with barriers of their
//   own: K_{j+2} and V_{j+1} are in flight while tile j is computed.
//   The loop is software-pipelined: iteration j issues S_j and then
//   P_{j-1} V_{j-1}, so the softmax of S_j runs while the tensor cores
//   finish the previous tile's PV. The online softmax stays in registers:
//   row max and row sum are quad shuffles over the accumulator fragment,
//   the scale is folded into a pre-scaled log2(e) and exponentials are
//   ex2.approx, and the softcap and the masks each run in their own branch,
//   the masks only in tiles that the causal frontier, the window or S cut.
//   Tiles wholly above the causal frontier or before the window are never
//   loaded. Key tiles are 64 keys (32 at Dh 256, whose 64 x 256 fp32
//   accumulator takes 128 registers a thread); two blocks share an SM. The
//   7B 256-token shape gives 4 x 32 = 128 blocks for the 132 SMs; the grid
//   issues the latest (heaviest) query tiles first, which evens out long
//   prompts. The G query heads of one KV head are separate blocks (the
//   shared K/V tiles come from L2); packing them into one block is not
//   done. PERF.md has what this design leaves on the table, measured.
//
//   Deterministic and row-invariant: no atomics, no split of a row's keys
//   across blocks, and key tiles start at fixed multiples of the tile width
//   from key 0, so a row's output is bit-identical whatever B is, whatever
//   the other rows hold, and whatever S is beyond the keys it sees (a paged
//   insert over a gathered view and a prefill over the contiguous cache
//   give the same prompt different S).
//
// * float32: the CUDA-core kernel of the first port (flash_prefill_kernel),
//   unchanged. TF32 tensor cores would round the operands to 10 mantissa
//   bits, and the fp32 gate cases (tolerance 5e-3) and the exact fp32
//   greedy checks run in fp32. One block of 256 threads per (64-query
//   tile, head, row) stages each 64-key tile in shared memory as fp32,
//   forms scores with 4x4 register micro-tiles and accumulates PV in fp32.

#include <atomic>
#include <mutex>

#include <cuda.h>  // CUtensorMap and its enums only: no cu* call is linked (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxDevices = 64;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t q_sb, q_st, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_st, o_sh;
  int T, S, G, past, window;
  float scale, softcap;
};

// The key tiles [kb_lo, kb_hi] of width BK that hold any key visible to
// some query of the tile starting at q0 (kb_hi < kb_lo when there is none).
struct KeyTiles {
  int lo, hi;
};

__device__ __forceinline__ KeyTiles key_tiles(const Args& a, int q0, int bq, int bk) {
  const int t_last = min(q0 + bq, a.T) - 1;
  const int first_pos = a.past + q0;
  const int k_lo = a.window > 0 ? max(0, first_pos - a.window + 1) : 0;
  const int k_hi = min(a.past + t_last, a.S - 1);
  const int kb_lo = k_lo / bk;
  return {kb_lo, k_hi >= k_lo ? k_hi / bk : kb_lo - 1};
}

// ------------------------------------------------------------ fp32 route

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;

template <int DH>
constexpr size_t smem_floats() {
  // q [BQ][DH+1], k [BK][DH+1], v [BK][DH], s [BQ][BK+1], m/l/alpha [BQ]
  return (size_t)kBQ * (DH + 1) + (size_t)kBK * (DH + 1) + (size_t)kBK * DH +
         (size_t)kBQ * (kBK + 1) + 3 * kBQ;
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
    flash_prefill_kernel(const Args a) {
  constexpr int QSTR = DH + 1;
  constexpr int KSTR = DH + 1;
  constexpr int SSTR = kBK + 1;
  constexpr int DJ = DH / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBQ * QSTR;
  float* vs = ks + kBK * KSTR;
  float* ss = vs + kBK * DH;
  float* m_s = ss + kBQ * SSTR;
  float* l_s = m_s + kBQ;
  float* a_s = l_s + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / a.G;

  const float* qg = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kg = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* vg = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  float* og = static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh;

  for (int i = tid; i < kBQ * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    const int t = q0 + r;
    qs[r * QSTR + d] = t < a.T ? qg[(int64_t)t * a.q_st + d] : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const KeyTiles kt = key_tiles(a, q0, kBQ, kBK);
  __syncthreads();

  for (int kb = kt.lo; kb <= kt.hi; ++kb) {
    const int k0 = kb * kBK;
    for (int i = tid; i < kBK * DH; i += kThreads) {
      const int r = i / DH, d = i % DH;
      const int s = k0 + r;
      const bool in = s < a.S;
      ks[r * KSTR + d] = in ? kg[(int64_t)s * a.k_ss + d] : 0.f;
      vs[r * DH + d] = in ? vg[(int64_t)s * a.v_ss + d] : 0.f;
    }
    __syncthreads();

    // scores: rows ty + 16 i, columns tx + 16 j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * QSTR + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * KSTR + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qpos = a.past + q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kpos = k0 + c;
        float s = sc[i][j] * a.scale;
        if (a.softcap > 0.f) s = a.softcap * tanhf(s / a.softcap);
        const bool vis = kpos <= qpos && kpos < a.S &&
                         (a.window <= 0 || kpos > qpos - a.window);
        ss[r * SSTR + c] = vis ? s : kNegInf;
      }
    }
    __syncthreads();

    // online softmax update: four neighbouring lanes per row
    {
      const int r = tid / 4, part = tid % 4;
      float* row = ss + r * SSTR;
      const float m_prev = m_s[r];
      float mx = kNegInf;
      for (int c = part; c < kBK; c += 4) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_cur = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = part; c < kBK; c += 4) {
        const float s = row[c];
        const float p = s > kNegInf * 0.5f ? expf(s - m_cur) : 0.f;
        sum += p;
        row[c] = p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (part == 0) {
        const float alpha = expf(m_prev - m_cur);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_cur;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= al;
    }
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ss[(ty + 16 * i) * SSTR + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = vs[c * DH + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int t = q0 + r;
    if (t < a.T) {
      const float denom = fmaxf(l_s[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        og[(int64_t)t * a.o_st + tx + 16 * j] = acc[i][j] / denom;
    }
  }
}

// ------------------------------------------------------ bf16 tensor-core route

constexpr int kStages = 2;  // K/V ring depth: the loop refills K_{j+2} and V_{j+1}
constexpr float kLog2e = 1.4426950408889634f;

// Shared tiles are what TMA writes with 128-byte swizzle from a box of 64
// head dims x R rows: a "plane" of R rows of 128 bytes per 64 head dims,
// planes one after another, each 1024-byte aligned. wgmma reads them
// through descriptors of the same swizzle. A block is one warpgroup of 4
// warps and 64 query rows, 16 per warp.
constexpr int kTcThreads = 128;
constexpr int kTcBQ = 64;

template <int DH>
struct TcShape {
  static constexpr int BK = DH == 256 ? 32 : 64;  // keys per tile
  static constexpr int kPlanes = DH / 64;
  static constexpr uint32_t kQBytes = kTcBQ * DH * 2;
  static constexpr uint32_t kTileBytes = BK * DH * 2;  // one K or V tile
  static constexpr size_t smem_bytes = kQBytes + 2 * kStages * kTileBytes + 1024;  // + alignment
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

// one arrival that also expects `bytes` of asynchronous copies
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// TMA: the box at coordinates (c0, c1, c2, c3) of `map` into shared memory
// at dst, completing on the mbarrier at bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// until at most N committed groups of this warpgroup are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps registers that a running wgmma reads or writes away from the
// compiler until the wait before this call: they stay live up to here and
// their later uses depend on it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// wgmma descriptor of a 128-byte-swizzled operand: start address, the
// byte stride between 64-element atoms along M or N for an MN-major
// operand (lbo; unused K-major), 1024 bytes between 8-row groups (sbo)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// 2^x on the special-function unit (subnormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (64 x 32, fp32) += A (64 x 16, shared) * B (16 x 32, shared), both K-major
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[16], uint64_t desc_a,
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d (64 x 64, fp32) += A (64 x 16, shared) * B (16 x 64, shared), both K-major
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d (64 x 64, fp32) += A (64 x 16, registers) * B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 128, fp32) += A (64 x 16, registers) * B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 256, fp32) += A (64 x 16, registers) * B (16 x 256, shared, MN-major)
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// two floats as a bf16 pair, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

struct TcMaps {  // [B, rows, heads, Dh] views of q, k and v for TMA
  CUtensorMap q, k, v;
};

template <int DH>
__global__ void __launch_bounds__(kTcThreads, 2)
    flash_prefill_tc_kernel(const __grid_constant__ Args a, const __grid_constant__ TcMaps maps) {
  using Shape = TcShape<DH>;
  constexpr int BK = Shape::BK;
  constexpr int NS = BK / 2;   // score registers per thread (64 x BK tile)
  constexpr int NO = DH / 2;   // output registers per thread (64 x DH tile)
  constexpr int KD = DH / 16;  // k-steps of S = Q K^T
  constexpr uint32_t kTile = Shape::kTileBytes;

  // K stages, V stages, then Q: K and V have barriers of their own, since
  // a K tile is read one iteration before its V tile
  __shared__ __align__(8) uint64_t bars[2 * kStages + 1];
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  unsigned char* base_ptr = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t qs_a = base;                    // [planes][kTcBQ rows][128 B]
  const uint32_t ks_a = qs_a + Shape::kQBytes;   // [kStages][planes][BK][128 B]
  const uint32_t vs_a = ks_a + kStages * kTile;  // [kStages][planes][BK][128 B]
  const uint32_t k_bar = smem_addr(bars), v_bar = k_bar + 8 * kStages;
  const uint32_t q_bar = v_bar + 8 * kStages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;  // fragment row and column pair
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcBQ;  // latest tiles first
  const int t_last = min(q0 + kTcBQ, a.T) - 1;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / a.G;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + h * a.o_sh;
  const KeyTiles kt = key_tiles(a, q0, kTcBQ, BK);

  // one thread issues every copy: Q once, then K and V tiles into their rings
  auto load = [&](const CUtensorMap* map, uint32_t ring, uint32_t bar, int kb) {
    const int st = (kb - kt.lo) % kStages;
    mbar_expect_tx(bar + 8 * st, kTile);
#pragma unroll
    for (int p = 0; p < Shape::kPlanes; ++p)
      tma_load(ring + st * kTile + p * BK * 128, map, bar + 8 * st, p * 64, kb * BK, hk, b);
  };
  if (tid == 0) {
    for (int i = 0; i <= 2 * kStages; ++i) mbar_init(k_bar + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(q_bar, Shape::kQBytes);
#pragma unroll
    for (int p = 0; p < Shape::kPlanes; ++p)
      tma_load(qs_a + p * kTcBQ * 128, &maps.q, q_bar, p * 64, q0, h, b);
    if (kt.lo <= kt.hi) {
      load(&maps.k, ks_a, k_bar, kt.lo);
      load(&maps.v, vs_a, v_bar, kt.lo);
    }
    if (kt.lo + 1 <= kt.hi) load(&maps.k, ks_a, k_bar, kt.lo + 1);
  }
  __syncthreads();  // the barriers are initialised
  mbar_wait(q_bar, 0);

  // accumulator fragments: register 4j + e holds row g + 8 (e / 2) of this
  // warp's 16 rows and column 8 j + 2 t4 + e % 2
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // rows g and g + 8
  float l[2] = {0.f, 0.f};          // this lane's part of the row sums
  uint32_t pa[BK / 16][4];          // P of the previous tile, bf16 A fragments
  const int pos_g = a.past + q0 + warp * 16 + g;
  const float sl2 = (a.softcap > 0.f ? 1.f : a.scale) * kLog2e;

  // O += P V of the tile `j` steps into the walk: V MN-major, key step kk
  // is 16 rows of 128 bytes, 64-dim planes BK * 128 bytes apart
  auto issue_pv = [&](int j) {
    const uint32_t vst = vs_a + (j % kStages) * kTile;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t db = smem_desc(vst + kk * 16 * 128, BK * 128);
      if constexpr (DH == 64)
        wgmma_m64n64k16_rs(o, pa[kk], db);
      else if constexpr (DH == 128)
        wgmma_m64n128k16_rs(o, pa[kk], db);
      else
        wgmma_m64n256k16_rs(o, pa[kk], db);
    }
  };

  // Software pipeline: iteration j issues S_j = Q K_j^T and then the PV
  // product of tile j - 1, so the softmax of S_j runs while the tensor
  // cores finish P_{j-1} V_{j-1}.
  for (int kb = kt.lo; kb <= kt.hi; ++kb) {
    const int j = kb - kt.lo;
    mbar_wait(k_bar + 8 * (j % kStages), (j / kStages) & 1);

    // S = Q K^T, both K-major: k-step kk is 32 bytes into a 128-byte row of
    // plane kk / 4
    float s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const uint64_t da = smem_desc(qs_a + kk / 4 * kTcBQ * 128 + kk % 4 * 32, 16);
      const uint64_t db =
          smem_desc(ks_a + (j % kStages) * kTile + kk / 4 * BK * 128 + kk % 4 * 32, 16);
      if constexpr (BK == 64)
        wgmma_m64n64k16_ss(s, da, db);
      else
        wgmma_m64n32k16_ss(s, da, db);
    }
    wgmma_commit();
    if (j > 0) {
      mbar_wait(v_bar + 8 * ((j - 1) % kStages), ((j - 1) / kStages) & 1);
      issue_pv(j - 1);
      wgmma_commit();
      wgmma_wait<1>();  // S_j is done; P_{j-1} V_{j-1} may still run
    } else {
      wgmma_wait<0>();
    }
    fence_regs(s);

    // softcap and (in tiles that cut this block's rows) the masks, on
    // the fragment; each in its own branch, so that a tile without them
    // runs no per-key instruction for them. Without a softcap the scale is
    // folded into the exponent: s stays q.k and sl2 = scale * log2(e).
    if (a.softcap > 0.f) {
      const float pre = a.scale / a.softcap;
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] = a.softcap * tanhf(s[i] * pre);
    }
    const int k0 = kb * BK;
    if (k0 + BK - 1 > a.past + q0 || k0 + BK > a.S ||
        (a.window > 0 && k0 <= a.past + t_last - a.window)) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int qpos = pos_g + ((i >> 1) & 1) * 8;
        const int kpos = k0 + (i >> 2) * 8 + 2 * t4 + (i & 1);
        const bool vis = kpos <= qpos && kpos < a.S &&
                         (a.window <= 0 || kpos > qpos - a.window);
        s[i] = vis ? s[i] : kNegInf;
      }
    }

    // online softmax in registers: a row lives in the four lanes of a quad
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < NS; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float alpha[2], m_l2[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = ex2((m[r] - m_new) * sl2);
      m[r] = m_new;
      m_l2[r] = m_new * sl2;
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int r = (i >> 1) & 1;
      const float x = s[i];
      const float p = x > kNegInf * 0.5f ? ex2(fmaf(x, sl2, -m_l2[r])) : 0.f;
      rs[r] += p;
      s[i] = p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];

    // P_{j-1} V_{j-1} has finished: rescale O by this tile's alpha and pack
    // P_j (the A layout of a k-step is the two score fragments of its 16
    // keys) for the next iteration
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    fence_regs(s);
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) pa[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);

    // K_j and V_{j-1} are free: refill their stages with K_{j+2} and V_{j+1}
    __syncthreads();
    if (tid == 0) {
      if (kb + 2 <= kt.hi) load(&maps.k, ks_a, k_bar, kb + 2);
      if (kb + 1 <= kt.hi) load(&maps.v, vs_a, v_bar, kb + 1);
    }
  }
  if (kt.lo <= kt.hi) {  // the last tile's PV
    const int j = kt.hi - kt.lo;
    mbar_wait(v_bar + 8 * (j % kStages), (j / kStages) & 1);
    wgmma_fence();
    issue_pv(j);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
  }

  // o / max(l, 1e-30) in bf16, staged row-major in the Q tile (no longer
  // read) with 16-byte chunk c of row r at chunk c ^ (r % 8), so that both
  // the fragment writes and the 16-byte reads are free of bank conflicts
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  constexpr int kChunks = DH / 8;
  unsigned char* ostage = base_ptr + warp * 16 * DH * 2;  // this warp's 16 rows
#pragma unroll
  for (int jd = 0; jd < NO / 4; ++jd) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(ostage + (g + 8 * r) * DH * 2 + (jd ^ g) * 16 + t4 * 4) =
          pack_bf16(o[4 * jd + 2 * r] / l[r], o[4 * jd + 2 * r + 1] / l[r]);
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 16 * kChunks / 32; ++it) {
    const int i = lane + it * 32;
    const int r = i / kChunks, c = i % kChunks;
    const int t = q0 + warp * 16 + r;
    if (t < a.T)
      *reinterpret_cast<uint4*>(og + (int64_t)t * a.o_st + c * 8) =
          *reinterpret_cast<const uint4*>(ostage + r * DH * 2 + (c ^ (r % 8)) * 16);
  }
}

// ------------------------------------------------------------------ launch

// The shared-memory limit is set once per kernel and device, not before
// every launch (two threads may both set it; that is harmless).
template <typename Kernel>
cudaError_t set_smem_once(Kernel kernel, size_t smem, std::atomic<bool>* ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && ready[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && dev < kMaxDevices) ready[dev].store(true, std::memory_order_release);
  return err;
}

template <int DH>
cudaError_t launch_f32(const Args& a, int B, int Hq, cudaStream_t stream) {
  static std::atomic<bool> ready[kMaxDevices];
  const size_t smem = smem_floats<DH>() * sizeof(float);
  cudaError_t err = set_smem_once(flash_prefill_kernel<DH>, smem, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T + kBQ - 1) / kBQ, Hq, B);
  flash_prefill_kernel<DH><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  });
  return fn;
}

// A [B, rows, heads, Dh] bf16 tensor with the given element strides (Dh
// contiguous) as a 4-D TMA map, Dh innermost, read in boxes of 64 head
// dims x box_rows rows with 128-byte swizzle; rows past `rows` read as 0.
bool tensor_map(CUtensorMap* map, const void* ptr, int B, int rows, int heads, int dh,
                int64_t s_b, int64_t s_row, int64_t s_head, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  // a dimension of extent 1 is never stepped; give it a legal stride
  auto stride = [](int64_t st, int n) { return (cuuint64_t)(n == 1 ? 16 : st * 2); };
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)rows, (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {stride(s_row, rows), stride(s_head, heads), stride(s_b, B)};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
cudaError_t launch_tc(const Args& a, int B, int Hq, cudaStream_t stream) {
  using Shape = TcShape<DH>;
  static std::atomic<bool> ready[kMaxDevices];
  cudaError_t err = set_smem_once(flash_prefill_tc_kernel<DH>, Shape::smem_bytes, ready);
  if (err != cudaSuccess) return err;
  const int hkv = Hq / a.G;
  TcMaps maps;
  if (!tensor_map(&maps.q, a.q, B, a.T, Hq, DH, a.q_sb, a.q_st, a.q_sh, kTcBQ) ||
      !tensor_map(&maps.k, a.k, B, a.S, hkv, DH, a.k_sb, a.k_ss, a.k_sh, Shape::BK) ||
      !tensor_map(&maps.v, a.v, B, a.S, hkv, DH, a.v_sb, a.v_ss, a.v_sh, Shape::BK))
    return cudaErrorInvalidValue;
  const dim3 grid((a.T + kTcBQ - 1) / kTcBQ, Hq, B);
  flash_prefill_tc_kernel<DH><<<grid, kTcThreads, Shape::smem_bytes, stream>>>(a, maps);
  return cudaGetLastError();
}

template <bool kTensorCores>
cudaError_t launch_dh(int dh, const Args& a, int B, int Hq, cudaStream_t stream) {
  switch (dh) {
    case 64:
      return kTensorCores ? launch_tc<64>(a, B, Hq, stream) : launch_f32<64>(a, B, Hq, stream);
    case 128:
      return kTensorCores ? launch_tc<128>(a, B, Hq, stream)
                          : launch_f32<128>(a, B, Hq, stream);
    case 256:
      return kTensorCores ? launch_tc<256>(a, B, Hq, stream)
                          : launch_f32<256>(a, B, Hq, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32 (CUDA-core route), 1 = bfloat16 (tensor-core route).
// Strides are in elements; the head_dim axis must be contiguous, and for
// bfloat16 every pointer must be 16-byte aligned and the other strides
// multiples of 8. Returns a cudaError_t (0 = launched).
extern "C" int flash_prefill_launch(
    int dtype, int head_dim, const void* q, const void* k, const void* v,
    void* o, int64_t q_sb, int64_t q_st, int64_t q_sh, int64_t k_sb,
    int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t o_sb, int64_t o_st, int64_t o_sh, int B, int T, int S, int Hq,
    int G, int past, int window, float scale, float softcap, void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.q_sb = q_sb;
  a.q_st = q_st;
  a.q_sh = q_sh;
  a.k_sb = k_sb;
  a.k_ss = k_ss;
  a.k_sh = k_sh;
  a.v_sb = v_sb;
  a.v_ss = v_ss;
  a.v_sh = v_sh;
  a.o_sb = o_sb;
  a.o_st = o_st;
  a.o_sh = o_sh;
  a.T = T;
  a.S = S;
  a.G = G;
  a.past = past;
  a.window = window;
  a.scale = scale;
  a.softcap = softcap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_dh<false>(head_dim, a, B, Hq, st);
  if (dtype == 1) return (int)launch_dh<true>(head_dim, a, B, Hq, st);
  return (int)cudaErrorInvalidValue;
}
