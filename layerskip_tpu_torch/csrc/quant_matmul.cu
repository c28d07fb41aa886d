// Weight-quantized matrix products for Hopper (sm_90a), exposed through a
// plain C interface and loaded with ctypes (layerskip_tpu_torch/ops/cuda/quant_matmul.py).
//
// Replaces the four dequantizing products of
// layerskip_tpu/ops/pallas/quant_matmul.py:
//   K4 quant_matmul_t  x[M,K] @ (q[N,K] int8 * scale[N])^T
//   K5 quant_matmul    x[M,K] @ (q[K,N] int8 * scale[N])
//   K6 int4_matmul     x[M,K] @ dequant(q[K/2,N] uint8, scale[K/G,N])
//   K7 int4_matmul_t   x[M,K] @ dequant(q[N,K/2] uint8, scale[N,K/G])^T
// (kernel bodies _qmm_t_kernel, _qmm_kernel and _i4mm_kernel /
// _i4mm_t_kernel with variant "fused"). The functions are the TPU kernels':
//   int8: sum_k x * float(q) accumulated in fp32, times scale[n] on the
//         fp32 accumulator, rounded once to x's dtype;
//   int4: each byte holds element 2i in its low and 2i+1 in its high nibble,
//         offset-binary (value = nibble - 8); the value times its group's
//         scale in fp32 is rounded to x's dtype BEFORE the product (as the
//         compiled TPU kernel and ops/linear.py::_qdot do), then fp32
//         accumulation and one rounding at the end.
// x is read as it is (row stride given, K contiguous): no even/odd split of
// x and no padding of M, which the TPU wrapper needed. Any N, any K with
// K % G == 0. fp32 activations are multiplied in full fp32 (CUDA-core FMA),
// never TF32.
//
// Row invariance: the order in which one output element's K-reduction is
// summed depends only on K (and the route, which the dtype picks), never on
// M or on the row's place in the batch. Tile heights only select which rows
// share a weight read. So an AR step (M = 1) and a verify window (M = W + 1)
// give bit-identical rows, which greedy AR == self-spec needs.
//
// What bounds them on this card: at decode (M of 1 to a few) a product reads
// every weight byte once and does 2 flops per weight per row: ~2 flop/byte,
// far below the H100's ~295 flop/byte ridge, so bytes bound it (a 7B
// [4096, 11008] int8 weight: 45 MB, 13.5 us at 3.35 TB/s). At a 256-row
// prefill it is ~500 flop/byte (int8) and ~1000 (int4): the bf16 tensor
// cores bound it (23 GFLOP, 23 us at 989 TFLOP/s for w_gate).
//
// In bf16 all four run on the tensor cores, in one kernel template
// (qmm_tc_kernel) for both weight layouts: [K, N] (K5, K6: wo, w_gate,
// w_up, w_down) and [N, K] (K4, K7: wq, wk, wv).
//   * mma.sync m16n8k16 with the weight as the row operand (16 columns a
//     fragment) and the tokens as the column operand (8 a fragment): M = 1
//     wastes nothing the bytes bound, M = 256 reads each weight tile once
//     per 128 tokens. One instruction shape at every M.
//   * The weight is dequantized in registers straight into the fragment.
//     [K, N]: an int4 byte holds two consecutive K of one column, one bf16x2
//     register; int8 pairs come from two rows. [N, K]: K is contiguous, so a
//     lane reads 16 consecutive K of a weight row (16 bytes of int8, 8 of
//     int4) in one shared load and hands them to its fragment slots over
//     the tile's four k16 steps: lane c of a quad takes K 16c .. 16c + 15,
//     and in step s slots 2c, 2c + 1 get K 16c + 4s + {0, 1} and slots
//     2c + 8, 2c + 9 get 16c + 4s + {2, 3}; x is read with the same
//     permutation (one 16-byte load of 8 consecutive bf16 per two steps).
//     Which K share one MMA thus differs between the layouts, and depends
//     on K alone in both. A byte becomes fp32 by the magic-number trick
//     (0x4B0000xx is 2^23 + xx), one subtraction gives the exact value;
//     int8 takes the upper halves of two such values as its bf16 pair
//     (exact), int4 multiplies by its group's scale in fp32 and one
//     cvt.rn.bf16x2.f32 rounds a pair. Products of bf16 x and these bf16
//     weights are exact, so the tensor cores compute the function above;
//     only the order of the fp32 sums differs.
//   * Tiles of 64 K come in by TMA into a ring of 4-6 stages on mbarriers:
//     x [tokens, 64] and the [K, N] weight [64 or 32 rows, 128 columns]
//     128-byte swizzled (fragment loads free of bank conflicts), the [N, K]
//     weight [128 rows, 64 or 32 bytes] unswizzled (a lane's rows are 8
//     apart and its quad's loads 16 or 8 bytes apart, so every phase of a
//     warp's load hits distinct banks). [K, N] int4 scales come as one row
//     [1, 128] per tile; [N, K] int4 scales, one 4-byte group per row below
//     TMA's 16-byte box, are loaded by each lane one tile ahead. Where TMA
//     cannot read a tensor (a pointer or row stride not 16-byte aligned:
//     [K, N] N % 16, [N, K] K % 16 for int8 and K % 32 for int4; a [K, N]
//     int4 group that is not a multiple of 64), the block loads the same
//     tiles itself: same layout, same bits. An int4 group that is not a
//     multiple of 64 takes its scales per element.
//   * K splits into tc_slices(K) slices (at most 8, at least 4 tiles each):
//     a cluster of that many blocks computes one output tile, one slice
//     each, and the slices' fp32 partials are added in rank order through
//     distributed shared memory: one launch, no workspace, no atomics. The
//     split depends on K alone; at M = 1 it gives the card 256-1376 blocks
//     at the 7B shapes instead of 128-344.
//   * The token tile (8, 32 or 128 rows a block) follows M; it changes no
//     row's sums.
// In fp32 they run on the CUDA cores (this file's first design), with the
// chunk of x that a block needs staged in shared memory once per chunk and
// shared by every column of the block:
//   [K, N] (qmm_kn_kernel): threads run along N; a block of 256 threads
//     owns 32 output columns and BM rows; 8 threads cover the 32 bytes of a
//     weight row (one 32-bit load each, 4 columns), 32 thread rows take 16
//     consecutive packed rows each per 512-row chunk, and the 32 partial
//     sums of each output are added in a fixed order through shared memory.
//   [N, K] (qmm_nk_kernel): K is contiguous, so a warp reads along K. Each
//     warp owns 4 output columns and each lane 16 consecutive bytes of each
//     (one 16-byte load per column per 512-byte chunk); the lane sums are
//     added by a butterfly of warp shuffles, which gives every lane the same
//     value. x is padded by one float per lane segment, so the lanes read
//     distinct banks.

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums only: no cu* call is linked (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <atomic>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 32;  // output columns per block

struct Args {
  const float* x;
  const uint8_t* q;
  const float* scale;
  float* out;
  int64_t x_stride;  // elements between rows of x
  int M, K, N, group;
  int vec;  // the weight rows allow aligned vector loads
};

// Stage x[m0 : m0 + BM, e0 : e0 + EPC] into shared memory (zeros past M
// and K). With SEG > 0, one float of padding follows every SEG elements.
template <int EPC, int SEG>
__host__ __device__ constexpr int padded_row() {
  if constexpr (SEG > 0) return EPC + EPC / SEG;
  return EPC;
}

template <int BM, int EPC, int SEG>
__device__ __forceinline__ void stage_x(float* xs, const Args& a, int m0, int e0) {
  constexpr int XS = padded_row<EPC, SEG>();
  for (int i = threadIdx.x; i < BM * EPC; i += kThreads) {
    const int m = i / EPC, e = i % EPC;
    const int k = e0 + e;
    float v = 0.f;
    if (m0 + m < a.M && k < a.K) v = a.x[(int64_t)(m0 + m) * a.x_stride + k];
    int idx = m * XS + e;
    if constexpr (SEG > 0) idx += e / SEG;
    xs[idx] = v;
  }
}

// ------------------------------------------------ [K, N] fp32, CUDA cores

template <bool INT4, int BM>
__global__ void __launch_bounds__(kThreads) qmm_kn_kernel(const Args a) {
  constexpr int TX = 8;             // threads along N, 4 columns each
  constexpr int TY = kThreads / TX;  // 32 thread rows along K
  constexpr int R = 16;             // packed rows per thread per chunk
  constexpr int EL = INT4 ? 2 : 1;  // K elements per packed byte
  constexpr int CH = TY * R;        // packed rows per chunk
  constexpr int EPC = CH * EL;      // K elements per chunk
  constexpr uint32_t kZero = INT4 ? 0x88888888u : 0u;  // decodes to 0
  static_assert(BM * EPC <= BM * 1024 && TY * kBN <= 1024, "smem");
  __shared__ float smem[BM * 1024];  // x chunk, then the partial sums

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int nc = n0 + 4 * tx;
  const int Kp = INT4 ? a.K / 2 : a.K;
  const int g2 = INT4 ? a.group / 2 : 1;

  float acc[BM][4];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  for (int c0 = 0; c0 < Kp; c0 += CH) {
    stage_x<BM, EPC, 0>(smem, a, m0, c0 * EL);
    __syncthreads();
    uint32_t wv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int kp = c0 + ty * R + r;
      uint32_t v = kZero;
      if (kp < Kp && nc < a.N) {
        const uint8_t* p = a.q + (int64_t)kp * a.N + nc;
        if (a.vec) {
          v = *reinterpret_cast<const uint32_t*>(p);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (nc + c < a.N)
              v = (v & ~(0xFFu << (8 * c))) | ((uint32_t)p[c] << (8 * c));
        }
      }
      wv[r] = v;
    }
    int g_last = -1;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int kp = c0 + ty * R + r;
      const int e = (ty * R + r) * EL;
      float w0[4], w1[4];
      if (INT4) {
        const int gi = kp / g2;
        if (gi != g_last) {
          g_last = gi;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            s[c] = (kp < Kp && nc + c < a.N) ? a.scale[(int64_t)gi * a.N + nc + c] : 0.f;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint32_t byte = (wv[r] >> (8 * c)) & 0xFFu;
          w0[c] = (float)((int)(byte & 0xFu) - 8) * s[c];
          w1[c] = (float)((int)(byte >> 4) - 8) * s[c];
        }
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          w0[c] = (float)(int8_t)((wv[r] >> (8 * c)) & 0xFFu);
      }
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        const float xv = smem[m * EPC + e];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][c] = fmaf(xv, w0[c], acc[m][c]);
      }
      if (INT4) {
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          const float xv = smem[m * EPC + e + 1];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[m][c] = fmaf(xv, w1[c], acc[m][c]);
        }
      }
    }
    __syncthreads();
  }

  // the TY partial sums of each output, added in thread-row order
  float* red = smem;  // [TY][BM][kBN]
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[(ty * BM + m) * kBN + 4 * tx + c] = acc[m][c];
  __syncthreads();
  for (int i = tid; i < BM * kBN; i += kThreads) {
    const int m = i / kBN, col = i % kBN, n = n0 + col;
    float sum = 0.f;
    for (int t = 0; t < TY; ++t) sum += red[(t * BM + m) * kBN + col];
    if (m0 + m < a.M && n < a.N) {
      if (!INT4) sum *= a.scale[n];
      a.out[(int64_t)(m0 + m) * a.N + n] = sum;
    }
  }
}

// ------------------------------------------------ [N, K] fp32, CUDA cores

template <bool INT4, int BM>
__global__ void __launch_bounds__(kThreads) qmm_nk_kernel(const Args a) {
  constexpr int NC = 4;             // output columns per warp
  constexpr int VB = 16;            // packed bytes per lane per chunk
  constexpr int EL = INT4 ? 2 : 1;
  constexpr int CH = 32 * VB;       // packed bytes per chunk
  constexpr int EPC = CH * EL;
  constexpr int SEG = VB * EL;      // one lane's K elements
  constexpr int XS = padded_row<EPC, SEG>();
  constexpr uint32_t kZero = INT4 ? 0x88888888u : 0u;
  static_assert(kBN == (kThreads / 32) * NC, "columns per block");
  __shared__ float xs[BM * XS];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nb = blockIdx.x * kBN + warp * NC;
  const int m0 = blockIdx.y * BM;
  const int Kp = INT4 ? a.K / 2 : a.K;
  const int KG = INT4 ? a.K / a.group : 1;
  // a lane's 32 int4 elements start at a multiple of 32: one scale group
  const bool one_group = INT4 && (a.group % (2 * VB)) == 0;

  float acc[BM][NC];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[m][j] = 0.f;

  for (int c0 = 0; c0 < Kp; c0 += CH) {
    stage_x<BM, EPC, SEG>(xs, a, m0, c0 * EL);
    __syncthreads();
    const int kb = c0 + lane * VB;
    uint32_t wv[NC][4];
    float s[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int n = nb + j;
      uint4 v = make_uint4(kZero, kZero, kZero, kZero);
      s[j] = 0.f;
      if (n < a.N && kb < Kp) {
        const uint8_t* p = a.q + (int64_t)n * Kp + kb;
        if (a.vec) {
          v = *reinterpret_cast<const uint4*>(p);
        } else {
          uint32_t w[4] = {kZero, kZero, kZero, kZero};
          for (int b = 0; b < VB && kb + b < Kp; ++b)
            w[b / 4] = (w[b / 4] & ~(0xFFu << (8 * (b % 4)))) |
                       ((uint32_t)p[b] << (8 * (b % 4)));
          v = make_uint4(w[0], w[1], w[2], w[3]);
        }
        if (INT4 && one_group) s[j] = a.scale[(int64_t)n * KG + (2 * kb) / a.group];
      }
      wv[j][0] = v.x;
      wv[j][1] = v.y;
      wv[j][2] = v.z;
      wv[j][3] = v.w;
    }
#pragma unroll
    for (int b = 0; b < VB; ++b) {
      float w0[NC], w1[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const uint32_t byte = (wv[j][b / 4] >> (8 * (b % 4))) & 0xFFu;
        if (INT4) {
          float sj = s[j];
          if (!one_group) {
            const int n = nb + j, k = 2 * (kb + b);
            sj = (n < a.N && k < a.K) ? a.scale[(int64_t)n * KG + k / a.group] : 0.f;
          }
          w0[j] = (float)((int)(byte & 0xFu) - 8) * sj;
          w1[j] = (float)((int)(byte >> 4) - 8) * sj;
        } else {
          w0[j] = (float)(int8_t)byte;
        }
      }
      const int e = lane * SEG + b * EL + lane;  // padded index
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        const float xv = xs[m * XS + e];
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[m][j] = fmaf(xv, w0[j], acc[m][j]);
      }
      if (INT4) {
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          const float xv = xs[m * XS + e + 1];
#pragma unroll
          for (int j = 0; j < NC; ++j) acc[m][j] = fmaf(xv, w1[j], acc[m][j]);
        }
      }
    }
    __syncthreads();
  }

  // butterfly: a + b == b + a exactly, so every lane ends with the same sum
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      float v = acc[m][j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      acc[m][j] = v;
    }
  if (lane == 0) {
#pragma unroll
    for (int m = 0; m < BM; ++m)
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int n = nb + j;
        if (m0 + m < a.M && n < a.N)
          a.out[(int64_t)(m0 + m) * a.N + n] = INT4 ? acc[m][j] : acc[m][j] * a.scale[n];
      }
  }
}

// ------------------------------------------------------ bf16, tensor cores

constexpr int kMaxDevices = 64;
constexpr int kTcBN = 128;          // weight columns per block: 4 warps x 32
constexpr int kTcKT = 64;           // K elements per tile
constexpr int kTcMaxSlices = 8;     // K slices of one output tile, at most
constexpr int kTcMinTiles = 4;      // tiles per slice, at least, once K splits
constexpr int kTcRedStride = kTcBN + 4;  // floats per row of the merge buffer

// The K slices of every bf16 product: a function of K alone, so a row's
// bits never depend on M, on the other rows or on the card.
__host__ __device__ inline int tc_slices(int K) {
  const int s = (K + kTcKT - 1) / kTcKT / kTcMinTiles;
  return s < 1 ? 1 : (s > kTcMaxSlices ? kTcMaxSlices : s);
}

// WT groups of warps along the tokens, TT tokens each, of kWN warps along
// the 128 columns, FR fragments (16 columns each) a warp; STAGES tiles in
// the copy ring. A stage holds the packed weight tile ([K, N]: kKp rows
// of 128 bytes, 128-byte swizzle; [N, K]: 128 rows of kKp bytes, no
// swizzle), the x tile [BT][64 bf16] (128-byte swizzle) and, for [K, N]
// int4, one row of 128 scales.
template <bool NK, bool INT4, int WT, int TT, int STAGES, int FR>
struct TcShape {
  static constexpr int kWN = kTcBN / (16 * FR);
  static constexpr int kThreads = 32 * kWN * WT;
  static constexpr int BT = WT * TT;
  static constexpr int kKp = INT4 ? kTcKT / 2 : kTcKT;  // packed bytes of a tile's K
  static constexpr int kWBytes = kKp * kTcBN;
  static constexpr int kXBytes = BT * kTcKT * 2;
  static constexpr int kSBytes = INT4 && !NK ? kTcBN * 4 : 0;
  static constexpr int kStageBytes = (kWBytes + kXBytes + kSBytes + 1023) / 1024 * 1024;
  static constexpr int kRingBytes = STAGES * kStageBytes;
  static constexpr int kRedBytes = BT * kTcRedStride * 4;
  static constexpr size_t smem_bytes =
      (kRingBytes > kRedBytes ? kRingBytes : kRedBytes) + 1024;  // + alignment
};

struct TcMaps {
  CUtensorMap w, x, s;
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

// TMA: the box at coordinates (c0, c1) of `map` into shared memory at dst,
// completing on the mbarrier at bar
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// byte `b` of a tile of 128-byte rows as TMA's 128-byte swizzle lays it
// out: the 16-byte chunk index XOR the row index mod 8
__device__ __forceinline__ int swz(int row, int b) {
  return row * 128 + ((((b >> 4) ^ row) & 7) << 4) + (b & 15);
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// d += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), d 16x8 fp32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // cvt.rn.bf16x2.f32
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^23 + byte `B` of w, exactly, as fp32 (the magic-number conversion)
template <int B>
__device__ __forceinline__ float magic(uint32_t w) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 | B));
}

// int8: byte B of wa (element k) and of wb (element k + 1), both stored
// XOR 0x80 (v + 128), as one bf16x2 register. v has at most 8 significant
// bits, so its fp32 form ends in 16 zero bits and its upper half IS its
// bf16: one byte permute packs the pair, no conversion instruction.
template <int B>
__device__ __forceinline__ uint32_t deq8(uint32_t wa, uint32_t wb) {
  return __byte_perm(__float_as_uint(magic<B>(wa) - 8388736.f),
                     __float_as_uint(magic<B>(wb) - 8388736.f), 0x7632);
}

// int8: bytes B (element k) and B + 1 (element k + 1) of one word, as deq8
template <int B>
__device__ __forceinline__ uint32_t deq8_pair(uint32_t w) {
  return __byte_perm(__float_as_uint(magic<B>(w) - 8388736.f),
                     __float_as_uint(magic<B + 1>(w) - 8388736.f), 0x7632);
}

// int4: the low (element k) and high (element k + 1) nibble of byte B,
// given as lo = w & 0x0F0F0F0F and hi = (w >> 4) & 0x0F0F0F0F: (nibble - 8)
// exactly, times the group's scale in fp32, rounded to bf16 (nearest even)
template <int B>
__device__ __forceinline__ uint32_t deq4(uint32_t lo, uint32_t hi, float s) {
  return pack_bf16x2((magic<B>(lo) - 8388616.f) * s, (magic<B>(hi) - 8388616.f) * s);
}

struct TcArgs {
  const void* x;       // [M, K] bf16, row stride x_stride
  const uint8_t* q;    // [K, N] / [N, K] int8 or [K/2, N] / [N, K/2] packed int4
  const float* scale;  // [N], or [K/G, N] / [N, K/G]
  void* out;           // [M, N] bf16, contiguous
  int64_t x_stride;
  int M, K, N, group;
  int tma;  // 1: tiles by TMA; 0: the block loads them itself (same layout)
};

// One block: 128 weight columns x BT tokens x one K slice. The cluster's
// S blocks (rank = slice) share the output tile; each sums its slice's
// tiles in order on the tensor cores, then the slices' partial sums are
// added in rank order through distributed shared memory.
//
// The weight is the MMA's A operand (16 columns a fragment), the tokens
// its B operand (8 a fragment): warp (wn, wt) owns columns wn*16*FR ..
// +16*FR-1 and tokens wt*TT .. +TT-1. Lane (g = lane / 4, c = lane % 4)
// holds, in fragment f, MMA rows g and g + 8 of two weight columns: [K, N]
// (FR = 2) columns 4g + 2f and 4g + 2f + 1, so its four columns 4g ..
// 4g + 3 are one 32-bit word of a weight row and one float4 of the
// accumulators; [N, K] columns g + 16f and g + 16f + 8, weight rows 8
// apart. FR = 1 halves each warp's share of a tile and doubles the warps,
// for the short chains of a few tokens; no column's sums change with it.
template <bool NK, bool INT4, int WT, int TT, int STAGES, int FR>
__global__ void __launch_bounds__(TcShape<NK, INT4, WT, TT, STAGES, FR>::kThreads,
                                  FR == 1 ? 3 : (WT == 1 ? 4 : 2))
    qmm_tc_kernel(const __grid_constant__ TcArgs a, const __grid_constant__ TcMaps maps) {
  using Sh = TcShape<NK, INT4, WT, TT, STAGES, FR>;
  static_assert(NK || FR == 2, "[K, N] tiles pair each lane's columns");
  constexpr int NI = TT / 8;  // token fragments per warp
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[STAGES];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  unsigned char* ring = smem_raw + (base - smem_addr(smem_raw));

  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wn = warp % Sh::kWN, wt = warp / Sh::kWN;
  const int g = lane / 4, c = lane % 4;
  const int n0 = blockIdx.x / S * kTcBN;
  const int m0 = blockIdx.y * Sh::BT;
  const int tiles = (a.K + kTcKT - 1) / kTcKT;
  const int t_lo = rank * tiles / S;
  const int nt = (rank + 1) * tiles / S - t_lo;
  const int kp_end = INT4 ? a.K / 2 : a.K;  // packed bytes of K
  // this lane's first weight column in the block
  const int cb = NK ? wn * 16 * FR + g : wn * 32 + 4 * g;

  auto issue = [&](int i) {  // slice tile i into stage i % STAGES (one thread)
    const int st = i % STAGES, kt = t_lo + i;
    const uint32_t dst = base + st * Sh::kStageBytes, bar = smem_addr(&bars[st]);
    mbar_expect_tx(bar, Sh::kWBytes + Sh::kXBytes + Sh::kSBytes);
    if constexpr (NK)
      tma_load_2d(dst, &maps.w, bar, kt * Sh::kKp, n0);
    else
      tma_load_2d(dst, &maps.w, bar, n0, kt * Sh::kKp);
    tma_load_2d(dst + Sh::kWBytes, &maps.x, bar, kt * kTcKT, m0);
    if constexpr (INT4 && !NK)
      tma_load_2d(dst + Sh::kWBytes + Sh::kXBytes, &maps.s, bar, n0, kt * kTcKT / a.group);
  };
  // the same tile, loaded by the block's threads (zeros past K, N and M)
  auto load = [&](int i, unsigned char* sp) {
    const int kt = t_lo + i;
    for (int e = tid; e < Sh::kWBytes; e += Sh::kThreads) {
      if constexpr (NK) {
        const int r = e / Sh::kKp, b = e % Sh::kKp;
        const int n = n0 + r, kp = kt * Sh::kKp + b;
        sp[e] = (kp < kp_end && n < a.N) ? a.q[(int64_t)n * kp_end + kp] : 0;
      } else {
        const int r = e / kTcBN, col = e % kTcBN;
        const int kp = kt * Sh::kKp + r, n = n0 + col;
        sp[swz(r, col)] = (kp < kp_end && n < a.N) ? a.q[(int64_t)kp * a.N + n] : 0;
      }
    }
    const uint16_t* x = static_cast<const uint16_t*>(a.x);
    for (int e = tid; e < Sh::BT * kTcKT; e += Sh::kThreads) {
      const int r = e / kTcKT, kk = e % kTcKT;
      const int m = m0 + r, k = kt * kTcKT + kk;
      *reinterpret_cast<uint16_t*>(sp + Sh::kWBytes + swz(r, 2 * kk)) =
          (m < a.M && k < a.K) ? x[(int64_t)m * a.x_stride + k] : 0;
    }
  };
  // the int4 scale of weight column n (in the block) at element k (0 past
  // K and N)
  auto scale_at = [&](int n, int k) -> float {
    if (k >= a.K || n0 + n >= a.N) return 0.f;
    return NK ? a.scale[(int64_t)(n0 + n) * (a.K / a.group) + k / a.group]
              : a.scale[(int64_t)(k / a.group) * a.N + n0 + n];
  };
  // [N, K] int4 with whole groups in a tile: the scales of the lane's four
  // columns, loaded one tile ahead of their use. The group walks with the
  // tiles (no division in the loop): tile t_lo + i is in group sg, tile sr
  // of its tpg.
  const bool tile_groups = a.group % kTcKT == 0;
  const int tpg = tile_groups ? a.group / kTcKT : 1;
  const int64_t s_row8 = INT4 ? (int64_t)8 * (a.K / a.group) : 0;  // 8 rows of scales
  const float* s_col = a.scale + (NK ? (int64_t)(n0 + cb) * (s_row8 / 8) : 0);
  int sg = t_lo / tpg, sr = t_lo % tpg;
  float s_next[FR][2] = {};
  auto tile_scales = [&]() {  // the next tile's scales, then step to the tile after it
#pragma unroll
    for (int f = 0; f < FR; ++f)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        s_next[f][h] =
            n0 + cb + 16 * f + 8 * h < a.N ? s_col[(2 * f + h) * s_row8 + sg] : 0.f;
    if (++sr == tpg) sr = 0, ++sg;
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_addr(&bars[s]));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (a.tma)
      for (int i = 0; i < STAGES && i < nt; ++i) issue(i);
  }
  if constexpr (NK && INT4) {
    if (tile_groups) tile_scales();
  }
  __syncthreads();

  float acc[FR][NI][4];
#pragma unroll
  for (int f = 0; f < FR; ++f)
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][i][e] = 0.f;

  for (int i = 0; i < nt; ++i) {
    const int st = i % STAGES;
    unsigned char* sp = ring + st * Sh::kStageBytes;
    float s_tile[FR][2] = {};
    if constexpr (NK && INT4) {
      if (tile_groups) {
#pragma unroll
        for (int f = 0; f < FR; ++f)
#pragma unroll
          for (int h = 0; h < 2; ++h) s_tile[f][h] = s_next[f][h];
        if (i + 1 < nt) tile_scales();
      }
    }
    if (a.tma) {
      mbar_wait(smem_addr(&bars[st]), (i / STAGES) & 1);
    } else {
      load(i, sp);
      __syncthreads();
    }
    const unsigned char* wtile = sp;
    if constexpr (NK) {
      // this lane's K 16c .. 16c + 15 of the tile in its four weight rows
      // (row g + 8h of fragment f): 16 int8 or 8 int4 bytes each
      constexpr int kWords = INT4 ? 2 : 4;
      uint32_t w[FR][2][kWords];
#pragma unroll
      for (int f = 0; f < FR; ++f)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const unsigned char* p = wtile + (cb + 16 * f + 8 * h) * Sh::kKp + 4 * kWords * c;
          if constexpr (INT4) {
            const uint2 v = *reinterpret_cast<const uint2*>(p);
            w[f][h][0] = v.x;
            w[f][h][1] = v.y;
          } else {
            const uint4 v = *reinterpret_cast<const uint4*>(p);
            w[f][h][0] = v.x ^ 0x80808080u;
            w[f][h][1] = v.y ^ 0x80808080u;
            w[f][h][2] = v.z ^ 0x80808080u;
            w[f][h][3] = v.w ^ 0x80808080u;
          }
        }
#pragma unroll
      for (int p2 = 0; p2 < 2; ++p2) {
        // A of steps s = 2 p2 + u: registers 0 and 1 (rows g, g + 8) take
        // K 16c + 4s + {0, 1}, registers 2 and 3 take 16c + 4s + {2, 3}
        uint32_t af[2][FR][4];
#pragma unroll
        for (int f = 0; f < FR; ++f) {
          if constexpr (INT4) {
            // word p2 holds steps 2 p2 (bytes 0, 1) and 2 p2 + 1 (bytes 2, 3)
            float sa[2][2], sb[2][2];  // [u][h]: the scale of K 16c + 4s and 16c + 4s + 2
#pragma unroll
            for (int u = 0; u < 2; ++u)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                if (tile_groups) {
                  sa[u][h] = sb[u][h] = s_tile[f][h];
                } else {
                  const int k = (t_lo + i) * kTcKT + 16 * c + 4 * (2 * p2 + u);
                  sa[u][h] = scale_at(cb + 16 * f + 8 * h, k);
                  sb[u][h] = scale_at(cb + 16 * f + 8 * h, k + 2);
                }
              }
            const uint32_t w0 = w[f][0][p2], w1 = w[f][1][p2];
            const uint32_t l0 = w0 & 0x0F0F0F0Fu, h0 = (w0 >> 4) & 0x0F0F0F0Fu;
            const uint32_t l1 = w1 & 0x0F0F0F0Fu, h1 = (w1 >> 4) & 0x0F0F0F0Fu;
            af[0][f][0] = deq4<0>(l0, h0, sa[0][0]);
            af[0][f][1] = deq4<0>(l1, h1, sa[0][1]);
            af[0][f][2] = deq4<1>(l0, h0, sb[0][0]);
            af[0][f][3] = deq4<1>(l1, h1, sb[0][1]);
            af[1][f][0] = deq4<2>(l0, h0, sa[1][0]);
            af[1][f][1] = deq4<2>(l1, h1, sa[1][1]);
            af[1][f][2] = deq4<3>(l0, h0, sb[1][0]);
            af[1][f][3] = deq4<3>(l1, h1, sb[1][1]);
          } else {
#pragma unroll
            for (int u = 0; u < 2; ++u) {  // word s holds step s
              const uint32_t w0 = w[f][0][2 * p2 + u], w1 = w[f][1][2 * p2 + u];
              af[u][f][0] = deq8_pair<0>(w0);
              af[u][f][1] = deq8_pair<0>(w1);
              af[u][f][2] = deq8_pair<2>(w0);
              af[u][f][3] = deq8_pair<2>(w1);
            }
          }
        }
        // B: x of token 8j + g at K 16c + 8 p2 .. + 7, in one 16-byte load:
        // words 0, 1 for step 2 p2 and 2, 3 for step 2 p2 + 1
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const uint4 v = *reinterpret_cast<const uint4*>(
              wtile + Sh::kWBytes + swz(wt * TT + 8 * j + g, 32 * c + 16 * p2));
#pragma unroll
          for (int f = 0; f < FR; ++f) {
            mma_bf16(acc[f][j], af[0][f], v.x, v.y);
            mma_bf16(acc[f][j], af[1][f], v.z, v.w);
          }
        }
      }
    } else {
      const uint32_t xtile = base + st * Sh::kStageBytes + Sh::kWBytes;
      float s4[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (INT4) {
        if (a.tma) {  // G % 64 == 0: the whole tile is in one group
          const float4 v =
              *reinterpret_cast<const float4*>(sp + Sh::kWBytes + Sh::kXBytes + 4 * cb);
          s4[0] = v.x, s4[1] = v.y, s4[2] = v.z, s4[3] = v.w;
        }
      }
#pragma unroll
      for (int s = 0; s < kTcKT / 16; ++s) {
        // A: this lane's weights at elements 2c, 2c + 1 (registers 0, 1) and
        // 2c + 8, 2c + 9 (registers 2, 3) of the step, for columns 4g + 2f
        // (even registers) and 4g + 2f + 1 (odd)
        uint32_t af[2][4];
        if constexpr (INT4) {
          float sa[4], sb[4];
          if (a.tma) {
#pragma unroll
            for (int j = 0; j < 4; ++j) sa[j] = sb[j] = s4[j];
          } else {
            const int k = (t_lo + i) * kTcKT + 16 * s + 2 * c;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              sa[j] = scale_at(cb + j, k);
              sb[j] = scale_at(cb + j, k + 8);
            }
          }
          const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wtile + swz(8 * s + c, cb));
          const uint32_t w1 = *reinterpret_cast<const uint32_t*>(wtile + swz(8 * s + c + 4, cb));
          const uint32_t l0 = w0 & 0x0F0F0F0Fu, h0 = (w0 >> 4) & 0x0F0F0F0Fu;
          const uint32_t l1 = w1 & 0x0F0F0F0Fu, h1 = (w1 >> 4) & 0x0F0F0F0Fu;
          af[0][0] = deq4<0>(l0, h0, sa[0]);
          af[0][1] = deq4<1>(l0, h0, sa[1]);
          af[0][2] = deq4<0>(l1, h1, sb[0]);
          af[0][3] = deq4<1>(l1, h1, sb[1]);
          af[1][0] = deq4<2>(l0, h0, sa[2]);
          af[1][1] = deq4<3>(l0, h0, sa[3]);
          af[1][2] = deq4<2>(l1, h1, sb[2]);
          af[1][3] = deq4<3>(l1, h1, sb[3]);
        } else {
          uint32_t w[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            w[j] = *reinterpret_cast<const uint32_t*>(
                       wtile + swz(16 * s + 2 * c + (j & 1) + 8 * (j >> 1), cb)) ^
                   0x80808080u;
          af[0][0] = deq8<0>(w[0], w[1]);
          af[0][1] = deq8<1>(w[0], w[1]);
          af[0][2] = deq8<0>(w[2], w[3]);
          af[0][3] = deq8<1>(w[2], w[3]);
          af[1][0] = deq8<2>(w[0], w[1]);
          af[1][1] = deq8<3>(w[0], w[1]);
          af[1][2] = deq8<2>(w[2], w[3]);
          af[1][3] = deq8<3>(w[2], w[3]);
        }
        // B: x of token fragment j, elements 16s + 2c, +1 and 16s + 2c + 8, +9
        // of token 8j + g; ldmatrix row (lane & 7) of matrix (lane >> 3)
        uint32_t bf[NI][2];
        const int krow = 2 * (16 * s + 8 * ((lane >> 3) & 1));  // byte in the x row
        if constexpr (NI == 1) {
          ldsm_x2(xtile + swz(wt * TT + (lane & 7), krow), bf[0][0], bf[0][1]);
        } else {
#pragma unroll
          for (int j = 0; j < NI; j += 2) {
            uint32_t r[4];
            ldsm_x4(xtile + swz(wt * TT + 8 * (j + (lane >> 4)) + (lane & 7), krow), r);
            bf[j][0] = r[0], bf[j][1] = r[1], bf[j + 1][0] = r[2], bf[j + 1][1] = r[3];
          }
        }
#pragma unroll
        for (int f = 0; f < 2; ++f)
#pragma unroll
          for (int j = 0; j < NI; ++j) mma_bf16(acc[f][j], af[f], bf[j][0], bf[j][1]);
      }
    }
    __syncthreads();  // every warp is done with the stage
    if (a.tma && tid == 0 && i + STAGES < nt) issue(i + STAGES);
  }

  // the slice's partial sums into this block's shared memory: token rows t
  // and t + 1, this lane's four columns (the ring is free: every copy has
  // landed and been read)
  float* red = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int j = 0; j < NI; ++j) {
    const int t = wt * TT + 8 * j + 2 * c;
    if constexpr (NK) {
#pragma unroll
      for (int f = 0; f < FR; ++f)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = cb + 16 * f + 8 * h;
          red[t * kTcRedStride + col] = acc[f][j][2 * h];
          red[(t + 1) * kTcRedStride + col] = acc[f][j][2 * h + 1];
        }
    } else {
      *reinterpret_cast<float4*>(red + t * kTcRedStride + cb) =
          make_float4(acc[0][j][0], acc[0][j][2], acc[1][j][0], acc[1][j][2]);
      *reinterpret_cast<float4*>(red + (t + 1) * kTcRedStride + cb) =
          make_float4(acc[0][j][1], acc[0][j][3], acc[1][j][1], acc[1][j][3]);
    }
  }
  cluster.sync();

  // rank r finishes its share of the tile's float4s: the S partials added
  // in rank order (the same order whichever block adds them), then int8's
  // per-column scale, one rounding to bf16
  constexpr int kUnits = Sh::BT * kTcBN / 4;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
  for (int u = rank * kUnits / S + tid; u < (rank + 1) * kUnits / S; u += Sh::kThreads) {
    const int t = u / (kTcBN / 4), col = u % (kTcBN / 4) * 4;
    const int m = m0 + t, n = n0 + col;
    if (m >= a.M || n >= a.N) continue;
    float4 part[kTcMaxSlices];  // every remote load in flight before the first add
#pragma unroll
    for (int r = 0; r < kTcMaxSlices; ++r)
      if (r < S)
        part[r] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(red, r) +
                                                   t * kTcRedStride + col);
    float4 v = part[0];
#pragma unroll
    for (int r = 1; r < kTcMaxSlices; ++r)
      if (r < S)
        v = make_float4(v.x + part[r].x, v.y + part[r].y, v.z + part[r].z, v.w + part[r].w);
    float o[4] = {v.x, v.y, v.z, v.w};
    __nv_bfloat16* dst = out + (int64_t)m * a.N + n;
    if (n + 4 <= a.N && a.N % 4 == 0) {
      if (!INT4) {
#pragma unroll
        for (int j = 0; j < 4; ++j) o[j] *= a.scale[n + j];
      }
      uint2 p;
      p.x = pack_bf16x2(o[0], o[1]);
      p.y = pack_bf16x2(o[2], o[3]);
      *reinterpret_cast<uint2*>(dst) = p;
    } else {
      for (int j = 0; j < 4 && n + j < a.N; ++j)
        dst[j] = __float2bfloat16(INT4 ? o[j] : o[j] * a.scale[n + j]);
    }
  }
  cluster.sync();  // no block leaves while another still reads its shared memory
}

// ------------------------------------------------------------------ launch

template <bool INT4, int BM>
cudaError_t launch(int layout, const Args& a, cudaStream_t stream) {
  const dim3 grid((a.N + kBN - 1) / kBN, (a.M + BM - 1) / BM);
  if (layout == 0)
    qmm_kn_kernel<INT4, BM><<<grid, kThreads, 0, stream>>>(a);
  else
    qmm_nk_kernel<INT4, BM><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <bool INT4>
cudaError_t launch_bm(int layout, const Args& a, cudaStream_t stream) {
  // the tile height changes which rows share a weight read, never the
  // order of any output's reduction
  if (a.M <= 1) return launch<INT4, 1>(layout, a, stream);
  if (a.M <= 2) return launch<INT4, 2>(layout, a, stream);
  if (a.M <= 4) return launch<INT4, 4>(layout, a, stream);
  return launch<INT4, 8>(layout, a, stream);
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

// A 2-D [rows, cols] tensor with `row_bytes` between rows as a TMA map read
// in boxes of box_cols x box_rows; elements past either edge read as 0.
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, int rows,
                int cols, int64_t row_bytes, int box_cols, int box_rows,
                CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  // a dimension of extent 1 is never stepped; give it a legal stride
  const cuuint64_t strides[1] = {(cuuint64_t)(rows == 1 ? 16 : row_bytes)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <bool NK, bool INT4, int WT, int TT, int STAGES, int FR = 2>
cudaError_t launch_tc(const TcArgs& a0, cudaStream_t stream) {
  using Sh = TcShape<NK, INT4, WT, TT, STAGES, FR>;
  auto kernel = qmm_tc_kernel<NK, INT4, WT, TT, STAGES, FR>;
  // per instantiation and device: the shared-memory limit, set once (two
  // threads may both set it; that is harmless)
  static std::atomic<bool> ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Sh::smem_bytes);
    if (err != cudaSuccess) return err;
    ready[dev].store(true, std::memory_order_release);
  }
  // TMA needs 16-byte aligned bases and row strides and, for [K, N] int4,
  // one scale group per tile; otherwise the blocks load the same tiles
  // themselves
  TcArgs a = a0;
  const int kp = INT4 ? a.K / 2 : a.K;  // packed bytes of K
  const bool x_ok = aligned16(a.x) && (a.M == 1 || a.x_stride % 8 == 0);
  if (NK)
    a.tma = x_ok && aligned16(a.q) && kp % 16 == 0;
  else
    a.tma = x_ok && aligned16(a.q) && a.N % 16 == 0 &&
            (!INT4 || (a.group % kTcKT == 0 && aligned16(a.scale)));
  TcMaps maps;
  memset(&maps, 0, sizeof(maps));
  if (a.tma) {
    const bool w_ok =
        NK ? tensor_map(&maps.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.q, a.N, kp, kp, Sh::kKp,
                        kTcBN, CU_TENSOR_MAP_SWIZZLE_NONE)
           : tensor_map(&maps.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.q, kp, a.N, a.N, kTcBN,
                        Sh::kKp, CU_TENSOR_MAP_SWIZZLE_128B);
    if (!w_ok ||
        !tensor_map(&maps.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a.x, a.M, a.K, a.x_stride * 2,
                    kTcKT, Sh::BT, CU_TENSOR_MAP_SWIZZLE_128B) ||
        (INT4 && !NK &&
         !tensor_map(&maps.s, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, a.scale, a.K / a.group, a.N,
                     (int64_t)a.N * 4, kTcBN, 1, CU_TENSOR_MAP_SWIZZLE_NONE)))
      return cudaErrorInvalidValue;
  }
  const int S = tc_slices(a.K);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.N + kTcBN - 1) / kTcBN * S, (a.M + Sh::BT - 1) / Sh::BT, 1);
  cfg.blockDim = dim3(Sh::kThreads, 1, 1);
  cfg.dynamicSmemBytes = Sh::smem_bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a, maps);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The token tile (8, 32 or 128 rows a block) only picks which rows share a
// weight tile, and the fragments per warp which warp computes a column;
// every row's sums run in the same order at every M.
template <bool NK, bool INT4>
cudaError_t launch_tc_rows(const TcArgs& a, cudaStream_t stream) {
  // fragments per warp for a few tokens: one for [N, K] int4, whose
  // dequantization bounds the decode step (two for int8, which is faster)
  constexpr int kFew = NK && INT4 ? 1 : 2;
  if (a.M <= 8) return launch_tc<NK, INT4, 1, 8, 6, kFew>(a, stream);
  if (a.M <= 32) return launch_tc<NK, INT4, 1, 32, 6, kFew>(a, stream);
  return launch_tc<NK, INT4, 2, 64, 4>(a, stream);
}

}  // namespace

// layout: 0 = weights [K, N] (K5, K6), 1 = weights [N, K] (K4, K7).
// dtype: 0 = float32, 1 = bfloat16 (x and out). bits: 8 (q int8, scale [N])
// or 4 (q packed uint8, scale [K/G, N] or [N, K/G], group = G). out is a
// contiguous [M, N]. bfloat16 products run on the tensor cores, float32
// ones on the CUDA cores. Returns a cudaError_t (0 = launched).
extern "C" int quant_matmul_launch(int layout, int dtype, int bits,
                                   const void* x, int64_t x_stride,
                                   const void* q, const void* scale, void* out,
                                   int M, int K, int N, int group, int vec,
                                   void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || (layout != 0 && layout != 1))
    return (int)cudaErrorInvalidValue;
  if (bits == 4 && (group <= 0 || group % 2 || K % group))
    return (int)cudaErrorInvalidValue;
  if (bits != 4 && bits != 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    TcArgs t;
    t.x = x;
    t.q = static_cast<const uint8_t*>(q);
    t.scale = static_cast<const float*>(scale);
    t.out = out;
    t.x_stride = x_stride;
    t.M = M;
    t.K = K;
    t.N = N;
    t.group = group;
    t.tma = 0;
    if (layout == 0)
      return (int)(bits == 4 ? launch_tc_rows<false, true>(t, st)
                             : launch_tc_rows<false, false>(t, st));
    return (int)(bits == 4 ? launch_tc_rows<true, true>(t, st)
                           : launch_tc_rows<true, false>(t, st));
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const float*>(x);
  a.q = static_cast<const uint8_t*>(q);
  a.scale = static_cast<const float*>(scale);
  a.out = static_cast<float*>(out);
  a.x_stride = x_stride;
  a.M = M;
  a.K = K;
  a.N = N;
  a.group = group;
  a.vec = vec;
  return (int)(bits == 4 ? launch_bm<true>(layout, a, st) : launch_bm<false>(layout, a, st));
}

// The K split of the tensor-core route (both layouts): elements per tile
// and slices for a K (the constants the CPU tests' model of the split must
// use).
extern "C" int quant_matmul_tc_tile() { return kTcKT; }
extern "C" int quant_matmul_tc_slices(int K) { return K > 0 ? tc_slices(K) : 0; }
