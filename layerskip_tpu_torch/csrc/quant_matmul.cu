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
// summed depends only on K (fixed chunking, a fixed per-thread order and a
// fixed cross-thread reduction), never on M or on the row's place in the
// batch. The M tile (1, 2, 4 or 8 rows) only selects which rows share a
// weight read. So an AR step (M = 1) and a verify window (M = W + 1) give
// bit-identical rows, which greedy AR == self-spec in fp32 needs.
//
// What bounds it on this card: at decode (M of 1 to a few) the product reads
// every weight byte once and does 2 flops per weight per row: ~2 flop/byte,
// far below the H100's ~295 flop/byte ridge, so bytes bound it (a 7B
// [4096, 11008] int8 weight: 45 MB, 13.5 us at 3.35 TB/s). At a 256-row
// prefill it is ~500 flop/byte and would be compute-bound on the tensor
// cores; this kernel computes on the fp32 CUDA cores instead.
//
// Design (a simple, correct first version; mma.sync/wgmma, TMA and a
// split-K across blocks to fill the card at M = 1 are a later revision's):
//   [K, N] weights (K5, K6): N is contiguous, so threads run along N. A
//     block of 256 threads owns 32 output columns and BM rows; 8 threads
//     cover the 32 bytes of a weight row (one 32-bit load each, 4 columns),
//     32 thread rows take 16 consecutive packed rows each per 512-row chunk
//     (16 loads in flight per thread), and the 32 partial sums of each
//     output are added in a fixed order through shared memory.
//   [N, K] weights (K4, K7): K is contiguous, so a warp reads along K. Each
//     warp owns 4 output columns and each lane 16 consecutive bytes of each
//     (one 16-byte load per column per 512-byte chunk); the lane sums are
//     added by a butterfly of warp shuffles, which gives every lane the same
//     value. x is staged in shared memory padded by one float per lane
//     segment, so the lanes read distinct banks.
// In both, the chunk of x that the block needs is staged in shared memory as
// fp32 once per chunk and shared by every column of the block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 32;  // output columns per block

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// An fp32 value rounded to T and back: the dequantized int4 weight in x's dtype.
template <typename T>
__device__ __forceinline__ float round_to(float w) {
  return to_f32(from_f32<T>(w));
}

struct Args {
  const void* x;
  const uint8_t* q;
  const float* scale;
  void* out;
  int64_t x_stride;  // elements between rows of x
  int M, K, N, group;
  int vec;  // the weight rows allow aligned vector loads
};

// Stage x[m0 : m0 + BM, e0 : e0 + EPC] into shared memory as fp32 (zeros
// past M and K). With SEG > 0, one float of padding follows every SEG
// elements.
template <int EPC, int SEG>
__host__ __device__ constexpr int padded_row() {
  if constexpr (SEG > 0) return EPC + EPC / SEG;
  return EPC;
}

template <typename T, int BM, int EPC, int SEG>
__device__ __forceinline__ void stage_x(float* xs, const Args& a, int m0,
                                        int e0) {
  constexpr int XS = padded_row<EPC, SEG>();
  const T* x = static_cast<const T*>(a.x);
  for (int i = threadIdx.x; i < BM * EPC; i += kThreads) {
    const int m = i / EPC, e = i % EPC;
    const int k = e0 + e;
    float v = 0.f;
    if (m0 + m < a.M && k < a.K) v = to_f32(x[(int64_t)(m0 + m) * a.x_stride + k]);
    int idx = m * XS + e;
    if constexpr (SEG > 0) idx += e / SEG;
    xs[idx] = v;
  }
}

// ---------------------------------------------------------------- [K, N]

template <typename T, bool INT4, int BM>
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
    stage_x<T, BM, EPC, 0>(smem, a, m0, c0 * EL);
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
          w0[c] = round_to<T>((float)((int)(byte & 0xFu) - 8) * s[c]);
          w1[c] = round_to<T>((float)((int)(byte >> 4) - 8) * s[c]);
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
  T* out = static_cast<T*>(a.out);
  for (int i = tid; i < BM * kBN; i += kThreads) {
    const int m = i / kBN, col = i % kBN, n = n0 + col;
    float sum = 0.f;
    for (int t = 0; t < TY; ++t) sum += red[(t * BM + m) * kBN + col];
    if (m0 + m < a.M && n < a.N) {
      if (!INT4) sum *= a.scale[n];
      out[(int64_t)(m0 + m) * a.N + n] = from_f32<T>(sum);
    }
  }
}

// ---------------------------------------------------------------- [N, K]

template <typename T, bool INT4, int BM>
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
    stage_x<T, BM, EPC, SEG>(xs, a, m0, c0 * EL);
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
          w0[j] = round_to<T>((float)((int)(byte & 0xFu) - 8) * sj);
          w1[j] = round_to<T>((float)((int)(byte >> 4) - 8) * sj);
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
    T* out = static_cast<T*>(a.out);
#pragma unroll
    for (int m = 0; m < BM; ++m)
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int n = nb + j;
        if (m0 + m < a.M && n < a.N) {
          const float v = INT4 ? acc[m][j] : acc[m][j] * a.scale[n];
          out[(int64_t)(m0 + m) * a.N + n] = from_f32<T>(v);
        }
      }
  }
}

template <typename T, bool INT4, int BM>
cudaError_t launch(int layout, const Args& a, cudaStream_t stream) {
  const dim3 grid((a.N + kBN - 1) / kBN, (a.M + BM - 1) / BM);
  if (layout == 0)
    qmm_kn_kernel<T, INT4, BM><<<grid, kThreads, 0, stream>>>(a);
  else
    qmm_nk_kernel<T, INT4, BM><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool INT4>
cudaError_t launch_bm(int layout, const Args& a, cudaStream_t stream) {
  // the tile height changes which rows share a weight read, never the
  // order of any output's reduction
  if (a.M <= 1) return launch<T, INT4, 1>(layout, a, stream);
  if (a.M <= 2) return launch<T, INT4, 2>(layout, a, stream);
  if (a.M <= 4) return launch<T, INT4, 4>(layout, a, stream);
  return launch<T, INT4, 8>(layout, a, stream);
}

}  // namespace

// layout: 0 = weights [K, N] (K5, K6), 1 = weights [N, K] (K4, K7).
// dtype: 0 = float32, 1 = bfloat16 (x and out). bits: 8 (q int8, scale [N])
// or 4 (q packed uint8, scale [K/G, N] or [N, K/G], group = G). out is a
// contiguous [M, N]. Returns a cudaError_t (0 = launched).
extern "C" int quant_matmul_launch(int layout, int dtype, int bits,
                                   const void* x, int64_t x_stride,
                                   const void* q, const void* scale, void* out,
                                   int M, int K, int N, int group, int vec,
                                   void* stream) {
  Args a;
  a.x = x;
  a.q = static_cast<const uint8_t*>(q);
  a.scale = static_cast<const float*>(scale);
  a.out = out;
  a.x_stride = x_stride;
  a.M = M;
  a.K = K;
  a.N = N;
  a.group = group;
  a.vec = vec;
  if (M <= 0 || K <= 0 || N <= 0 || (layout != 0 && layout != 1))
    return (int)cudaErrorInvalidValue;
  if (bits == 4 && (group <= 0 || group % 2 || K % group))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && bits == 8) return (int)launch_bm<float, false>(layout, a, st);
  if (dtype == 0 && bits == 4) return (int)launch_bm<float, true>(layout, a, st);
  if (dtype == 1 && bits == 8) return (int)launch_bm<__nv_bfloat16, false>(layout, a, st);
  if (dtype == 1 && bits == 4) return (int)launch_bm<__nv_bfloat16, true>(layout, a, st);
  return (int)cudaErrorInvalidValue;
}
