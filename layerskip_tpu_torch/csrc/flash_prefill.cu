// Flash prefill attention for Hopper (sm_90a), exposed through a plain C
// interface and loaded with ctypes (layerskip_tpu_torch/ops/cuda/flash_prefill.py).
//
// Replaces: layerskip_tpu/ops/pallas/flash_prefill.py::flash_prefill_attention
// (kernel body _flash_kernel). Same function: causal GQA attention of a
// prompt block q [B, T, Hq, Dh] over the KV cache k, v [B, S, Hkv, Dh] with
// a scalar past offset. Query row i sits at position past + i and sees key j
// when j <= past + i and, with a window w > 0, j > past + i - w. Scores are
// scale * q.k (then cap * tanh(s / cap) with a softcap); the softmax is
// online with fp32 running max, denominator and accumulator; masked lanes
// give p = 0 and the denominator is clamped at 1e-30, so a fully masked row
// returns 0; p is rounded to the value dtype before the PV product.
//
// What bounds it on this card: at the main path's prefill shapes (T of a few
// hundred, Dh = 128) the work is ~4*T*S_visible*Dh flops per head against
// reading Q, the visible K/V once and writing O, about 64 flop/byte in bf16 —
// below the H100's ~295 flop/byte ridge, so the ideal kernel is bound by
// memory bytes. Computing it on the fp32 CUDA cores (as this kernel does)
// moves the limit to the FMA rate and shared-memory bandwidth instead.
//
// Design: one thread block of 256 threads per (64-query tile, query head,
// batch row). Q is staged in shared memory once; a loop walks 64-key tiles
// from the window's first tile to the causal frontier (tiles wholly above
// the frontier or outside the window are never loaded, as the TPU kernel
// skips them). Each tile is staged into shared memory as fp32 (padded rows,
// so the score loop is free of bank conflicts), the 64x64 score tile is
// formed with 4x4 register micro-tiles, the online-softmax update runs with
// four threads per row, and the PV product accumulates a 4 x Dh/16 fp32
// register tile per thread. Q, K, V and O are read and written in their
// native [B, S, H, Dh] layout through strides: no transposed copy of the
// cache is made (the TPU wrapper transposes the whole cache per call).
// Tensor cores (mma.sync / wgmma) and asynchronous copies are left for a
// later revision.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

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
  return __float2bfloat16(x);
}

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

template <int DH>
constexpr size_t smem_floats() {
  // q [BQ][DH+1], k [BK][DH+1], v [BK][DH], s [BQ][BK+1], m/l/alpha [BQ]
  return (size_t)kBQ * (DH + 1) + (size_t)kBK * (DH + 1) + (size_t)kBK * DH +
         (size_t)kBQ * (kBK + 1) + 3 * kBQ;
}

template <typename T, int DH>
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

  const T* qg = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  T* og = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  for (int i = tid; i < kBQ * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    const int t = q0 + r;
    qs[r * QSTR + d] = t < a.T ? to_f32(qg[(int64_t)t * a.q_st + d]) : 0.f;
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

  // Key tiles that hold any key visible to some query of this tile.
  const int t_last = min(q0 + kBQ, a.T) - 1;
  const int first_pos = a.past + q0;
  const int k_lo = a.window > 0 ? max(0, first_pos - a.window + 1) : 0;
  const int k_hi = min(a.past + t_last, a.S - 1);
  const int kb_lo = k_lo / kBK;
  const int kb_hi = k_hi >= k_lo ? k_hi / kBK : kb_lo - 1;
  __syncthreads();

  for (int kb = kb_lo; kb <= kb_hi; ++kb) {
    const int k0 = kb * kBK;
    for (int i = tid; i < kBK * DH; i += kThreads) {
      const int r = i / DH, d = i % DH;
      const int s = k0 + r;
      const bool in = s < a.S;
      ks[r * KSTR + d] = in ? to_f32(kg[(int64_t)s * a.k_ss + d]) : 0.f;
      vs[r * DH + d] = in ? to_f32(vg[(int64_t)s * a.v_ss + d]) : 0.f;
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
        row[c] = to_f32(from_f32<T>(p));  // p in the value dtype for PV
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
        og[(int64_t)t * a.o_st + tx + 16 * j] = from_f32<T>(acc[i][j] / denom);
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const Args& a, int B, int Hq, cudaStream_t stream) {
  const size_t smem = smem_floats<DH>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel<T, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T + kBQ - 1) / kBQ, Hq, B);
  flash_prefill_kernel<T, DH><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(int dh, const Args& a, int B, int Hq,
                      cudaStream_t stream) {
  switch (dh) {
    case 64:
      return launch<T, 64>(a, B, Hq, stream);
    case 128:
      return launch<T, 128>(a, B, Hq, stream);
    case 256:
      return launch<T, 256>(a, B, Hq, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the head_dim
// axis must be contiguous. Returns a cudaError_t (0 = launched).
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
  if (dtype == 0) return (int)launch_dh<float>(head_dim, a, B, Hq, st);
  if (dtype == 1) return (int)launch_dh<__nv_bfloat16>(head_dim, a, B, Hq, st);
  return (int)cudaErrorInvalidValue;
}
