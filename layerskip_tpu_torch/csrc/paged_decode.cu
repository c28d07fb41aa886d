// Paged short-query attention for Hopper (sm_90a): K2 (bf16 or fp32 page
// pool) and K3 (int8 page pool with bf16 scales), exposed through a plain C
// interface and loaded with ctypes (layerskip_tpu_torch/ops/cuda/paged_decode.py).
//
// Replaces: layerskip_tpu/ops/pallas/paged_decode.py::paged_decode_attention
// (K2, kernel body _paged_kernel) and ::paged_decode_attention_q8 (K3,
// _paged_kernel_q8), with their helpers _key_coords, _block_visible and
// _tree_rows, and decode_attention.py::_online_block and _row_positions.
//
// Function. q [B, T, Hq, Dh] (T <= 16) attends over a page pool
// [P, Hkv, page, Dh] read through a page table [B, maxp]: logical key slot
// n * page + i of row b lives at pool[table[b, n], j, i]. Query row (t, g) of
// KV head j is head j * G + g at position pos[b, t]. A key is visible when
// key_pos <= q_pos and, with a window w > 0, key_pos > q_pos - w. With a tree
// (fanout > 1), slots at or past the row's scratch start hold interleaved
// chains: position scratch + rel / fanout, chain rel % fanout, visible only
// to query rows of the same chain (committed slots have chain -1 and are
// visible to all). Scores are scale * q.k in fp32 from the operands' exact
// products, then cap * tanh(s / cap) with a softcap, then masked to -1e30.
// The softmax is online over the logical pages in order, with fp32 m, l and
// acc; a lane is 0 where s <= -1e30 / 2. K2 rounds p to the pool's dtype
// before the PV product; K3 casts q to fp32, dequantizes k and v in fp32
// (int8 * float(bf16 scale)) and keeps p in fp32. The output is acc / l in
// q's dtype (l is clamped at 1e-30, so a row that sees no key returns 0;
// the engine never makes one, every row sees its own slot).
//
// What bounds it on this card: bytes. At decode every visible key and value
// is read once for T * G query rows of at most 16, about 4 * T * G flops per
// byte of bf16 KV: far below the H100's ~295 flop/byte ridge. The least
// time is the visible pages' K and V bytes (plus q and o) at 3.35 TB/s.
//
// Design (simple and right first). One block of 128 threads per (up to 16
// query rows, KV head, batch row), instantiated for 1, 8 or 16 rows so a
// decode step or a verify window does no work for rows it lacks: at the 7B
// decode shape (B 4, Hkv 32, G 1) that is 128 blocks on 132 SMs. The block reads its own table entries (there is
// no scalar prefetch) and walks the row's logical pages in order, skipping a
// page no query row can see (the TPU kernel's block test; per-key masking is
// exact, so a skipped page changes nothing). Each page is taken in tiles of
// 32 keys, whatever its size (16, 128 and 256 all work): the tile's K and V
// rows are contiguous in the pool, read with 16-byte loads that are all in
// flight at once, converted (K3: dequantized) to fp32 and staged in shared
// memory, K padded one float per row so the score loop is free of bank
// conflicts. Scores put one key on each lane and a quarter of Dh on each
// warp, for every query row, so a single decode row (T = 1) keeps all four
// warps busy; the quarters are summed in a fixed order. The online update
// runs one warp per row; the PV product accumulates a register tile of
// rows x Dh / 128 columns per thread. Splitting a row's pages across
// blocks (flash-decoding), asynchronous copies and tensor cores are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kMaxRows = 16;   // query rows (t, g) per block, at most
constexpr int kKeys = 32;      // keys per staged tile, one per lane
constexpr int kThreads = 128;  // four warps
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;
constexpr int kNoScratch = 0x3fffffff;  // int32 max // 2: no tree slots

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f32<int8_t>(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// p as the PV product sees it: rounded to the pool dtype (K2); K3's values
// are dequantized to fp32, so p stays fp32 there.
template <typename TKV>
__device__ __forceinline__ float round_p(float p) {
  return to_f32(from_f32<TKV>(p));
}
template <>
__device__ __forceinline__ float round_p<int8_t>(float p) { return p; }

struct Args {
  const void* q;                  // [B, T, Hq, Dh], strides below
  const void* k;                  // [P, Hkv, page, Dh] contiguous
  const void* v;
  const __nv_bfloat16* k_scale;   // [P, Hkv, page] (K3), else null
  const __nv_bfloat16* v_scale;
  const int* table;               // [B, maxp]
  const int* pos;                 // [B, T]
  const int* chain;               // [B, T], or null: no tree
  const int* scratch;             // [B], or null: no tree
  void* o;                        // [B, T, Hq, Dh], strides below
  int64_t q_sb, q_st, q_sh;
  int64_t o_sb, o_st, o_sh;
  int T, G, Hkv, page, maxp, window, fanout;
  float scale, softcap;
};

template <int DH, int kRows>
constexpr size_t smem_bytes() {
  // q [rows][DH+1], k [keys][DH+1], v [keys][DH], p [rows][keys+1],
  // partial scores [warps][rows][keys+1], m/l/alpha [rows] floats;
  // pos/chain [rows] ints
  return sizeof(float) * ((size_t)kRows * (DH + 1) + (size_t)kKeys * (DH + 1) +
                          (size_t)kKeys * DH + (size_t)(1 + kWarps) * kRows * (kKeys + 1) +
                          3 * kRows) +
         sizeof(int) * 2 * kRows;
}

// kRows (1, 8 or 16) is the block's query-row capacity, picked per call so
// a decode step (T * G = 1) or a verify window (<= 8) does no work for rows
// it does not have.
template <typename TQ, typename TKV, int DH, int kRows>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const Args a) {
  constexpr int QSTR = DH + 1;
  constexpr int KSTR = DH + 1;
  constexpr int PSTR = kKeys + 1;
  constexpr int kColThreads = DH < kThreads ? DH : kThreads;
  // threads share a column across kRowGroups row groups (2 at Dh 64 when
  // the block has more than one row, else 1)
  constexpr int kRowGroups = kThreads / kColThreads < kRows ? kThreads / kColThreads : kRows;
  constexpr int kCols = DH / kColThreads;             // 1, or 2 at Dh 256
  constexpr int kRowsPer = kRows / kRowGroups;
  constexpr int kVec = 16 / sizeof(TKV);  // elements per 16-byte load
  constexpr int kLoads = (kKeys * DH / kVec + kThreads - 1) / kThreads;
  constexpr bool kQ8 = sizeof(TKV) == 1;

  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kRows * QSTR;
  float* vs = ks + kKeys * KSTR;
  float* ps = vs + kKeys * DH;
  float* part = ps + kRows * PSTR;  // [warps][rows][keys + 1] partial scores
  float* m_s = part + kWarps * kRows * PSTR;
  float* l_s = m_s + kRows;
  float* a_s = l_s + kRows;
  int* pos_s = reinterpret_cast<int*>(a_s + kRows);
  int* chain_s = pos_s + kRows;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = blockIdx.x * kRows;
  const int j = blockIdx.y;
  const int b = blockIdx.z;
  const int R = min(kRows, a.T * a.G - r0);  // live query rows of the block

  const TQ* qg = static_cast<const TQ*>(a.q) + b * a.q_sb;
  for (int i = tid; i < kRows * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    float x = 0.f;
    if (r < R) {
      const int rr = r0 + r;
      x = to_f32(qg[(rr / a.G) * a.q_st + (j * a.G + rr % a.G) * a.q_sh + d]);
    }
    qs[r * QSTR + d] = x;
  }
  if (tid < kRows) {
    int p = 0, c = -1;
    if (tid < R) {
      const int t = (r0 + tid) / a.G;
      p = a.pos[b * a.T + t];
      if (a.chain != nullptr) c = a.chain[b * a.T + t];
    }
    pos_s[tid] = p;
    chain_s[tid] = c;
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
    a_s[tid] = 1.f;
  }
  __syncthreads();

  int pos_min = pos_s[0], pos_max = pos_s[0];
  for (int r = 1; r < R; ++r) {
    pos_min = min(pos_min, pos_s[r]);
    pos_max = max(pos_max, pos_s[r]);
  }
  const int scr = a.scratch != nullptr ? a.scratch[b] : kNoScratch;
  const bool tree = a.fanout > 1;

  const int col0 = tid % kColThreads;
  const int rg = tid / kColThreads;  // >= kRowGroups: no row of its own
  float acc[kRowsPer][kCols];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  const TKV* kpool = static_cast<const TKV*>(a.k);
  const TKV* vpool = static_cast<const TKV*>(a.v);
  for (int n = 0; n < a.maxp; ++n) {
    const int start = n * a.page;
    // the smallest position this page holds (tree slots share positions)
    const int blk_min =
        (tree && start >= scr) ? scr + (start - scr) / a.fanout : start;
    if (blk_min > pos_max) continue;
    if (a.window > 0 && start + a.page <= pos_min - a.window + 1) continue;
    const int64_t page_row =
        ((int64_t)a.table[b * a.maxp + n] * a.Hkv + j) * a.page;

    for (int c0 = 0; c0 < a.page; c0 += kKeys) {
      const int nk = min(kKeys, a.page - c0);
      // stage K and V rows [c0, c0 + nk) of the page as fp32: every load
      // of the tile is issued before the first store, so the tile costs
      // one memory latency
      const uint4* kg = reinterpret_cast<const uint4*>(kpool + (page_row + c0) * DH);
      const uint4* vg = reinterpret_cast<const uint4*>(vpool + (page_row + c0) * DH);
      const int nvec = nk * DH / kVec;
      uint4 kr[kLoads], vr[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = tid + u * kThreads;
        if (i < nvec) {
          kr[u] = __ldg(kg + i);
          vr[u] = __ldg(vg + i);
        }
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = tid + u * kThreads;
        if (i < nvec) {
          const int e0 = i * kVec, row = e0 / DH, col = e0 % DH;
          const TKV* ke = reinterpret_cast<const TKV*>(&kr[u]);
          const TKV* ve = reinterpret_cast<const TKV*>(&vr[u]);
          float ksc = 1.f, vsc = 1.f;
          if constexpr (kQ8) {
            ksc = __bfloat162float(a.k_scale[page_row + c0 + row]);
            vsc = __bfloat162float(a.v_scale[page_row + c0 + row]);
          }
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            ks[row * KSTR + col + e] = kQ8 ? to_f32(ke[e]) * ksc : to_f32(ke[e]);
            vs[row * DH + col + e] = kQ8 ? to_f32(ve[e]) * vsc : to_f32(ve[e]);
          }
        }
      }
      __syncthreads();

      // partial scores: lane = key, warp = a quarter of Dh, every row; the
      // quarters are summed in a fixed order below
      if (lane < nk) {
        float sc[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) sc[r] = 0.f;
        const int d0 = warp * (DH / kWarps);
#pragma unroll 4
        for (int d = d0; d < d0 + DH / kWarps; ++d) {
          const float kv = ks[lane * KSTR + d];
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            if (r < R) sc[r] = fmaf(qs[r * QSTR + d], kv, sc[r]);
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (r < R) part[(warp * kRows + r) * PSTR + lane] = sc[r];
      }
      __syncthreads();

      // scores: lane = key, rows warp + 4 i
      {
        const int key = start + c0 + lane;
        int key_pos = key, key_chain = -1;
        if (tree && key >= scr) {
          const int rel = key - scr;
          key_pos = scr + rel / a.fanout;
          key_chain = rel % a.fanout;
        }
#pragma unroll
        for (int i = 0; i < (kRows + kWarps - 1) / kWarps; ++i) {
          const int r = warp + kWarps * i;
          if (r >= kRows) break;
          float s = 0.f;
          if (lane < nk && r < R) {
#pragma unroll
            for (int w = 0; w < kWarps; ++w) s += part[(w * kRows + r) * PSTR + lane];
          }
          s *= a.scale;
          if (a.softcap != 0.f) s = a.softcap * tanhf(s / a.softcap);
          const int qp = pos_s[r];
          const bool vis = lane < nk && key_pos <= qp &&
                           (!tree || key_chain < 0 || key_chain == chain_s[r]) &&
                           (a.window <= 0 || key_pos > qp - a.window);
          ps[r * PSTR + lane] = r < R ? (vis ? s : kNegInf) : 0.f;
        }
      }
      __syncthreads();

      // online softmax update: one warp per row
      for (int r = warp; r < R; r += kWarps) {
        const float s = ps[r * PSTR + lane];
        float mx = s;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, mx);
        const float p = s > kNegInf * 0.5f ? expf(s - m_new) : 0.f;
        float sum = p;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        ps[r * PSTR + lane] = round_p<TKV>(p);
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          a_s[r] = alpha;
          l_s[r] = l_s[r] * alpha + sum;
          m_s[r] = m_new;
        }
      }
      __syncthreads();

      // acc = acc * alpha + P V
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) {
        const int r = rg + kRowGroups * i;
        if (rg < kRowGroups && r < R) {
          const float al = a_s[r];
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[i][c] *= al;
        }
      }
      for (int key = 0; key < nk; ++key) {
        float vv[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) vv[c] = vs[key * DH + col0 + kColThreads * c];
#pragma unroll
        for (int i = 0; i < kRowsPer; ++i) {
          const int r = rg + kRowGroups * i;
          if (rg < kRowGroups && r < R) {
            const float p = ps[r * PSTR + key];
#pragma unroll
            for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
          }
        }
      }
      __syncthreads();
    }
  }

  TQ* og = static_cast<TQ*>(a.o) + b * a.o_sb;
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const int r = rg + kRowGroups * i;
    if (rg < kRowGroups && r < R) {
      const int rr = r0 + r;
      const float denom = fmaxf(l_s[r], 1e-30f);
      TQ* orow = og + (rr / a.G) * a.o_st + (j * a.G + rr % a.G) * a.o_sh;
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        orow[col0 + kColThreads * c] = from_f32<TQ>(acc[i][c] / denom);
    }
  }
}

constexpr int kMaxDevices = 64;

template <typename TQ, typename TKV, int DH, int kRows>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<DH, kRows>();
  // the shared-memory limit is set once per instantiation and device, not
  // before every launch (two threads may both set it; that is harmless)
  static std::atomic<bool> ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !ready[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(paged_decode_kernel<TQ, TKV, DH, kRows>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) ready[dev].store(true, std::memory_order_release);
  }
  const dim3 grid((a.T * a.G + kRows - 1) / kRows, a.Hkv, B);
  paged_decode_kernel<TQ, TKV, DH, kRows><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int DH>
cudaError_t launch_rows(const Args& a, int B, cudaStream_t stream) {
  const int rows = a.T * a.G;
  if (rows == 1) return launch<TQ, TKV, DH, 1>(a, B, stream);
  if (rows <= 8) return launch<TQ, TKV, DH, 8>(a, B, stream);
  return launch<TQ, TKV, DH, kMaxRows>(a, B, stream);
}

template <typename TQ, typename TKV>
cudaError_t launch_dh(int dh, const Args& a, int B, cudaStream_t stream) {
  switch (dh) {
    case 64:
      return launch_rows<TQ, TKV, 64>(a, B, stream);
    case 128:
      return launch_rows<TQ, TKV, 128>(a, B, stream);
    case 256:
      return launch_rows<TQ, TKV, 256>(a, B, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16. kv_dtype: 0 = float32, 1 = bfloat16
// (K2, equal to q_dtype), 2 = int8 with bf16 scales (K3). Strides are in
// elements; head_dim is contiguous. chain and scratch are null without a
// tree. Returns a cudaError_t (0 = launched).
extern "C" int paged_decode_launch(
    int q_dtype, int kv_dtype, int head_dim, const void* q, const void* k,
    const void* v, const void* k_scale, const void* v_scale,
    const void* table, const void* pos, const void* chain,
    const void* scratch, void* o, int64_t q_sb, int64_t q_st, int64_t q_sh,
    int64_t o_sb, int64_t o_st, int64_t o_sh, int B, int T, int G, int Hkv,
    int page, int maxp, int window, int fanout, float scale, float softcap,
    void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.k_scale = static_cast<const __nv_bfloat16*>(k_scale);
  a.v_scale = static_cast<const __nv_bfloat16*>(v_scale);
  a.table = static_cast<const int*>(table);
  a.pos = static_cast<const int*>(pos);
  a.chain = static_cast<const int*>(chain);
  a.scratch = static_cast<const int*>(scratch);
  a.o = o;
  a.q_sb = q_sb;
  a.q_st = q_st;
  a.q_sh = q_sh;
  a.o_sb = o_sb;
  a.o_st = o_st;
  a.o_sh = o_sh;
  a.T = T;
  a.G = G;
  a.Hkv = Hkv;
  a.page = page;
  a.maxp = maxp;
  a.window = window;
  a.fanout = fanout;
  a.scale = scale;
  a.softcap = softcap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0) return (int)launch_dh<float, float>(head_dim, a, B, st);
  if (q_dtype == 1 && kv_dtype == 1)
    return (int)launch_dh<__nv_bfloat16, __nv_bfloat16>(head_dim, a, B, st);
  if (q_dtype == 0 && kv_dtype == 2) return (int)launch_dh<float, int8_t>(head_dim, a, B, st);
  if (q_dtype == 1 && kv_dtype == 2)
    return (int)launch_dh<__nv_bfloat16, int8_t>(head_dim, a, B, st);
  return (int)cudaErrorInvalidValue;
}
