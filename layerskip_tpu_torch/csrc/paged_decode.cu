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
// visible to all). Scores are scale * q.k in fp32, then cap * tanh(s / cap)
// with a softcap, then masked to -1e30. The softmax is online with fp32 m,
// l and acc; a lane is 0 where s <= -1e30 / 2. K2 rounds p to the pool's
// dtype before the PV product; K3 reads int8 keys and values, folds the
// per-key bf16 scales into the score (ks * (q . k_i8)) and into p for the
// PV product ((p * vs) * v_i8), and keeps p in fp32. The output is acc / l
// in q's dtype (l is clamped at 1e-30, so a row that sees no key returns
// 0; the engine never makes one, every row sees its own slot).
//
// What bounds it on this card: bytes. At decode every visible key and value
// is read once for T * G query rows of at most 16, about 4 * T * G flops per
// byte of bf16 KV: far below the H100's ~295 flop/byte ridge. The least
// time is the visible keys' K and V bytes (plus q and o) at 3.35 TB/s, so
// the design keeps many bytes in flight on every SM.
//
// Design (split-KV, "flash-decoding", one launch per call).
// * A row's keys are cut into chunks of a fixed size per (Dh, pool dtype):
//   8 KB of K (32 keys of bf16 at Dh 128, 64 of int8, 16 of fp32; at least
//   16). Chunk c belongs to virtual rank c % 8, and each virtual rank keeps
//   fp32 partials (m, l, acc) over its chunks, in order, skipping a chunk
//   no query row of the block can see (the TPU kernel's block test;
//   masking is exact per key, so a skipped chunk and a fully masked one
//   give the same bits). The 8 partials merge in virtual-rank order (never
//   in arrival order, no atomics). None of this depends on B, T, maxp or
//   the card, so a row's output is the same bits alone or beside other rows.
// * A thread-block cluster of P blocks serves one (up to 16 query rows, KV
//   head, batch row); block r computes the virtual ranks r, r + P, ... one
//   after another. The launch takes the largest P of 8, 4, 2, 1 that keeps
//   the grid within 4 blocks per SM: at B 1 a 2000-key row is walked by 8
//   blocks, and at the 7B serving shape (B 4, Hkv 32) 4 blocks per row
//   fill the card in one wave where a whole-row block gave 128 blocks.
//   After a cluster barrier each block merges a share of the outputs from
//   the 8 partials through distributed shared memory and writes it. No
//   second kernel and no workspace.
// * Chunks arrive by 1-D bulk copies (cp.async.bulk, the TMA without a
//   tensor map) into a two-stage ring completing on mbarriers: one head's
//   [page, Dh] slab of a pool page is contiguous, so a chunk is one copy per
//   page it touches for K, for V and (K3) for each scale. Warp 0 issues
//   them, one lane per page; a scale run that is not 16 bytes in size and
//   alignment (pages of other than a multiple of 8 slots) the lane copies
//   with plain loads before it arrives on the barrier. It fetches the first
//   chunks' table entries
//   while q and the positions load, and the next chunk's while the current
//   one is computed, so chunk i + 1 (and the other blocks' chunks) load
//   while chunk i is computed.
// * Tiles stay in their pool dtype in shared memory and are converted in
//   registers: no fp32 staging copy. Scores put DH / 8 lanes (bf16; DH / 16
//   for int8, DH / 4 for fp32, at most 32) on one key with 16-byte loads;
//   a butterfly sums each row over those lanes and, while a lane holds
//   several rows, hands half of them to its partner at each step, so a
//   verify window costs few shuffles and a query row's sum order is fixed
//   by (Dh, dtype) alone, whatever the number of rows. PV gives each thread
//   4 columns and a fixed quarter of the chunk's keys (at Dh 128; an eighth
//   at Dh 64, a half at Dh 256); the key groups' sums are added in group
//   order when a virtual rank's partial is stored.
// * The block's row capacity is instantiated for 1, 8 or 16 rows, so a
//   decode step (T * G = 1) or a verify window does no work for rows it
//   lacks; q lives in registers for one row, in shared memory otherwise.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxRows = 16;   // query rows (t, g) per block, at most
constexpr int kThreads = 128;  // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kSplits = 8;     // virtual ranks that split one row's chunks
constexpr int kStages = 2;     // chunks in the copy ring
constexpr int kChunkKBytes = 8192;  // K bytes of one chunk (before the 16-key floor)
constexpr float kNegInf = -1e30f;
constexpr int kNoScratch = 0x3fffffff;  // int32 max // 2: no tree slots

// Geometry of one (pool dtype, Dh) instantiation.
template <typename TKV, int DH>
struct Geo {
  static constexpr int kEsize = sizeof(TKV);
  static constexpr int kChunk =
      kChunkKBytes / (DH * kEsize) < 16 ? 16 : kChunkKBytes / (DH * kEsize);
  static constexpr bool kQ8 = kEsize == 1;
  static constexpr int kVec = 16 / kEsize;  // elements per 16-byte load
  static constexpr int kVecsPerRow = DH / kVec;
  // scores: kLK lanes per key, kVL 16-byte vectors per lane, kKW keys per
  // warp per step
  static constexpr int kLK = kVecsPerRow < 32 ? kVecsPerRow : 32;
  static constexpr int kVL = kVecsPerRow / kLK;
  static constexpr int kKW = 32 / kLK;
  static constexpr int kScoreSteps = kChunk / (kWarps * kKW);
  static constexpr int kSoftPerLane = (kChunk + 31) / 32;
  // PV: 4 columns per thread, kKG key groups of kKPG keys each
  static constexpr int kPvThreads = DH / 4;
  static constexpr int kKG = kThreads / kPvThreads;
  static constexpr int kKPG = kChunk / kKG;
  static constexpr int kRowBytes = DH * kEsize;
  static constexpr int kKBytes = kChunk * kRowBytes;  // one K (or V) chunk
  static constexpr int kScaleBytes = kQ8 ? kChunk * 2 : 0;
  static constexpr int kStageBytes = 2 * kKBytes + 2 * kScaleBytes;
  static_assert(kChunk % (kWarps * kKW) == 0, "score steps");
  static_assert(kKPG % 4 == 0, "PV key groups");
  static_assert(kScaleBytes % 16 == 0, "bulk copies move multiples of 16 bytes");
};

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

__device__ __forceinline__ float bf16_bits_f32(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

// 32-bit word w holding 4 / sizeof(T) elements -> floats at out
template <typename T>
__device__ __forceinline__ void word_f32(uint32_t w, float* out);
template <>
__device__ __forceinline__ void word_f32<float>(uint32_t w, float* out) {
  out[0] = __uint_as_float(w);
}
template <>
__device__ __forceinline__ void word_f32<__nv_bfloat16>(uint32_t w, float* out) {
  out[0] = __uint_as_float(w << 16);
  out[1] = __uint_as_float(w & 0xffff0000u);
}
template <>
__device__ __forceinline__ void word_f32<int8_t>(uint32_t w, float* out) {
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = static_cast<float>(static_cast<int8_t>(w >> (8 * i)));
}

// 16 bytes of shared memory at p -> 16 / sizeof(T) floats
template <typename T>
__device__ __forceinline__ void load16_f32(const void* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  constexpr int kPer = 4 / sizeof(T) > 0 ? 4 / sizeof(T) : 1;
  word_f32<T>(u.x, out);
  word_f32<T>(u.y, out + kPer);
  word_f32<T>(u.z, out + 2 * kPer);
  word_f32<T>(u.w, out + 3 * kPer);
}

// 4 elements of shared memory at p -> 4 floats
template <typename T>
__device__ __forceinline__ void load4_f32(const void* p, float* out);
template <>
__device__ __forceinline__ void load4_f32<float>(const void* p, float* out) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  out[0] = f.x;
  out[1] = f.y;
  out[2] = f.z;
  out[3] = f.w;
}
template <>
__device__ __forceinline__ void load4_f32<__nv_bfloat16>(const void* p, float* out) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  word_f32<__nv_bfloat16>(u.x, out);
  word_f32<__nv_bfloat16>(u.y, out + 2);
}
template <>
__device__ __forceinline__ void load4_f32<int8_t>(const void* p, float* out) {
  word_f32<int8_t>(*reinterpret_cast<const uint32_t*>(p), out);
}

// p as K2's PV product sees it: rounded to the pool dtype
template <typename TKV>
__device__ __forceinline__ float round_p(float p) {
  return to_f32(from_f32<TKV>(p));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a barrier that completes a phase after 32 arrivals (the lanes of warp 0)
// and the bytes they announced
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 32;\n" ::"r"(bar) : "memory");
}

// expect `bytes` more of asynchronous copies in the current phase (no arrival)
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// one arrival; it releases this thread's earlier shared-memory stores
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
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

// 1-D bulk copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from global memory into this block's shared memory at dst,
// completing on the mbarrier at bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Sums each of kN rows' partials over a key's kLK lanes (xor offsets
// kLK / 2, ..., 1). While a lane holds more than one row, each stage also
// transposes: the lane keeps half of its rows, sends the other half to its
// partner and adds the partner's half of its own, so the rows spread over
// the lanes and each stage costs kN / 2 shuffles, not kN. Row r is summed
// over the same tree (own + partner at each offset) as a plain butterfly,
// so its bits do not depend on kN. On return the lane holds kHeld rows,
// base .. base + kHeld - 1, in s[0 .. kHeld); kRep lanes hold each.
template <int kLK, int kN>
struct Butterfly {
  static constexpr int kHeld = kN > kLK ? kN / kLK : 1;
  static constexpr int kRep = kLK * kHeld / kN;
  template <int kArr>
  __device__ __forceinline__ static void run(float (&s)[kArr], int lane, int& base) {
    if constexpr (kLK > 1) {
      constexpr int o = kLK / 2;
      if constexpr (kN > 1) {
        constexpr int half = kN / 2;
        const bool up = (lane & o) != 0;
#pragma unroll
        for (int i = 0; i < half; ++i) {
          const float send = up ? s[i] : s[i + half];
          const float keep = up ? s[i + half] : s[i];
          s[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
        }
        base += up ? half : 0;
        Butterfly<o, half>::run(s, lane, base);
      } else {
        s[0] += __shfl_xor_sync(0xffffffffu, s[0], o);
        Butterfly<o, 1>::run(s, lane, base);
      }
    }
  }
};

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

// ring | mbarriers | q [rows][DH] | scores/p [rows][chunk] |
// slot acc [slots][rows][DH] | m, l, alpha [rows] | slot m, l [slots][rows] |
// pos, chain [rows]
template <typename TKV, int DH, int kRows>
constexpr size_t smem_bytes(int nslots) {
  using Gm = Geo<TKV, DH>;
  return (size_t)kStages * Gm::kStageBytes + kStages * sizeof(uint64_t) +
         sizeof(float) * ((size_t)kRows * DH + (size_t)kRows * Gm::kChunk +
                          (size_t)nslots * kRows * DH + 3 * kRows + 2 * (size_t)nslots * kRows) +
         sizeof(int) * 2 * kRows;
}

// kRows (1, 8 or 16) is the block's query-row capacity, picked per call so
// a decode step (T * G = 1) or a verify window (<= 8) does no work for rows
// it does not have. Every block of a cluster has the same rows, KV head and
// batch row. Virtual rank v (of kSplits) takes chunks v, v + kSplits, ...;
// cluster block r of P serves the virtual ranks r, r + P, ... in turn, one
// partial slot each.
template <typename TQ, typename TKV, int DH, int kRows>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(const Args a) {
  using Gm = Geo<TKV, DH>;
  constexpr int kChunk = Gm::kChunk;
  constexpr bool kQ8 = Gm::kQ8;

  cg::cluster_group cluster = cg::this_cluster();
  const int P = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int nslots = kSplits / P;

  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kStages * Gm::kStageBytes);
  float* qs = reinterpret_cast<float*>(bars + kStages);
  float* sp = qs + kRows * DH;
  float* slot_acc = sp + kRows * kChunk;
  float* m_s = slot_acc + nslots * kRows * DH;
  float* l_s = m_s + kRows;
  float* a_s = l_s + kRows;
  float* slot_m = a_s + kRows;
  float* slot_l = slot_m + nslots * kRows;
  int* pos_s = reinterpret_cast<int*>(slot_l + nslots * kRows);
  int* chain_s = pos_s + kRows;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = (blockIdx.x / P) * kRows;
  const int j = blockIdx.y;
  const int b = blockIdx.z;
  const int R = min(kRows, a.T * a.G - r0);  // live query rows of the block
  const int S = a.maxp * a.page;  // logical key slots of the row
  const int nchunks = (S + kChunk - 1) / kChunk;

  // warp 0, lane l: the table entry of the l-th page chunk c touches
  auto fetch = [&](int c) -> int {
    if (c < 0) return 0;
    const int n = c * kChunk / a.page + lane;
    return n * a.page < min(c * kChunk + kChunk, S) ? a.table[b * a.maxp + n] : 0;
  };
  // the table entries of this block's first kStages chunks if none is
  // skipped, fetched before the positions are known (the prologue fetches
  // again where one is)
  int tab_early[kStages];
#pragma unroll
  for (int s = 0; s < kStages; ++s) tab_early[s] = warp == 0 ? fetch(rank + s * kSplits) : 0;

  // q rows as fp32 (rows past R as 0): every load issued before the first store
  constexpr int kQPer = (kRows * DH + kThreads - 1) / kThreads;
  const TQ* qg = static_cast<const TQ*>(a.q) + b * a.q_sb;
  float qx[kQPer];
#pragma unroll
  for (int u = 0; u < kQPer; ++u) {
    const int i = tid + u * kThreads;
    const int r = i / DH, d = i % DH;
    qx[u] = 0.f;
    if (r < R) {
      const int rr = r0 + r;
      qx[u] = to_f32(__ldg(qg + (rr / a.G) * a.q_st + (j * a.G + rr % a.G) * a.q_sh + d));
    }
  }
#pragma unroll
  for (int u = 0; u < kQPer; ++u)
    if (tid + u * kThreads < kRows * DH) qs[tid + u * kThreads] = qx[u];
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
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(smem_addr(bars + s));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int pos_min = pos_s[0], pos_max = pos_s[0];
  for (int r = 1; r < R; ++r) {
    pos_min = min(pos_min, pos_s[r]);
    pos_max = max(pos_max, pos_s[r]);
  }
  const int scr = a.scratch != nullptr ? a.scratch[b] : kNoScratch;
  const bool tree = a.fanout > 1;

  // the next chunk from c on (in steps of kSplits) that some query row of
  // the block can see, or -1. Positions grow with the slot (tree slots share
  // them), so once a chunk lies past every row's position, all later do.
  auto next_chunk = [&](int c) -> int {
    for (; c < nchunks; c += kSplits) {
      const int start = c * kChunk;
      const int blk_min = (tree && start >= scr) ? scr + (start - scr) / a.fanout : start;
      if (blk_min > pos_max) return -1;
      if (a.window > 0 && min(start + kChunk, S) <= pos_min - a.window + 1) continue;
      return c;
    }
    return -1;
  };
  // this block's work in order: partial slot s (virtual rank rank + s * P),
  // chunk c; past the last, s = nslots and c = -1
  auto first_from = [&](int s, int& c) -> int {
    for (; s < nslots; ++s) {
      c = next_chunk(rank + s * P);
      if (c >= 0) return s;
    }
    c = -1;
    return nslots;
  };
  auto advance = [&](int& s, int& c) {
    c = next_chunk(c + kSplits);
    if (c < 0) s = first_from(s + 1, c);
  };

  // warp 0: chunk c's K, V (and scales) into ring stage `stage`, one lane
  // per page the chunk touches (tab: that page's table entry, from fetch).
  // Each lane announces the bytes of its bulk copies before it issues them
  // and arrives once at the end. A K3 scale run that a bulk copy cannot move
  // (not a multiple of 16 bytes in size, source or destination alignment:
  // pages of other than a multiple of 8 slots) the lane copies itself,
  // before it arrives.
  const TKV* kpool = static_cast<const TKV*>(a.k);
  const TKV* vpool = static_cast<const TKV*>(a.v);
  auto issue = [&](int c, int stage, int tab) {
    const int start = c * kChunk;
    const int end = min(start + kChunk, S);
    const uint32_t bar = smem_addr(bars + stage);
    unsigned char* st = ring + stage * Gm::kStageBytes;
    for (int n = start / a.page + lane; n * a.page < end; n += 32) {
      if (n - start / a.page >= 32) tab = a.table[b * a.maxp + n];
      const int k0 = max(start, n * a.page), k1 = min(end, (n + 1) * a.page);
      const int64_t row = ((int64_t)tab * a.Hkv + j) * a.page + (k0 - n * a.page);
      const uint32_t off = (uint32_t)(k0 - start);
      const uint32_t nb = (uint32_t)(k1 - k0) * Gm::kRowBytes;
      bool bulk_scales = false;
      if constexpr (kQ8) {
        const uint32_t sb = (uint32_t)(k1 - k0) * 2;
        bulk_scales = sb % 16 == 0 && (off * 2) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(a.k_scale + row) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(a.v_scale + row) % 16 == 0;
        mbar_expect_tx(bar, 2 * nb + (bulk_scales ? 2 * sb : 0));
      } else {
        mbar_expect_tx(bar, 2 * nb);
      }
      bulk_load(smem_addr(st + off * Gm::kRowBytes), kpool + row * DH, nb, bar);
      bulk_load(smem_addr(st + Gm::kKBytes + off * Gm::kRowBytes), vpool + row * DH, nb, bar);
      if constexpr (kQ8) {
        unsigned char* ks = st + 2 * Gm::kKBytes + off * 2;
        unsigned char* vs = ks + Gm::kScaleBytes;
        if (bulk_scales) {
          bulk_load(smem_addr(ks), a.k_scale + row, (uint32_t)(k1 - k0) * 2, bar);
          bulk_load(smem_addr(vs), a.v_scale + row, (uint32_t)(k1 - k0) * 2, bar);
        } else {
          const uint16_t* ksrc = reinterpret_cast<const uint16_t*>(a.k_scale + row);
          const uint16_t* vsrc = reinterpret_cast<const uint16_t*>(a.v_scale + row);
          for (int i = 0; i < k1 - k0; ++i) {
            reinterpret_cast<uint16_t*>(ks)[i] = ksrc[i];
            reinterpret_cast<uint16_t*>(vs)[i] = vsrc[i];
          }
        }
      }
    }
    mbar_arrive(bar);
  };

  // scores: lane li of a key's kLK lanes holds vectors li + v * kLK of q
  const int li = lane % Gm::kLK;
  float qreg[kRows == 1 ? Gm::kVL * Gm::kVec : 1];
  if constexpr (kRows == 1) {
#pragma unroll
    for (int v = 0; v < Gm::kVL; ++v)
#pragma unroll
      for (int e = 0; e < Gm::kVec; ++e) qreg[v * Gm::kVec + e] = qs[(li + v * Gm::kLK) * Gm::kVec + e];
  }
  // PV: thread owns columns c4 .. c4 + 3 and keys [kg * kKPG, (kg + 1) *
  // kKPG) of each chunk
  const int kg = tid / Gm::kPvThreads;
  const int c4 = (tid % Gm::kPvThreads) * 4;
  float acc[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[r][x] = 0.f;

  // the running (m, l, acc) into partial slot s, the key groups' acc
  // summed in group order, and a fresh start; m_s and l_s are final after
  // the barrier that ends a chunk. Every thread of the block calls it.
  auto finalize = [&](int s) {
    for (int g = 0; g < Gm::kKG; ++g) {
      if (kg == g) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r >= R) break;
          float4* dst = reinterpret_cast<float4*>(slot_acc + (s * kRows + r) * DH + c4);
          float4 v = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
          if (g > 0) {
            const float4 w = *dst;
            v = make_float4(w.x + v.x, w.y + v.y, w.z + v.z, w.w + v.w);
          }
          *dst = v;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[r][x] = 0.f;
    if (tid < kRows) {
      slot_m[s * kRows + tid] = m_s[tid];
      slot_l[s * kRows + tid] = l_s[tid];
      m_s[tid] = kNegInf;
      l_s[tid] = 0.f;
    }
  };

  // prologue: the first kStages chunks in flight (their table entries
  // mostly fetched above, while q and the positions loaded)
  int s_iss, c_iss;
  s_iss = first_from(0, c_iss);
  {
    int cs[kStages];
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      cs[s] = c_iss;
      if (c_iss >= 0) advance(s_iss, c_iss);
    }
    if (warp == 0) {
#pragma unroll
      for (int s = 0; s < kStages; ++s)
        if (cs[s] != rank + s * kSplits) tab_early[s] = fetch(cs[s]);
#pragma unroll
      for (int s = 0; s < kStages; ++s)
        if (cs[s] >= 0) issue(cs[s], s, tab_early[s]);
    }
  }

  int s_cur, c_cur;
  s_cur = first_from(0, c_cur);
  int n_done = 0, n_fin = 0;
  for (; c_cur >= 0; advance(s_cur, c_cur), ++n_done) {
    while (n_fin < s_cur) finalize(n_fin++);  // slots whose chunks are all done
    const int c = c_cur;
    const int stage = n_done % kStages;
    const int tab_next = warp == 0 ? fetch(c_iss) : 0;  // for the issue below
    const unsigned char* st = ring + stage * Gm::kStageBytes;
    const int start = c * kChunk;
    const int n_valid = min(kChunk, S - start);
    mbar_wait(smem_addr(bars + stage), (n_done / kStages) & 1);

    // scores of every (row, key) into sp, scaled, capped and masked: each
    // lane's partial dot products for all rows and all of its keys first,
    // then the transposing butterflies over the keys' lanes (independent,
    // so they overlap), then the lanes left holding a row apply the score
    // math and the mask
    using Bf = Butterfly<Gm::kLK, kRows>;
    float sc[Gm::kScoreSteps][kRows];
#pragma unroll
    for (int step = 0; step < Gm::kScoreSteps; ++step) {
      const int key = step * (kWarps * Gm::kKW) + warp * Gm::kKW + lane / Gm::kLK;
      float kf[Gm::kVL * Gm::kVec];
#pragma unroll
      for (int v = 0; v < Gm::kVL; ++v)
        load16_f32<TKV>(st + key * Gm::kRowBytes + (li + v * Gm::kLK) * 16, kf + v * Gm::kVec);
#pragma unroll
      for (int r = 0; r < kRows; ++r) sc[step][r] = 0.f;
#pragma unroll
      for (int v = 0; v < Gm::kVL; ++v) {
#pragma unroll
        for (int e4 = 0; e4 < Gm::kVec; e4 += 4) {
#pragma unroll
          for (int r = 0; r < kRows; ++r) {  // rows past R hold q = 0
            float qv[4];
            if constexpr (kRows == 1) {
#pragma unroll
              for (int x = 0; x < 4; ++x) qv[x] = qreg[v * Gm::kVec + e4 + x];
            } else {
              const float4 f = *reinterpret_cast<const float4*>(
                  qs + r * DH + (li + v * Gm::kLK) * Gm::kVec + e4);
              qv[0] = f.x;
              qv[1] = f.y;
              qv[2] = f.z;
              qv[3] = f.w;
            }
#pragma unroll
            for (int x = 0; x < 4; ++x)
              sc[step][r] = fmaf(qv[x], kf[v * Gm::kVec + e4 + x], sc[step][r]);
          }
        }
      }
    }
    int base = 0;  // the same for every step: it depends on the lane alone
#pragma unroll
    for (int step = 0; step < Gm::kScoreSteps; ++step) {
      base = 0;
      Bf::run(sc[step], lane, base);
    }
    if (li % Bf::kRep == 0) {
#pragma unroll
      for (int step = 0; step < Gm::kScoreSteps; ++step) {
        const int key = step * (kWarps * Gm::kKW) + warp * Gm::kKW + lane / Gm::kLK;
        const int gk = start + key;
        int key_pos = gk, key_chain = -1;
        if (tree && gk >= scr) {
          const int rel = gk - scr;
          key_pos = scr + rel / a.fanout;
          key_chain = rel % a.fanout;
        }
        float kscale = a.scale;
        if constexpr (kQ8) {
          const uint16_t bits = reinterpret_cast<const uint16_t*>(st + 2 * Gm::kKBytes)[key];
          kscale = bf16_bits_f32(bits);
        }
#pragma unroll
        for (int i = 0; i < Bf::kHeld; ++i) {
          const int r = base + i;
          if (r < R) {
            float x = sc[step][i];
            if constexpr (kQ8) x = x * kscale * a.scale;
            else x *= kscale;
            if (a.softcap != 0.f) x = a.softcap * tanhf(x / a.softcap);
            const int qp = pos_s[r];
            const bool vis = key < n_valid && key_pos <= qp &&
                             (!tree || key_chain < 0 || key_chain == chain_s[r]) &&
                             (a.window <= 0 || key_pos > qp - a.window);
            sp[r * kChunk + key] = vis ? x : kNegInf;
          }
        }
      }
    }
    __syncthreads();

    // online softmax over the chunk: one warp per row; p overwrites the
    // scores (K2: rounded to the pool dtype; K3: times the value scale)
    for (int r = warp; r < R; r += kWarps) {
      float sv[Gm::kSoftPerLane];
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < Gm::kSoftPerLane; ++i) {
        const int key = lane + 32 * i;
        sv[i] = key < kChunk ? sp[r * kChunk + key] : kNegInf;
        mx = fmaxf(mx, sv[i]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < Gm::kSoftPerLane; ++i) {
        const int key = lane + 32 * i;
        const float p = sv[i] > kNegInf * 0.5f ? expf(sv[i] - m_new) : 0.f;
        sum += p;
        if (key < kChunk) {
          float pe;
          if constexpr (kQ8) {
            const uint16_t bits = reinterpret_cast<const uint16_t*>(
                st + 2 * Gm::kKBytes + Gm::kScaleBytes)[key];
            pe = key < n_valid ? p * bf16_bits_f32(bits) : 0.f;
          } else {
            pe = round_p<TKV>(p);
          }
          sp[r * kChunk + key] = pe;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V over this thread's keys and columns
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= R) break;
      const float al = a_s[r];
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[r][x] *= al;
    }
    const unsigned char* vt = st + Gm::kKBytes;
#pragma unroll
    for (int kk = 0; kk < Gm::kKPG; kk += 4) {
      const int key0 = kg * Gm::kKPG + kk;
      float vv[4][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (key0 + e < n_valid) {
          load4_f32<TKV>(vt + (key0 + e) * Gm::kRowBytes + c4 * (int)sizeof(TKV), vv[e]);
        } else {
#pragma unroll
          for (int x = 0; x < 4; ++x) vv[e][x] = 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r >= R) break;
        const float4 p4 = *reinterpret_cast<const float4*>(sp + r * kChunk + key0);
        const float pk[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int x = 0; x < 4; ++x) acc[r][x] = fmaf(pk[e], vv[e][x], acc[r][x]);
      }
    }
    __syncthreads();  // the stage and sp are free again

    if (c_iss >= 0) {
      if (warp == 0) issue(c_iss, stage, tab_next);
      advance(s_iss, c_iss);
    }
  }
  while (n_fin < nslots) finalize(n_fin++);

  // merge the kSplits partials in virtual-rank order (slot v / P of block
  // v % P); block `rank` writes its share of the outputs
  cluster.sync();
  const int total = R * DH;
  const int per = (total + P - 1) / P;
  const int e_end = min(total, (rank + 1) * per);
  TQ* og = static_cast<TQ*>(a.o) + b * a.o_sb;
  for (int e = rank * per + tid; e < e_end; e += kThreads) {
    const int r = e / DH, d = e % DH;
    float mr[kSplits];
    float M = kNegInf;
#pragma unroll
    for (int v = 0; v < kSplits; ++v) {
      mr[v] = cluster.map_shared_rank(slot_m, v % P)[(v / P) * kRows + r];
      M = fmaxf(M, mr[v]);
    }
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int v = 0; v < kSplits; ++v) {
      const float w = expf(mr[v] - M);
      L += cluster.map_shared_rank(slot_l, v % P)[(v / P) * kRows + r] * w;
      O += cluster.map_shared_rank(slot_acc, v % P)[((v / P) * kRows + r) * DH + d] * w;
    }
    const int rr = r0 + r;
    TQ* orow = og + (rr / a.G) * a.o_st + (j * a.G + rr % a.G) * a.o_sh;
    orow[d] = from_f32<TQ>(O / fmaxf(L, 1e-30f));
  }
  cluster.sync();  // no block leaves while another still reads its shared memory
}

constexpr int kMaxDevices = 64;

// The cluster size P (8, 4, 2 or 1 blocks per row block, KV head and batch
// row) is the largest that keeps the grid within kBlocksPerSm blocks per SM:
// a single row spreads over 8 blocks, the 7B serving batch (B 4, Hkv 32)
// over 4, larger batches over fewer. On the H100 (PERF.md, PR 5) clusters
// of 4 beat 8 at B 4 (one wave of blocks, not two) and 8 beat 4 at B 1.
// The virtual ranks, and so the output bits, are the same for every P.
constexpr int kBlocksPerSm = 4;

template <typename TQ, typename TKV, int DH, int kRows>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  auto kernel = paged_decode_kernel<TQ, TKV, DH, kRows>;
  // per instantiation and device: the shared-memory limit, set once (two
  // threads may both set it; that is harmless); per device: the SM count
  static std::atomic<bool> ready[kMaxDevices];
  static std::atomic<int> sms[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes<TKV, DH, kRows>(kSplits));
    if (err != cudaSuccess) return err;
    ready[dev].store(true, std::memory_order_release);
  }
  int n_sm = sms[dev].load(std::memory_order_acquire);
  if (n_sm == 0) {
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    sms[dev].store(n_sm, std::memory_order_release);
  }
  const int items = (a.T * a.G + kRows - 1) / kRows * a.Hkv * B;
  int P = kSplits;
  while (P > 1 && (int64_t)items * P > (int64_t)kBlocksPerSm * n_sm) P /= 2;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.T * a.G + kRows - 1) / kRows * P, a.Hkv, B);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes<TKV, DH, kRows>(kSplits / P);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
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

template <typename TKV>
int chunk_keys(int dh) {
  switch (dh) {
    case 64:
      return Geo<TKV, 64>::kChunk;
    case 128:
      return Geo<TKV, 128>::kChunk;
    case 256:
      return Geo<TKV, 256>::kChunk;
    default:
      return 0;
  }
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16. kv_dtype: 0 = float32, 1 = bfloat16
// (K2, equal to q_dtype), 2 = int8 with bf16 scales (K3). Strides are in
// elements; head_dim is contiguous. chain and scratch are null without a
// tree. Any page size. Returns a cudaError_t (0 = launched).
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

// Keys per chunk for a kv_dtype (codes as above) and head_dim, and the
// virtual ranks that split one row: the constants the CPU tests' model of
// the split-and-merge must use. Returns 0 for an unknown pair.
extern "C" int paged_decode_chunk_keys(int kv_dtype, int head_dim) {
  if (kv_dtype == 0) return chunk_keys<float>(head_dim);
  if (kv_dtype == 1) return chunk_keys<__nv_bfloat16>(head_dim);
  if (kv_dtype == 2) return chunk_keys<int8_t>(head_dim);
  return 0;
}

extern "C" int paged_decode_splits() { return kSplits; }
