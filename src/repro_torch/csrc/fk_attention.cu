// Hand-written Hopper (sm_90a) flash attention for the port's LM stack.
//
// Three kernels replace the Pallas TPU kernel flash_attention of
// src/repro/kernels/flash_attention.py (body _kernel): online-softmax GQA
// attention, q (B, H, Sq, hd) against k, v (B, KV, Skv, hd), query head h
// reading KV head h / (H / KV), masked by absolute positions with the
// reference's contract
//
//   valid = kpos >= 0 && (!causal || kpos <= qpos)
//                     && (!window || kpos > qpos - window)
//
// and the reference kernel's arithmetic: s = q . k in f32 (no scaling: the
// caller scales q), masked scores set to the finite NEG = -1e30, per key
// tile m_new = max(m, rowmax s), p = exp(s - m_new), l = l * exp(m - m_new)
// + sum p (p unrounded), acc = acc * exp(m - m_new) + round_T(p) . v in f32,
// out = acc / max(l, 1e-30) cast to T. A query row with no valid key gets
// exp(NEG - NEG) = 1 for every key, i.e. the mean of v over all keys, as the
// reference kernel gives; with zero_empty != 0 (models/attention.attend's
// contract) such a row is written as zero instead. A row has no valid key
// exactly when its running max is still NEG after the walk (a valid score
// is a finite product, far above -1e30). Keys past Skv do not exist (p = 0,
// staged K/V rows zero), so ragged Sq and Skv need no padding copy; query
// rows past Sq are not written. q, k, v and out are addressed by (batch,
// head, sequence) element strides with a contiguous head dim, so (B, S, H,
// hd) tensors are read and written in place through transposed views.
//
// Tile skip by position bounds (the prefill and decode kernels).
// Positions are arbitrary (decode caches are rings with empty slots,
// callers shift them), so the kernels never decide by index. Before a KV
// tile is fetched, a warp (the producer warp at prefill, every warp at
// decode) reads its key positions (two per lane, L1) and reduces the valid
// ones (kpos >= 0, key < Skv) to kmin, kmax and a count;
// with the query tile's qmin, qmax the tile is
//   dead       when no key is valid, or causal and kmin > qmax, or a window
//              and kmax <= qmin - window: no query of the tile sees a key;
//   fully live when all of its keys exist and are valid, and causal ->
//              kmax <= qmin, window -> kmin > qmax - window: every query
//              sees every key, so the per-score mask is skipped;
//   live       otherwise (masked score by score).
// A dead tile is not fetched. For every row with a valid key that is exact:
// in the reference's walk such a tile gives p = exp(NEG - m) = 0 and scale
// 1, or, before the row's first valid tile, a sum the first valid tile's
// scale exp(NEG - m) = 0 wipes. A row left with m == NEG has no valid key;
// with zero_empty == 0 it gets the mean of v over all Skv keys (below).
// kernels/flash_attention.py's live_tiles states the rule in PyTorch.
//
//   * flash_prefill_kernel<T, HD> (bf16 / fp16 at Sq > 16; hd 64, 128,
//     256): Hopper's shape. A block of 288 threads takes 128 query rows:
//     two consumer warpgroups of 64 rows and one producer warp. The
//     producer classifies the next KV tile by position (the rule above),
//     skips dead ones, and TMA-loads the live tile's K and V (64-value
//     panels of 128 bytes, 128-byte swizzle, zeros past Skv) into a ring of
//     three stages, each guarded by a "full" mbarrier (the TMA's bytes) and
//     an "empty" one (the 256 consumer threads); a slot also carries the
//     tile's index and class, and an index of -1 ends the walk. Query tiles
//     go out last first (blockIdx.y reversed; heads of a GQA group on
//     neighbouring blocks share K/V through L2), so the longest causal walks
//     start first. Each consumer warpgroup runs S = Q K^T as wgmma.mma_async
//     m64nBKk16 with Q (staged once by cp.async in the same swizzled panels)
//     and K from shared memory, the online softmax on the accumulator
//     fragments (a row's values sit in the four lanes of a quad), and O +=
//     P V as wgmma m64nHDk16 with P from registers (rounded to T in pairs:
//     the accumulator layout of S is the A-fragment layout) and V read as
//     the MN-major B operand (imm-trans-b), so V is never transposed. BK =
//     64 keys a tile (32 at hd 256, so O's 128 f32 a thread, S and P fit
//     without spills). exp(x) is ex2.approx.ftz(x * log2(e)) on (s - m)
//     formed first, so exp(NEG - NEG) is exactly 1 and the masked rows keep
//     the reference's result; its error (about 2 ulp of f32) sits far under
//     the bf16 / fp16 rounding of p, and chip_smoke.py phases 11, 12 and 14
//     hold the result to the bars and the LM gate. A row with no valid key
//     and zero_empty == 0 takes the fallback: its warp sums v over all Skv
//     keys and writes the mean. (An mma.sync version of the FA2 shape, with
//     a cp.async ring and ldmatrix from swizzled tiles, took 0.397 ms at
//     internlm2-1.8b's prefill against this kernel's 0.247, chip_smoke.py
//     phase 11 on an H100 80GB HBM3 at 700 W; PERF.md has the runs.)
//   * flash_decode_kernel<T, HD, R> (f32, bf16, fp16 at Sq <= 16): split-KV
//     with GQA packing. One block per (batch, KV head, row chunk, split)
//     takes all group x Sq query rows that read that KV head (packed rows
//     r = g * Sq + i, up to R = 16 a block, 8 at hd 256), so each K/V byte
//     is read once per launch, not group times. The splits follow from Skv
//     and B * KV * row chunks, so that about two blocks per SM are in
//     flight. A split walks its KV tiles through a two-stage cp.async ring
//     in T (rows padded by 16 bytes) and skips dead tiles; each of its four
//     warps runs its own online softmax over its quarter of every tile's
//     keys, products as f32 FMAs on the CUDA cores (decode is bound by
//     bytes; f32 stays exact) with accurate expf. Each warp writes f32
//     partials (m, l, acc); a warp whose row saw no valid key and
//     zero_empty == 0 sums v over all keys of its share instead, so the
//     combine's weights exp(m_s - M) give the reference's mean of v over
//     all keys. The last block of a (batch, KV head, row chunk) to finish
//     (__threadfence and an atomic ticket, reset by that block for the next
//     launch) combines the partials and writes the rows: one launch a call.
//     The wrapper allocates the partials and keeps the tickets.
//   * flash_f32_kernel<HD> (f32 at Sq > 16): f32 FMAs on the CUDA cores
//     with accurate expf (no tensor cores in f32 without TF32, which would
//     change the arithmetic). A block of 8 warps packs hb query heads of
//     one GQA group (the largest power of two dividing the group, at most
//     8) x 128 / hb positions (64 / hb at hd 256) into 128 rows (64), so
//     one K / V tile serves every head of the run. It walks the KV tiles
//     of 64 keys (32 at hd 256) by the rule above (every warp classifies
//     the same tiles from the positions): dead tiles are not fetched,
//     fully live ones are not masked. K and V go through a two-stage
//     cp.async ring, so the next live tile's copies overlap this tile's
//     FMAs; Q is staged once; Q and K rows keep their 16-byte chunks
//     XOR-swizzled by (row & 7), so the reads are conflict-free with no
//     padding (224 KB of shared memory at hd 128). A warp owns 16 rows (8
//     at hd 256) in row groups of 4: a lane holds S for its 4 rows x 8
//     keys (2 at hd 256) and O for its 4 rows x 16 columns (8 at hd 64):
//     at hd 128, 12 16-byte shared reads feed 128 FMAs of S and 5 feed 64
//     of P V (a 4 x 4 tile: 8 per 64). Row max and row sum are butterflies
//     over the 8 (16) lanes of a row group. P cannot stay in registers (a
//     lane's S keys are not its P V keys); it goes through a buffer of the
//     warp's own, behind a __syncwarp, not a block barrier. A row
//     with no valid key and zero_empty == 0 takes the mean of v over all
//     Skv keys (its lanes sum v), as the prefill kernel does.
//     kernels/flash_attention.py's flash_f32_walk_plain states the walk.
//
// The prefill and f32 kernels also write, when the caller gives them an
// lse pointer (the entry point then runs them at every Sq), each row's
// log-sum-exp m + log(l) in f32, +inf for a row with no valid key: the
// input of the backward kernels of fk_attention_bwd.cu (bf16 / fp16) and
// fk_attention_bwd_f32.cu (f32). A null pointer leaves the launch and the
// output bits as they were.
//
// The entry point picks the kernel from Sq, the dtype and hd, and the
// decode kernel's rows and splits from the group and the shapes
// (decode_plan). Bound on the H100: at prefill the 4 * B * H * hd FLOPs of
// each (query, valid key) pair (989 TFLOP/s; 67 TFLOP/s on the CUDA cores
// at f32); at decode the bytes of the
// KV cache, read once per launch (3.35 TB/s). The prefill kernel's tensor
// maps come from cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint (no link against the driver library); that and
// the mbarrier / TMA helpers live in fk_tma.cuh, shared with
// fk_abft_gemm.cu and fk_attention_bwd.cu.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (no --use_fast_math: expf and the final division stay accurate).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "fk_tma.cuh"
#include "fk_wgmma.cuh"

namespace {

constexpr float kNeg = -1e30f;     // the reference kernel's NEG
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxRows = 65535;    // a grid dimension of (batch, head) rows
constexpr int kDecodeMaxSq = 16;   // Sq at or below: the decode kernel
constexpr int kMaxSplits = 64;     // KV splits of one decode row block

// --- shared helpers ---------------------------------------------------------

// 16 bytes global -> shared, zero-filled when !full (src then unread)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

enum TileClass : int { kDead = 0, kLive = 1, kFull = 2 };

// The class of KV tile [k0, k0 + bk) for queries with positions in
// [qmin, qmax] (see the header); the same in every lane of the warp.
__device__ __forceinline__ int tile_class(const int* __restrict__ kpos, int k0,
                                          int bk, int Skv, int qmin, int qmax,
                                          int causal, int window) {
  const int lane = threadIdx.x & 31;
  int kmin = INT_MAX, kmax = INT_MIN, cnt = 0;
  for (int j = lane; j < bk; j += 32) {
    if (k0 + j < Skv) {
      const int kp = __ldg(kpos + k0 + j);
      if (kp >= 0) {
        kmin = min(kmin, kp);
        kmax = max(kmax, kp);
        ++cnt;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, off));
    kmax = max(kmax, __shfl_xor_sync(0xffffffffu, kmax, off));
    cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
  }
  if (cnt == 0 || (causal && kmin > qmax) ||
      (window && (long long)kmax <= (long long)qmin - window))
    return kDead;
  if (cnt == bk && (!causal || kmax <= qmin) &&
      (!window || (long long)kmin > (long long)qmax - window))
    return kFull;
  return kLive;
}

// min and max of qpos[i0, i0 + n), the same in every lane of the warp
__device__ __forceinline__ void query_bounds(const int* __restrict__ qpos,
                                             int i0, int n, int& qmin,
                                             int& qmax) {
  qmin = INT_MAX;
  qmax = INT_MIN;
  for (int i = threadIdx.x & 31; i < n; i += 32) {
    const int p = __ldg(qpos + i0 + i);
    qmin = min(qmin, p);
    qmax = max(qmax, p);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, off));
    qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, off));
  }
}

// 2^x on the SFU (ex2.approx.ftz: about 2 ulp; results under 2^-126 flush
// to zero, far below what a p rounded to bf16 / fp16 beside a p of 1 keeps)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ bool key_valid(int kp, int qp, int causal,
                                          int window) {
  return kp >= 0 && (!causal || kp <= qp) &&
         (!window || (long long)kp > (long long)qp - window);
}

// Two values of a 2-byte type T packed in one 32-bit word (round to nearest)
template <typename T>
struct Pair;
template <>
struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
  __device__ static type make(float lo, float hi) {
    return __floats2bfloat162_rn(lo, hi);
  }
};
template <>
struct Pair<__half> {
  using type = __half2;
  __device__ static type make(float lo, float hi) {
    return __floats2half2_rn(lo, hi);
  }
};

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const typename Pair<T>::type h = Pair<T>::make(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// one 32-bit word of T widened to 4 / sizeof(T) floats
template <typename T>
__device__ __forceinline__ void unpack(uint32_t w, float* o);
template <>
__device__ __forceinline__ void unpack<float>(uint32_t w, float* o) {
  o[0] = __uint_as_float(w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(uint32_t w, float* o) {
  const float2 f = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&w));
  o[0] = f.x;
  o[1] = f.y;
}
template <>
__device__ __forceinline__ void unpack<__half>(uint32_t w, float* o) {
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w));
  o[0] = f.x;
  o[1] = f.y;
}

// N consecutive values of T (N * sizeof(T) a multiple of 4 bytes, the
// address aligned to it, up to 16) widened to f32
template <typename T, int N>
__device__ __forceinline__ void widen(const T* p, float* o) {
  constexpr int W = N * int(sizeof(T)) / 4;   // 32-bit words
  constexpr int E = 4 / int(sizeof(T));       // values per word
  uint32_t w[W];
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W / 4; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = v.x;
      w[4 * i + 1] = v.y;
      w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
  } else if constexpr (W == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < W; ++i) unpack<T>(w[i], o + i * E);
}

__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float round_to(float x, __half) {
  return __half2float(__float2half_rn(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store(__half* p, float x) {
  *p = __float2half_rn(x);
}

// --- f32 at Sq > 16: CUDA-core tiles ----------------------------------------

constexpr int kF32Threads = 256;
constexpr int kF32Warps = kF32Threads / 32;
constexpr int kF32MaxHeads = 8;    // GQA heads packed in one block, most

// The shape of flash_f32_kernel<HD>. A warp owns WR packed query rows in RG
// row groups of 4 (lane = rg * KG + kg); for S the lane holds its 4 rows x
// KPL keys kg + KG j, for O its 4 rows x CPL float4 columns 4 kg + 4 KG h.
// Shared memory in floats: Q (RB rows), two stages of K and V (BK keys
// each) and each warp's P (BK x WR). Q and K rows keep their 16-byte
// chunks XOR-swizzled by (row & 7), so the lanes' 16-byte reads of
// different rows hit different banks without padding.
template <int HD>
struct F32Tile {
  static constexpr int RG = HD <= 128 ? 4 : 2;
  static constexpr int KG = 32 / RG;
  static constexpr int WR = 4 * RG;
  static constexpr int RB = kF32Warps * WR;   // 128 rows, 64 at hd 256
  static constexpr int BK = HD <= 128 ? 64 : 32;
  static constexpr int KPL = BK / KG;
  static constexpr int CH = HD / 4;           // 16-byte chunks a row
  static constexpr int CPL = HD / (4 * KG);
  static constexpr int q = 0;
  static constexpr int stage = 2 * BK * HD;   // K, then V
  static constexpr int kv = q + RB * HD;
  static constexpr int p = kv + 2 * stage;
  static constexpr int words = p + kF32Warps * BK * WR;
  static constexpr size_t bytes = size_t(words) * 4;
};

template <int HD>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ qpos,
                 const int* __restrict__ kpos, float* __restrict__ out,
                 int KV, int group, int hb, int Sq, int Skv, long long qsb,
                 long long qsh, long long qss, long long ksb, long long ksh,
                 long long kss, long long vsb, long long vsh, long long vss,
                 long long osb, long long osh, long long oss, int causal,
                 int window, int zero_empty, float* __restrict__ lse) {
  using S = F32Tile<HD>;
  constexpr int RG = S::RG, KG = S::KG, WR = S::WR, RB = S::RB, BK = S::BK;
  constexpr int KPL = S::KPL, CH = S::CH, CPL = S::CPL;
  extern __shared__ __align__(16) float smem[];
  const float4* Q4 = reinterpret_cast<const float4*>(smem + S::q);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int rg = lane / KG, kg = lane % KG;
  float* Pw = smem + S::p + w * BK * WR;

  // block: (batch, KV head, run of hb heads of its group), query tile;
  // query tiles go out last first (the longest causal walks start first)
  const int hruns = group / hb;
  const int b = blockIdx.x / (KV * hruns);
  const int rest = blockIdx.x - b * KV * hruns;
  const int kvh = rest / hruns;
  const int h0 = kvh * group + (rest - kvh * hruns) * hb;
  const int pb = RB / hb;                     // query positions a block
  const int q0 = (gridDim.y - 1 - blockIdx.y) * pb;
  const int nq = min(pb, Sq - q0);
  const int nt = (Skv + BK - 1) / BK;
  const float* kb = k + b * ksb + kvh * ksh;
  const float* vb = v + b * vsb + kvh * vsh;

  // Q: row r is head h0 + r / pb at position q0 + r % pb, zero past Sq
  for (int i = tid; i < RB * CH; i += kF32Threads) {
    const int r = i / CH, c = i - (i / CH) * CH;
    const int pi = r % pb;
    const bool full = pi < nq;
    const float* src = full ? q + b * qsb + (h0 + r / pb) * qsh
                                  + (q0 + pi) * qss + c * 4
                            : q;
    cp_async16(smem + S::q + r * HD + ((c ^ (r & 7)) << 2), src, full);
  }
  auto stage_kv = [&](int t, int st) {
    float* ks = smem + S::kv + st * S::stage;
    float* vs = ks + BK * HD;
    for (int i = tid; i < BK * CH; i += kF32Threads) {
      const int j = i / CH, c = i - (i / CH) * CH;
      const int kk = t * BK + j;
      const bool full = kk < Skv;
      cp_async16(ks + j * HD + ((c ^ (j & 7)) << 2),
                 full ? kb + kk * kss + c * 4 : kb, full);
      cp_async16(vs + j * HD + c * 4, full ? vb + kk * vss + c * 4 : vb,
                 full);
    }
  };
  int qmin, qmax;
  query_bounds(qpos, q0, nq, qmin, qmax);
  // the next KV tile from t that is not dead (nt: none), and its class;
  // every warp walks the same tiles
  auto next_live = [&](int t, int& cls) {
    for (; t < nt; ++t) {
      cls = tile_class(kpos, t * BK, BK, Skv, qmin, qmax, causal, window);
      if (cls != kDead) break;
    }
    return t;
  };

  int row[4], qp[4];
  float m[4], l[4], acc[4][CPL][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row[i] = w * WR + rg + RG * i;
    const int pi = row[i] % pb;
    qp[i] = pi < nq ? __ldg(qpos + q0 + pi) : 0;
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int h = 0; h < CPL; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][h][e] = 0.0f;
  }

  int cls = kDead, cls1 = kDead;
  int t = next_live(0, cls);
  if (t < nt) stage_kv(t, 0);
  cp_commit();
  int t1 = t < nt ? next_live(t + 1, cls1) : nt;
  if (t1 < nt) stage_kv(t1, 1);
  cp_commit();
  for (int st = 0; t < nt; st ^= 1) {
    cp_wait<1>();
    __syncthreads();
    const float4* K4 =
        reinterpret_cast<const float4*>(smem + S::kv + st * S::stage);
    const float4* V4 = K4 + BK * CH;
    const int k0 = t * BK;

    // S = Q K^T: rows row[i], keys kg + KG j, over the head dim in order
    float s[4][KPL];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KPL; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < CH; ++c) {
      float4 a[4], bk[KPL];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Q4[row[i] * CH + (c ^ (row[i] & 7))];
#pragma unroll
      for (int j = 0; j < KPL; ++j)
        bk[j] = K4[(kg + KG * j) * CH + (c ^ (kg & 7))];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < KPL; ++j) {
          s[i][j] = fmaf(a[i].x, bk[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, bk[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, bk[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, bk[j].w, s[i][j]);
        }
    }

    // mask (live tiles only), online softmax over the row's KG lanes; P to
    // the warp's buffer, slot rg * 4 + i of each key
    const bool masked = cls != kFull;
    int kp[KPL];
    bool ex[KPL];
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      ex[j] = !masked || k0 + kg + KG * j < Skv;
      kp[j] = masked && ex[j] ? __ldg(kpos + k0 + kg + KG * j) : 0;
    }
    float sc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        if (masked && !(ex[j] && key_valid(kp[j], qp[i], causal, window)))
          s[i][j] = kNeg;
        if (ex[j]) mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = KG / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        s[i][j] = ex[j] ? expf(s[i][j] - m_new) : 0.0f;
        psum += s[i][j];
      }
#pragma unroll
      for (int off = KG / 2; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      sc[i] = expf(m[i] - m_new);
      l[i] = l[i] * sc[i] + psum;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < KPL; ++j)
      *reinterpret_cast<float4*>(Pw + (kg + KG * j) * WR + rg * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncwarp();

    // O = O * scale + P V: rows row[i], columns 4 kg + 4 KG h
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < CPL; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][h][e] *= sc[i];
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(Pw + kk * WR
                                                        + rg * 4);
      const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int h = 0; h < CPL; ++h) {
        const float4 bv = V4[kk * CH + kg + KG * h];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][h][0] = fmaf(pr[i], bv.x, acc[i][h][0]);
          acc[i][h][1] = fmaf(pr[i], bv.y, acc[i][h][1]);
          acc[i][h][2] = fmaf(pr[i], bv.z, acc[i][h][2]);
          acc[i][h][3] = fmaf(pr[i], bv.w, acc[i][h][3]);
        }
      }
    }
    __syncthreads();   // every warp is done with this stage
    int cls2 = kDead;
    const int t2 = t1 < nt ? next_live(t1 + 1, cls2) : nt;
    if (t2 < nt) stage_kv(t2, st);
    cp_commit();
    t = t1;
    cls = cls1;
    t1 = t2;
    cls1 = cls2;
  }
  cp_wait<0>();

  // a row with no valid key: zero with zero_empty, else the mean of v over
  // all Skv keys (the reference kernel's exp(NEG - NEG) = 1 for every key)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int pi = row[i] % pb;
    if (pi >= nq) continue;
    const bool empty = m[i] == kNeg;
    // the row's log-sum-exp for the backward kernels
    // (fk_attention_bwd_f32.cu): +inf for a row with no valid key
    if (lse && kg == 0)
      lse[((long long)b * KV * group + h0 + row[i] / pb) * Sq + q0 + pi] =
          empty ? INFINITY : m[i] + logf(l[i]);
    if (empty && !zero_empty) {
#pragma unroll
      for (int h = 0; h < CPL; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][h][e] = 0.0f;
      for (int j = 0; j < Skv; ++j)
#pragma unroll
        for (int h = 0; h < CPL; ++h) {
          const float4 x = *reinterpret_cast<const float4*>(
              vb + j * vss + 4 * kg + 4 * KG * h);
          acc[i][h][0] += x.x;
          acc[i][h][1] += x.y;
          acc[i][h][2] += x.z;
          acc[i][h][3] += x.w;
        }
      l[i] = float(Skv);
    }
    const float den = fmaxf(l[i], 1e-30f);
    const bool zero = zero_empty && empty;
    float* orow = out + b * osb + (h0 + row[i] / pb) * osh + (q0 + pi) * oss;
#pragma unroll
    for (int h = 0; h < CPL; ++h)
      *reinterpret_cast<float4*>(orow + 4 * kg + 4 * KG * h) =
          zero ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
               : make_float4(acc[i][h][0] / den, acc[i][h][1] / den,
                             acc[i][h][2] / den, acc[i][h][3] / den);
  }
}

// --- bf16 / fp16 prefill on wgmma: TMA producer warp, two consumer
// warpgroups --------------------------------------------------------------

// v summed over all Skv keys in the chunks of 8 columns a lane owns,
// divided by Skv, written to the rows of `rows` (bit i: query q_first + i)
// with no valid key: the reference kernel's result for such a row
template <typename T, int HD>
__device__ void prefill_mean_rows(const T* __restrict__ vb, long long vss,
                                  int Skv, unsigned rows, T* __restrict__ ob,
                                  long long oss, int q_first) {
  const int lane = threadIdx.x & 31;
  for (int c = lane; c < HD / 8; c += 32) {
    float sum[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int j = 0; j < Skv; ++j) {
      float x[8];
      widen<T, 8>(vb + j * vss + c * 8, x);
#pragma unroll
      for (int e = 0; e < 8; ++e) sum[e] += x[e];
    }
    const float n = float(Skv);
    for (unsigned bits = rows; bits; bits &= bits - 1) {
      T* o = ob + (q_first + __ffs(bits) - 1) * oss + c * 8;
#pragma unroll
      for (int e = 0; e < 8; e += 2)
        *reinterpret_cast<typename Pair<T>::type*>(o + e) =
            Pair<T>::make(sum[e] / n, sum[e + 1] / n);
    }
  }
}

constexpr int kPfThreads = 288;        // 2 consumer warpgroups + 1 producer
constexpr int kPfBQ = 128;             // query rows a block (64 a group)

// keys a KV tile: 32 at hd 256, so O (128 f32 a thread), S and P fit the
// consumers' registers without spills
template <int HD>
constexpr int prefill_bk() { return HD > 128 ? 32 : 64; }

template <int HD>
struct PfShape {
  static constexpr int bk = prefill_bk<HD>();
  static constexpr int panels = HD / 64;             // 128-byte panels a row
  static constexpr int stages = 3;
  static constexpr int q_bytes = kPfBQ * HD * 2;
  static constexpr int kv_bytes = bk * HD * 2;       // K or V of one tile
  static constexpr int stage_bytes = 2 * kv_bytes;
  static constexpr int q = 0;
  static constexpr int kv = q_bytes;                 // K then V, a stage
  static constexpr int bars = kv + stages * stage_bytes;
  static constexpr int info = bars + 2 * stages * 8;
  static constexpr size_t bytes = size_t(info) + 2 * stages * 4 + 1024;
};

template <typename T, int HD>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (HD == 64) wgmma_rs_n64(o, a, db, T());
  else if constexpr (HD == 128) wgmma_rs_n128(o, a, db, T());
  else wgmma_rs_n256(o, a, db, T());
}

template <typename T, int BK>
__device__ __forceinline__ void wgmma_qk(float* s, uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (BK == 32) wgmma_ss_n32(s, da, db, scale_d, T());
  else wgmma_ss_n64(s, da, db, scale_d, T());
}

template <typename T, int HD>
__global__ void __launch_bounds__(kPfThreads, 1)
flash_prefill_kernel(const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const T* __restrict__ q, const T* __restrict__ v,
                   const int* __restrict__ qpos, const int* __restrict__ kpos,
                   T* __restrict__ out, float* __restrict__ lse, int H,
                   int group, int Sq, int Skv,
                   long long qsb, long long qsh, long long qss, long long vsb,
                   long long vsh, long long vss, long long osb, long long osh,
                   long long oss, int causal, int window, int zero_empty) {
  using W = PfShape<HD>;
  constexpr int BK = W::bk;
  constexpr int S = W::stages;
  constexpr int NT = BK / 8;
  constexpr int DT = HD / 8;
  constexpr int CH = HD / 8;
  extern __shared__ unsigned char smw_raw[];
  unsigned char* smw = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smw_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Qs = smw + W::q;
  uint64_t* full = reinterpret_cast<uint64_t*>(smw + W::bars);
  uint64_t* empty = full + S;
  int* tile_t = reinterpret_cast<int*>(smw + W::info);
  int* tile_c = tile_t + S;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int kvh = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kPfBQ;
  const int nq = min(kPfBQ, Sq - q0);
  const int ntiles = (Skv + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {
    // producer: classify the next tile by position, TMA its K and V
    int qmin, qmax;
    query_bounds(qpos, q0, nq, qmin, qmax);
    int cls = kDead;
    int t = 0;
    for (; t < ntiles; ++t) {
      cls = tile_class(kpos, t * BK, BK, Skv, qmin, qmax, causal,
                       window);
      if (cls != kDead) break;
    }
    for (int it = 0;; ++it) {
      const int st = it % S;
      mbar_wait(empty + st, ((it / S) & 1) ^ 1);
      if (lane == 0) {
        tile_t[st] = t < ntiles ? t : -1;
        tile_c[st] = cls;
        if (t < ntiles) {
          unsigned char* Ks = smw + W::kv + st * W::stage_bytes;
          mbar_expect_tx(full + st, W::stage_bytes);
#pragma unroll
          for (int p = 0; p < W::panels; ++p) {
            tma_load(Ks + p * BK * 128, &kmap, full + st, p * 64,
                     t * BK, kvh, b);
            tma_load(Ks + W::kv_bytes + p * BK * 128, &vmap, full + st,
                     p * 64, t * BK, kvh, b);
          }
        } else {
          mbar_arrive(full + st);
        }
      }
      __syncwarp();
      if (t >= ntiles) break;
      for (++t; t < ntiles; ++t) {
        cls = tile_class(kpos, t * BK, BK, Skv, qmin, qmax, causal,
                         window);
        if (cls != kDead) break;
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows 64 wg .. 64 wg + 63
  const int wg = warp >> 2, wi = warp & 3;
  const int g = lane >> 2, tig = lane & 3;
  {
    const T* qb = q + b * qsb + h * qsh;
    for (int idx = tid - 128 * wg; idx < 64 * CH; idx += 128) {
      const int r = 64 * wg + idx / CH, c = idx - (idx / CH) * CH;
      const bool ok = r < nq;
      cp_async16(Qs + (c >> 3) * (kPfBQ * 128) + r * 128
                     + (((c & 7) ^ (r & 7)) << 4),
                 ok ? qb + (q0 + r) * qss + c * 8 : qb, ok);
    }
    cp_commit();
    cp_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  }
  int qp[2];
  float m[2], l[2], o[HD / 2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + 64 * wg + 16 * wi + g + 8 * r;
    qp[r] = qi < Sq ? qpos[qi] : 0;
    m[r] = kNeg;
    l[r] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
  const unsigned char* Qw = Qs + 64 * wg * 128;

  for (int it = 0;; ++it) {
    const int st = it % S;
    mbar_wait(full + st, (it / S) & 1);
    const int t = *reinterpret_cast<volatile int*>(tile_t + st);
    if (t < 0) break;
    const int cls = *reinterpret_cast<volatile int*>(tile_c + st);
    const int k0 = t * BK;
    const unsigned char* Ks = smw + W::kv + st * W::stage_bytes;
    const unsigned char* Vs = Ks + W::kv_bytes;

    // S = Q K^T: 64 rows x 64 keys on wgmma, Q and K from shared memory
    float s[NT * 4];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int off = (kk & 3) << 5;
      wgmma_qk<T, BK>(s,
                      sw128_desc(Qw + (kk >> 2) * (kPfBQ * 128) + off, 16),
                      sw128_desc(Ks + (kk >> 2) * (BK * 128) + off, 16),
                      kk > 0);
    }
    wg_commit();
    wg_wait0();
    fence_regs<NT * 4>(s);

    if (cls == kLive) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + nt * 8 + tig * 2 + (e & 1);
          s[nt * 4 + e] =
              key >= Skv ? -INFINITY
              : key_valid(__ldg(kpos + key), qp[e >> 1], causal, window)
                  ? s[nt * 4 + e] : kNeg;
        }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt * 4 + e]);
    float sc[2], psum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      mx[r] = fmaxf(m[r], mx[r]);
    }
    uint32_t pp[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float p0 = fast_exp2((s[nt * 4 + 2 * r] - mx[r]) * kLog2e);
        const float p1 = fast_exp2((s[nt * 4 + 2 * r + 1] - mx[r]) * kLog2e);
        psum[r] += p0 + p1;
        pp[nt][r] = pack2<T>(p0, p1);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
      sc[r] = fast_exp2((m[r] - mx[r]) * kLog2e);
      l[r] = l[r] * sc[r] + psum[r];
      m[r] = mx[r];
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      o[dt * 4] *= sc[0];
      o[dt * 4 + 1] *= sc[0];
      o[dt * 4 + 2] *= sc[1];
      o[dt * 4 + 3] *= sc[1];
    }

    // O += P V: P from registers, V (keys x hd, hd contiguous) from shared
    // memory as the MN-major B operand
    fence_regs<HD / 2>(o);
    wg_fence();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint32_t pa[4] = {pp[2 * j][0], pp[2 * j][1], pp[2 * j + 1][0],
                              pp[2 * j + 1][1]};
      wgmma_pv<T, HD>(o, pa, sw128_desc(Vs + j * 16 * 128, BK * 128));
    }
    wg_commit();
    wg_wait0();
    fence_regs<HD / 2>(o);
    mbar_arrive(empty + st);
  }

  T* ob = out + b * osb + h * osh;
  const int row0 = q0 + 64 * wg + 16 * wi;
  unsigned empty_rows = 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + g + 8 * r;
    if (qi >= Sq) continue;
    // the row's log-sum-exp for the backward kernels (fk_attention_bwd.cu):
    // +inf for a row with no valid key
    if (lse && tig == 0)
      lse[(long long)bh * Sq + qi] =
          m[r] == kNeg ? INFINITY : m[r] + logf(l[r]);
    if (m[r] == kNeg) {
      empty_rows |= 1u << (g + 8 * r);
      if (!zero_empty) continue;
    }
    const bool zero = m[r] == kNeg;
    const float den = fmaxf(l[r], 1e-30f);
    T* orow = ob + qi * oss + tig * 2;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<typename Pair<T>::type*>(orow + dt * 8) =
          Pair<T>::make(zero ? 0.0f : o[dt * 4 + 2 * r] / den,
                        zero ? 0.0f : o[dt * 4 + 2 * r + 1] / den);
  }
  empty_rows = __reduce_or_sync(0xffffffffu, empty_rows);
  if (empty_rows && !zero_empty)
    prefill_mean_rows<T, HD>(v + b * vsb + kvh * vsh, vss, Skv, empty_rows,
                             ob, oss, row0);
}

// --- decode (Sq <= 16): split-KV with GQA packing on the CUDA cores --------

constexpr int kDcWarps = 4;
constexpr int kDcThreads = 32 * kDcWarps;

template <typename T, int HD, int R>
struct Dc {
  static constexpr int KW = (4096 / (HD * int(sizeof(T)))) < 16
                                ? 4096 / (HD * int(sizeof(T))) : 16;
  static constexpr int BK = KW * kDcWarps;         // keys a tile
  static constexpr int LPK = 32 / KW;              // lanes a key (scores)
  static constexpr int EPC = 16 / int(sizeof(T));  // values a 16-byte chunk
  static constexpr int CH = HD / EPC;              // chunks a row
  static constexpr int CPL = CH / LPK;             // chunks a lane
  static constexpr int COLS = HD / 32;             // output columns a lane
  static constexpr int ROWB = HD * int(sizeof(T)) + 16;   // padded row bytes
  // shared memory in bytes: K and V stages, Q as f32, key positions, the
  // combine's per-row max and denominator
  static constexpr int kv = 0;
  static constexpr int qs = kv + 2 * 2 * BK * ROWB;
  static constexpr int kp = qs + R * HD * 4;
  static constexpr int rows = kp + 2 * BK * 4;
  static constexpr size_t bytes = size_t(rows) + 2 * R * 4;
  static_assert(KW * LPK == 32 && CPL * LPK == CH, "lane split");
  static_assert(2 * 2 * BK * ROWB >= R * 4 * kMaxSplits * kDcWarps,
                "the combine's weights fit in the staging buffers");
};

// the plan of one decode launch: rows a block (R, a template value), row
// chunks, splits of the KV tiles and tiles a split
struct DecodePlan {
  int R, nrc, nsplit, tps, bk;
};

DecodePlan decode_plan(int B, int KV, int rows, int Skv, int hd, int elt) {
  DecodePlan p;
  const int rcap = hd > 128 ? 8 : 16;
  const int want = rows < rcap ? rows : rcap;
  p.R = 1;
  while (p.R < want) p.R *= 2;
  p.nrc = (rows + p.R - 1) / p.R;
  const int kw = 4096 / (hd * elt) < 16 ? 4096 / (hd * elt) : 16;
  p.bk = kw * kDcWarps;
  const int ntiles = (Skv + p.bk - 1) / p.bk;
  const long long blocks = (long long)B * KV * p.nrc;
  int n = int((2LL * sm_count() + blocks - 1) / blocks);
  n = n < ntiles ? n : ntiles;
  n = n < kMaxSplits ? n : kMaxSplits;
  n = n > 1 ? n : 1;
  p.tps = (ntiles + n - 1) / n;
  p.nsplit = (ntiles + p.tps - 1) / p.tps;
  return p;
}

template <typename T, int HD, int R>
__global__ void __launch_bounds__(kDcThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ qpos,
                    const int* __restrict__ kpos, T* __restrict__ out,
                    int KV, int group, int Sq, int Skv, long long qsb,
                    long long qsh, long long qss, long long ksb,
                    long long ksh, long long kss, long long vsb,
                    long long vsh, long long vss, long long osb,
                    long long osh, long long oss, int causal, int window,
                    int zero_empty, int nsplit, int tps,
                    float* __restrict__ part, int* __restrict__ tickets) {
  using D = Dc<T, HD, R>;
  constexpr int KW = D::KW, BK = D::BK, LPK = D::LPK, EPC = D::EPC;
  constexpr int CH = D::CH, COLS = D::COLS, ROWB = D::ROWB;
  extern __shared__ __align__(128) unsigned char smd[];
  float* Qs = reinterpret_cast<float*>(smd + D::qs);
  int* Kp = reinterpret_cast<int*>(smd + D::kp);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, rc = blockIdx.y, bkv = blockIdx.z;
  const int nrc = gridDim.y;
  const int b = bkv / KV, kvh = bkv - b * KV;
  const int rows = group * Sq;
  const int r0 = rc * R;
  const int nr = min(R, rows - r0);
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;
  const int ntiles = (Skv + BK - 1) / BK;
  const int t0 = split * tps, t1 = min(ntiles, t0 + tps);

  // the block's query rows as f32 (rows past nr zero), their positions
  for (int idx = tid; idx < R * CH; idx += kDcThreads) {
    const int r = idx / CH, c = idx - (idx / CH) * CH;
    float x[EPC];
    if (r < nr) {
      const int rr = r0 + r, gi = rr / Sq, i = rr - gi * Sq;
      widen<T, EPC>(q + b * qsb + (kvh * group + gi) * qsh + i * qss
                    + c * EPC, x);
    } else {
#pragma unroll
      for (int e = 0; e < EPC; ++e) x[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < EPC; e += 4)
      *reinterpret_cast<float4*>(Qs + r * HD + c * EPC + e) =
          make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
  }
  int qp[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int rr = r0 + (r < nr ? r : 0);
    qp[r] = qpos[rr - (rr / Sq) * Sq];
  }
  int qmin, qmax;
  query_bounds(qpos, 0, Sq, qmin, qmax);

  auto load_kv = [&](int t, int st) {
    const int k0 = t * BK;
    unsigned char* Ks = smd + D::kv + (2 * st) * BK * ROWB;
    unsigned char* Vs = Ks + BK * ROWB;
    for (int idx = tid; idx < BK * CH; idx += kDcThreads) {
      const int r = idx / CH, c = idx - (idx / CH) * CH;
      const bool ok = k0 + r < Skv;
      cp_async16(Ks + r * ROWB + c * 16,
                 ok ? kb + (k0 + r) * kss + c * EPC : kb, ok);
      cp_async16(Vs + r * ROWB + c * 16,
                 ok ? vb + (k0 + r) * vss + c * EPC : vb, ok);
    }
    if (tid < BK) {
      const bool ok = k0 + tid < Skv;
      cp_async4(Kp + st * BK + tid, ok ? kpos + k0 + tid : kpos, ok);
    }
  };
  auto next_live = [&](int t, int& cls) {
    for (; t < t1; ++t) {
      cls = tile_class(kpos, t * BK, BK, Skv, qmin, qmax, causal, window);
      if (cls != kDead) break;
    }
    return t;
  };

  // lane (h, j) = (lane / KW, lane % KW): key warp * KW + j of each tile,
  // chunks c = i * LPK + h of its row for the scores; output columns
  // lane * COLS .. + COLS for P V
  const int j = lane % KW, hh = lane / KW;
  const int kk = warp * KW + j;
  float m[R], l[R], acc[R][COLS];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNeg;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[r][c] = 0.0f;
  }

  int cls = kDead;
  int t = next_live(t0, cls);
  if (t < t1) load_kv(t, 0);
  cp_commit();
  int st = 0;
  while (t < t1) {
    int cls_next = kDead;
    const int tn = next_live(t + 1, cls_next);
    if (tn < t1) load_kv(tn, st ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const unsigned char* Ks = smd + D::kv + (2 * st) * BK * ROWB;
    const unsigned char* Vs = Ks + BK * ROWB;
    const int key = t * BK + kk;

    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.0f;
    const T* krow = reinterpret_cast<const T*>(Ks + kk * ROWB);
#pragma unroll
    for (int i = 0; i < D::CPL; ++i) {
      const int c = i * LPK + hh;
      float kx[EPC];
      widen<T, EPC>(krow + c * EPC, kx);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float* qr = Qs + r * HD + c * EPC;
#pragma unroll
        for (int e = 0; e < EPC; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qr + e);
          s[r] = fmaf(qv.x, kx[e], s[r]);
          s[r] = fmaf(qv.y, kx[e + 1], s[r]);
          s[r] = fmaf(qv.z, kx[e + 2], s[r]);
          s[r] = fmaf(qv.w, kx[e + 3], s[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int off = KW; off < 32; off <<= 1)
        s[r] += __shfl_xor_sync(0xffffffffu, s[r], off);
    }
    if (cls == kLive) {
      const int kp = Kp[st * BK + kk];
      const bool ex = key < Skv;
#pragma unroll
      for (int r = 0; r < R; ++r)
        s[r] = !ex ? -INFINITY
               : key_valid(kp, qp[r], causal, window) ? s[r] : kNeg;
    }

    // online softmax over this warp's KW keys; p rounded to T for P V
    float pr[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float mx = s[r];
#pragma unroll
      for (int off = 1; off < KW; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float p = expf(s[r] - m_new);
      float ps = p;
#pragma unroll
      for (int off = 1; off < KW; off <<= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      const float sc = expf(m[r] - m_new);
      l[r] = l[r] * sc + ps;
      m[r] = m_new;
      pr[r] = round_to(p, T());
#pragma unroll
      for (int c = 0; c < COLS; ++c) acc[r][c] *= sc;
    }
#pragma unroll
    for (int jj = 0; jj < KW; ++jj) {
      float vx[COLS];
      widen<T, COLS>(reinterpret_cast<const T*>(Vs + (warp * KW + jj) * ROWB)
                     + lane * COLS, vx);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = __shfl_sync(0xffffffffu, pr[r], jj);
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[r][c] = fmaf(p, vx[c], acc[r][c]);
      }
    }
    __syncthreads();
    t = tn;
    cls = cls_next;
    st ^= 1;
  }
  cp_wait<0>();

  // a row with no valid key in this warp's share: the sum of v over every
  // key of the share, and their count (the combine's weights are then 1
  // for every share when no share saw a valid key)
  bool any_empty = false;
#pragma unroll
  for (int r = 0; r < R; ++r) any_empty |= r < nr && m[r] == kNeg;
  if (any_empty && !zero_empty) {
    float vsum[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c) vsum[c] = 0.0f;
    int cnt = 0;
    for (int tt = t0; tt < t1; ++tt) {
      for (int jj = 0; jj < KW; ++jj) {
        const int key = tt * BK + warp * KW + jj;
        if (key >= Skv) break;
        float vx[COLS];
        widen<T, COLS>(vb + key * vss + lane * COLS, vx);
#pragma unroll
        for (int c = 0; c < COLS; ++c) vsum[c] += vx[c];
        ++cnt;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (m[r] == kNeg) {
        l[r] = float(cnt);
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[r][c] = vsum[c];
      }
  }

  // partials of slot (row block, split, warp): (m, l) pairs, then acc rows
  const int bkr = bkv * nrc + rc;
  const int nslots = gridDim.x * gridDim.y * gridDim.z * kDcWarps;
  const int slot = (bkr * nsplit + split) * kDcWarps + warp;
  float* ml = part;
  float* pacc = part + size_t(nslots) * R * 2;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (lane == 0) {
      ml[(size_t(slot) * R + r) * 2] = m[r];
      ml[(size_t(slot) * R + r) * 2 + 1] = l[r];
    }
    float* dst = pacc + (size_t(slot) * R + r) * HD + lane * COLS;
#pragma unroll
    for (int c = 0; c < COLS; ++c) dst[c] = acc[r][c];
  }
  __threadfence();
  __syncthreads();
  __shared__ int last;
  if (tid == 0) last = atomicAdd(tickets + bkr, 1) == nsplit - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // combine the row block's P = nsplit * 4 partials: per row the max M,
  // weights exp(m_s - M) (in the staging buffers) and the denominator
  const int P = nsplit * kDcWarps;
  const int s0 = bkr * P;
  float* wts = reinterpret_cast<float*>(smd + D::kv);
  float* rowm = reinterpret_cast<float*>(smd + D::rows);
  float* den = rowm + R;
  for (int r = warp; r < nr; r += kDcWarps) {
    float mm = kNeg;
    for (int sl = lane; sl < P; sl += 32)
      mm = fmaxf(mm, __ldcg(ml + (size_t(s0 + sl) * R + r) * 2));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, off));
    float dd = 0.0f;
    for (int sl = lane; sl < P; sl += 32) {
      const float* e = ml + (size_t(s0 + sl) * R + r) * 2;
      const float w = expf(__ldcg(e) - mm);
      wts[r * P + sl] = w;
      dd += w * __ldcg(e + 1);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dd += __shfl_xor_sync(0xffffffffu, dd, off);
    if (lane == 0) {
      rowm[r] = mm;
      den[r] = dd;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < nr * HD; idx += kDcThreads) {
    const int r = idx / HD, d = idx - (idx / HD) * HD;
    float num = 0.0f;
#pragma unroll 4
    for (int sl = 0; sl < P; ++sl)
      num = fmaf(wts[r * P + sl],
                 __ldcg(pacc + (size_t(s0 + sl) * R + r) * HD + d), num);
    const bool zero = zero_empty && rowm[r] == kNeg;
    const int rr = r0 + r, gi = rr / Sq, i = rr - gi * Sq;
    store(out + b * osb + (kvh * group + gi) * osh + i * oss + d,
          zero ? 0.0f : num / fmaxf(den[r], 1e-30f));
  }
  if (tid == 0) tickets[bkr] = 0;   // ready for the next launch
}

// --- launches ---------------------------------------------------------------

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* qpos;
  const int* kpos;
  void* out;
  int B, H, KV, Sq, Skv;
  const long long* st;
  int causal, window, zero_empty;
  float* part;
  int* tickets;
  float* lse;
  cudaStream_t s;
};

template <typename K>
cudaError_t smem_attr(K kern, size_t bytes) {
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

// heads of a GQA group one f32 block packs: the largest power of two that
// divides the group, at most kF32MaxHeads
int f32_heads(int group) {
  int hb = 1;
  while (hb < kF32MaxHeads && group % (2 * hb) == 0) hb *= 2;
  return hb;
}

template <int HD>
int launch_f32(const Args& a) {
  using L = F32Tile<HD>;
  auto kern = flash_f32_kernel<HD>;
  cudaError_t e = smem_attr(kern, L::bytes);
  if (e != cudaSuccess) return int(e);
  const long long* st = a.st;
  const int group = a.H / a.KV, hb = f32_heads(group);
  const int nqt = (a.Sq + L::RB / hb - 1) / (L::RB / hb);
  if (nqt > 65535) return int(cudaErrorInvalidValue);
  const dim3 grid(a.B * a.KV * (group / hb), nqt);
  kern<<<grid, kF32Threads, L::bytes, a.s>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.qpos, a.kpos,
      static_cast<float*>(a.out), a.KV, group, hb, a.Sq, a.Skv, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      a.causal, a.window, a.zero_empty, a.lse);
  return int(cudaGetLastError());
}

template <typename T, int HD>
int launch_prefill(const Args& a) {
  using W = PfShape<HD>;
  const long long* st = a.st;
  CUtensorMap km, vm;
  const bool bf = std::is_same<T, __nv_bfloat16>::value;
  if (!head_map(&km, a.k, bf, HD, a.Skv, a.KV, a.B, st[5], st[4], st[3],
                W::bk) ||
      !head_map(&vm, a.v, bf, HD, a.Skv, a.KV, a.B, st[8], st[7], st[6],
                W::bk))
    return int(cudaErrorInvalidValue);
  auto kern = flash_prefill_kernel<T, HD>;
  cudaError_t e = smem_attr(kern, W::bytes);
  if (e != cudaSuccess) return int(e);
  const int nqt = (a.Sq + kPfBQ - 1) / kPfBQ;
  if (nqt > 65535) return int(cudaErrorInvalidValue);
  const dim3 grid(a.B * a.H, nqt);
  kern<<<grid, kPfThreads, W::bytes, a.s>>>(
      km, vm, static_cast<const T*>(a.q), static_cast<const T*>(a.v), a.qpos,
      a.kpos, static_cast<T*>(a.out), a.lse, a.H, a.H / a.KV, a.Sq, a.Skv,
      st[0],
      st[1], st[2], st[6], st[7], st[8], st[9], st[10], st[11], a.causal,
      a.window, a.zero_empty);
  return int(cudaGetLastError());
}

template <typename T, int HD, int R>
int launch_decode_r(const Args& a, const DecodePlan& p) {
  using D = Dc<T, HD, R>;
  auto kern = flash_decode_kernel<T, HD, R>;
  cudaError_t e = smem_attr(kern, D::bytes);
  if (e != cudaSuccess) return int(e);
  const long long* st = a.st;
  const dim3 grid(p.nsplit, p.nrc, a.B * a.KV);
  kern<<<grid, kDcThreads, D::bytes, a.s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.qpos, a.kpos, static_cast<T*>(a.out),
      a.KV, a.H / a.KV, a.Sq, a.Skv, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11], a.causal, a.window,
      a.zero_empty, p.nsplit, p.tps, a.part, a.tickets);
  return int(cudaGetLastError());
}

template <typename T, int HD>
int launch_decode(const Args& a) {
  if (!a.part || !a.tickets) return int(cudaErrorInvalidValue);
  const DecodePlan p = decode_plan(a.B, a.KV, (a.H / a.KV) * a.Sq, a.Skv,
                                   HD, int(sizeof(T)));
  if (p.nrc > 65535) return int(cudaErrorInvalidValue);
  switch (p.R) {
    case 1: return launch_decode_r<T, HD, 1>(a, p);
    case 2: return launch_decode_r<T, HD, 2>(a, p);
    case 4: return launch_decode_r<T, HD, 4>(a, p);
    case 8: return launch_decode_r<T, HD, 8>(a, p);
    default:
      if constexpr (HD <= 128) return launch_decode_r<T, HD, 16>(a, p);
      return int(cudaErrorInvalidValue);
  }
}

template <typename T>
int by_hd(int hd, const Args& a) {
  // with an lse output every Sq runs the prefill kernel (the only one that
  // writes it)
  const bool decode = a.Sq <= kDecodeMaxSq && !a.lse;
  switch (hd) {
    case 64:
      return decode ? launch_decode<T, 64>(a) : launch_prefill<T, 64>(a);
    case 128:
      return decode ? launch_decode<T, 128>(a) : launch_prefill<T, 128>(a);
    case 256:
      return decode ? launch_decode<T, 256>(a) : launch_prefill<T, 256>(a);
    default: return int(cudaErrorInvalidValue);
  }
}

int f32_by_hd(int hd, const Args& a) {
  // with an lse output every Sq runs flash_f32_kernel (as by_hd)
  if (a.Sq <= kDecodeMaxSq && !a.lse) {
    switch (hd) {
      case 64: return launch_decode<float, 64>(a);
      case 128: return launch_decode<float, 128>(a);
      case 256: return launch_decode<float, 256>(a);
      default: return int(cudaErrorInvalidValue);
    }
  }
  switch (hd) {
    case 64: return launch_f32<64>(a);
    case 128: return launch_f32<128>(a);
    case 256: return launch_f32<256>(a);
    default: return int(cudaErrorInvalidValue);
  }
}

bool bad_shape(int B, int H, int KV, int Sq, int Skv, int hd, int dtype) {
  return B < 1 || H < 1 || KV < 1 || H % KV || Sq < 1 || Skv < 1 ||
         B * H > kMaxRows || dtype < 0 || dtype > 2 ||
         (hd != 64 && hd != 128 && hd != 256);
}

}  // namespace

extern "C" {

// q, k, v, out: T = f32 (dtype 0), bf16 (dtype 1) or fp16 (dtype 2),
// addressed as base + b * s_b + head * s_h + pos * s_s + d with d
// contiguous; the 12 strides are (q, k, v, out) x (batch, head, sequence) in
// elements, each a multiple of 16 bytes. hd in {64, 128, 256}; H a multiple
// of KV. Sq <= 16: flash_decode_kernel (any dtype), whose f32 partials and
// int tickets (zero before the first launch; each launch leaves them zero)
// the caller provides at the sizes fk_flash_workspace gives, for launches
// serialised on one stream; else flash_prefill_kernel for a 2-byte dtype
// and flash_f32_kernel for f32 (partials and tickets unused, may be null).
// zero_empty != 0 writes zero for a row with no valid key (else the mean of
// v, as the reference kernel). lse, when not null: each row's log-sum-exp
// m + log(l) in f32, (B, H, Sq) contiguous, +inf for a row with no valid
// key; every Sq then runs the prefill kernel (bf16 / fp16) or
// flash_f32_kernel (f32). A null lse leaves the launch and its output bits
// as they were.
int fk_flash_attention(const void* q, const void* k, const void* v,
                       const int* qpos, const int* kpos, void* out, int B,
                       int H, int KV, int Sq, int Skv, int hd, long long qsb,
                       long long qsh, long long qss, long long ksb,
                       long long ksh, long long kss, long long vsb,
                       long long vsh, long long vss, long long osb,
                       long long osh, long long oss, int causal, int window,
                       int zero_empty, int dtype, void* partials,
                       void* tickets, float* lse, void* stream) {
  if (bad_shape(B, H, KV, Sq, Skv, hd, dtype) || window < 0)
    return int(cudaErrorInvalidValue);
  const long long st[12] = {qsb, qsh, qss, ksb, ksh, kss,
                            vsb, vsh, vss, osb, osh, oss};
  const Args a{q, k, v, qpos, kpos, out, B, H, KV, Sq, Skv, st, causal,
               window, zero_empty, static_cast<float*>(partials),
               static_cast<int*>(tickets), lse,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 1) return by_hd<__nv_bfloat16>(hd, a);
  if (dtype == 2) return by_hd<__half>(hd, a);
  return f32_by_hd(hd, a);
}

// flash_f32_kernel<hd>'s resources: resident blocks an SM, registers and
// local bytes a thread, dynamic shared bytes (out, 4 ints).
int fk_flash_f32_resources(int hd, int* out) {
  auto get = [&](auto kern, size_t bytes) {
    cudaError_t e = smem_attr(kern, bytes);
    if (e != cudaSuccess) return int(e);
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, kern);
    if (e != cudaSuccess) return int(e);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kern,
                                                      kF32Threads, bytes);
    out[1] = attr.numRegs;
    out[2] = int(attr.localSizeBytes);
    out[3] = int(bytes);
    return int(e);
  };
  switch (hd) {
    case 64: return get(flash_f32_kernel<64>, F32Tile<64>::bytes);
    case 128: return get(flash_f32_kernel<128>, F32Tile<128>::bytes);
    case 256: return get(flash_f32_kernel<256>, F32Tile<256>::bytes);
    default: return int(cudaErrorInvalidValue);
  }
}

// sizes[0]: f32 values of the decode kernel's partials, sizes[1]: ints of
// its tickets, for a launch of these shapes on the current device (both 0
// when Sq > 16); sizes[2]: the KV splits, sizes[3]: rows a block
int fk_flash_workspace(int B, int H, int KV, int Sq, int Skv, int hd,
                       int dtype, long long* sizes) {
  if (bad_shape(B, H, KV, Sq, Skv, hd, dtype))
    return int(cudaErrorInvalidValue);
  sizes[0] = sizes[1] = sizes[2] = sizes[3] = 0;
  if (Sq > kDecodeMaxSq) return 0;
  const DecodePlan p = decode_plan(B, KV, (H / KV) * Sq, Skv, hd,
                                   dtype ? 2 : 4);
  const long long blocks = (long long)B * KV * p.nrc;
  sizes[0] = blocks * p.nsplit * kDcWarps * p.R * (hd + 2);
  sizes[1] = blocks;
  sizes[2] = p.nsplit;
  sizes[3] = p.R;
  return 0;
}

const char* fk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
