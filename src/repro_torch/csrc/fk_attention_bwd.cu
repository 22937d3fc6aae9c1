// Hand-written Hopper (sm_90a) gradient of the port's flash attention.
//
// The reference replaces no Pallas kernel here: it trains through XLA's
// autodiff of models/attention.py's _attend_local, and its Pallas
// flash_attention (src/repro/kernels/flash_attention.py) has no backward.
// The port runs attention on the card only through fk_attention.cu's
// flash_prefill_kernel, whose result carries no autograd graph, so
// kernels/flash_attention.py's FlashAttentionFn pairs it with these three
// kernels. They compute the gradient of what that kernel computes,
//
//   out = P V,   P = softmax_row(S) over the valid keys,   S = Q K^T
//
// (no scaling: the caller scales q, and autograd of that scaling scales dq
// back), masked by absolute positions with the forward's contract
// valid = kpos >= 0 && (!causal || kpos <= qpos) && (!window || kpos >
// qpos - window), from the forward's row log-sum-exp
// lse = m + log(l) (+inf for a row with no valid key, whose output is zero:
// it gets zero dq and adds nothing to dk or dv):
//
//   P  = exp(S - lse), dP = dO V^T
//   D  = rowsum(P o dP)                      flash_bwd_prep_kernel
//   dS = P o (dP - D)
//   dV = sum over the group's heads of P^T dO, dK = ... dS^T Q
//                                            flash_bwd_dkdv_kernel
//   dQ = dS K                                flash_bwd_dq_kernel
//
// Products run on bf16 or fp16 operands with f32 accumulation; P (for dV)
// and dS (for dK and dQ) are rounded to the input type first, as the
// forward rounds P before P V. Accumulators stay in f32 registers and are
// rounded once, at the end, to the input type.
//
// D is the row sum of P o dP over the same P and dP the other two kernels
// compute, not dO . O: then every row of dS sums to zero up to f32
// rounding, as the plain gradient's does. D from the rounded output is off
// by dO . (O - P V), a rounding of O's size, so a row's dS sums to that
// times one, not to zero; dQ = dS K then carries that sum times the keys'
// common direction, and dK's sum over the keys carries it times the
// queries'. Where a model's tokens share most of their direction (deep
// random layers: whisper-medium's decoder and encoder), that term is many
// times the cancelling gradient it rides on (chip_smoke.py phase 20).
//
// Hopper's shape, as the forward's prefill kernel (fk_attention.cu): a
// block of 384 threads is two consumer warpgroups and a producer
// warpgroup. The producer's registers are cut to 24 a thread and the
// consumers' raised to 240 (setmaxnreg; the role broadcast warp-uniform),
// since a consumer holds two f32 accumulators of 64 rows x hd. One warp of
// the producer warpgroup works, the other three exit: it decides each
// step's tile by position (the tile rule of fk_attention.cu's header:
// dead, live, fully live, from the positions' bounds; a dead tile is not
// loaded) and TMA-loads it (64-value panels of 128 bytes, 128-byte swizzle,
// zeros past the tensor's end) into a ring of three stages, each guarded by
// a "full" mbarrier (the TMA's bytes) and an "empty" one (the 256 consumer
// threads). A stage's index of -1 ends the walk. The consumers classify the
// step once more for their own 64 rows (a tile dead for them is skipped, a
// fully live one not masked) and run every product as wgmma.mma_async
// (fk_wgmma.cuh) from shared memory:
//
//   * flash_bwd_dkdv_kernel<T, HD>: one block per (batch, KV head, 128
//     keys); warpgroup w owns keys 64 w .. 64 w + 63 and their dK and dV
//     (2 x HD / 2 f32 a thread). The producer loads the block's K and V
//     once, then walks the query tiles of 64 rows that are live for the
//     block's keys, each over the group's query heads, loading Q and dO by
//     TMA and the rows' lse, D and positions by its lanes. Per step S^T =
//     K Q^T and dP^T = V dO^T (m64n64k16, both operands K-major), P^T and
//     dS^T on the accumulator fragments, then dV += P^T dO and dK += dS^T Q
//     (m64nHDk16, A from registers: S^T's accumulator layout is the A
//     fragment's; Q and dO read as the MN-major B operand, imm-trans-b), so
//     P and dS never go through shared memory. Key tile 0, the longest
//     causal walk, goes first (blockIdx.y).
//   * flash_bwd_dq_kernel<T, HD>: one block per (batch, query head, 128
//     rows); warpgroup w owns rows 64 w .. 64 w + 63 and their dQ (HD / 2
//     f32 a thread). Q and dO are loaded once; the producer walks the KV
//     tiles of 64 keys that are live for the block's rows. Per step S = Q
//     K^T and dP = dO V^T (K-major), dS on the fragments, dQ += dS K (A from
//     registers, K MN-major): the forward's structure with one more
//     product. Query tiles go out last first (blockIdx.y reversed), so the
//     longest causal walks start first.
//   * flash_bwd_prep_kernel<T, HD>: the dQ kernel's walk with S and dP
//     only (dq_walk<DSUM>), D = rowsum(P o dP) summed by each thread over
//     its columns and steps, then over the quad of a row's threads in a
//     fixed order. It runs first: the dK / dV and dQ kernels read D.
//
// No atomics: every dK / dV / dQ element has one owner thread and a fixed
// walk, so two launches give the same bits. (FA3's fused design adds dQ
// partials from the dK / dV walk into an f32 buffer with atomics, which
// changes bits between launches; ordered, it moves about a GB more at the
// training shape.) Query rows past Sq are zero rows (TMA) with lse = +inf,
// so their P is 0; keys past Skv are zero rows, masked, never fully live,
// and their dK / dV rows are not written.
//
// Bound on the H100: per (query, valid key) pair and query head, 8 HD FLOPs
// in the dK / dV kernel (S^T, dP^T, dV, dK) and 6 HD in the dQ kernel (S,
// dP, dQ) and 4 HD in the prep kernel (S, dP), at 989 TFLOP/s; the
// gradient itself needs 10 HD (S and dP once). hd 64, 128 and 256 are built. At hd 256 (KvShape, QShape) a dK /
// dV block is 64 keys whose dK and dV the two consumer warpgroups split by
// hd half (64 + 64 f32 a thread): each computes the block's S^T and dP^T
// over all of hd itself, so the dK / dV kernel does 12 hd FLOPs a pair
// there (S^T and dP^T twice), in a two-stage ring; the dQ kernel walks
// steps of 32 keys (m64n32k16 for S and dP, m64n256k16 for dQ += dS K) in
// a two-stage ring. Both keep the rules above: no atomics, the same walk.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (no --use_fast_math).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <type_traits>

#include "fk_tma.cuh"
#include "fk_wgmma.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 384;       // two consumer warpgroups, a producer one
constexpr int kConsumers = 256;
constexpr int kProducerRegs = 24;   // a thread, after setmaxnreg
constexpr int kConsumerRegs = 240;
constexpr int kRows = 64;           // a warpgroup's keys (dK/dV), rows (dQ)
constexpr int kBlock = 128;         // a block's keys (dK/dV), rows (dQ)
constexpr int kTile = 64;           // a step's query rows (dK/dV), keys (dQ)
constexpr int kStages = 3;
constexpr int kMaxRows = 65535;     // a grid dimension

enum TileClass : int { kDead = 0, kLive = 1, kFull = 2 };

// The dK / dV kernel's shape by head dim: keys a block, ring stages, and
// the dK / dV columns a consumer warpgroup owns. Up to hd 128 warpgroup w
// owns keys 64 w .. 64 w + 63 of a 128-key block, all of hd. At hd 256 the
// two warpgroups share one block of 64 keys and own one half of hd each
// (64 + 64 f32 of dK and dV a thread, as at hd 128); each computes the
// block's S^T and dP^T over the whole hd itself, so those two products run
// twice (no shared-memory exchange, no extra barrier). K and V of 64 keys
// (64 KB) and two stages of Q and dO (64 KB each) fit the 227 KB.
template <int HD>
struct KvShape {
  static constexpr bool split = HD > 128;
  static constexpr int block = split ? kRows : kBlock;
  static constexpr int stages = split ? 2 : kStages;
  static constexpr int cols = split ? HD / 2 : HD;
};

// The dQ kernel's: keys a walk step and ring stages. At hd 256 a step is
// 32 keys, as the forward's prefill kernel walks them: dQ (128 f32 a
// thread), S and dP (16 each) fit the consumers' registers, and Q and dO of
// 128 rows (128 KB) leave room for two stages of K and V.
template <int HD>
struct QShape {
  static constexpr int tile = HD > 128 ? 32 : kTile;
  static constexpr int stages = HD > 128 ? 2 : kStages;
};

// element strides (batch, head, sequence) of the outputs: dk and dv, or dq
struct OutStrides {
  long long v[6];
};

// 2^x on the SFU, as the forward's (ex2.approx.ftz: -inf gives +0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ bool key_valid(int kp, int qp, int causal,
                                          int window) {
  return kp >= 0 && (!causal || kp <= qp) &&
         (!window || (long long)kp > (long long)qp - window);
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

// kmin, kmax and the count of the valid keys (kpos >= 0, key < Skv) of
// [k0, k0 + bk), the same in every lane of the warp
__device__ __forceinline__ void key_bounds(const int* __restrict__ kpos,
                                           int k0, int bk, int Skv, int& kmin,
                                           int& kmax, int& cnt) {
  kmin = INT_MAX;
  kmax = INT_MIN;
  cnt = 0;
  for (int j = threadIdx.x & 31; j < bk; j += 32) {
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
}

// the forward's tile rule (fk_attention.cu's tile_class) from the bounds
__device__ __forceinline__ int pair_class(int qmin, int qmax, int kmin,
                                          int kmax, int cnt, int bk,
                                          int causal, int window) {
  if (cnt == 0 || (causal && kmin > qmax) ||
      (window && (long long)kmax <= (long long)qmin - window))
    return kDead;
  if (cnt == bk && (!causal || kmax <= qmin) &&
      (!window || (long long)kmin > (long long)qmax - window))
    return kFull;
  return kLive;
}

// S (64 x N) = A B^T over HD, both K-major 128-byte-swizzled tiles: A's
// panels a_panel bytes apart, B's b_panel (wgmma m64nNk16, N 32 or 64, HD
// / 16 steps)
template <typename T, int HD, int N = 64>
__device__ __forceinline__ void wgmma_abt(float* s, const unsigned char* a,
                                          int a_panel,
                                          const unsigned char* b,
                                          int b_panel) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int off = (kk & 3) << 5;
    const uint64_t da = sw128_desc(a + (kk >> 2) * a_panel + off, 16);
    const uint64_t db = sw128_desc(b + (kk >> 2) * b_panel + off, 16);
    if constexpr (N == 32) wgmma_ss_n32(s, da, db, kk > 0, T());
    else wgmma_ss_n64(s, da, db, kk > 0, T());
  }
}

// D (64 x N) += A B over KT rows of B: A from registers (KT / 16 k16 steps
// of the mma.sync A fragment, pairs packed in T), B a KT-row tile with its
// N columns contiguous (MN-major, imm-trans-b), its 64-value panels KT *
// 128 bytes apart
template <typename T, int N, int KT>
__device__ __forceinline__ void wgmma_ab(float* d, const uint32_t (*a)[2],
                                         const unsigned char* b) {
#pragma unroll
  for (int j = 0; j < KT / 16; ++j) {
    const uint32_t f[4] = {a[2 * j][0], a[2 * j][1], a[2 * j + 1][0],
                           a[2 * j + 1][1]};
    const uint64_t db = sw128_desc(b + j * 16 * 128, KT * 128);
    if constexpr (N == 64) wgmma_rs_n64(d, f, db, T());
    else if constexpr (N == 128) wgmma_rs_n128(d, f, db, T());
    else wgmma_rs_n256(d, f, db, T());
  }
}

// rows [0, 64) of a warpgroup's f32 accumulator (64 x HD, wgmma's layout)
// rounded to T into rows row0 + r of out (stride ss), rows at or past n
// not written
template <typename T, int HD>
__device__ __forceinline__ void store_rows(T* __restrict__ out, long long ss,
                                           int row0, int n, const float* d) {
  const int lane = threadIdx.x & 31, wi = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 16 * wi + (lane >> 2) + 8 * r;
    if (row >= n) continue;
    T* o = out + row * ss + 2 * (lane & 3);
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
      *reinterpret_cast<uint32_t*>(o + nt * 8) =
          pack2<T>(d[nt * 4 + 2 * r], d[nt * 4 + 2 * r + 1]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.0f;
}

// --- dK, dV ------------------------------------------------------------------

template <int HD>
struct KvSmem {
  static constexpr int NS = KvShape<HD>::stages;
  static constexpr int panels = HD / 64;
  // K or V of the block
  static constexpr int kv_bytes = KvShape<HD>::block * HD * 2;
  static constexpr int tile_bytes = kTile * HD * 2;  // Q or dO of a step
  static constexpr int stage_bytes = 2 * tile_bytes;
  static constexpr int k = 0;
  static constexpr int v = kv_bytes;
  static constexpr int ring = 2 * kv_bytes;
  // each stage's rows: lse, D (f32) and positions (int), kTile each
  static constexpr int rows = ring + NS * stage_bytes;
  // each stage's (query tile or -1, head of the group, qmin, qmax)
  static constexpr int info = rows + NS * 3 * kTile * 4;
  static constexpr int bars = info + NS * 4 * 4;  // full, empty, kv
  static constexpr size_t bytes = size_t(bars) + (2 * NS + 1) * 8 + 1024;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap gmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const float* __restrict__ lse,
                      const float* __restrict__ dsum,
                      const int* __restrict__ qpos,
                      const int* __restrict__ kpos, T* __restrict__ dk,
                      T* __restrict__ dv, int H, int KV, int Sq, int Skv,
                      const OutStrides os, int causal, int window) {
  using W = KvSmem<HD>;
  using P = KvShape<HD>;
  constexpr int KB = P::block, NS = P::stages, AW = P::cols;
  extern __shared__ unsigned char smw_raw[];
  unsigned char* smw = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smw_raw) + 1023) & ~uintptr_t(1023));
  float* ls = reinterpret_cast<float*>(smw + W::rows);     // [stage][kTile]
  float* ds = ls + NS * kTile;
  int* qs = reinterpret_cast<int*>(ds + NS * kTile);
  int* info = reinterpret_cast<int*>(smw + W::info);       // [stage][4]
  uint64_t* full = reinterpret_cast<uint64_t*>(smw + W::bars);
  uint64_t* empty = full + NS;
  uint64_t* kvbar = empty + NS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / KV, kvh = blockIdx.x - (blockIdx.x / KV) * KV;
  const int group = H / KV;
  const int k0 = blockIdx.y * KB;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, 32);          // the producer's lanes
      mbar_init(empty + s, kConsumers);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warpgroup 2 produces; the role broadcast from lane 0 is visibly
  // warp-uniform, so ptxas gives each role its setmaxnreg count
  const int role = __shfl_sync(0xffffffffu, warp >> 2, 0);
  if (role == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs)
                 : "memory");
    if (warp != 8) return;
    if (lane == 0) {
      mbar_expect_tx(kvbar, 2 * W::kv_bytes);
#pragma unroll
      for (int p = 0; p < W::panels; ++p) {
        tma_load(smw + W::k + p * KB * 128, &kmap, kvbar, p * 64, k0, kvh,
                 b);
        tma_load(smw + W::v + p * KB * 128, &vmap, kvbar, p * 64, k0, kvh,
                 b);
      }
    }
    int kmin, kmax, kcnt;
    key_bounds(kpos, k0, KB, Skv, kmin, kmax, kcnt);
    const int nqt = (Sq + kTile - 1) / kTile;
    // the first query tile at or after qt that is live for the block
    int qmin = 0, qmax = 0;
    auto next_live = [&](int qt) {
      for (; qt < nqt; ++qt) {
        query_bounds(qpos, qt * kTile, min(kTile, Sq - qt * kTile), qmin,
                     qmax);
        if (pair_class(qmin, qmax, kmin, kmax, kcnt, KB, causal,
                       window) != kDead)
          break;
      }
      return qt;
    };
    int qt = next_live(0), j = 0;
    for (int it = 0;; ++it) {
      const int st = it % NS;
      mbar_wait(empty + st, ((it / NS) & 1) ^ 1);
      const bool more = qt < nqt;
      const int h = kvh * group + j;
      if (more) {
        const long long row = ((long long)b * H + h) * Sq;
        for (int i = lane; i < kTile; i += 32) {
          const int qi = qt * kTile + i;
          ls[st * kTile + i] = qi < Sq ? lse[row + qi] : INFINITY;
          ds[st * kTile + i] = qi < Sq ? dsum[row + qi] : 0.0f;
          qs[st * kTile + i] = qi < Sq ? qpos[qi] : 0;
        }
      }
      if (lane == 0) {
        int* in = info + 4 * st;
        in[0] = more ? qt : -1;
        in[1] = j;
        in[2] = qmin;
        in[3] = qmax;
      }
      if (lane == 0 && more) {
        unsigned char* Qs = smw + W::ring + st * W::stage_bytes;
        mbar_expect_tx(full + st, W::stage_bytes);
#pragma unroll
        for (int p = 0; p < W::panels; ++p) {
          tma_load(Qs + p * kTile * 128, &qmap, full + st, p * 64,
                   qt * kTile, h, b);
          tma_load(Qs + W::tile_bytes + p * kTile * 128, &gmap, full + st,
                   p * 64, qt * kTile, h, b);
        }
      } else {
        mbar_arrive(full + st);
      }
      if (!more) return;
      if (++j == group) {
        j = 0;
        qt = next_live(qt + 1);
      }
    }
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs)
               : "memory");

  // consumers: warpgroup wg owns keys kw .. kw + 63, dK / dV columns cw ..
  // cw + AW - 1
  const int wg = warp >> 2, wi = warp & 3;
  const int g = lane >> 2, tg = lane & 3;
  const int kw = k0 + (P::split ? 0 : kRows * wg);
  const int cw = P::split ? AW * wg : 0;
  int kmin, kmax, kcnt;
  key_bounds(kpos, kw, kRows, Skv, kmin, kmax, kcnt);
  int kp[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kw + 16 * wi + g + 8 * r;
    kp[r] = key < Skv ? __ldg(kpos + key) : -1;
  }
  float dka[AW / 2], dva[AW / 2];
  zero<AW / 2>(dka);
  zero<AW / 2>(dva);
  const int kr = P::split ? 0 : kRows * wg;        // the keys' first row
  const unsigned char* Kw = smw + W::k + kr * 128;
  const unsigned char* Vw = smw + W::v + kr * 128;
  mbar_wait(kvbar, 0);

  for (int it = 0;; ++it) {
    const int st = it % NS;
    mbar_wait(full + st, (it / NS) & 1);
    const volatile int* in = info + 4 * st;
    if (in[0] < 0) break;
    const int cls = pair_class(in[2], in[3], kmin, kmax, kcnt, kRows, causal,
                               window);
    if (cls != kDead) {
      const unsigned char* Qt = smw + W::ring + st * W::stage_bytes;
      const unsigned char* Gt = Qt + W::tile_bytes;
      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries
      float sa[32], pa[32];
      wg_fence();
      wgmma_abt<T, HD>(sa, Kw, KB * 128, Qt, kTile * 128);
      wgmma_abt<T, HD>(pa, Vw, KB * 128, Gt, kTile * 128);
      wg_commit();
      wg_wait0();
      fence_regs<32>(sa);
      fence_regs<32>(pa);
      // P^T = exp(S^T - lse) on the valid pairs, dS^T = P^T o (dP^T - D),
      // rounded to T in pairs: the A fragments of dV's and dK's products
      const float* lt = ls + st * kTile;
      const float* dt = ds + st * kTile;
      const int* qpt = qs + st * kTile;
      uint32_t pp[8][2], sp[8][2];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int c = nt * 8 + 2 * tg;             // query columns c, c + 1
        const float2 l2 = *reinterpret_cast<const float2*>(lt + c);
        const float2 d2 = *reinterpret_cast<const float2*>(dt + c);
        const int2 q2 = *reinterpret_cast<const int2*>(qpt + c);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float p0 = fast_exp2((sa[nt * 4 + 2 * r] - l2.x) * kLog2e);
          float p1 = fast_exp2((sa[nt * 4 + 2 * r + 1] - l2.y) * kLog2e);
          if (cls == kLive) {
            if (!key_valid(kp[r], q2.x, causal, window)) p0 = 0.0f;
            if (!key_valid(kp[r], q2.y, causal, window)) p1 = 0.0f;
          }
          pp[nt][r] = pack2<T>(p0, p1);
          sp[nt][r] = pack2<T>(p0 * (pa[nt * 4 + 2 * r] - d2.x),
                               p1 * (pa[nt * 4 + 2 * r + 1] - d2.y));
        }
      }
      // dV += P^T dO and dK += dS^T Q over the 64 queries, columns cw ..
      // cw + AW - 1 (dO's and Q's panels from cw / 64 on)
      const int pc = (cw / 64) * kTile * 128;
      fence_regs<AW / 2>(dva);
      fence_regs<AW / 2>(dka);
      wg_fence();
      wgmma_ab<T, AW, kTile>(dva, pp, Gt + pc);
      wgmma_ab<T, AW, kTile>(dka, sp, Qt + pc);
      wg_commit();
      wg_wait0();
      fence_regs<AW / 2>(dva);
      fence_regs<AW / 2>(dka);
    }
    mbar_arrive(empty + st);
  }

  store_rows<T, AW>(dk + b * os.v[0] + kvh * os.v[1] + cw, os.v[2], kw, Skv,
                    dka);
  store_rows<T, AW>(dv + b * os.v[3] + kvh * os.v[4] + cw, os.v[5], kw, Skv,
                    dva);
}

// --- dQ ----------------------------------------------------------------------

template <int HD>
struct QSmem {
  static constexpr int NS = QShape<HD>::stages;
  static constexpr int panels = HD / 64;
  static constexpr int q_bytes = kBlock * HD * 2;    // Q or dO of the block
  // K or V of a step
  static constexpr int tile_bytes = QShape<HD>::tile * HD * 2;
  static constexpr int stage_bytes = 2 * tile_bytes;
  static constexpr int q = 0;
  static constexpr int g = q_bytes;
  static constexpr int ring = 2 * q_bytes;
  // each stage's (KV tile or -1, kmin, kmax, valid keys)
  static constexpr int info = ring + NS * stage_bytes;
  static constexpr int bars = info + NS * 4 * 4;  // full, empty, q
  static constexpr size_t bytes = size_t(bars) + (2 * NS + 1) * 8 + 1024;
};

// The walk of a block of 128 query rows over its live KV tiles. DSUM false:
// dQ += dS K, dS = P o (dP - D) from D (dsum, read). DSUM true, the D pass:
// S and dP only, D = rowsum(P o dP) over the same tiles, written to dsum
// (each thread sums its columns a step, then over the steps; the quad of
// a row's threads adds in a fixed order).
template <typename T, int HD, bool DSUM>
__device__ __forceinline__ void dq_walk(
    const CUtensorMap& qmap, const CUtensorMap& gmap, const CUtensorMap& kmap,
    const CUtensorMap& vmap, const float* __restrict__ lse,
    float* __restrict__ dsum, const int* __restrict__ qpos,
    const int* __restrict__ kpos, T* __restrict__ dq, int H, int KV, int Sq,
    int Skv, const OutStrides& os, int causal, int window) {
  using W = QSmem<HD>;
  constexpr int TK = QShape<HD>::tile, NS = QShape<HD>::stages;
  extern __shared__ unsigned char smw_raw[];
  unsigned char* smw = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smw_raw) + 1023) & ~uintptr_t(1023));
  int* info = reinterpret_cast<int*>(smw + W::info);       // [stage][4]
  uint64_t* full = reinterpret_cast<uint64_t*>(smw + W::bars);
  uint64_t* empty = full + NS;
  uint64_t* qbar = empty + NS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / H, h = blockIdx.x - (blockIdx.x / H) * H;
  const int kvh = h / (H / KV);
  // the longest causal walks first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlock;
  const int nq = min(kBlock, Sq - q0);
  const int ntiles = (Skv + TK - 1) / TK;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, warp >> 2, 0);
  if (role == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs)
                 : "memory");
    if (warp != 8) return;
    if (lane == 0) {
      mbar_expect_tx(qbar, 2 * W::q_bytes);
#pragma unroll
      for (int p = 0; p < W::panels; ++p) {
        tma_load(smw + W::q + p * kBlock * 128, &qmap, qbar, p * 64, q0, h, b);
        tma_load(smw + W::g + p * kBlock * 128, &gmap, qbar, p * 64, q0, h, b);
      }
    }
    int qmin, qmax;
    query_bounds(qpos, q0, nq, qmin, qmax);
    int kmin = 0, kmax = 0, kcnt = 0;
    // the first KV tile at or after t that is live for the block's rows
    auto next_live = [&](int t) {
      for (; t < ntiles; ++t) {
        key_bounds(kpos, t * TK, TK, Skv, kmin, kmax, kcnt);
        if (pair_class(qmin, qmax, kmin, kmax, kcnt, TK, causal,
                       window) != kDead)
          break;
      }
      return t;
    };
    int t = next_live(0);
    for (int it = 0;; ++it) {
      const int st = it % NS;
      mbar_wait(empty + st, ((it / NS) & 1) ^ 1);
      const bool more = t < ntiles;
      if (lane == 0) {
        int* in = info + 4 * st;
        in[0] = more ? t : -1;
        in[1] = kmin;
        in[2] = kmax;
        in[3] = kcnt;
        if (more) {
          unsigned char* Ks = smw + W::ring + st * W::stage_bytes;
          mbar_expect_tx(full + st, W::stage_bytes);
#pragma unroll
          for (int p = 0; p < W::panels; ++p) {
            tma_load(Ks + p * TK * 128, &kmap, full + st, p * 64,
                     t * TK, kvh, b);
            tma_load(Ks + W::tile_bytes + p * TK * 128, &vmap, full + st,
                     p * 64, t * TK, kvh, b);
          }
        } else {
          mbar_arrive(full + st);
        }
      }
      __syncwarp();
      if (!more) return;
      t = next_live(t + 1);
    }
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs)
               : "memory");

  // consumers: warpgroup wg owns rows q0 + 64 wg .. + 63
  const int wg = warp >> 2, wi = warp & 3;
  const int g = lane >> 2, tg = lane & 3;
  const int r0 = kRows * wg;
  const int nw = min(kRows, nq - r0);              // its rows below Sq
  int qmin, qmax;
  query_bounds(qpos, q0 + r0, nw, qmin, qmax);
  float lr[2], dr[2];
  int qp[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + r0 + 16 * wi + g + 8 * r;
    const long long row = ((long long)b * H + h) * Sq + i;
    lr[r] = i < Sq ? lse[row] : INFINITY;
    dr[r] = !DSUM && i < Sq ? dsum[row] : 0.0f;
    qp[r] = i < Sq ? qpos[i] : 0;
  }
  float dqa[DSUM ? 1 : HD / 2];
  zero<DSUM ? 1 : HD / 2>(dqa);
  float dacc[2] = {0.0f, 0.0f};
  const unsigned char* Qw = smw + W::q + r0 * 128;
  const unsigned char* Gw = smw + W::g + r0 * 128;
  mbar_wait(qbar, 0);

  for (int it = 0;; ++it) {
    const int st = it % NS;
    mbar_wait(full + st, (it / NS) & 1);
    const volatile int* in = info + 4 * st;
    const int t = in[0];
    if (t < 0) break;
    const int cls = nw > 0 ? pair_class(qmin, qmax, in[1], in[2], in[3],
                                        TK, causal, window)
                           : kDead;
    if (cls != kDead) {
      const unsigned char* Kt = smw + W::ring + st * W::stage_bytes;
      const unsigned char* Vt = Kt + W::tile_bytes;
      // S = Q K^T and dP = dO V^T: 64 rows x TK keys
      float sa[TK / 2], pa[TK / 2];
      wg_fence();
      wgmma_abt<T, HD, TK>(sa, Qw, kBlock * 128, Kt, TK * 128);
      wgmma_abt<T, HD, TK>(pa, Gw, kBlock * 128, Vt, TK * 128);
      wg_commit();
      wg_wait0();
      fence_regs<TK / 2>(sa);
      fence_regs<TK / 2>(pa);
      // P = exp(S - lse) on the valid pairs; dS = P o (dP - D), or (the D
      // pass) the step's sums of P o dP
      const int k0 = t * TK;
      uint32_t sp[TK / 8][2];
      float part[2] = {0.0f, 0.0f};
#pragma unroll
      for (int nt = 0; nt < TK / 8; ++nt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float d[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + nt * 8 + 2 * tg + e;
            float x = fast_exp2((sa[nt * 4 + 2 * r + e] - lr[r]) * kLog2e);
            if (cls == kLive &&
                (key >= Skv || !key_valid(__ldg(kpos + key), qp[r], causal,
                                          window)))
              x = 0.0f;
            if constexpr (DSUM)
              part[r] = fmaf(x, pa[nt * 4 + 2 * r + e], part[r]);
            else
              d[e] = x * (pa[nt * 4 + 2 * r + e] - dr[r]);
          }
          if constexpr (!DSUM) sp[nt][r] = pack2<T>(d[0], d[1]);
        }
      }
      if constexpr (DSUM) {
        dacc[0] += part[0];
        dacc[1] += part[1];
      } else {
        // dQ += dS K over the TK keys
        fence_regs<HD / 2>(dqa);
        wg_fence();
        wgmma_ab<T, HD, TK>(dqa, sp, Kt);
        wg_commit();
        wg_wait0();
        fence_regs<HD / 2>(dqa);
      }
    }
    mbar_arrive(empty + st);
  }

  if constexpr (DSUM) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = dacc[r];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      const int i = q0 + r0 + 16 * wi + g + 8 * r;
      if (tg == 0 && i < Sq) dsum[((long long)b * H + h) * Sq + i] = x;
    }
  } else {
    store_rows<T, HD>(dq + b * os.v[0] + h * os.v[1], os.v[2], q0 + r0, Sq,
                      dqa);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap gmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const float* __restrict__ lse, float* __restrict__ dsum,
                    const int* __restrict__ qpos, const int* __restrict__ kpos,
                    T* __restrict__ dq, int H, int KV, int Sq, int Skv,
                    const OutStrides os, int causal, int window) {
  dq_walk<T, HD, false>(qmap, gmap, kmap, vmap, lse, dsum, qpos, kpos, dq, H,
                        KV, Sq, Skv, os, causal, window);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_prep_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap gmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const float* __restrict__ lse, float* __restrict__ dsum,
                      const int* __restrict__ qpos,
                      const int* __restrict__ kpos, T* __restrict__ dq, int H,
                      int KV, int Sq, int Skv, const OutStrides os,
                      int causal, int window) {
  dq_walk<T, HD, true>(qmap, gmap, kmap, vmap, lse, dsum, qpos, kpos, dq, H,
                       KV, Sq, Skv, os, causal, window);
}

// --- launches ----------------------------------------------------------------

template <typename K>
cudaError_t smem_attr(K kern, size_t bytes) {
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

bool bad_shape(int B, int H, int KV, int Sq, int Skv, int hd, int dtype) {
  return B < 1 || H < 1 || KV < 1 || H % KV || Sq < 1 || Skv < 1 ||
         (hd != 64 && hd != 128 && hd != 256) || (dtype != 1 && dtype != 2);
}

// F<T, HD>::run(args...) at the dtype code (1 bf16, 2 fp16) and hd (64,
// 128, 256) that bad_shape let through
template <template <typename, int> class F, typename... A>
int by_type_hd(int dtype, int hd, A&&... args) {
  if (dtype == 1) {
    if (hd == 64) return F<__nv_bfloat16, 64>::run(args...);
    if (hd == 128) return F<__nv_bfloat16, 128>::run(args...);
    return F<__nv_bfloat16, 256>::run(args...);
  }
  if (hd == 64) return F<__half, 64>::run(args...);
  if (hd == 128) return F<__half, 128>::run(args...);
  return F<__half, 256>::run(args...);
}

// the operands of both gradient kernels: q, k, v, dout with 12 element
// strides ((q, k, v, dout) x (batch, head, sequence)), lse, D, positions
struct Operands {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* dsum;
  const int* qpos;
  const int* kpos;
  int B, H, KV, Sq, Skv;
  const long long* st;
  int causal, window;
  cudaStream_t s;
};

// the four tensor maps: q and dout in boxes of q_rows, k and v of kv_rows
template <typename T, int HD>
bool maps(const Operands& a, int q_rows, int kv_rows, CUtensorMap* m) {
  const bool bf = std::is_same<T, __nv_bfloat16>::value;
  const long long* st = a.st;
  return head_map(m + 0, a.q, bf, HD, a.Sq, a.H, a.B, st[2], st[1], st[0],
                  q_rows) &&
         head_map(m + 1, a.dout, bf, HD, a.Sq, a.H, a.B, st[11], st[10],
                  st[9], q_rows) &&
         head_map(m + 2, a.k, bf, HD, a.Skv, a.KV, a.B, st[5], st[4], st[3],
                  kv_rows) &&
         head_map(m + 3, a.v, bf, HD, a.Skv, a.KV, a.B, st[8], st[7], st[6],
                  kv_rows);
}

template <typename T, int HD>
int dkdv(const Operands& a, void* dk, void* dv, const OutStrides& os) {
  CUtensorMap m[4];
  constexpr int KB = KvShape<HD>::block;
  if (!maps<T, HD>(a, kTile, KB, m)) return int(cudaErrorInvalidValue);
  auto kern = flash_bwd_dkdv_kernel<T, HD>;
  cudaError_t e = smem_attr(kern, KvSmem<HD>::bytes);
  if (e != cudaSuccess) return int(e);
  const int nkt = (a.Skv + KB - 1) / KB;
  if (nkt > 65535 || a.B * a.KV > kMaxRows) return int(cudaErrorInvalidValue);
  kern<<<dim3(a.B * a.KV, nkt), kThreads, KvSmem<HD>::bytes, a.s>>>(
      m[0], m[1], m[2], m[3], a.lse, a.dsum, a.qpos, a.kpos,
      static_cast<T*>(dk), static_cast<T*>(dv), a.H, a.KV, a.Sq, a.Skv, os,
      a.causal, a.window);
  return int(cudaGetLastError());
}

// the dQ kernel, or with DSUM its D pass (writing a.dsum)
template <typename T, int HD, bool DSUM>
int dq_launch(const Operands& a, void* dq, const OutStrides& os) {
  CUtensorMap m[4];
  if (!maps<T, HD>(a, kBlock, QShape<HD>::tile, m))
    return int(cudaErrorInvalidValue);
  auto kern = DSUM ? flash_bwd_prep_kernel<T, HD>
                   : flash_bwd_dq_kernel<T, HD>;
  cudaError_t e = smem_attr(kern, QSmem<HD>::bytes);
  if (e != cudaSuccess) return int(e);
  const int nqt = (a.Sq + kBlock - 1) / kBlock;
  if (nqt > 65535 || a.B * a.H > kMaxRows) return int(cudaErrorInvalidValue);
  kern<<<dim3(a.B * a.H, nqt), kThreads, QSmem<HD>::bytes, a.s>>>(
      m[0], m[1], m[2], m[3], a.lse, const_cast<float*>(a.dsum), a.qpos,
      a.kpos, static_cast<T*>(dq), a.H, a.KV, a.Sq, a.Skv, os, a.causal,
      a.window);
  return int(cudaGetLastError());
}

// a kernel's resident blocks an SM, registers and local bytes a thread,
// dynamic shared bytes, and the setmaxnreg counts of its two roles
template <typename K>
int resources(K kern, size_t bytes, int* out) {
  cudaError_t e = smem_attr(kern, bytes);
  if (e != cudaSuccess) return int(e);
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kern);
  if (e != cudaSuccess) return int(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kern, kThreads,
                                                    bytes);
  out[1] = attr.numRegs;
  out[2] = int(attr.localSizeBytes);
  out[3] = int(bytes);
  out[4] = kProducerRegs;
  out[5] = kConsumerRegs;
  return int(e);
}

template <typename T, int HD>
int resources_of(int which, int* out) {
  return which == 0
             ? resources(flash_bwd_dkdv_kernel<T, HD>, KvSmem<HD>::bytes, out)
             : resources(flash_bwd_dq_kernel<T, HD>, QSmem<HD>::bytes, out);
}

template <typename T, int HD>
struct DkdvOf {
  static int run(const Operands& a, void* dk, void* dv,
                 const OutStrides& os) {
    return dkdv<T, HD>(a, dk, dv, os);
  }
};
template <typename T, int HD>
struct DqOf {
  static int run(const Operands& a, void* dq, const OutStrides& os) {
    return dq_launch<T, HD, false>(a, dq, os);
  }
};
template <typename T, int HD>
struct PrepOf {
  static int run(const Operands& a, const OutStrides& os) {
    return dq_launch<T, HD, true>(a, nullptr, os);
  }
};
template <typename T, int HD>
struct ResourcesOf {
  static int run(int which, int* out) { return resources_of<T, HD>(which, out); }
};

}  // namespace

extern "C" {

// D = rowsum(P o dP) in f32, (B, H, Sq) contiguous, into dsum, of the
// operands of fk_flash_bwd_dq (lse, positions; 12 element strides, (q, k,
// v, dout) x (batch, head, sequence)): the dQ kernel's walk with S and dP
// only.
int fk_flash_bwd_prep(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, float* dsum,
                      const int* qpos, const int* kpos, int B, int H, int KV,
                      int Sq, int Skv, int hd, const long long* strides,
                      int causal, int window, int dtype, void* stream) {
  if (bad_shape(B, H, KV, Sq, Skv, hd, dtype) || window < 0)
    return int(cudaErrorInvalidValue);
  const Operands a{q, k, v, dout, lse, dsum, qpos, kpos, B, H, KV, Sq, Skv,
                   strides, causal, window,
                   static_cast<cudaStream_t>(stream)};
  const OutStrides os{};
  return by_type_hd<PrepOf>(dtype, hd, a, os);
}

// dK and dV (B, KV, Skv, hd) of q (B, H, Sq, hd), k, v (B, KV, Skv, hd) and
// dout (B, H, Sq, hd), from lse and D (B, H, Sq) f32 contiguous. strides:
// 18 element strides, (q, k, v, dout, dk, dv) x (batch, head, sequence),
// each a multiple of 16 bytes, bases 16-byte aligned, the head dim
// contiguous.
int fk_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* dsum,
                      const int* qpos, const int* kpos, void* dk, void* dv,
                      int B, int H, int KV, int Sq, int Skv, int hd,
                      const long long* strides, int causal, int window,
                      int dtype, void* stream) {
  if (bad_shape(B, H, KV, Sq, Skv, hd, dtype) || window < 0)
    return int(cudaErrorInvalidValue);
  const Operands a{q, k, v, dout, lse, dsum, qpos, kpos, B, H, KV, Sq, Skv,
                   strides, causal, window,
                   static_cast<cudaStream_t>(stream)};
  OutStrides os;
  for (int i = 0; i < 6; ++i) os.v[i] = strides[12 + i];
  return by_type_hd<DkdvOf>(dtype, hd, a, dk, dv, os);
}

// dQ (B, H, Sq, hd), the same operands; strides: 15 element strides,
// (q, k, v, dout, dq) x (batch, head, sequence).
int fk_flash_bwd_dq(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* dsum,
                    const int* qpos, const int* kpos, void* dq, int B, int H,
                    int KV, int Sq, int Skv, int hd, const long long* strides,
                    int causal, int window, int dtype, void* stream) {
  if (bad_shape(B, H, KV, Sq, Skv, hd, dtype) || window < 0)
    return int(cudaErrorInvalidValue);
  const Operands a{q, k, v, dout, lse, dsum, qpos, kpos, B, H, KV, Sq, Skv,
                   strides, causal, window,
                   static_cast<cudaStream_t>(stream)};
  OutStrides os;
  for (int i = 0; i < 3; ++i) os.v[i] = strides[12 + i];
  os.v[3] = os.v[4] = os.v[5] = 0;
  return by_type_hd<DqOf>(dtype, hd, a, dq, os);
}

// which 0: flash_bwd_dkdv_kernel, 1: flash_bwd_dq_kernel, at dtype (1 bf16,
// 2 fp16) and hd (64, 128, 256): out[0..5] = resident blocks an SM, registers and
// local (spill) bytes a thread, dynamic shared bytes, the producer's and
// the consumers' registers a thread after setmaxnreg.
int fk_flash_bwd_resources(int which, int dtype, int hd, int* out) {
  if ((which != 0 && which != 1) || bad_shape(1, 1, 1, 1, 1, hd, dtype))
    return int(cudaErrorInvalidValue);
  return by_type_hd<ResourcesOf>(dtype, hd, which, out);
}

const char* fk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
