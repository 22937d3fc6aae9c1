// Hand-written Hopper (sm_90a) gradient of the port's f32 flash attention.
//
// The reference replaces no Pallas kernel here: it trains through XLA's
// autodiff of models/attention.py's _attend_local, and its Pallas
// flash_attention (src/repro/kernels/flash_attention.py) has no backward.
// fk_attention.cu's flash_f32_kernel runs the port's f32 attention on the
// card (every SMOKE config is f32) and writes each row's log-sum-exp
// lse = m + log(l) when asked (+inf for a row with no valid key, whose
// output is zero: it gets zero dq and adds nothing to dk or dv). These
// three kernels are the gradient of what it computes, the f32 twin of
// fk_attention_bwd.cu's bf16 / fp16 kernels:
//
//   D  = rowsum(dO o O)                         flash_bwd_f32_prep_kernel
//   P  = exp(S - lse) on the valid pairs, S = Q K^T (no scaling: the
//        caller scales q), dP = dO V^T, dS = P o (dP - D)
//   dV = sum over the group's heads of P^T dO, dK = ... dS^T Q
//                                               flash_bwd_f32_dkdv_kernel
//   dQ = dS K                                   flash_bwd_f32_dq_kernel
//
// masked by absolute positions with the forward's contract
// valid = kpos >= 0 && (!causal || kpos <= qpos) && (!window || kpos >
// qpos - window). Every product is an f32 FMA on the CUDA cores (no
// tensor cores in f32 without TF32, which would change the arithmetic) and
// exp is the accurate expf: nothing is rounded below f32, so the kernels
// differ from flash_attention_backward_plain by the order of f32 sums only.
// Each accumulator sums a walk step's terms in registers of its own first
// and adds that partial (accumulate): over the thousands of terms of a
// training row one running f32 sum would carry about twice the rounding of
// the plain version's cuBLAS products.
//
// The shape is flash_f32_kernel's (fk_attention.cu): a block of 8 warps;
// a warp owns WR rows in RG row groups of 4 (lane = rg * KG + kg). For the
// two score products the lane holds its 4 rows x KPL columns kg + KG j of
// the walk step; for an accumulator its 4 rows x CPL float4 columns 4 kg +
// 4 KG h. A step's P (and dS) cannot stay in registers (a lane's score
// columns are not its accumulator's), so they go through a buffer of the
// warp's own behind a __syncwarp. Rows of shared memory keep their 16-byte
// chunks XOR-swizzled by (row & 7), so both the score reads (one chunk of
// 8 rows a phase) and the accumulator reads (8 chunks of one row) are free
// of bank conflicts without padding. The walked tiles go through a
// two-stage cp.async ring, so the next live step's copies overlap this
// step's FMAs.
//
//   * flash_bwd_f32_dkdv_kernel<HD>: one block per (batch, KV head, RB
//     keys); the block's K and V are staged once. It walks the query tiles
//     of BT rows that are live for its keys (the tile rule of
//     fk_attention.cu's header, from the positions' bounds: a dead tile is
//     not fetched, a fully live one not masked), each over the GQA group's
//     query heads, staging Q, dO and the rows' lse, D and positions. Per
//     step S^T = K Q^T and dP^T = V dO^T, P^T and dS^T, then dV += P^T dO
//     and dK += dS^T Q: two accumulators a lane.
//   * flash_bwd_f32_dq_kernel<HD>: one block per (batch, query head, RB
//     rows); Q and dO are staged once, the walk goes over the KV tiles of
//     BT keys that are live for the rows: S = Q K^T, dP = dO V^T, dS, then
//     dQ += dS K. Query tiles go out last first (the longest causal walks
//     start first).
//   * flash_bwd_f32_prep_kernel: one warp a query row.
//
// RB x BT: 64 x 64 at hd 64, 64 x 32 at hd 128, 32 x 32 at hd 256 (RG 2, 2,
// 1); shared memory 112 to 201 KB, one block an SM. No atomics: every dK /
// dV / dQ element has one owner thread and a fixed walk, so two launches
// give the same bits. Query rows past Sq are zero rows that the kernels
// mask; keys past Skv are zero rows, masked, and their dK / dV rows are not
// written. Head dims other than 64, 128 and 256 are zero-padded by the
// caller, as the forward pads them.
//
// Bound on the H100: per (query, valid key) pair and query head, 8 HD
// FLOPs in the dK / dV kernel and 6 HD in the dQ kernel (S and dP computed
// in both), at the 67 TFLOP/s of f32 FMAs on the CUDA cores; the prep
// kernel by its bytes (O and dO read, D written; 3.35 TB/s).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (no --use_fast_math: expf stays accurate).
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 65535;     // a grid dimension

enum TileClass : int { kDead = 0, kLive = 1, kFull = 2 };

// element strides (batch, head, sequence) of up to six operands
struct Strides {
  long long v[18];
};

// The shape of both kernels at head dim HD (see the header). RB rows a
// block (keys for dK / dV, query rows for dQ), BT columns a walk step
// (query rows, keys); a buffer of BT x WR floats a warp for P (and dS).
template <int HD>
struct Tile {
  static constexpr int RG = HD <= 128 ? 2 : 1;
  static constexpr int KG = 32 / RG;
  static constexpr int WR = 4 * RG;
  static constexpr int RB = kWarps * WR;
  static constexpr int BT = HD <= 64 ? 64 : 32;
  static constexpr int KPL = BT / KG;
  static constexpr int CH = HD / 4;            // 16-byte chunks a row
  static constexpr int CPL = HD / (4 * KG);
  static_assert(KG % 8 == 0 && KPL >= 1 && CPL >= 1, "tile shape");
};

// shared memory of the dK / dV kernel, in floats: K and V (RB rows), two
// stages of Q and dO (BT rows) with the rows' lse, D and positions, and
// each warp's P^T and dS^T
template <int HD>
struct KvLayout {
  using S = Tile<HD>;
  static constexpr int k = 0;
  static constexpr int v = S::RB * HD;
  static constexpr int ring = 2 * S::RB * HD;
  static constexpr int stage = 2 * S::BT * HD + 3 * S::BT;
  static constexpr int p = ring + 2 * stage;
  static constexpr int words = p + 2 * kWarps * S::BT * S::WR;
  static constexpr size_t bytes = size_t(words) * 4;
};

// shared memory of the dQ kernel, in floats: Q and dO (RB rows), two stages
// of K and V (BT rows), each warp's dS
template <int HD>
struct QLayout {
  using S = Tile<HD>;
  static constexpr int q = 0;
  static constexpr int g = S::RB * HD;
  static constexpr int ring = 2 * S::RB * HD;
  static constexpr int stage = 2 * S::BT * HD;
  static constexpr int p = ring + 2 * stage;
  static constexpr int words = p + kWarps * S::BT * S::WR;
  static constexpr size_t bytes = size_t(words) * 4;
};

// 16 bytes global -> shared, zero-filled when !full (src then unread)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(full ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// n rows of HD floats from src (row i at src + i * ss) into dst, swizzled
// (row r's chunk c at chunk c ^ (r & 7)); rows at or past `valid` zero
template <int HD>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           long long ss, int n, int valid) {
  constexpr int CH = HD / 4;
  for (int i = threadIdx.x; i < n * CH; i += kThreads) {
    const int r = i / CH, c = i - (i / CH) * CH;
    const bool full = r < valid;
    cp_async16(dst + r * HD + ((c ^ (r & 7)) << 2),
               full ? src + r * ss + c * 4 : src, full);
  }
}

// s[i][j] = A[row_i] . B[col_j] and t[i][j] = C[row_i] . E[col_j] over HD,
// in order: A and C the block's rows, B and E a step's, all swizzled; the
// lane's rows row[i], columns kg + KG j
template <int HD>
__device__ __forceinline__ void two_scores(const float* A, const float* C,
                                           const float* B, const float* E,
                                           const int* row, int kg,
                                           float (*s)[Tile<HD>::KPL],
                                           float (*t)[Tile<HD>::KPL]) {
  using S = Tile<HD>;
  constexpr int KPL = S::KPL, CH = S::CH, KG = S::KG;
  const float4* A4 = reinterpret_cast<const float4*>(A);
  const float4* C4 = reinterpret_cast<const float4*>(C);
  const float4* B4 = reinterpret_cast<const float4*>(B);
  const float4* E4 = reinterpret_cast<const float4*>(E);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < KPL; ++j) s[i][j] = t[i][j] = 0.0f;
#pragma unroll 2
  for (int c = 0; c < CH; ++c) {
    float4 a[4], cc[4], b[KPL], e[KPL];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = A4[row[i] * CH + (c ^ (row[i] & 7))];
      cc[i] = C4[row[i] * CH + (c ^ (row[i] & 7))];
    }
#pragma unroll
    for (int j = 0; j < KPL; ++j) {      // (kg + KG j) & 7 == kg & 7
      b[j] = B4[(kg + KG * j) * CH + (c ^ (kg & 7))];
      e[j] = E4[(kg + KG * j) * CH + (c ^ (kg & 7))];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        t[i][j] = fmaf(cc[i].x, e[j].x, t[i][j]);
        t[i][j] = fmaf(cc[i].y, e[j].y, t[i][j]);
        t[i][j] = fmaf(cc[i].z, e[j].z, t[i][j]);
        t[i][j] = fmaf(cc[i].w, e[j].w, t[i][j]);
      }
  }
}

// acc[i][h] += the sum over the step's BT columns kk of X[kk][rg * 4 + i]
// * M[kk][chunk kg + KG h] (M swizzled, X the warp's buffer), taken in kk
// order in registers of its own and then added: a two-level sum, so an
// accumulator over n steps carries the rounding of BT + n additions, not
// of BT x n
template <int HD>
__device__ __forceinline__ void accumulate(float4 (*acc)[Tile<HD>::CPL],
                                           const float* X, const float* M,
                                           int rg, int kg) {
  using S = Tile<HD>;
  constexpr int CPL = S::CPL, CH = S::CH, KG = S::KG, WR = S::WR;
  const float4* M4 = reinterpret_cast<const float4*>(M);
  float4 part[4][CPL];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < CPL; ++h)
      part[i][h] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
  for (int kk = 0; kk < S::BT; ++kk) {
    const float4 x = *reinterpret_cast<const float4*>(X + kk * WR + rg * 4);
    const float xr[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int h = 0; h < CPL; ++h) {
      const float4 m = M4[kk * CH + ((kg + KG * h) ^ (kk & 7))];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        part[i][h].x = fmaf(xr[i], m.x, part[i][h].x);
        part[i][h].y = fmaf(xr[i], m.y, part[i][h].y);
        part[i][h].z = fmaf(xr[i], m.z, part[i][h].z);
        part[i][h].w = fmaf(xr[i], m.w, part[i][h].w);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < CPL; ++h) {
      acc[i][h].x += part[i][h].x;
      acc[i][h].y += part[i][h].y;
      acc[i][h].z += part[i][h].z;
      acc[i][h].w += part[i][h].w;
    }
}

// --- D = rowsum(dO o O) ------------------------------------------------------

__global__ void __launch_bounds__(256)
flash_bwd_f32_prep_kernel(const float* __restrict__ o,
                          const float* __restrict__ dout,
                          float* __restrict__ dsum, int H, int Sq, int hd,
                          long long osb, long long osh, long long oss,
                          long long dsb, long long dsh, long long dss) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * 8 + warp;
  if (i >= Sq) return;
  const int b = blockIdx.y / H, h = blockIdx.y - (blockIdx.y / H) * H;
  const float* orow = o + b * osb + h * osh + i * oss;
  const float* drow = dout + b * dsb + h * dsh + i * dss;
  float acc = 0.0f;
  for (int d = lane; d < hd; d += 32) acc = fmaf(orow[d], drow[d], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dsum[(long long)blockIdx.y * Sq + i] = acc;
}

// --- dK, dV ------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_f32_dkdv_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ dsum,
                          const int* __restrict__ qpos,
                          const int* __restrict__ kpos, float* __restrict__ dk,
                          float* __restrict__ dv, int H, int KV, int Sq,
                          int Skv, const Strides st, int causal, int window) {
  using S = Tile<HD>;
  using L = KvLayout<HD>;
  constexpr int RG = S::RG, KG = S::KG, WR = S::WR, RB = S::RB, BT = S::BT;
  constexpr int KPL = S::KPL, CPL = S::CPL;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int rg = lane / KG, kg = lane % KG;
  float* Pw = smem + L::p + w * BT * WR;
  float* Sw = Pw + kWarps * BT * WR;

  const int b = blockIdx.x / KV, kvh = blockIdx.x - (blockIdx.x / KV) * KV;
  const int group = H / KV;
  const int k0 = blockIdx.y * RB;
  const int nk = min(RB, Skv - k0);
  const int nqt = (Sq + BT - 1) / BT;
  // q (0..2), k (3..5), v (6..8), dout (9..11): (batch, head, sequence)
  const long long* sv = st.v;

  stage_rows<HD>(smem + L::k, k + b * sv[3] + kvh * sv[4] + k0 * sv[5],
                 sv[5], RB, nk);
  stage_rows<HD>(smem + L::v, v + b * sv[6] + kvh * sv[7] + k0 * sv[8],
                 sv[8], RB, nk);
  // a step (query tile qt, head j of the group) into stage s
  auto stage = [&](int qt, int j, int s) {
    float* base = smem + L::ring + s * L::stage;
    const int h = kvh * group + j;
    const int q0 = qt * BT, n = min(BT, Sq - q0);
    stage_rows<HD>(base, q + b * sv[0] + h * sv[1] + q0 * sv[2], sv[2], BT,
                   n);
    stage_rows<HD>(base + BT * HD,
                   dout + b * sv[9] + h * sv[10] + q0 * sv[11], sv[11], BT,
                   n);
    float* rows = base + 2 * BT * HD;
    const long long r0 = ((long long)b * H + h) * Sq + q0;
    for (int i = tid; i < BT; i += kThreads) {
      const bool full = i < n;
      cp_async4(rows + i, full ? lse + r0 + i : lse, full);
      cp_async4(rows + BT + i, full ? dsum + r0 + i : dsum, full);
      cp_async4(rows + 2 * BT + i, full ? qpos + q0 + i : qpos, full);
    }
  };
  int kmin, kmax, kcnt;
  key_bounds(kpos, k0, RB, Skv, kmin, kmax, kcnt);
  // the first query tile from qt that is live for the block's keys (nqt:
  // none) and its class; every warp walks the same steps
  auto next_live = [&](int qt, int& cls) {
    for (; qt < nqt; ++qt) {
      int qmin, qmax;
      query_bounds(qpos, qt * BT, min(BT, Sq - qt * BT), qmin, qmax);
      cls = pair_class(qmin, qmax, kmin, kmax, kcnt, RB, causal, window);
      if (cls != kDead) break;
    }
    return qt;
  };
  // the step after (qt, j): the next head of the group, else the next live
  // query tile's first
  auto advance = [&](int& qt, int& j, int& cls) {
    if (qt >= nqt) return;
    if (++j == group) {
      j = 0;
      qt = next_live(qt + 1, cls);
    }
  };

  int row[4], kp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row[i] = w * WR + rg + RG * i;
    kp[i] = row[i] < nk ? __ldg(kpos + k0 + row[i]) : -1;
  }
  float4 dka[4][CPL], dva[4][CPL];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < CPL; ++h)
      dka[i][h] = dva[i][h] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  int cls0 = kDead, j0 = 0;
  int qt0 = next_live(0, cls0);
  if (qt0 < nqt) stage(qt0, j0, 0);
  cp_commit();
  int qt1 = qt0, j1 = j0, cls1 = cls0;
  advance(qt1, j1, cls1);
  if (qt1 < nqt) stage(qt1, j1, 1);
  cp_commit();
  for (int s = 0; qt0 < nqt; s ^= 1) {
    cp_wait<1>();
    __syncthreads();
    const float* Qs = smem + L::ring + s * L::stage;
    const float* Gs = Qs + BT * HD;
    const float* lt = Gs + BT * HD;
    const float* dt = lt + BT;
    const int* qpt = reinterpret_cast<const int*>(dt + BT);
    const int q0 = qt0 * BT;

    // S^T = K Q^T and dP^T = V dO^T: the lane's 4 keys x KPL queries
    float sc[4][KPL], dp[4][KPL];
    two_scores<HD>(smem + L::k, smem + L::v, Qs, Gs, row, kg, sc, dp);

    // P^T = exp(S^T - lse) on the valid pairs, dS^T = P^T o (dP^T - D), to
    // the warp's buffers, slot rg * 4 + i of each query
    const bool masked = cls0 != kFull;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const int c = kg + KG * j;
      const bool exists = q0 + c < Sq;
      const float l = lt[c], d = dt[c];
      const int qp = qpt[c];
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = exists &&
                        (!masked || key_valid(kp[i], qp, causal, window));
        p[i] = ok ? expf(sc[i][j] - l) : 0.0f;
        ds[i] = p[i] * (dp[i][j] - d);
      }
      *reinterpret_cast<float4*>(Pw + c * WR + rg * 4) =
          make_float4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<float4*>(Sw + c * WR + rg * 4) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncwarp();
    // dV += P^T dO and dK += dS^T Q over the step's queries
    accumulate<HD>(dva, Pw, Gs, rg, kg);
    accumulate<HD>(dka, Sw, Qs, rg, kg);
    __syncthreads();   // every warp is done with this stage
    int qt2 = qt1, j2 = j1, cls2 = cls1;
    advance(qt2, j2, cls2);
    if (qt2 < nqt) stage(qt2, j2, s);
    cp_commit();
    qt0 = qt1;
    j0 = j1;
    cls0 = cls1;
    qt1 = qt2;
    j1 = j2;
    cls1 = cls2;
  }
  cp_wait<0>();

  // dk (12..14), dv (15..17)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (row[i] >= nk) continue;
    const long long key = k0 + row[i];
    float* kr = dk + b * sv[12] + kvh * sv[13] + key * sv[14];
    float* vr = dv + b * sv[15] + kvh * sv[16] + key * sv[17];
#pragma unroll
    for (int h = 0; h < CPL; ++h) {
      *reinterpret_cast<float4*>(kr + 4 * (kg + KG * h)) = dka[i][h];
      *reinterpret_cast<float4*>(vr + 4 * (kg + KG * h)) = dva[i][h];
    }
  }
}

// --- dQ ----------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_f32_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dsum,
                        const int* __restrict__ qpos,
                        const int* __restrict__ kpos, float* __restrict__ dq,
                        int H, int KV, int Sq, int Skv, const Strides st,
                        int causal, int window) {
  using S = Tile<HD>;
  using L = QLayout<HD>;
  constexpr int RG = S::RG, KG = S::KG, WR = S::WR, RB = S::RB, BT = S::BT;
  constexpr int KPL = S::KPL, CPL = S::CPL;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int rg = lane / KG, kg = lane % KG;
  float* Xw = smem + L::p + w * BT * WR;

  const int b = blockIdx.x / H, h = blockIdx.x - (blockIdx.x / H) * H;
  const int kvh = h / (H / KV);
  // the longest causal walks first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * RB;
  const int nq = min(RB, Sq - q0);
  const int nt = (Skv + BT - 1) / BT;
  const long long* sv = st.v;
  const float* kb = k + b * sv[3] + kvh * sv[4];
  const float* vb = v + b * sv[6] + kvh * sv[7];

  stage_rows<HD>(smem + L::q, q + b * sv[0] + h * sv[1] + q0 * sv[2], sv[2],
                 RB, nq);
  stage_rows<HD>(smem + L::g, dout + b * sv[9] + h * sv[10] + q0 * sv[11],
                 sv[11], RB, nq);
  auto stage = [&](int t, int s) {
    float* base = smem + L::ring + s * L::stage;
    const int n = min(BT, Skv - t * BT);
    stage_rows<HD>(base, kb + (long long)t * BT * sv[5], sv[5], BT, n);
    stage_rows<HD>(base + BT * HD, vb + (long long)t * BT * sv[8], sv[8], BT,
                   n);
  };
  int qmin, qmax;
  query_bounds(qpos, q0, nq, qmin, qmax);
  auto next_live = [&](int t, int& cls) {
    for (; t < nt; ++t) {
      int kmin, kmax, kcnt;
      key_bounds(kpos, t * BT, BT, Skv, kmin, kmax, kcnt);
      cls = pair_class(qmin, qmax, kmin, kmax, kcnt, BT, causal, window);
      if (cls != kDead) break;
    }
    return t;
  };

  int row[4], qp[4];
  float lr[4], dr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row[i] = w * WR + rg + RG * i;
    const bool in = row[i] < nq;
    const long long r = ((long long)b * H + h) * Sq + q0 + row[i];
    qp[i] = in ? __ldg(qpos + q0 + row[i]) : 0;
    lr[i] = in ? __ldg(lse + r) : INFINITY;   // rows past Sq: P = 0
    dr[i] = in ? __ldg(dsum + r) : 0.0f;
  }
  float4 dqa[4][CPL];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hh = 0; hh < CPL; ++hh)
      dqa[i][hh] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  int cls = kDead, cls1 = kDead;
  int t = next_live(0, cls);
  if (t < nt) stage(t, 0);
  cp_commit();
  int t1 = t < nt ? next_live(t + 1, cls1) : nt;
  if (t1 < nt) stage(t1, 1);
  cp_commit();
  for (int s = 0; t < nt; s ^= 1) {
    cp_wait<1>();
    __syncthreads();
    const float* Ks = smem + L::ring + s * L::stage;
    const float* Vs = Ks + BT * HD;
    const int k0 = t * BT;

    // S = Q K^T and dP = dO V^T: the lane's 4 rows x KPL keys
    float sc[4][KPL], dp[4][KPL];
    two_scores<HD>(smem + L::q, smem + L::g, Ks, Vs, row, kg, sc, dp);

    // dS = P o (dP - D), P = exp(S - lse) on the valid pairs, to the warp's
    // buffer, slot rg * 4 + i of each key
    const bool masked = cls != kFull;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const int c = kg + KG * j;
      const bool exists = k0 + c < Skv;
      const int kp = masked && exists ? __ldg(kpos + k0 + c) : 0;
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = !masked ||
                        (exists && key_valid(kp, qp[i], causal, window));
        const float p = ok ? expf(sc[i][j] - lr[i]) : 0.0f;
        ds[i] = p * (dp[i][j] - dr[i]);
      }
      *reinterpret_cast<float4*>(Xw + c * WR + rg * 4) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncwarp();
    // dQ += dS K over the step's keys
    accumulate<HD>(dqa, Xw, Ks, rg, kg);
    __syncthreads();   // every warp is done with this stage
    int cls2 = kDead;
    const int t2 = t1 < nt ? next_live(t1 + 1, cls2) : nt;
    if (t2 < nt) stage(t2, s);
    cp_commit();
    t = t1;
    cls = cls1;
    t1 = t2;
    cls1 = cls2;
  }
  cp_wait<0>();

  // dq (12..14)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (row[i] >= nq) continue;
    float* qr = dq + b * sv[12] + h * sv[13] + (long long)(q0 + row[i])
                * sv[14];
#pragma unroll
    for (int hh = 0; hh < CPL; ++hh)
      *reinterpret_cast<float4*>(qr + 4 * (kg + KG * hh)) = dqa[i][hh];
  }
}

// --- launches ----------------------------------------------------------------

template <typename K>
cudaError_t smem_attr(K kern, size_t bytes) {
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

bool bad_shape(int B, int H, int KV, int Sq, int Skv, int hd) {
  return B < 1 || H < 1 || KV < 1 || H % KV || Sq < 1 || Skv < 1 ||
         (hd != 64 && hd != 128 && hd != 256);
}

struct Operands {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;
  const float* dsum;
  const int* qpos;
  const int* kpos;
  int B, H, KV, Sq, Skv;
  Strides st;
  int causal, window;
  cudaStream_t s;
};

template <int HD>
int dkdv(const Operands& a, float* dk, float* dv) {
  using L = KvLayout<HD>;
  auto kern = flash_bwd_f32_dkdv_kernel<HD>;
  cudaError_t e = smem_attr(kern, L::bytes);
  if (e != cudaSuccess) return int(e);
  const int nkt = (a.Skv + Tile<HD>::RB - 1) / Tile<HD>::RB;
  if (nkt > 65535) return int(cudaErrorInvalidValue);
  kern<<<dim3(a.B * a.KV, nkt), kThreads, L::bytes, a.s>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.dsum, a.qpos, a.kpos, dk, dv, a.H,
      a.KV, a.Sq, a.Skv, a.st, a.causal, a.window);
  return int(cudaGetLastError());
}

template <int HD>
int dq_launch(const Operands& a, float* dq) {
  using L = QLayout<HD>;
  auto kern = flash_bwd_f32_dq_kernel<HD>;
  cudaError_t e = smem_attr(kern, L::bytes);
  if (e != cudaSuccess) return int(e);
  const int nqt = (a.Sq + Tile<HD>::RB - 1) / Tile<HD>::RB;
  if (nqt > 65535) return int(cudaErrorInvalidValue);
  kern<<<dim3(a.B * a.H, nqt), kThreads, L::bytes, a.s>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.dsum, a.qpos, a.kpos, dq, a.H, a.KV,
      a.Sq, a.Skv, a.st, a.causal, a.window);
  return int(cudaGetLastError());
}

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
  return int(e);
}

template <int HD>
int resources_of(int which, int* out) {
  return which == 0
             ? resources(flash_bwd_f32_dkdv_kernel<HD>, KvLayout<HD>::bytes,
                         out)
             : resources(flash_bwd_f32_dq_kernel<HD>, QLayout<HD>::bytes,
                         out);
}

Operands operands(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* dsum,
                  const int* qpos, const int* kpos, int B, int H, int KV,
                  int Sq, int Skv, const long long* strides, int n,
                  int causal, int window, void* stream) {
  Operands a{static_cast<const float*>(q), static_cast<const float*>(k),
             static_cast<const float*>(v), static_cast<const float*>(dout),
             lse, dsum, qpos, kpos, B, H, KV, Sq, Skv, Strides{}, causal,
             window, static_cast<cudaStream_t>(stream)};
  for (int i = 0; i < n; ++i) a.st.v[i] = strides[i];
  return a;
}

}  // namespace

extern "C" {

// D = rowsum(dO o O) in f32, (B, H, Sq) contiguous; o and dout f32 with
// (batch, head, sequence) element strides st[0..2] (o) and st[3..5] (dout),
// the head dim contiguous.
int fk_flash_bwd_f32_prep(const void* o, const void* dout, float* dsum,
                          int B, int H, int Sq, int hd, const long long* st,
                          void* stream) {
  if (bad_shape(B, H, H, Sq, 1, hd) || B * H > kMaxRows)
    return int(cudaErrorInvalidValue);
  const dim3 grid((Sq + 7) / 8, B * H);
  flash_bwd_f32_prep_kernel<<<grid, 256, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(dout), dsum, H,
      Sq, hd, st[0], st[1], st[2], st[3], st[4], st[5]);
  return int(cudaGetLastError());
}

// dK and dV (B, KV, Skv, hd) of f32 q (B, H, Sq, hd), k, v (B, KV, Skv, hd)
// and dout (B, H, Sq, hd), from lse and D (B, H, Sq) f32 contiguous.
// strides: 18 element strides, (q, k, v, dout, dk, dv) x (batch, head,
// sequence), each a multiple of 4 (16 bytes), bases 16-byte aligned, the
// head dim contiguous; hd 64, 128 or 256.
int fk_flash_bwd_f32_dkdv(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse,
                          const float* dsum, const int* qpos, const int* kpos,
                          void* dk, void* dv, int B, int H, int KV, int Sq,
                          int Skv, int hd, const long long* strides,
                          int causal, int window, void* stream) {
  if (bad_shape(B, H, KV, Sq, Skv, hd) || window < 0)
    return int(cudaErrorInvalidValue);
  const Operands a = operands(q, k, v, dout, lse, dsum, qpos, kpos, B, H, KV,
                              Sq, Skv, strides, 18, causal, window, stream);
  float* k_ = static_cast<float*>(dk);
  float* v_ = static_cast<float*>(dv);
  if (hd == 64) return dkdv<64>(a, k_, v_);
  if (hd == 128) return dkdv<128>(a, k_, v_);
  return dkdv<256>(a, k_, v_);
}

// dQ (B, H, Sq, hd), the same operands; strides: 15 element strides,
// (q, k, v, dout, dq) x (batch, head, sequence).
int fk_flash_bwd_f32_dq(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse, const float* dsum,
                        const int* qpos, const int* kpos, void* dq, int B,
                        int H, int KV, int Sq, int Skv, int hd,
                        const long long* strides, int causal, int window,
                        void* stream) {
  if (bad_shape(B, H, KV, Sq, Skv, hd) || window < 0)
    return int(cudaErrorInvalidValue);
  const Operands a = operands(q, k, v, dout, lse, dsum, qpos, kpos, B, H, KV,
                              Sq, Skv, strides, 15, causal, window, stream);
  float* q_ = static_cast<float*>(dq);
  if (hd == 64) return dq_launch<64>(a, q_);
  if (hd == 128) return dq_launch<128>(a, q_);
  return dq_launch<256>(a, q_);
}

// which 0: flash_bwd_f32_dkdv_kernel, 1: flash_bwd_f32_dq_kernel, at hd (64,
// 128, 256): out[0..3] = resident blocks an SM, registers and local (spill)
// bytes a thread, dynamic shared bytes.
int fk_flash_bwd_f32_resources(int which, int hd, int* out) {
  if ((which != 0 && which != 1) || bad_shape(1, 1, 1, 1, 1, hd))
    return int(cudaErrorInvalidValue);
  if (hd == 64) return resources_of<64>(which, out);
  if (hd == 128) return resources_of<128>(which, out);
  return resources_of<256>(which, out);
}

const char* fk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
