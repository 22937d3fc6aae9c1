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
//   D  = rowsum(dO o O)                      flash_bwd_prep_kernel
//   P  = exp(S - lse), dP = dO V^T, dS = P o (dP - D)
//   dV = sum over the group's heads of P^T dO, dK = ... dS^T Q
//                                            flash_bwd_dkdv_kernel
//   dQ = dS K                                flash_bwd_dq_kernel
//
// Every product runs on mma.sync m16n8k16 (fk_mma.cuh) on bf16 or fp16
// operands with f32 accumulation: S, dP and S^T, dP^T from the inputs, and
// P (for dV) and dS (for dK and dQ) rounded to the input type first, as
// the forward rounds P before P V. Accumulators stay in f32 registers and
// are rounded once, at the end, to the input type.
//
//   * flash_bwd_prep_kernel<T>: one warp a query row, D in f32.
//   * flash_bwd_dkdv_kernel<T, HD>: one block of four warps per (batch, KV
//     head, tile of 64 keys); warp w owns keys 16 w .. 16 w + 15 and their
//     dK and dV rows (2 x HD / 2 f32 a thread). K and V are staged once;
//     the block walks the group's query heads for every query tile of 64
//     rows that the tile rule (fk_attention.cu's header: dead, live, fully
//     live, from the positions' bounds) does not call dead, Q, dO, lse and
//     D of the next (tile, head) on a two-stage cp.async ring while it
//     computes this one, in halves of 32 query rows (S^T and dP^T, 16 f32
//     a thread each). Every dK / dV element has one owner thread and a
//     fixed walk: no atomics, two launches give the same bits.
//   * flash_bwd_dq_kernel<T, HD>: one block of four warps per (batch,
//     query head, tile of 64 query rows); warp w owns rows 16 w ..
//     16 w + 15 and their dQ (HD / 2 f32 a thread). Q and dO are staged
//     once; the live KV tiles of 64 keys come through a two-stage cp.async
//     ring; S and dP are 32 f32 a thread each.
//
// Shared tiles keep rows padded by 16 bytes (HD + 8 values), so the
// ldmatrix row addresses of a warp fall in distinct banks. Fully live
// tiles skip the per-score mask; keys past Skv are zero rows whose P is
// forced to 0 (dQ) or whose dK / dV rows are never written (dK, dV); query
// rows past Sq are zero rows with lse = +inf, so their P is 0.
//
// Bound on the H100: per (query, valid key) pair and query head, 8 HD FLOPs
// in the dK / dV kernel (S^T, dP^T, dV, dK) and 6 HD in the dQ kernel (S,
// dP, dQ), at 989 TFLOP/s; the prep kernel by its bytes (O and dO read, D
// written; 3.35 TB/s). This is the first, simple design: mma.sync with a
// cp.async ring, not wgmma with TMA.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (no --use_fast_math).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "fk_mma.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;       // four warps
constexpr int kBM = 64;             // query rows a tile
constexpr int kBN = 64;             // keys a tile
constexpr int kPad = 8;             // values of padding a shared row
constexpr int kMaxRows = 65535;     // a grid dimension

enum TileClass : int { kDead = 0, kLive = 1, kFull = 2 };

// element strides of the operands, (batch, head, sequence) each, passed by
// value: (q, k, v, dO, dK, dV) to the dK / dV kernel, (q, k, v, dO, dQ) to
// the dQ kernel
struct Strides {
  long long v[18];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 matrices of 2-byte values, each delivered transposed
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

// 2^x on the SFU, as the forward's (ex2.approx.ftz: -inf gives +0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

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

// rows [row0, row0 + 64) of a (rows, HD) operand with row stride ss into a
// shared tile of HD + kPad values a row; rows at or past n are zeros
template <typename T, int HD>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src,
                                           long long ss, int row0, int n) {
  constexpr int CH = HD / 8;        // 16-byte chunks a row
  for (int idx = threadIdx.x; idx < 64 * CH; idx += kThreads) {
    const int r = idx / CH, c = idx - (idx / CH) * CH;
    const bool ok = row0 + r < n;
    cp_async16(dst + r * (HD + kPad) + c * 8,
               ok ? src + (long long)(row0 + r) * ss + c * 8 : src, ok);
  }
}

// the A fragment (16 x 16) of rows r0.., columns c0.. of a padded tile
template <int LD, typename T>
__device__ __forceinline__ void frag_a(uint32_t* a, const T* tile, int r0,
                                       int c0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(a, tile + (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8);
}

// B fragments of two n8 tiles (n0.., n0 + 8..) x k16 (k0..) of a tile
// stored [n][k] (k contiguous): b[0], b[1] n-tile 0, b[2], b[3] n-tile 1
template <int LD, typename T>
__device__ __forceinline__ void frag_b_nk(uint32_t* b, const T* tile, int n0,
                                          int k0) {
  const int lane = threadIdx.x & 31, i = lane >> 3;
  ldmatrix_x4(b, tile + (n0 + (lane & 7) + (i >> 1) * 8) * LD + k0
                     + (i & 1) * 8);
}

// the same from a tile stored [k][n] (n contiguous), transposed on load
template <int LD, typename T>
__device__ __forceinline__ void frag_b_kn(uint32_t* b, const T* tile, int k0,
                                          int n0) {
  const int lane = threadIdx.x & 31, i = lane >> 3;
  ldmatrix_x4_trans(b, tile + (k0 + (lane & 7) + (i & 1) * 8) * LD + n0
                           + (i >> 1) * 8);
}

// --- D = rowsum(dO o O) ------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_prep_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                      float* __restrict__ dsum, int H, int Sq, int hd,
                      long long osb, long long osh, long long oss,
                      long long dsb, long long dsh, long long dss) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * 8 + warp;
  if (i >= Sq) return;
  const int b = blockIdx.y / H, h = blockIdx.y - (blockIdx.y / H) * H;
  const T* orow = o + b * osb + h * osh + i * oss;
  const T* drow = dout + b * dsb + h * dsh + i * dss;
  float acc = 0.0f;
  for (int d = 2 * lane; d < hd; d += 64) {
    acc = fmaf(to_f32(orow[d]), to_f32(drow[d]), acc);
    acc = fmaf(to_f32(orow[d + 1]), to_f32(drow[d + 1]), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dsum[(long long)blockIdx.y * Sq + i] = acc;
}

// --- dK, dV --------------------------------------------------------------

template <int HD>
struct KvShape {
  static constexpr int ld = HD + kPad;
  static constexpr int tile = kBM * ld;              // values of one tile
  // K, V, then two stages of (Q, dO), then two of (lse, D, qpos)
  static constexpr size_t bytes = size_t(6) * tile * 2 + 2 * 3 * kBM * 4;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ dsum,
                      const int* __restrict__ qpos,
                      const int* __restrict__ kpos, T* __restrict__ dk,
                      T* __restrict__ dv, int H, int KV, int Sq, int Skv,
                      const Strides st, int causal, int window) {
  using W = KvShape<HD>;
  constexpr int LD = W::ld;
  constexpr int DT = HD / 8;                         // n8 tiles of HD
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + W::tile;
  T* Qs = Vs + W::tile;                              // [2] stages
  T* Ds = Qs + 2 * W::tile;                          // dO, [2] stages
  float* ls = reinterpret_cast<float*>(Ds + 2 * W::tile);   // [2][kBM]
  float* dd = ls + 2 * kBM;                                 // [2][kBM]
  int* qps = reinterpret_cast<int*>(dd + 2 * kBM);          // [2][kBM]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int b = blockIdx.x / KV, kvh = blockIdx.x - (blockIdx.x / KV) * KV;
  const int group = H / KV;
  const int k0 = blockIdx.y * kBN;
  // strides (elements): q, k, v, dO, dk, dv x (batch, head, sequence)
  const long long qsb = st.v[0], qsh = st.v[1], qss = st.v[2];
  const long long ksb = st.v[3], ksh = st.v[4], kss = st.v[5];
  const long long vsb = st.v[6], vsh = st.v[7], vss = st.v[8];
  const long long gsb = st.v[9], gsh = st.v[10], gss = st.v[11];
  const long long dksb = st.v[12], dksh = st.v[13], dkss = st.v[14];
  const long long dvsb = st.v[15], dvsh = st.v[16], dvss = st.v[17];

  int kmin, kmax, kcnt;
  key_bounds(kpos, k0, kBN, Skv, kmin, kmax, kcnt);
  const int nqt = (Sq + kBM - 1) / kBM;
  // the first live query tile at or after qt, nqt if none
  auto next_tile = [&](int qt) {
    for (; qt < nqt; ++qt) {
      int qmin, qmax;
      query_bounds(qpos, qt * kBM, min(kBM, Sq - qt * kBM), qmin, qmax);
      if (pair_class(qmin, qmax, kmin, kmax, kcnt, kBN, causal, window) !=
          kDead)
        return qt;
    }
    return nqt;
  };
  auto tile_cls = [&](int qt) {
    int qmin, qmax;
    query_bounds(qpos, qt * kBM, min(kBM, Sq - qt * kBM), qmin, qmax);
    return pair_class(qmin, qmax, kmin, kmax, kcnt, kBN, causal, window);
  };
  // stage (query tile qt, head j of the group) into stage s
  auto stage = [&](int qt, int j, int s) {
    const int h = kvh * group + j;
    const int q0 = qt * kBM;
    stage_rows<T, HD>(Qs + s * W::tile, q + b * qsb + h * qsh, qss, q0, Sq);
    stage_rows<T, HD>(Ds + s * W::tile, dout + b * gsb + h * gsh, gss, q0,
                      Sq);
    if (tid < kBM) {
      const int i = q0 + tid;
      const long long row = ((long long)b * H + h) * Sq + i;
      ls[s * kBM + tid] = i < Sq ? lse[row] : INFINITY;
      dd[s * kBM + tid] = i < Sq ? dsum[row] : 0.0f;
      qps[s * kBM + tid] = i < Sq ? qpos[i] : 0;
    }
  };

  int qt = next_tile(0);
  stage_rows<T, HD>(Ks, k + b * ksb + kvh * ksh, kss, k0, Skv);
  stage_rows<T, HD>(Vs, v + b * vsb + kvh * vsh, vss, k0, Skv);
  if (qt < nqt) stage(qt, 0, 0);
  cp_commit();

  // this thread's keys: rows g and g + 8 of the warp's 16
  const int kr0 = 16 * warp + g;
  int kp[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + kr0 + 8 * r;
    kp[r] = key < Skv ? __ldg(kpos + key) : -1;
  }
  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.0f;

  int j = 0, s = 0;
  while (qt < nqt) {
    const int cls = tile_cls(qt);
    // the next (tile, head) into the other stage
    int nqt_next = qt, nj = j + 1;
    if (nj == group) {
      nj = 0;
      nqt_next = next_tile(qt + 1);
    }
    if (nqt_next < nqt) stage(nqt_next, nj, s ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();

    const T* Qt = Qs + s * W::tile;
    const T* Dt = Ds + s * W::tile;
    const float* lt = ls + s * kBM;
    const float* dt = dd + s * kBM;
    const int* qpt = qps + s * kBM;
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const int c0 = 32 * half;                      // query columns
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 32 queries
      float sa[4][4], pa[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sa[n][e] = pa[n][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t ak[4], av[4];
        frag_a<LD>(ak, Ks, 16 * warp, kk * 16);
        frag_a<LD>(av, Vs, 16 * warp, kk * 16);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bq[4], bd[4];
          frag_b_nk<LD>(bq, Qt, c0 + np * 16, kk * 16);
          frag_b_nk<LD>(bd, Dt, c0 + np * 16, kk * 16);
          mma_16816<T>(sa[2 * np], ak, bq[0], bq[1]);
          mma_16816<T>(sa[2 * np + 1], ak, bq[2], bq[3]);
          mma_16816<T>(pa[2 * np], av, bd[0], bd[1]);
          mma_16816<T>(pa[2 * np + 1], av, bd[2], bd[3]);
        }
      }
      // P^T = exp(S^T - lse) on the valid pairs, dS^T = P^T o (dP^T - D)
      uint32_t pp[2][4], ds[2][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        float p[4], d[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + n * 8 + 2 * tig + (e & 1);
          float x = fast_exp2((sa[n][e] - lt[col]) * kLog2e);
          if (cls == kLive && !key_valid(kp[e >> 1], qpt[col], causal, window))
            x = 0.0f;
          p[e] = x;
          d[e] = x * (pa[n][e] - dt[col]);
        }
        // the C fragments of n-tiles 2 m, 2 m + 1 are the A fragment of
        // k-step m
        const int m = n >> 1, hi = (n & 1) * 2;
        pp[m][hi] = pack2<T>(p[0], p[1]);
        pp[m][hi + 1] = pack2<T>(p[2], p[3]);
        ds[m][hi] = pack2<T>(d[0], d[1]);
        ds[m][hi + 1] = pack2<T>(d[2], d[3]);
      }
      // dV += P^T dO, dK += dS^T Q over the 32 queries
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const uint32_t ap[4] = {pp[m][0], pp[m][1], pp[m][2], pp[m][3]};
        const uint32_t as[4] = {ds[m][0], ds[m][1], ds[m][2], ds[m][3]};
#pragma unroll
        for (int np = 0; np < DT / 2; ++np) {
          uint32_t bd[4], bq[4];
          frag_b_kn<LD>(bd, Dt, c0 + m * 16, np * 16);
          frag_b_kn<LD>(bq, Qt, c0 + m * 16, np * 16);
          mma_16816<T>(dva[2 * np], ap, bd[0], bd[1]);
          mma_16816<T>(dva[2 * np + 1], ap, bd[2], bd[3]);
          mma_16816<T>(dka[2 * np], as, bq[0], bq[1]);
          mma_16816<T>(dka[2 * np + 1], as, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();                 // stage s is free for the next copy
    qt = nqt_next;
    j = nj;
    s ^= 1;
  }
  cp_wait<0>();

  // the warp's 16 keys, rows g and g + 8, columns 8 n + 2 tig, + 1
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + kr0 + 8 * r;
    if (key >= Skv) continue;
    T* krow = dk + b * dksb + kvh * dksh + key * dkss + 2 * tig;
    T* vrow = dv + b * dvsb + kvh * dvsh + key * dvss + 2 * tig;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      *reinterpret_cast<uint32_t*>(krow + n * 8) =
          pack2<T>(dka[n][2 * r], dka[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(vrow + n * 8) =
          pack2<T>(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

// --- dQ ------------------------------------------------------------------

template <int HD>
struct QShape {
  static constexpr int ld = HD + kPad;
  static constexpr int tile = kBM * ld;
  // Q, dO, then two stages of (K, V)
  static constexpr size_t bytes = size_t(6) * tile * 2;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum,
                    const int* __restrict__ qpos, const int* __restrict__ kpos,
                    T* __restrict__ dq, int H, int KV, int Sq, int Skv,
                    const Strides st, int causal, int window) {
  using W = QShape<HD>;
  constexpr int LD = W::ld;
  constexpr int DT = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ds = Qs + W::tile;
  T* Ks = Ds + W::tile;                              // [2] stages of K, V
  T* Vs = Ks + 2 * W::tile;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int b = blockIdx.x / H, h = blockIdx.x - (blockIdx.x / H) * H;
  const int kvh = h / (H / KV);
  // the longest causal walks first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;
  const int nq = min(kBM, Sq - q0);
  const long long qsb = st.v[0], qsh = st.v[1], qss = st.v[2];
  const long long ksb = st.v[3], ksh = st.v[4], kss = st.v[5];
  const long long vsb = st.v[6], vsh = st.v[7], vss = st.v[8];
  const long long gsb = st.v[9], gsh = st.v[10], gss = st.v[11];
  const long long dqsb = st.v[12], dqsh = st.v[13], dqss = st.v[14];
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;

  int qmin, qmax;
  query_bounds(qpos, q0, nq, qmin, qmax);
  const int ntiles = (Skv + kBN - 1) / kBN;
  auto tile_cls = [&](int t) {
    int kmin, kmax, cnt;
    key_bounds(kpos, t * kBN, kBN, Skv, kmin, kmax, cnt);
    return pair_class(qmin, qmax, kmin, kmax, cnt, kBN, causal, window);
  };
  auto next_tile = [&](int t) {
    for (; t < ntiles; ++t)
      if (tile_cls(t) != kDead) return t;
    return ntiles;
  };

  stage_rows<T, HD>(Qs, q + b * qsb + h * qsh, qss, q0, Sq);
  stage_rows<T, HD>(Ds, dout + b * gsb + h * gsh, gss, q0, Sq);
  int t = next_tile(0);
  if (t < ntiles) {
    stage_rows<T, HD>(Ks, kb, kss, t * kBN, Skv);
    stage_rows<T, HD>(Vs, vb, vss, t * kBN, Skv);
  }
  cp_commit();

  // this thread's rows g and g + 8 of the warp's 16
  const int qr0 = 16 * warp + g;
  float lr[2], dr[2];
  int qp[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + qr0 + 8 * r;
    const long long row = ((long long)b * H + h) * Sq + i;
    lr[r] = i < Sq ? lse[row] : INFINITY;
    dr[r] = i < Sq ? dsum[row] : 0.0f;
    qp[r] = i < Sq ? qpos[i] : 0;
  }
  float dqa[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.0f;

  int s = 0;
  while (t < ntiles) {
    const int cls = tile_cls(t);
    const int k0 = t * kBN;
    const int tn = next_tile(t + 1);
    if (tn < ntiles) {
      stage_rows<T, HD>(Ks + (s ^ 1) * W::tile, kb, kss, tn * kBN, Skv);
      stage_rows<T, HD>(Vs + (s ^ 1) * W::tile, vb, vss, tn * kBN, Skv);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const T* Kt = Ks + s * W::tile;
    const T* Vt = Vs + s * W::tile;

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys
    float sa[8][4], pa[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sa[n][e] = pa[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t aq[4], ad[4];
      frag_a<LD>(aq, Qs, 16 * warp, kk * 16);
      frag_a<LD>(ad, Ds, 16 * warp, kk * 16);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4], bv[4];
        frag_b_nk<LD>(bk, Kt, np * 16, kk * 16);
        frag_b_nk<LD>(bv, Vt, np * 16, kk * 16);
        mma_16816<T>(sa[2 * np], aq, bk[0], bk[1]);
        mma_16816<T>(sa[2 * np + 1], aq, bk[2], bk[3]);
        mma_16816<T>(pa[2 * np], ad, bv[0], bv[1]);
        mma_16816<T>(pa[2 * np + 1], ad, bv[2], bv[3]);
      }
    }
    // dS = P o (dP - D), P = exp(S - lse) on the valid pairs
    uint32_t ds[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * tig + (e & 1);
        const int r = e >> 1;
        float x = fast_exp2((sa[n][e] - lr[r]) * kLog2e);
        if (cls == kLive &&
            (key >= Skv || !key_valid(__ldg(kpos + key), qp[r], causal,
                                      window)))
          x = 0.0f;
        d[e] = x * (pa[n][e] - dr[r]);
      }
      const int m = n >> 1, hi = (n & 1) * 2;
      ds[m][hi] = pack2<T>(d[0], d[1]);
      ds[m][hi + 1] = pack2<T>(d[2], d[3]);
    }
    // dQ += dS K over the 64 keys
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const uint32_t as[4] = {ds[m][0], ds[m][1], ds[m][2], ds[m][3]};
#pragma unroll
      for (int np = 0; np < DT / 2; ++np) {
        uint32_t bk[4];
        frag_b_kn<LD>(bk, Kt, m * 16, np * 16);
        mma_16816<T>(dqa[2 * np], as, bk[0], bk[1]);
        mma_16816<T>(dqa[2 * np + 1], as, bk[2], bk[3]);
      }
    }
    __syncthreads();
    t = tn;
    s ^= 1;
  }
  cp_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + qr0 + 8 * r;
    if (i >= Sq) continue;
    T* row = dq + b * dqsb + h * dqsh + i * dqss + 2 * tig;
#pragma unroll
    for (int n = 0; n < DT; ++n)
      *reinterpret_cast<uint32_t*>(row + n * 8) =
          pack2<T>(dqa[n][2 * r], dqa[n][2 * r + 1]);
  }
}

// --- launches --------------------------------------------------------------

template <typename K>
cudaError_t smem_attr(K kern, size_t bytes) {
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

bool bad_shape(int B, int H, int KV, int Sq, int Skv, int hd, int dtype) {
  return B < 1 || H < 1 || KV < 1 || H % KV || Sq < 1 || Skv < 1 ||
         (hd != 64 && hd != 128) || (dtype != 1 && dtype != 2);
}

template <typename T>
int prep(const void* o, const void* dout, float* dsum, int B, int H, int Sq,
         int hd, const long long* st, cudaStream_t s) {
  const dim3 grid((Sq + 7) / 8, B * H);
  if (B * H > kMaxRows) return int(cudaErrorInvalidValue);
  flash_bwd_prep_kernel<T><<<grid, 256, 0, s>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), dsum, H, Sq, hd,
      st[0], st[1], st[2], st[3], st[4], st[5]);
  return int(cudaGetLastError());
}

template <typename T, int HD>
int dkdv(const void* q, const void* k, const void* v, const void* dout,
         const float* lse, const float* dsum, const int* qpos,
         const int* kpos, void* dk, void* dv, int B, int H, int KV, int Sq,
         int Skv, const Strides& st, int causal, int window,
         cudaStream_t s) {
  auto kern = flash_bwd_dkdv_kernel<T, HD>;
  cudaError_t e = smem_attr(kern, KvShape<HD>::bytes);
  if (e != cudaSuccess) return int(e);
  const int nkt = (Skv + kBN - 1) / kBN;
  if (nkt > 65535 || B * KV > kMaxRows) return int(cudaErrorInvalidValue);
  kern<<<dim3(B * KV, nkt), kThreads, KvShape<HD>::bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dsum, qpos,
      kpos, static_cast<T*>(dk), static_cast<T*>(dv), H, KV, Sq, Skv, st,
      causal, window);
  return int(cudaGetLastError());
}

template <typename T, int HD>
int dq_launch(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* dsum, const int* qpos,
              const int* kpos, void* dq, int B, int H, int KV, int Sq,
              int Skv, const Strides& st, int causal, int window,
              cudaStream_t s) {
  auto kern = flash_bwd_dq_kernel<T, HD>;
  cudaError_t e = smem_attr(kern, QShape<HD>::bytes);
  if (e != cudaSuccess) return int(e);
  const int nqt = (Sq + kBM - 1) / kBM;
  if (nqt > 65535 || B * H > kMaxRows) return int(cudaErrorInvalidValue);
  kern<<<dim3(B * H, nqt), kThreads, QShape<HD>::bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dsum, qpos,
      kpos, static_cast<T*>(dq), H, KV, Sq, Skv, st, causal, window);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// D = rowsum(dO o O) in f32, (B, H, Sq) contiguous. o and dout: bf16
// (dtype 1) or fp16 (dtype 2), (batch, head, sequence) element strides in
// st[0..2] (o) and st[3..5] (dout), the head dim contiguous.
int fk_flash_bwd_prep(const void* o, const void* dout, float* dsum, int B,
                      int H, int Sq, int hd, const long long* st, int dtype,
                      void* stream) {
  if (bad_shape(B, H, H, Sq, 1, hd, dtype)) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? prep<__nv_bfloat16>(o, dout, dsum, B, H, Sq, hd, st, s)
                    : prep<__half>(o, dout, dsum, B, H, Sq, hd, st, s);
}

// dK and dV (B, KV, Skv, hd) of q (B, H, Sq, hd), k, v (B, KV, Skv, hd) and
// dout (B, H, Sq, hd), from lse and D (B, H, Sq) f32 contiguous. strides:
// 18 element strides, (q, k, v, dout, dk, dv) x (batch, head, sequence),
// each row 16-byte aligned, the head dim contiguous.
int fk_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* dsum,
                      const int* qpos, const int* kpos, void* dk, void* dv,
                      int B, int H, int KV, int Sq, int Skv, int hd,
                      const long long* strides, int causal, int window,
                      int dtype, void* stream) {
  if (bad_shape(B, H, KV, Sq, Skv, hd, dtype) || window < 0)
    return int(cudaErrorInvalidValue);
  Strides st;
  for (int i = 0; i < 18; ++i) st.v[i] = strides[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return hd == 64 ? dkdv<__nv_bfloat16, 64>(q, k, v, dout, lse, dsum, qpos,
                                              kpos, dk, dv, B, H, KV, Sq,
                                              Skv, st, causal, window, s)
                    : dkdv<__nv_bfloat16, 128>(q, k, v, dout, lse, dsum,
                                               qpos, kpos, dk, dv, B, H, KV,
                                               Sq, Skv, st, causal, window,
                                               s);
  return hd == 64 ? dkdv<__half, 64>(q, k, v, dout, lse, dsum, qpos, kpos,
                                     dk, dv, B, H, KV, Sq, Skv, st, causal,
                                     window, s)
                  : dkdv<__half, 128>(q, k, v, dout, lse, dsum, qpos, kpos,
                                      dk, dv, B, H, KV, Sq, Skv, st, causal,
                                      window, s);
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
  Strides st;
  for (int i = 0; i < 15; ++i) st.v[i] = strides[i];
  st.v[15] = st.v[16] = st.v[17] = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return hd == 64 ? dq_launch<__nv_bfloat16, 64>(q, k, v, dout, lse, dsum,
                                                   qpos, kpos, dq, B, H, KV,
                                                   Sq, Skv, st, causal,
                                                   window, s)
                    : dq_launch<__nv_bfloat16, 128>(q, k, v, dout, lse, dsum,
                                                    qpos, kpos, dq, B, H, KV,
                                                    Sq, Skv, st, causal,
                                                    window, s);
  return hd == 64 ? dq_launch<__half, 64>(q, k, v, dout, lse, dsum, qpos,
                                          kpos, dq, B, H, KV, Sq, Skv, st,
                                          causal, window, s)
                  : dq_launch<__half, 128>(q, k, v, dout, lse, dsum, qpos,
                                           kpos, dq, B, H, KV, Sq, Skv, st,
                                           causal, window, s);
}

const char* fk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
