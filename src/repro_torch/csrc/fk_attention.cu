// Hand-written Hopper (sm_90a) flash attention for the port's LM stack.
//
// flash_mma_kernel<T, HD> and flash_kernel<T, HD, RI> replace the Pallas TPU
// kernel flash_attention of src/repro/kernels/flash_attention.py (body
// _kernel): online-softmax GQA
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
// is a finite product, far above -1e30), so no mask is kept for it.
//
// Design (right and simple first). One thread block per (batch * head,
// query tile) walks the KV tiles of 64 keys in a loop: the loop replaces the
// TPU grid's sequential kv axis, and the running max, denominator and the
// f32 accumulator stay in registers across it. Keys past Skv do not exist
// (p = 0, staged K/V rows zero), so ragged Sq and Skv need no padding copy;
// query rows past Sq are not written. q, k, v and out are addressed by
// (batch, head, sequence) element strides with a contiguous head dim, so
// (B, S, H, hd) tensors are read and written in place through transposed
// views. Every tile is visited and masked, as the Pallas grid does (no
// causal skip): a fully masked row keeps the reference kernel's result.
// Two kernels share that walk:
//
//   * flash_mma_kernel<T, HD> (T bf16 or fp16, 64-row query tiles, hd 64 or
//     128: the prefill launch): the products on the tensor cores with
//     mma.sync m16n8k16 and f32 accumulation (below);
//   * flash_kernel<T, HD, RI> (f32 at every tile and hd; bf16 / fp16 decode
//     launches, 16-row tiles, and bf16 / fp16 at hd 256): the products as
//     f32 FMAs on the CUDA cores. The query tile (once) and each K and V
//     tile are staged in shared memory as f32 (2-byte values widened
//     exactly), rows padded by 4 words so the 16-byte reads of the score
//     loop hit distinct banks.
//     Thread (ty, tx) = (tid / 16, tid % 16) owns query rows ty * RI + i
//     and, for the scores, keys tx + 16 j (j < 4): S = Q K^T with a (RI x 4)
//     register tile; the row max and row sum of the online softmax are
//     butterflies over the 16 lanes that share ty. p (rounded to T) goes
//     through shared memory to P V, where the thread owns columns
//     c * 64 + tx * 4 + e of its rows. RI = 1 (16-row tiles) when
//     Sq <= 16, e.g. a decode launch, else RI = 4 (64-row tiles).
//
// The entry point picks the kernel and tile from Sq, the dtype and hd
// alone. 2-byte decode stays on the CUDA-core kernel: the tensor-core one
// would spend a 64-row tile (4 warps, 128 threads) on the one query row
// and stage the same K/V bytes with half the threads. chip_smoke.py phase
// 11 times it on a decode's K/V (Sq = 17) beside this kernel at Sq = 1.
//
// Bound on the H100: at prefill the 4 * B * H * Sq * Skv * hd FLOPs of the
// two products (bf16 / fp16 tensor cores, 989 TFLOP/s); at decode (Sq = 1)
// the bytes of the KV cache, read once per launch (3.35 TB/s). Neither kernel
// pipelines its loads (no cp.async / TMA), the decode launch has one block
// per (batch, head) and re-reads each KV tile once per query head of a
// group; wgmma tiles, TMA staging, a split KV walk for decode, GQA packing
// and a causal tile skip are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (no --use_fast_math: expf and the final division stay accurate).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

#include "fk_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 64;            // keys per KV tile
constexpr float kNeg = -1e30f;     // the reference kernel's NEG
constexpr int kMaxRows = 65535;    // gridDim.y: one (batch, head) per row

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;      // 16 bytes
  __device__ static void load(const float* p, float* o) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
  __device__ static float round(float x) { return x; }
  __device__ static void store4(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;      // 16 bytes
  __device__ static void load(const __nv_bfloat16* p, float* o) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  __device__ static void store4(__nv_bfloat16* p, const float* v) {
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(p);
    h[0] = __floats2bfloat162_rn(v[0], v[1]);
    h[1] = __floats2bfloat162_rn(v[2], v[3]);
  }
};

template <>
struct Vec<__half> {
  static constexpr int N = 8;      // 16 bytes
  __device__ static void load(const __half* p, float* o) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __half2* h = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
  __device__ static float round(float x) {
    return __half2float(__float2half_rn(x));
  }
  __device__ static void store4(__half* p, const float* v) {
    __half2* h = reinterpret_cast<__half2*>(p);
    h[0] = __floats2half2_rn(v[0], v[1]);
    h[1] = __floats2half2_rn(v[2], v[3]);
  }
};

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

// Shared memory of one block, in 4-byte words: Q (BQ x LD), K and V
// (kBK x LD) as f32, P (BQ x (kBK + 1)) and the tile's key positions.
template <int HD, int RI>
struct Smem {
  static constexpr int BQ = 16 * RI;
  static constexpr int LD = HD + 4;
  static constexpr int PLD = kBK + 1;
  static constexpr int q = 0;
  static constexpr int k = q + BQ * LD;
  static constexpr int v = k + kBK * LD;
  static constexpr int p = v + kBK * LD;
  static constexpr int kpos = p + BQ * PLD;
  static constexpr int words = kpos + kBK;
  static constexpr size_t bytes = size_t(words) * 4;
};

// rows x HD elements of T starting at row0 (row stride `rs` elements) into
// shared f32 rows of LD words; rows at or past `nrows` are zero.
template <typename T, int HD, int LD>
__device__ __forceinline__ void stage(float* dst, const T* src, long long rs,
                                      int row0, int nrows, int rows) {
  constexpr int V = Vec<T>::N;
  constexpr int per_row = HD / V;
  for (int idx = threadIdx.x; idx < rows * per_row; idx += kThreads) {
    const int r = idx / per_row;
    const int d = (idx - r * per_row) * V;
    float vals[V];
    if (row0 + r < nrows) {
      Vec<T>::load(src + (row0 + r) * rs + d, vals);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) vals[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < V; e += 4)
      *reinterpret_cast<float4*>(dst + r * LD + d + e) =
          make_float4(vals[e], vals[e + 1], vals[e + 2], vals[e + 3]);
  }
}

template <typename T, int HD, int RI>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ qpos,
             const int* __restrict__ kpos, T* __restrict__ out, int H,
             int group, int Sq, int Skv, long long qsb, long long qsh,
             long long qss, long long ksb, long long ksh, long long kss,
             long long vsb, long long vsh, long long vss, long long osb,
             long long osh, long long oss, int causal, int window,
             int zero_empty) {
  using S = Smem<HD, RI>;
  constexpr int NC = HD / 64;        // 64-column groups of the output
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem + S::q;
  float* Ks = smem + S::k;
  float* Vs = smem + S::v;
  float* Ps = smem + S::p;
  int* Kp = reinterpret_cast<int*>(smem + S::kpos);

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int kvh = h / group;
  const int q0 = blockIdx.x * S::BQ;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;

  stage<T, HD, S::LD>(Qs, qb + q0 * qss, qss, 0, Sq - q0, S::BQ);

  int qp[RI];
  float m[RI], l[RI], acc[RI][NC][4];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + ty * RI + i;
    qp[i] = qi < Sq ? qpos[qi] : 0;
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.0f;
  }

  for (int k0 = 0; k0 < Skv; k0 += kBK) {
    __syncthreads();   // the previous tile's readers are done
    stage<T, HD, S::LD>(Ks, kb + k0 * kss, kss, 0, Skv - k0, kBK);
    stage<T, HD, S::LD>(Vs, vb + k0 * vss, vss, 0, Skv - k0, kBK);
    if (tid < kBK) Kp[tid] = k0 + tid < Skv ? kpos[k0 + tid] : 0;
    __syncthreads();

    // S = Q K^T for rows ty * RI + i, keys tx + 16 j
    float s[RI][4];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 a[RI], bk[4];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        a[i] = *reinterpret_cast<const float4*>(Qs + (ty * RI + i) * S::LD
                                                + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bk[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * S::LD
                                                 + d);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, bk[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, bk[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, bk[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, bk[j].w, s[i][j]);
        }
    }

    // mask, online softmax (the row's 16 lanes share ty), P to shared memory
    float sc[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      float mx = kNeg;
      bool ex[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kp = Kp[c];
        ex[j] = k0 + c < Skv;
        bool valid = ex[j] && kp >= 0;
        if (causal) valid = valid && kp <= qp[i];
        if (window)
          valid = valid && (long long)kp > (long long)qp[i] - window;
        s[i][j] = valid ? s[i][j] : kNeg;
        if (ex[j]) mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ex[j] ? expf(s[i][j] - m_new) : 0.0f;
        psum += p;
        Ps[(ty * RI + i) * S::PLD + tx + 16 * j] = Vec<T>::round(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      sc[i] = expf(m[i] - m_new);
      l[i] = l[i] * sc[i] + psum;
      m[i] = m_new;
    }
    __syncthreads();

    // acc = acc * scale + P V for rows ty * RI + i, columns c*64 + tx*4 + e
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= sc[i];
#pragma unroll 4
    for (int jj = 0; jj < kBK; ++jj) {
      float a[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) a[i] = Ps[(ty * RI + i) * S::PLD + jj];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 bv = *reinterpret_cast<const float4*>(
            Vs + jj * S::LD + c * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          acc[i][c][0] = fmaf(a[i], bv.x, acc[i][c][0]);
          acc[i][c][1] = fmaf(a[i], bv.y, acc[i][c][1]);
          acc[i][c][2] = fmaf(a[i], bv.z, acc[i][c][2]);
          acc[i][c][3] = fmaf(a[i], bv.w, acc[i][c][3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + ty * RI + i;
    if (qi >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    const bool zero = zero_empty && m[i] == kNeg;
    T* orow = out + b * osb + h * osh + qi * oss;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = zero ? 0.0f : acc[i][c][e] / den;
      Vec<T>::store4(orow + c * 64 + tx * 4, o);
    }
  }
}

// --- bf16 / fp16 on the tensor cores: mma.sync m16n8k16, f32 accumulation -
//
// flash_mma_kernel<T, HD>: the same function for T = bf16 or fp16 at 64-row
// query tiles and HD <= 128. Four warps per block, each owning 16 query
// rows: S = Q K^T is 8 (keys) x HD/16 (depth) mma.sync per KV tile with Q's
// fragments held in registers for the whole walk; the online softmax runs on
// the S fragments (a row's values live in the 4 lanes of a quad: butterflies
// over xor 1, 2);
// p, rounded to T as the reference's p.astype(v.dtype), is repacked in
// registers as the A operand of O += P V (HD/8 x 4 mma.sync per tile). K is
// staged in shared memory as it is (row-major), V transposed, so every
// fragment is one 32-bit shared load; rows are padded by 16 bytes so a
// quad's loads hit distinct banks.
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaBQ = 16 * kMmaWarps;

template <int HD>
struct MmaSmem {
  static constexpr int LD = HD + 8;       // 2-byte elements per Q / K row
  static constexpr int VLD = kBK + 8;     // per transposed V row
  static constexpr int q = 0;             // offsets in 2-byte elements
  static constexpr int k = q + kMmaBQ * LD;
  static constexpr int v = k + kBK * LD;
  static constexpr int kpos_bytes = 2 * (v + HD * VLD);
  static constexpr size_t bytes = size_t(kpos_bytes) + 4 * kBK;
};

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const typename Pair<T>::type h = Pair<T>::make(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// rows x HD 2-byte elements from row0 (row stride rs) into shared rows of
// LD elements, as they are; rows at or past nrows are zero.
template <typename T, int HD, int LD>
__device__ __forceinline__ void stage_2byte(unsigned short* dst,
                                            const T* src, long long rs,
                                            int nrows, int rows) {
  constexpr int per_row = HD / 8;
  for (int idx = threadIdx.x; idx < rows * per_row; idx += kMmaThreads) {
    const int r = idx / per_row;
    const int d = (idx - r * per_row) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < nrows) val = *reinterpret_cast<const uint4*>(src + r * rs + d);
    *reinterpret_cast<uint4*>(dst + r * LD + d) = val;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ qpos,
                 const int* __restrict__ kpos, T* __restrict__ out, int H,
                 int group, int Sq,
                 int Skv, long long qsb, long long qsh, long long qss,
                 long long ksb, long long ksh, long long kss, long long vsb,
                 long long vsh, long long vss, long long osb, long long osh,
                 long long oss, int causal, int window, int zero_empty) {
  using S = MmaSmem<HD>;
  constexpr int KD = HD / 16;     // depth steps of S = Q K^T
  constexpr int DT = HD / 8;      // 8-wide output column tiles
  constexpr int NT = kBK / 8;     // 8-key column tiles of S
  extern __shared__ __align__(16) unsigned short sm16[];
  unsigned short* Qs = sm16 + S::q;
  unsigned short* Ks = sm16 + S::k;
  unsigned short* Vt = sm16 + S::v;
  int* Kp = reinterpret_cast<int*>(reinterpret_cast<char*>(sm16)
                                   + S::kpos_bytes);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int kvh = h / group;
  const int q0 = blockIdx.x * kMmaBQ;
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;

  stage_2byte<T, HD, S::LD>(Qs, q + b * qsb + h * qsh + q0 * qss, qss, Sq - q0,
                        kMmaBQ);
  __syncthreads();
  // this warp's Q fragments, rows warp*16 + g (+8), for the whole walk
  uint32_t aq[KD][4];
  const unsigned short* qr = Qs + (warp * 16 + g) * S::LD + tig * 2;
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    aq[kk][0] = ld32(qr + kk * 16);
    aq[kk][1] = ld32(qr + 8 * S::LD + kk * 16);
    aq[kk][2] = ld32(qr + kk * 16 + 8);
    aq[kk][3] = ld32(qr + 8 * S::LD + kk * 16 + 8);
  }
  int qp[2];
  float m[2], l[2], o[DT][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + warp * 16 + g + 8 * r;
    qp[r] = qi < Sq ? qpos[qi] : 0;
    m[r] = kNeg;
    l[r] = 0.0f;
  }
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.0f;

  for (int k0 = 0; k0 < Skv; k0 += kBK) {
    __syncthreads();   // the previous tile's readers are done
    stage_2byte<T, HD, S::LD>(Ks, kb + k0 * kss, kss, Skv - k0, kBK);
    // V transposed: lanes take consecutive keys, so the 2-byte stores of
    // a warp fill consecutive words
    for (int idx = tid; idx < kBK * (HD / 8); idx += kMmaThreads) {
      const int j = idx % kBK;
      const int d = (idx / kBK) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + j < Skv)
        val = *reinterpret_cast<const uint4*>(vb + (k0 + j) * vss + d);
      const unsigned short* e = reinterpret_cast<const unsigned short*>(&val);
#pragma unroll
      for (int t = 0; t < 8; ++t) Vt[(d + t) * S::VLD + j] = e[t];
    }
    if (tid < kBK) Kp[tid] = k0 + tid < Skv ? kpos[k0 + tid] : 0;
    __syncthreads();

    // S = Q K^T: this warp's 16 rows x 64 keys
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
      const unsigned short* kr = Ks + (nt * 8 + g) * S::LD + tig * 2;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        mma_16816<T>(s[nt], aq[kk], ld32(kr + kk * 16),
                     ld32(kr + kk * 16 + 8));
    }

    // mask and online softmax; s[nt][e] is row g + 8 (e / 2), key
    // nt * 8 + tig * 2 + e % 2
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + tig * 2 + (e & 1);
        const int r = e >> 1;
        const int kp = Kp[c];
        const bool ex = k0 + c < Skv;
        bool valid = ex && kp >= 0;
        if (causal) valid = valid && kp <= qp[r];
        if (window)
          valid = valid && (long long)kp > (long long)qp[r] - window;
        s[nt][e] = valid ? s[nt][e] : kNeg;
        if (ex) mx[r] = fmaxf(mx[r], s[nt][e]);
      }
    float sc[2], psum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      mx[r] = fmaxf(m[r], mx[r]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ex = k0 + nt * 8 + tig * 2 + (e & 1) < Skv;
        const float p = ex ? expf(s[nt][e] - mx[e >> 1]) : 0.0f;
        psum[e >> 1] += p;
        s[nt][e] = p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
      sc[r] = expf(m[r] - mx[r]);
      l[r] = l[r] * sc[r] + psum[r];
      m[r] = mx[r];
    }

    // O = O * scale + P V, P repacked from the S fragments
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      o[dt][0] *= sc[0];
      o[dt][1] *= sc[0];
      o[dt][2] *= sc[1];
      o[dt][3] *= sc[1];
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack2<T>(s[2 * kk][0], s[2 * kk][1]),
          pack2<T>(s[2 * kk][2], s[2 * kk][3]),
          pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const unsigned short* vr = Vt + (dt * 8 + g) * S::VLD + kk * 16
                                   + tig * 2;
        mma_16816<T>(o[dt], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + warp * 16 + g + 8 * r;
    if (qi >= Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    const bool zero = zero_empty && m[r] == kNeg;
    T* orow = out + b * osb + h * osh + qi * oss + tig * 2;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<typename Pair<T>::type*>(orow + dt * 8) =
          Pair<T>::make(zero ? 0.0f : o[dt][2 * r] / den,
                        zero ? 0.0f : o[dt][2 * r + 1] / den);
  }
}

template <typename T, int HD, int RI>
int launch(const void* q, const void* k, const void* v, const int* qpos,
           const int* kpos, void* out, int B, int H, int KV, int Sq, int Skv,
           const long long* st, int causal, int window, int zero_empty,
           cudaStream_t s) {
  using L = Smem<HD, RI>;
  auto kern = flash_kernel<T, HD, RI>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(L::bytes));
  if (e != cudaSuccess) return int(e);
  const dim3 grid((Sq + L::BQ - 1) / L::BQ, B * H);
  kern<<<grid, kThreads, L::bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), qpos, kpos, static_cast<T*>(out), H, H / KV,
      Sq, Skv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], causal, window, zero_empty);
  return int(cudaGetLastError());
}

template <typename T, int RI>
int by_hd(int hd, const void* q, const void* k, const void* v,
          const int* qpos, const int* kpos, void* out, int B, int H, int KV,
          int Sq, int Skv, const long long* st, int causal, int window,
          int zero_empty, cudaStream_t s) {
  switch (hd) {
    case 64:
      return launch<T, 64, RI>(q, k, v, qpos, kpos, out, B, H, KV, Sq, Skv,
                               st, causal, window, zero_empty, s);
    case 128:
      return launch<T, 128, RI>(q, k, v, qpos, kpos, out, B, H, KV, Sq, Skv,
                                st, causal, window, zero_empty, s);
    case 256:
      return launch<T, 256, RI>(q, k, v, qpos, kpos, out, B, H, KV, Sq, Skv,
                                st, causal, window, zero_empty, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

template <typename T, int HD>
int launch_mma(const void* q, const void* k, const void* v, const int* qpos,
               const int* kpos, void* out, int B, int H, int KV, int Sq,
               int Skv, const long long* st, int causal, int window,
               int zero_empty, cudaStream_t s) {
  using L = MmaSmem<HD>;
  auto kern = flash_mma_kernel<T, HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(L::bytes));
  if (e != cudaSuccess) return int(e);
  const dim3 grid((Sq + kMmaBQ - 1) / kMmaBQ, B * H);
  kern<<<grid, kMmaThreads, L::bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), qpos, kpos, static_cast<T*>(out), H, H / KV,
      Sq, Skv, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      causal, window, zero_empty);
  return int(cudaGetLastError());
}

// a 2-byte T: 16-row tiles of flash_kernel when Sq <= 16, else the
// tensor-core kernel at hd 64 and 128 and flash_kernel's 64-row tiles at 256
template <typename T>
int launch_2byte(int hd, bool small, const void* q, const void* k,
                 const void* v, const int* qpos, const int* kpos, void* out,
                 int B, int H, int KV, int Sq, int Skv, const long long* st,
                 int causal, int window, int zero_empty, cudaStream_t s) {
#define FK_ARGS q, k, v, qpos, kpos, out, B, H, KV, Sq, Skv, st, causal, \
                window, zero_empty, s
  if (small) return by_hd<T, 1>(hd, FK_ARGS);
  switch (hd) {
    case 64: return launch_mma<T, 64>(FK_ARGS);
    case 128: return launch_mma<T, 128>(FK_ARGS);
    case 256: return launch<T, 256, 4>(FK_ARGS);
    default: return int(cudaErrorInvalidValue);
  }
#undef FK_ARGS
}

}  // namespace

extern "C" {

// q, k, v, out: T = f32 (dtype 0), bf16 (dtype 1) or fp16 (dtype 2),
// addressed as base + b * s_b + head * s_h + pos * s_s + d with d
// contiguous; the 12 strides are (q, k, v, out) x (batch, head, sequence) in
// elements, each a multiple of 16 bytes. hd in {64, 128, 256}; H a multiple
// of KV. The tile follows from Sq, the dtype and hd: 16-row tiles of
// flash_kernel when Sq <= 16; else a 2-byte dtype at hd 64 or 128 on
// flash_mma_kernel (64-row tiles), and flash_kernel's 64-row tiles for the
// rest. zero_empty != 0 writes zero for a row with no valid key (else the
// mean of v, as the reference kernel).
int fk_flash_attention(const void* q, const void* k, const void* v,
                       const int* qpos, const int* kpos, void* out, int B,
                       int H, int KV, int Sq, int Skv, int hd, long long qsb,
                       long long qsh, long long qss, long long ksb,
                       long long ksh, long long kss, long long vsb,
                       long long vsh, long long vss, long long osb,
                       long long osh, long long oss, int causal, int window,
                       int zero_empty, int dtype, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV || Sq < 1 || Skv < 1 ||
      window < 0 || B * H > kMaxRows || dtype < 0 || dtype > 2)
    return int(cudaErrorInvalidValue);
  const long long st[12] = {qsb, qsh, qss, ksb, ksh, kss,
                            vsb, vsh, vss, osb, osh, oss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FK_ARGS q, k, v, qpos, kpos, out, B, H, KV, Sq, Skv, st, causal, \
                window, zero_empty, s
  const bool small = Sq <= 16;
  if (dtype == 1) return launch_2byte<__nv_bfloat16>(hd, small, FK_ARGS);
  if (dtype == 2) return launch_2byte<__half>(hd, small, FK_ARGS);
  return small ? by_hd<float, 1>(hd, FK_ARGS) : by_hd<float, 4>(hd, FK_ARGS);
#undef FK_ARGS
}

const char* fk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
