// Hand-written Hopper (sm_90a) kernels of the two-pass centroid update and
// of the fixed-order tree sum of per-tile partials.
//
// Replaces, on the card's path of ops.tiled_update, the dense update of the
// reference: _emit_update (src/repro/kernels/lloyd_step.py:162) over every
// row tile, which writes (num_m, kp, fp) partial sums, and _tree_sum
// (src/repro/kernels/ops.py:510, XLA code in the reference), which halves
// the tile axis log2(num_m) times. The results are the same bits.
//
// The order every contract rests on, the slots of the halving tree and the
// entries' layout: fk_entries.cuh.
//
// update_entries_kernel<T, BM> (one block of 128 threads per BM-row tile,
//   or one block for the one tile *tile): write_entries (fk_entries.cuh),
//   the writer the one-pass kernels' epilogue runs too:
//   * ranks the tile's valid rows by (cluster, row) with a bitonic sort of
//     BM keys in shared memory (emit_update ranks in O(BM^2));
//   * writes one entry per present cluster: row t * BM + j for the tile's
//     j-th present cluster holds its Fp sums (each one lane's f32 sum over
//     the cluster's rows in row order, from 0, as emit_update sums), its
//     count, and idx[k][slot(t)] = t * BM + j. The entries buffer is
//     (Mp, Fp) f32 (O(M Fp), never O(T Kp Fp)); only present rows are
//     written; idx (Kp, 2^L) int32 is -1 where a tile has no row of k.
//   * for one tile (the FT recompute of lloyd_step_ft's entries) it first
//     clears the tile's idx column, then writes the tile keyed, as the
//     one-pass FT kernel wrote it.
// verify_entries_kernel<BM> (one block of 128 threads per row tile): the
//   one-pass FT step's update verification over its keyed entries, in one
//   launch (ops._verify_update_entries; the rule is lloyd_step_ft.
//   update_mismatch, the plain version its entries_observed and
//   update_mismatch): a thread a feature sums the tile's BM entry rows in
//   row order, e1 and e2 (an entry row weighs its cluster + 1; the spare
//   row joins the tile it holds a fault of), and the block takes the
//   largest residuals and expected magnitudes, the counts' sums likewise,
//   in a fixed order. A tile over its thresholds adds one to verdict[0] and
//   raises verdict[1] to ntiles - t, so ntiles - verdict[1] is the first
//   mismatched tile (integer atomics: the same result in any order).
// tree_reduce_kernel<V, kDense> (one pass): blocks own (row r, V-wide
//   feature group, chunk of 2^c slots). The block lists its chunk's present
//   slots in slot order (sparse: idx[r][slot] >= 0; dense: a slot some tile
//   maps to), then each thread walks the list once, its V features in
//   registers, and combines them in the tree's exact order with a
//   shift-reduce stack (in shared memory, one entry a level): two neighbours
//   in slot order meet at level h = the highest bit in which their slots
//   differ, so the subtrees below h close, lowest first, before the new leaf
//   is pushed. A chunk is an aligned subtree: it writes its node (or +0.0 and
//   idx -1 when nothing in it is present), and the next pass reduces the
//   chunks' nodes as the leaves of a tree of 2^(L-c) slots, until one chunk
//   remains. A cluster that holds every tile is thus split at subtree
//   boundaries over many blocks. No atomics anywhere: the order is part of
//   the result.
//
// Bound on the H100 (bytes): the update reads X and the labels once and
// writes and reads the present entries once, ~1.55 GB at M = 2^20, F = 128,
// K = 1000 with rows in random order (~985k present (tile, cluster) pairs):
// 0.46 ms at 3.35 TB/s (0.38 ms with 2-byte X). The tree sum of dense
// partials reads them once: 4.33 GB, 1.29 ms, at the lloyd_step partials
// (it writes no intermediate level, where the torch tree moved ~21 GB).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (no --use_fast_math: adds stay IEEE round-to-nearest adds).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstddef>

#include "fk_abft.cuh"
#include "fk_entries.cuh"

namespace {

constexpr int kEntryThreads = 128;
constexpr int kVerifyThreads = 128;
constexpr int kTreeThreads = 128;         // most threads a tree block has
constexpr int kTreeMaxLevels = 8;         // a chunk holds at most 2^8 slots
constexpr int kTreeChunk = 1 << kTreeMaxLevels;
constexpr int kTreeBatches = kTreeChunk / 32;
constexpr int kTreePrefetch = 8;

// --- the per-tile pass ------------------------------------------------------

// Rows >= true_m and labels outside [0, kp) enter nothing (emit_update's
// rule). When gate is given the launch is a no-op while *gate == 0; when
// tile is given the block writes the one tile *tile, its idx column cleared
// first. ekey may be null (see EntryOut).
template <typename T, int BM>
__global__ void __launch_bounds__(kEntryThreads)
update_entries_kernel(const T* __restrict__ x, const int* __restrict__ argmin,
                      const int* __restrict__ tile,
                      const int* __restrict__ gate,
                      float* __restrict__ entries, float* __restrict__ ecnt,
                      int* __restrict__ idx, int* __restrict__ ekey, int kp,
                      int fp, int true_m, int ntiles, int levels) {
  __shared__ int es[EntryScratch<BM, kEntryThreads>::kInts];
  if (gate != nullptr && *gate == 0) return;
  const int t = tile != nullptr ? *tile : int(blockIdx.x);
  const int tid = threadIdx.x;
  const int label = tid < BM ? argmin[t * BM + tid] : -1;
  const EntryOut o{entries, ecnt, idx, ekey, kp, fp, levels, ntiles};
  write_entries<T, BM, kEntryThreads, false>(label, x, t, true_m, o,
                                             tile != nullptr, es, nullptr,
                                             nullptr, nullptr);
}

// --- the verification of the one-pass FT step's entries ---------------------

// entries (ntiles * BM + 1, fp) keyed (ekey, the spare row last), ecnt,
// spare = (tile, cluster) or -1; ucheck (ntiles, 2, fp), ccheck (ntiles, 2)
// the expected checksums; verdict (2,) int32, zeros from the caller.
template <int BM>
__global__ void __launch_bounds__(kVerifyThreads)
verify_entries_kernel(const float* __restrict__ entries,
                      const float* __restrict__ ecnt,
                      const int* __restrict__ ekey,
                      const int* __restrict__ spare,
                      const float* __restrict__ ucheck,
                      const float* __restrict__ ccheck,
                      int* __restrict__ verdict, int fp, float factor) {
  constexpr int kWarps = kVerifyThreads / 32;
  __shared__ float w[BM];
  __shared__ float red[6][kWarps];
  const int t = blockIdx.x, nt = gridDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t r0 = size_t(t) * BM, sp_row = size_t(nt) * BM;
  for (int j = tid; j < BM; j += kVerifyThreads)
    w[j] = float(ekey[r0 + j] + 1);
  __syncthreads();
  const bool sp = spare[0] == t;
  const float wsp = float(spare[1] + 1);
  const float* u0 = ucheck + size_t(t) * 2 * fp;
  const float* u1 = u0 + fp;
  float res1 = 0.0f, res2 = 0.0f, mag1 = 0.0f, mag2 = 0.0f;
  for (int f = tid; f < fp; f += kVerifyThreads) {
    float o1 = 0.0f, o2 = 0.0f;
    for (int j = 0; j < BM; ++j) {
      const float v = entries[(r0 + j) * fp + f];
      o1 += v;
      o2 = fmaf(w[j], v, o2);
    }
    if (sp) {
      const float v = entries[sp_row * fp + f];
      o1 += v;
      o2 = fmaf(wsp, v, o2);
    }
    res1 = fmaxf(res1, fabsf(o1 - u0[f]));
    res2 = fmaxf(res2, fabsf(o2 - u1[f]));
    mag1 = fmaxf(mag1, fabsf(u0[f]));
    mag2 = fmaxf(mag2, fabsf(u1[f]));
  }
  float c1 = 0.0f, c2 = 0.0f;
  for (int j = tid; j < BM; j += kVerifyThreads) {
    const float v = ecnt[r0 + j];
    c1 += v;
    c2 = fmaf(w[j], v, c2);
  }
  const float part[6] = {warp_max(res1), warp_max(res2), warp_max(mag1),
                         warp_max(mag2), warp_sum(c1), warp_sum(c2)};
  if (lane == 0)
    for (int q = 0; q < 6; ++q) red[q][warp] = part[q];
  __syncthreads();
  if (tid == 0) {
    float v[6] = {red[0][0], red[1][0], red[2][0], red[3][0], red[4][0],
                  red[5][0]};
    for (int k = 1; k < kWarps; ++k) {
      for (int q = 0; q < 4; ++q) v[q] = fmaxf(v[q], red[q][k]);
      v[4] += red[4][k];
      v[5] += red[5][k];
    }
    const float e1 = ccheck[2 * t], e2 = ccheck[2 * t + 1];
    const bool bad = v[0] > factor * fmaxf(v[2], 1.0f) ||
                     v[1] > factor * fmaxf(v[3], 1.0f) ||
                     fabsf(v[4] - e1) > factor * fmaxf(fabsf(e1), 1.0f) ||
                     fabsf(v[5] - e2) > factor * fmaxf(fabsf(e2), 1.0f);
    if (bad) {
      atomicAdd(verdict, 1);
      atomicMax(verdict + 1, nt - t);
    }
  }
}

// --- the tree pass ----------------------------------------------------------

template <int V> struct VecOf;
template <> struct VecOf<1> { using type = float; };
template <> struct VecOf<4> { using type = float4; };

__device__ __forceinline__ float vadd(float a, float b) { return a + b; }
__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
template <typename Vec> __device__ __forceinline__ Vec vzero();
template <> __device__ __forceinline__ float vzero<float>() { return 0.0f; }
template <> __device__ __forceinline__ float4 vzero<float4>() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// One pass over chunks of 2^chunk_log2 slots (<= kTreeChunk). Leaves: dense
// (idx null) leaf (r, slot) = vals[r * rstride + tree_leaf(slot) * tstride
// + e] for the ntiles leaves of the halving tree; sparse, vals[idx[r *
// slots + slot] * width + e] where idx >= 0. Out: node (r, chunk) at
// out[(r * nchunks + chunk) * width + e], +0.0 when the chunk holds no
// leaf, and out_idx[r * nchunks + chunk] = its row or -1 (out_idx may be
// null on the last pass). Block: blockDim.x threads of V features each;
// grid (rows * fgroups, nchunks).
template <int V, bool kDense>
__global__ void __launch_bounds__(kTreeThreads)
tree_reduce_kernel(const float* __restrict__ vals,
                   const int* __restrict__ idx, const int* __restrict__ gate,
                   float* __restrict__ out, int* __restrict__ out_idx,
                   int slots, int ntiles, int levels, long long rstride,
                   long long tstride, int width, int fgroups,
                   int chunk_log2) {
  using Vec = typename VecOf<V>::type;
  __shared__ int list_slot[kTreeChunk];
  __shared__ long long list_off[kTreeChunk];
  __shared__ int batch_base[kTreeBatches + 1];
  // the stack, level l of thread t at stack[l * blockDim.x + t]: dynamic,
  // so a block of 32 threads holds a quarter of a 128-thread block's
  extern __shared__ __align__(16) unsigned char tree_smem[];
  Vec* stack = reinterpret_cast<Vec*>(tree_smem);
  if (gate != nullptr && *gate == 0) return;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const long long r = blockIdx.x / fgroups;
  const int e = (blockIdx.x % fgroups * nthr + tid) * V;
  const int chunk = blockIdx.y, nchunks = gridDim.y;
  const int s0 = chunk << chunk_log2;
  const int s1 = min(s0 + (1 << chunk_log2), slots);
  const int nb = (s1 - s0 + nthr - 1) / nthr;     // <= kTreeBatches / nwarps
  // 1. this thread's slots s0 + i * nthr + tid: present? where?
  long long off[kTreeBatches];
  unsigned ball[kTreeBatches];
#pragma unroll
  for (int i = 0; i < kTreeBatches; ++i) {
    off[i] = -1;
    const int s = s0 + i * nthr + tid;
    if (i < nb && s < s1) {
      if (kDense) {
        const int t = tree_leaf(s, ntiles, levels);
        if (t >= 0) off[i] = r * rstride + t * tstride;
      } else {
        const int row = idx[r * slots + s];
        if (row >= 0) off[i] = (long long)row * width;
      }
    }
  }
  // 2. list the present slots in slot order
#pragma unroll
  for (int i = 0; i < kTreeBatches; ++i) {
    ball[i] = 0;
    if (i < nb) {
      ball[i] = __ballot_sync(0xffffffffu, off[i] >= 0);
      if (lane == 0) batch_base[i * nwarps + warp] = __popc(ball[i]);
    }
  }
  __syncthreads();
  if (tid == 0) {
    int acc = 0;
    for (int b = 0; b < nb * nwarps; ++b) {
      const int n = batch_base[b];
      batch_base[b] = acc;
      acc += n;
    }
    batch_base[kTreeBatches] = acc;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kTreeBatches; ++i) {
    if (off[i] >= 0) {
      const int pos = batch_base[i * nwarps + warp] +
                      __popc(ball[i] & ((1u << lane) - 1u));
      list_slot[pos] = s0 + i * nthr + tid;
      list_off[pos] = off[i];
    }
  }
  const int n = batch_base[kTreeBatches];
  __syncthreads();
  // 3. walk the list: shift-reduce in the tree's order
  if (e < width) {
    Vec cur = vzero<Vec>();
    unsigned pending = 0;     // levels with a closed-left node on the stack
    int prev = 0;
    for (int i0 = 0; i0 < n; i0 += kTreePrefetch) {
      Vec v[kTreePrefetch];
#pragma unroll
      for (int u = 0; u < kTreePrefetch; ++u)
        v[u] = i0 + u < n
                   ? *reinterpret_cast<const Vec*>(vals + list_off[i0 + u] + e)
                   : vzero<Vec>();
#pragma unroll
      for (int u = 0; u < kTreePrefetch; ++u) {
        const int i = i0 + u;
        if (i < n) {
          const int s = list_slot[i];
          if (i > 0) {
            const int h = 31 - __clz(s ^ prev);
            const unsigned low = (1u << h) - 1u;
            for (unsigned below = pending & low; below; below &= below - 1)
              cur = vadd(stack[(__ffs(below) - 1) * nthr + tid], cur);
            pending = (pending & ~low) | (1u << h);
            stack[h * nthr + tid] = cur;
          }
          cur = v[u];
          prev = s;
        }
      }
    }
    for (unsigned rest = pending; rest; rest &= rest - 1)
      cur = vadd(stack[(__ffs(rest) - 1) * nthr + tid], cur);
    *reinterpret_cast<Vec*>(out + (r * nchunks + chunk) * width + e) = cur;
  }
  if (tid == 0 && out_idx != nullptr)
    out_idx[r * nchunks + chunk] = n > 0 ? int(r * nchunks + chunk) : -1;
}

template <typename T, int BM>
int launch_entries(const void* x, const int* argmin, const int* tile,
                   const int* gate, float* entries, float* ecnt, int* idx,
                   int* ekey, int true_m, int kp, int fp, int ntiles,
                   cudaStream_t s) {
  update_entries_kernel<T, BM><<<tile != nullptr ? 1 : ntiles, kEntryThreads,
                                 0, s>>>(
      static_cast<const T*>(x), argmin, tile, gate, entries, ecnt, idx, ekey,
      kp, fp, true_m, ntiles, tree_levels(ntiles));
  return int(cudaGetLastError());
}

template <int BM>
int launch_verify(const float* entries, const float* ecnt, const int* ekey,
                  const int* spare, const float* ucheck, const float* ccheck,
                  int* verdict, int ntiles, int fp, float factor,
                  cudaStream_t s) {
  verify_entries_kernel<BM><<<ntiles, kVerifyThreads, 0, s>>>(
      entries, ecnt, ekey, spare, ucheck, ccheck, verdict, fp, factor);
  return int(cudaGetLastError());
}

template <int V>
int launch_tree(const float* vals, const int* idx, const int* gate,
                float* out, int* out_idx, int rows, int slots, int ntiles,
                long long rstride, long long tstride, int width, int threads,
                int chunk_log2, cudaStream_t s) {
  const int fgroups = (width + threads * V - 1) / (threads * V);
  const long long blocks = (long long)rows * fgroups;
  const int nchunks = ((slots - 1) >> chunk_log2) + 1;
  if (blocks > INT_MAX || nchunks > 65535) return int(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(nchunks));
  const int levels = tree_levels(ntiles);
  const size_t smem =
      size_t(kTreeMaxLevels) * threads * sizeof(typename VecOf<V>::type);
  if (idx == nullptr)
    tree_reduce_kernel<V, true><<<grid, threads, smem, s>>>(
        vals, idx, gate, out, out_idx, slots, ntiles, levels, rstride,
        tstride, width, fgroups, chunk_log2);
  else
    tree_reduce_kernel<V, false><<<grid, threads, smem, s>>>(
        vals, idx, gate, out, out_idx, slots, ntiles, levels, rstride,
        tstride, width, fgroups, chunk_log2);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// The per-tile pass: x (ntiles * block_m, fp) of dtype 0 f32, 1 bf16, 2
// fp16 (16-byte aligned), argmin (ntiles * block_m,) int32, tile and gate
// (0-d int32 on the device, or null: every tile, ungated); entries (ntiles
// * block_m, fp) f32, ecnt (ntiles * block_m,) f32, idx (kp, 2^ceil(log2
// ntiles)) int32 filled with -1 by the caller, ekey (ntiles * block_m,)
// int32 or null. Unkeyed, only present entries are written.
int fk_update_entries(const void* x, const int* argmin, const int* tile,
                      const int* gate, float* entries, float* ecnt, int* idx,
                      int* ekey, int true_m, int kp, int fp, int block_m,
                      int ntiles, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((block_m != 64 && block_m != 128) || fp <= 0 || fp % 4 ||
      ntiles <= 0 || kp <= 0 || kp > INT_MAX / block_m ||
      ntiles > INT_MAX / block_m)
    return int(cudaErrorInvalidValue);
#define FK_ENTRIES(T)                                                         \
  (block_m == 128                                                             \
       ? launch_entries<T, 128>(x, argmin, tile, gate, entries, ecnt, idx,    \
                                ekey, true_m, kp, fp, ntiles, s)              \
       : launch_entries<T, 64>(x, argmin, tile, gate, entries, ecnt, idx,     \
                               ekey, true_m, kp, fp, ntiles, s))
  if (dtype == 0) return FK_ENTRIES(float);
  if (dtype == 1) return FK_ENTRIES(__nv_bfloat16);
  if (dtype == 2) return FK_ENTRIES(__half);
#undef FK_ENTRIES
  return int(cudaErrorInvalidValue);
}

// The one-pass FT step's update verification (verify_entries_kernel) over
// ntiles row tiles of block_m rows; verdict (2,) int32 zeroed by the
// caller.
int fk_verify_entries(const float* entries, const float* ecnt,
                      const int* ekey, const int* spare, const float* ucheck,
                      const float* ccheck, int* verdict, int block_m,
                      int ntiles, int fp, float factor, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ntiles <= 0 || fp <= 0 || ntiles > INT_MAX / block_m)
    return int(cudaErrorInvalidValue);
  if (block_m == 128)
    return launch_verify<128>(entries, ecnt, ekey, spare, ucheck, ccheck,
                              verdict, ntiles, fp, factor, s);
  if (block_m == 64)
    return launch_verify<64>(entries, ecnt, ekey, spare, ucheck, ccheck,
                             verdict, ntiles, fp, factor, s);
  return int(cudaErrorInvalidValue);
}

// One tree pass (see tree_reduce_kernel): idx null = dense leaves of the
// halving tree over ntiles leaves at vals + r * rstride + t * tstride;
// threads a multiple of 32 up to 128, vec 1 or 4 (then width, the strides
// and the pointers are multiples of 4 floats); chunk_log2 <= 8.
int fk_tree_reduce(const float* vals, const int* idx, const int* gate,
                   float* out, int* out_idx, int rows, int slots,
                   int ntiles, long long rstride, long long tstride,
                   int width, int threads, int vec, int chunk_log2,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || slots <= 0 || width <= 0 || ntiles <= 0 ||
      threads <= 0 || threads > kTreeThreads || threads % 32 ||
      chunk_log2 < 0 || chunk_log2 > kTreeMaxLevels ||
      (idx == nullptr && slots != (1 << tree_levels(ntiles))))
    return int(cudaErrorInvalidValue);
  if (vec == 1)
    return launch_tree<1>(vals, idx, gate, out, out_idx, rows, slots, ntiles,
                          rstride, tstride, width, threads, chunk_log2, s);
  if (vec == 4 && width % 4 == 0 && rstride % 4 == 0 && tstride % 4 == 0)
    return launch_tree<4>(vals, idx, gate, out, out_idx, rows, slots, ntiles,
                          rstride, tstride, width, threads, chunk_log2, s);
  return int(cudaErrorInvalidValue);
}

const char* fk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
