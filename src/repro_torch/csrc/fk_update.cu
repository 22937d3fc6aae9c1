// Hand-written Hopper (sm_90a) kernels of the two-pass centroid update and
// of the fixed-order tree sum of per-tile partials.
//
// Replaces, on the card's path of ops.tiled_update, the dense update of the
// reference: _emit_update (src/repro/kernels/lloyd_step.py:162) over every
// row tile, which writes (num_m, kp, fp) partial sums, and _tree_sum
// (src/repro/kernels/ops.py:510, XLA code in the reference), which halves
// the tile axis log2(num_m) times. The results are the same bits.
//
// The order every contract of the port rests on: each (tile, k, f) partial
// starts at +0.0 and adds its cluster's rows in row order, widened to f32;
// the tiles then combine in _tree_sum's halving tree (at a level of s nodes,
// node i < s/2 becomes a[i] + a[i + s/2], an odd last node is carried to
// index s/2). A partial that starts at +0.0 is never -0.0, and x + (+0.0)
// == x bitwise for every x that is not -0.0, so the tree over the dense,
// mostly zero leaves equals, bit for bit, the same tree over the present
// (tile, cluster) entries only, where a node with one present child is that
// child.
//
// Slots. Number the tree's levels l = 0 .. L-1 (L = ceil(log2 T)). Leaf t's
// slot has bit l set when at level l its node is the right operand (index
// in [s/2, 2 (s/2))); a left operand or a carried node gives 0. The tree
// over T leaves is then the perfect binary tree over 2^L slots, read left
// to right, with the slots no leaf maps to absent (a carried node is a node
// whose right subtree is absent). tree_slot / tree_leaf map both ways.
//
// update_entries_kernel<T, BM> (one block of 128 threads per BM-row tile):
//   * ranks the tile's valid rows by (cluster, row) with a bitonic sort of
//     BM keys in shared memory (the epilogue it replaces ranks in O(BM^2));
//   * writes one entry per present cluster: row t * BM + j for the tile's
//     j-th present cluster holds its Fp sums (each one lane's f32 sum over
//     the cluster's rows in row order, from 0, as emit_update sums), its
//     count, and idx[k][slot(t)] = t * BM + j. The entries buffer is
//     (Mp, Fp) f32 (O(M Fp), never O(T Kp Fp)); only present rows are
//     written; idx (Kp, 2^L) int32 is -1 where a tile has no row of k.
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

namespace {

constexpr int kEntryThreads = 128;
constexpr int kTreeThreads = 128;         // most threads a tree block has
constexpr int kTreeMaxLevels = 8;         // a chunk holds at most 2^8 slots
constexpr int kTreeChunk = 1 << kTreeMaxLevels;
constexpr int kTreeBatches = kTreeChunk / 32;
constexpr int kTreePrefetch = 8;

// --- the halving tree's slots -----------------------------------------------

// levels of _tree_sum over n >= 1 leaves: ceil(log2 n)
__host__ __device__ inline int tree_levels(int n) {
  int l = 0;
  while ((1LL << l) < n) ++l;
  return l;
}

// nodes at level l of the tree over n leaves: ceil(n / 2^l)
__device__ __forceinline__ int level_size(int n, int l) {
  return ((n - 1) >> l) + 1;
}

__device__ int tree_slot(int t, int n, int levels) {
  int slot = 0, i = t;
  for (int l = 0; l < levels; ++l) {
    const int h = level_size(n, l) >> 1;
    if (i >= 2 * h) {
      i = h;                      // the odd last node, carried
    } else if (i >= h) {
      slot |= 1 << l;             // right operand of a[i - h] + a[i]
      i -= h;
    }
  }
  return slot;
}

// the leaf at a slot, or -1 when the slot is under a carried node's empty
// right subtree
__device__ int tree_leaf(int slot, int n, int levels) {
  int i = 0;
  for (int l = levels - 1; l >= 0; --l) {
    const int h = level_size(n, l) >> 1;
    const int bit = (slot >> l) & 1;
    if (i < h) {
      i += bit * h;
    } else {
      if (bit) return -1;
      i = 2 * h;
    }
  }
  return i;
}

// --- the per-tile pass ------------------------------------------------------

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  v[0] = __low2float(a); v[1] = __high2float(a);
  v[2] = __low2float(b); v[3] = __high2float(b);
}

__device__ __forceinline__ void load4(const __half* p, float* v) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const __half2 a = *reinterpret_cast<const __half2*>(&q.x);
  const __half2 b = *reinterpret_cast<const __half2*>(&q.y);
  v[0] = __low2float(a); v[1] = __high2float(a);
  v[2] = __low2float(b); v[3] = __high2float(b);
}

// Rows >= true_m and labels outside [0, kp) enter nothing (emit_update's
// rule). When gate is given the launch is a no-op while *gate == 0.
template <typename T, int BM>
__global__ void __launch_bounds__(kEntryThreads)
update_entries_kernel(const T* __restrict__ x, const int* __restrict__ argmin,
                      const int* __restrict__ gate,
                      float* __restrict__ entries, float* __restrict__ ecnt,
                      int* __restrict__ idx, int kp, int fp, int true_m,
                      int ntiles, int levels) {
  __shared__ int key[BM];           // cluster * BM + row; INT_MAX: no entry
  __shared__ int seg[BM + 1];       // first sorted position of each entry
  __shared__ int warp_n[kEntryThreads / 32];
  if (gate != nullptr && *gate == 0) return;
  const int t = blockIdx.x, m0 = t * BM, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  if (tid < BM) {
    const int a = argmin[m0 + tid];
    key[tid] = (m0 + tid < true_m && a >= 0 && a < kp) ? a * BM + tid
                                                        : INT_MAX;
  }
  // bitonic sort, ascending: by cluster, then row
  for (int size = 2; size <= BM; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      if (tid < BM / 2) {
        const int i = 2 * tid - (tid & (stride - 1)), j = i + stride;
        const int a = key[i], b = key[j];
        if ((a > b) == ((i & size) == 0)) {
          key[i] = b;
          key[j] = a;
        }
      }
    }
  }
  __syncthreads();
  // one entry per run of equal clusters, numbered in cluster order
  const int v = tid < BM ? key[tid] : INT_MAX;
  const bool head = v != INT_MAX && (tid == 0 || key[tid - 1] / BM != v / BM);
  const unsigned ball = __ballot_sync(0xffffffffu, head);
  if (lane == 0) warp_n[warp] = __popc(ball);
  const int nvalid = __syncthreads_count(v != INT_MAX);
  int j = __popc(ball & ((1u << lane) - 1u)), nseg = 0;
  for (int w = 0; w < kEntryThreads / 32; ++w) {
    j += w < warp ? warp_n[w] : 0;
    nseg += warp_n[w];
  }
  if (head) seg[j] = tid;
  if (tid == 0) seg[nseg] = nvalid;
  __syncthreads();
  const int slot = tree_slot(t, ntiles, levels);
  for (int e = warp; e < nseg; e += kEntryThreads / 32) {
    const int lo = seg[e], hi = seg[e + 1];
    const int row = t * BM + e;
    for (int f0 = lane * 4; f0 < fp; f0 += 128) {
      float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
      for (int p = lo; p < hi; ++p) {
        float q[4];
        load4(x + size_t(m0 + (key[p] & (BM - 1))) * fp + f0, q);
        s0 += q[0];
        s1 += q[1];
        s2 += q[2];
        s3 += q[3];
      }
      *reinterpret_cast<float4*>(entries + size_t(row) * fp + f0) =
          make_float4(s0, s1, s2, s3);
    }
    if (lane == 0) {
      ecnt[row] = float(hi - lo);
      idx[(size_t(key[lo] / BM) << levels) + slot] = row;
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
int launch_entries(const void* x, const int* argmin, const int* gate,
                   float* entries, float* ecnt, int* idx, int true_m, int kp,
                   int fp, int ntiles, cudaStream_t s) {
  update_entries_kernel<T, BM><<<ntiles, kEntryThreads, 0, s>>>(
      static_cast<const T*>(x), argmin, gate, entries, ecnt, idx, kp, fp,
      true_m, ntiles, tree_levels(ntiles));
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
// fp16 (16-byte aligned), argmin (ntiles * block_m,) int32, gate (a 0-d
// int32 on the device, or null); entries (ntiles * block_m, fp) f32, ecnt
// (ntiles * block_m,) f32, idx (kp, 2^ceil(log2 ntiles)) int32 filled with
// -1 by the caller. Only present entries are written.
int fk_update_entries(const void* x, const int* argmin, const int* gate,
                      float* entries, float* ecnt, int* idx, int true_m,
                      int kp, int fp, int block_m, int ntiles, int dtype,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((block_m != 64 && block_m != 128) || fp <= 0 || fp % 4 ||
      ntiles <= 0 || kp <= 0 || kp > INT_MAX / block_m ||
      ntiles > INT_MAX / block_m)
    return int(cudaErrorInvalidValue);
#define FK_ENTRIES(T)                                                         \
  (block_m == 128 ? launch_entries<T, 128>(x, argmin, gate, entries, ecnt,    \
                                           idx, true_m, kp, fp, ntiles, s)    \
                  : launch_entries<T, 64>(x, argmin, gate, entries, ecnt,     \
                                          idx, true_m, kp, fp, ntiles, s))
  if (dtype == 0) return FK_ENTRIES(float);
  if (dtype == 1) return FK_ENTRIES(__nv_bfloat16);
  if (dtype == 2) return FK_ENTRIES(__half);
#undef FK_ENTRIES
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
