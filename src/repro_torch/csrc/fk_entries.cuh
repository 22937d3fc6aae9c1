// The per-tile entry writer of the centroid update, shared by fk_update.cu
// (update_entries_kernel: the two-pass update's per-tile pass and the FT
// recompute of one tile) and fk_kernels.cu (the one-pass kernels' update
// epilogue, lloyd_tile_kernel / lloyd_tile_mma_kernel with kEntries). One
// definition, so every route writes a tile's entries bit for bit alike.
//
// The order every update contract of the port rests on: each (tile, k, f)
// sum starts at +0.0 and adds its cluster's rows in row order, widened to
// f32; the tiles then combine in _tree_sum's halving tree (at a level of s
// nodes, node i < s/2 becomes a[i] + a[i + s/2], an odd last node is
// carried to index s/2). A sum that starts at +0.0 is never -0.0, and
// x + (+0.0) == x bitwise for every x that is not -0.0, so the tree over
// the dense, mostly zero per-tile blocks equals, bit for bit, the same tree
// over the present (tile, cluster) entries only, where a node with one
// present child is that child.
//
// Slots. Number the tree's levels l = 0 .. L-1 (L = ceil(log2 T)). Leaf t's
// slot has bit l set when at level l its node is the right operand (index
// in [s/2, 2 (s/2))); a left operand or a carried node gives 0. The tree
// over T leaves is then the perfect binary tree over 2^L slots, read left
// to right, with the slots no leaf maps to absent. tree_slot / tree_leaf
// map both ways.
//
// Layout of a tile's entries (write_entries): row t * BM + j of `entries`
// (f32, Fp wide) holds the Fp sums of tile t's j-th present cluster, in
// cluster order, `ecnt` its count, idx[k][slot(t)] its row (-1 where the
// tile has no row of k; the caller fills idx with -1). Keyed (ekey given):
// ekey[row] = its cluster, and the tile's rows past its last entry are
// zeros with ekey -1, so a verification can sum a tile's BM rows as they
// lie.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstddef>

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

__device__ inline int tree_slot(int t, int n, int levels) {
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
__device__ inline int tree_leaf(int slot, int n, int levels) {
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

// --- four consecutive values widened to f32 ---------------------------------

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

// --- the writer ---------------------------------------------------------------

// Where a launch's entries go. ntiles: the row tiles of the launch's X (the
// tree's leaves); ekey may be null (unkeyed); row0: the first entry row of
// the launch's problem (a batched launch's problem b: b * ntiles * BM),
// whose idx the caller has moved to the problem's rows.
struct EntryOut {
  float* entries;
  float* ecnt;
  int* idx;
  int* ekey;
  int kp, fp, levels, ntiles;
  size_t row0 = 0;
};

// Shared ints write_entries takes (caller-placed): key[BM], seg[BM + 1],
// the warps' head counts, each row's label (kChecks).
template <int BM, int NT>
struct EntryScratch {
  static constexpr int kKey = 0, kSeg = BM, kWarpN = 2 * BM + 1;
  static constexpr int kLab = kWarpN + NT / 32;
  static constexpr int kInts = kLab + BM;
};

// The entries of row tile t from X (Mp, Fp) of type T (f32, bf16 or fp16)
// and each row's final label (label: thread tid < BM holds row t BM + tid's;
// rows >= true_m and labels outside [0, kp) enter nothing). Called by all
// NT threads of the block; the sort and the entries are the two-pass
// update_entries_kernel's, for any NT. restore: first set the tile's idx
// column to -1 (a recompute over a column an earlier launch wrote). kChecks
// (NT = 256, the one-pass FT kernels): also the tile's expected update
// checksums from the rows the sums load, never from the sums --
// ucheck[0][f] = sum of the valid rows, ucheck[1][f] = sum of (label + 1)
// times the row (warp partials in upart, 2 x 128 floats a warp, summed in
// warp order), ccheck = (valid rows, sum of (label + 1)). Their weights
// come from each row's own label, kept apart from the sort's keys, so a row
// summed into the wrong entry moves the sums but not their checksums.
// Returns the
// tile's entry count; key / seg stay in shared memory for the caller: entry
// e is cluster key[seg[e]] / BM.
template <typename T, int BM, int NT, bool kChecks>
__device__ int write_entries(int label, const T* __restrict__ x, int t,
                             int true_m, const EntryOut& o, bool restore,
                             int* sm_ints, float* upart,
                             float* __restrict__ ucheck,
                             float* __restrict__ ccheck) {
  static_assert(BM == 64 || BM == 128, "row tiles of 64 or 128");
  static_assert(NT >= BM && NT % 32 == 0, "a thread per row");
  static_assert(!kChecks || NT == 256, "the checksums' combine: 2 x 128");
  using S = EntryScratch<BM, NT>;
  constexpr int kWarps = NT / 32;
  int* key = sm_ints + S::kKey;   // cluster * BM + row; INT_MAX: no entry
  int* seg = sm_ints + S::kSeg;   // first sorted position of each entry
  int* warp_n = sm_ints + S::kWarpN;
  int* lab = sm_ints + S::kLab;   // row -> its label (kChecks)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = t * BM;
  const int slot = tree_slot(t, o.ntiles, o.levels);
  if (restore)
    for (int k = tid; k < o.kp; k += NT)
      o.idx[(size_t(k) << o.levels) + slot] = -1;
  if (tid < BM)
    key[tid] = (m0 + tid < true_m && label >= 0 && label < o.kp)
                   ? label * BM + tid
                   : INT_MAX;
  if (kChecks && tid < BM) lab[tid] = label;
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
  for (int w = 0; w < kWarps; ++w) {
    j += w < warp ? warp_n[w] : 0;
    nseg += warp_n[w];
  }
  if (head) seg[j] = tid;
  if (tid == 0) seg[nseg] = nvalid;
  __syncthreads();
  const bool keyed = o.ekey != nullptr;
  // lanes an entry takes, 4 features a lane: where Fp is narrow a warp sums
  // 32 / lpe entries at once, so every lane loads (the checksums' combine
  // takes whole warps); each sum is the same whichever lane runs it
  const int lpe = kChecks || o.fp > 64 ? 32 : o.fp > 32 ? 16 : 8;
  const int epw = 32 / lpe, sl = lane % lpe, e0 = warp * epw + lane / lpe;
  for (int fc = 0; fc < o.fp; fc += 4 * lpe) {
    const int f0 = fc + sl * 4;
    float u0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, u1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int e = e0; e < nseg; e += kWarps * epw) {
      const int lo = seg[e], hi = seg[e + 1];
      const size_t row = o.row0 + m0 + e;
      if (f0 < o.fp) {
        float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int p = lo; p < hi; ++p) {
          const int r = key[p] & (BM - 1);
          float q[4];
          load4(x + size_t(m0 + r) * o.fp + f0, q);
          const float w = kChecks ? float(lab[r] + 1) : 0.0f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[i] += q[i];
            if (kChecks) {
              u0[i] += q[i];
              u1[i] = fmaf(w, q[i], u1[i]);
            }
          }
        }
        *reinterpret_cast<float4*>(o.entries + row * o.fp + f0) =
            make_float4(s[0], s[1], s[2], s[3]);
      }
      if (fc == 0 && sl == 0) {
        const int k = key[lo] / BM;
        o.ecnt[row] = float(hi - lo);
        o.idx[(size_t(k) << o.levels) + slot] = int(row);
        if (keyed) o.ekey[row] = k;
      }
    }
    if (keyed) {
      for (int e = nseg + e0; e < BM; e += kWarps * epw) {
        const size_t row = o.row0 + m0 + e;
        if (f0 < o.fp)
          *reinterpret_cast<float4*>(o.entries + row * o.fp + f0) =
              make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (fc == 0 && sl == 0) {
          o.ecnt[row] = 0.0f;
          o.ekey[row] = -1;
        }
      }
    }
    if (kChecks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        upart[(warp * 2 + 0) * 128 + lane * 4 + i] = u0[i];
        upart[(warp * 2 + 1) * 128 + lane * 4 + i] = u1[i];
      }
      __syncthreads();
      const int q = tid >> 7, f = tid & 127;
      float s = 0.0f;
      for (int w = 0; w < kWarps; ++w) s += upart[(w * 2 + q) * 128 + f];
      if (fc + f < o.fp) ucheck[q * o.fp + fc + f] = s;
      __syncthreads();
    }
  }
  if (kChecks && tid == 0) {
    float c1 = 0.0f;
    for (int p = 0; p < nvalid; ++p)
      c1 += float(lab[key[p] & (BM - 1)] + 1);
    ccheck[0] = float(nvalid);
    ccheck[1] = c1;
  }
  return nseg;
}
