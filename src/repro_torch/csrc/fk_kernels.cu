// Hand-written Hopper (sm_90a) kernels for the FT K-means main paths.
//
// One templated tile kernel, lloyd_tile_kernel<BM, kFT, kUpd>, carries
// six Pallas TPU kernels of the reference package:
//
//   kFT  kUpd      problems  replaces (src/repro/kernels/...)
//   no   none      1         distance_argmin.py    distance_argmin
//   no   entries   1         lloyd_step.py         lloyd_step
//   no   dense     B         lloyd_step.py         lloyd_step_batched
//   yes  none      1         distance_argmin_ft.py distance_argmin_ft
//   yes  entries   1         lloyd_step_ft.py      lloyd_step_ft
//   no   pruned    1         lloyd_step_pruned.py  lloyd_step_pruned
//
// Its inputs are f32 (CUDA-core FMAs). lloyd_tile_mma_kernel<T, BM, kFT,
// kUpd> is the same kernel for __nv_bfloat16 or __half X and C (the
// reference's 2-byte templates): mma.sync m16n8k16 on the tensor cores with
// f32 accumulation, its ABFT checksums on the tensor cores and in registers
// (see the kernel), and the f32 kernel's decode, epilogues and update, for
// every row of the table but the batched one's update, which is each
// problem's entries (kBatchedEntries) in place of the dense blocks;
// lloyd_encode_kernel<T> is its FT rows' pre-pass.
//
// The update: the single-problem one-pass steps (kEntryUpdate) write the
// tile's entries (write_entries, fk_entries.cuh: one row per present
// cluster, its sums, count and idx slot), the layout of the two-pass
// update's update_entries_kernel (fk_update.cu), which reduces them with the
// same tree kernel; O(M Fp) bytes, where the reference's dense (M/BM, Kp,
// Fp) block is O(M Kp Fp / BM). The batched step is the single-problem
// kernel launched over a (row tile, problem) grid: blockIdx.y picks the
// problem and moves every base pointer to that problem's slab, so problem
// b of a batched launch runs, bit for bit, the code one problem's launch
// runs. At f32 it keeps the dense block (<BM, false, kDenseUpdate>,
// emit_update); at 2 bytes (<T, BM, false, kBatchedEntries>) problem b
// writes lloyd_step's entries at entry rows b Mp .. and idx rows b Kp ..,
// so one tree over B Kp rows sums every problem. Only those two have the
// problem axis. Dense or entries, each (tile, k, f) sum is the same
// sequence of adds, so their trees give the same bits.
// The pruned step (kPrunedEntries, both kernels) walks only the centroid
// tiles a (row tile, centroid tile) skip mask leaves: a block lists them
// once, its staging ring prefetches through that list, a computed tile is
// lloyd_step's code plus the tile's Euclidean bound, and the update is
// lloyd_step's entries. Every mode is a compile-time parameter, so each
// instantiation carries only its own code.
// kmeanspp_round_kernel replaces kmeanspp_init.py kmeanspp_round (one D^2
// seeding round over (row tile, problem)).
// int8_tile_kernel replaces distance_argmin_int8.py distance_argmin_int8:
// mma.sync m16n8k32 s8 on the tensor cores over a stash of X's row tile and
// a cp.async ring of C's chunks, then the f32 scale correction and the
// min/argmin in registers (see the kernel).
// matmul_abft.py matmul_abft (the ABFT GEMM) is not here: every dtype of
// it, f32 included, is abft_gemm_kernel<T> in fk_abft_gemm.cu (wgmma fed
// by TMA).
// dmr_bucket_kernel<kPlace> (histogram, then scatter), dmr_scan_kernel,
// dmr_gather_kernel<V>, dmr_reduce_kernel and dmr_verdict_kernel replace
// centroid_update_dmr.py centroid_update_dmr: each row slab's rows
// bucketed by cluster (a stable counting sort: histogram, scan, ranks by
// __match_any_sync in row order), then one warp a (slab, chunk of up to
// 512 of a cluster's rows, feature group) loads 8 rows at once and adds
// them into two register replicas (the shadow in reversed order within
// each group of 8), the chunks summed per slab and the slabs in slab order
// in a fifth pass, compared in a sixth. X is read once, no float atomics.
//
// Instantiations: lloyd_tile_kernel 2 (BM = 64, 128) x 6 (kFT, kUpd: the
// table's rows) = 12, lloyd_tile_mma_kernel 2 (T) x 2 (BM) x 6 (the
// batched row with kBatchedEntries) = 24,
// lloyd_encode_kernel 2 (T), lloyd_prep_kernel 1 (the f32 kernel's
// pre-pass), update_tiles_kernel 3 (T) x 2 (BM), kmeanspp_round_kernel 1,
// int8_tile_kernel 2 (BM), the seven DMR kernels (bucket at kPlace 0, 1;
// gather at V = 1, 4): 55 kernels.
//
// The epilogues are single __device__ definitions (tile_min_argmin,
// fold_min, min_pair, emit_update, emit_entries; the warp reductions and
// the ABFT decode, locate_tile, in fk_abft.cuh, shared with
// fk_abft_gemm.cu;
// write_entries in fk_entries.cuh, shared with fk_update.cu) so the
// variants agree bit for bit by construction, as the reference's shared
// tile_min_argmin/_emit_update do.
// update_tiles_kernel launches emit_update alone over every row tile (or
// one): the dense route, the CPU's two-pass update and the reference every
// route's bits are held to.
//
// Design (right and simple first):
//   * one thread block owns one row tile of BM rows (the TPU grid's row axis);
//     a loop over centroid tiles of kBK = 128 and feature chunks of kChunk =
//     32 replaces the TPU's sequential (centroid, feature) grid axes;
//   * f32: X and C chunks are staged row-major by 16-byte cp.async into a
//     two-slot ring; each of the 256 threads keeps a (BM/16) x 8 f32
//     accumulator in registers (CUDA-core FMA, no tensor cores, no TF32)
//     fed by 16-byte shared loads (see lloyd_tile_kernel);
//   * bf16/fp16: X's row tile is copied once by 16-byte cp.async and kept
//     (streamed with C's chunks where it does not fit), C's chunks run
//     through a three-slot cp.async ring; the 8 warps tile the BM x 128
//     accumulator 2 x 4, each warp (BM/2) x 32 as (BM/32) x 4 m16n8 f32
//     fragments loaded by ldmatrix, one k16 mma.sync a fragment a step;
//   * min/argmin: the lowest index wins a tie inside a tile and the
//     earlier tile wins a tie across tiles -- the jnp.argmin tie-break, the
//     serial scan's strict '<' (tile_min_argmin). f32: every thread scans
//     its fragment and the row's 16 threads combine by shuffles
//     (tile_fold); bf16/fp16 and int8: every lane scans its MMA fragment,
//     the quad and the row band's 4 warps combine (min_pair); the same
//     result. The 2-byte FT kernels keep the stored tile (Ds) and thread
//     r's serial scan, whose pass also sums the observed checksums;
//   * ABFT (kFT), f32: expected e1/e2 column and row checksums accumulate
//     in f32 from the staged chunks; at each (row tile, centroid tile)
//     interval the observed checksums of Ds are compared, a fault is
//     located by the e2/e1 ratio and corrected before the min/argmin
//     (2 bytes: the same rule on tensor-core checksums, see
//     lloyd_tile_mma_kernel);
//   * update: rows are ranked by (cluster, row) in shared memory and each
//     (k, f) sum is one lane's sequential sum over its cluster's rows in
//     row order -- no atomics, so the sums are deterministic and a
//     recompute reproduces them bit for bit;
//   * seeding round: the block stages 256 rows x 32 features of its tile in
//     shared memory (coalesced), thread r dots row r with the centroid row,
//     and the tile sum is a fixed-order warp butterfly plus an in-order sum
//     of the 8 warp partials -- no atomics, so a round repeats bit for bit.
//
// Bound on the H100: the distance GEMM, 2*M*Kp*Fp FLOPs on f32 CUDA cores
// (67 TFLOP/s), above the bytes of X (read once per centroid tile, mostly
// from L2) and the update's entries (O(M Fp)). At bf16/fp16 the GEMM's
// tensor-core bound (989 TFLOP/s) and the bytes of 2-byte X and the f32
// entries are close (0.27 and 0.24 ms at M = 2^20, F = 128, K = 1000); the
// f32 batched step's dense partial-sum buffer bounds it by bytes; the
// 2-byte one writes the present entries only (~101 of 256 clusters a
// 128-row tile at the PQ shape).
// The 2-byte product runs mma.sync fed by ldmatrix from a cp.async ring
// (not wgmma: its accumulation order is not mma.sync's, and the bits are
// the bar).
// The pruned step needs the GEMM of its computed tiles only, against X
// read once and its entries.
// The int8 GEMM is bound by the int8 tensor cores' 1,979 Tera-op/s, which
// it runs on (mma.sync s8); its f32 epilogue over every distance comes
// next.
// The seeding round is bound by the bytes of X (one GEMV per round). The
// DMR update is bound by the bytes of X and the assignments, read once:
// its gather keeps 8 row loads of up to 512 bytes a warp in flight, and
// its bucketing reads the assignments twice and writes M row indices.
// wgmma and TMA are later work here; the int8 and 2-byte kernels keep a
// shared-memory X stash.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (no --use_fast_math: +inf norms of padded centroids must stay +inf
// and the e2/e1 division must round correctly).
#include <cuda_runtime.h>
#include <cfloat>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "fk_abft.cuh"
#include "fk_entries.cuh"
#include "fk_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;   // features staged per step
constexpr int kBK = 128;     // centroid tile
constexpr int kTN = kBK / 16;
constexpr int kMaxProblems = 65535;   // gridDim.y: one problem per grid row
constexpr int kRoundRows = kThreads;  // seeding: rows staged per step
// the split C encodings of the 2-byte FT kernels: e1 and e2 over a centroid
// tile scaled by 2^-kEnc1Shift and 2^-kEnc2Shift (ceil(log2 kBK) and
// ceil(log2 (kBK (kBK + 1) / 2)), so fp16 parts never overflow)
constexpr int kEnc1Shift = 7, kEnc2Shift = 14;
static_assert(kBK == 128, "the encoding shifts are kBK = 128's");

// The update a one-pass instantiation emits: none (distance_argmin[_ft]),
// the dense (Kp, Fp) block of every row tile (the f32 lloyd_step_batched:
// emit_update), the tile's entries (lloyd_step, lloyd_step_ft:
// write_entries) or, over a (row tile, problem) grid, each problem's
// entries (the 2-byte lloyd_step_batched, lloyd_tile_mma_kernel only), or
// the entries of a walk over the centroid tiles a skip mask leaves
// (lloyd_step_pruned, with each computed tile's Euclidean bound).
enum UpdateMode {
  kNoUpdate = 0,
  kDenseUpdate = 1,
  kEntryUpdate = 2,
  kBatchedEntries = 3,
  kPrunedEntries = 4
};

// Injection descriptor slots, as in the reference:
//   distance slot: [0] enabled [1] m_tile [2] c_tile [3] f_tile [4] row
//                  [5] col [6] delta (f32 bits)
//   update slot (lloyd_step_ft only, words 7..11): [7] enabled [8] m_tile
//                  [9] cluster row [10] feature col [11] delta (f32 bits)
struct DistInj {
  int enabled, m_tile, c_tile, f_tile, row, col;
  float delta;
};
struct UpdInj {
  int enabled, m_tile, row, col;
  float delta;
};

__device__ __forceinline__ DistInj load_dist_inj(const int* p) {
  DistInj d{p[0], p[1], p[2], p[3], p[4], p[5], __int_as_float(p[6])};
  return d;
}
__device__ __forceinline__ UpdInj load_upd_inj(const int* p) {
  UpdInj u{p[7], p[8], p[9], p[10], __int_as_float(p[11])};
  return u;
}

// Update-only layout (recompute kernel): the int region alone.
template <int BM>
struct UpdLayout {
  static constexpr int kAm = 0, kKey = BM, kOrder = 2 * BM, kSKey = 3 * BM;
  static constexpr int kWords = 4 * BM;
};

// --- epilogue 1: min/argmin of one row of a distance tile -----------------
// d = cn - 2*acc; the first (lowest-index) minimum wins inside the tile.
// kSums (the 2-byte FT kernels): the same pass also sums the row's observed
// checksums, s1 = sum_c acc[c], s2 = sum_c (c + 1) acc[c].
template <bool kSums = false>
__device__ __forceinline__ void tile_min_argmin(const float* ds_row,
                                                const float* cn, int base_col,
                                                float* lmin, int* larg,
                                                float* s1 = nullptr,
                                                float* s2 = nullptr) {
  float best = cn[0] - 2.0f * ds_row[0];
  int arg = 0;
  float a1 = ds_row[0], a2 = ds_row[0];
  for (int c = 1; c < kBK; ++c) {
    const float v = ds_row[c];
    float d = cn[c] - 2.0f * v;
    if (d < best) {
      best = d;
      arg = c;
    }
    if (kSums) {
      a1 += v;
      a2 = fmaf(float(c + 1), v, a2);
    }
  }
  *lmin = best;
  *larg = arg + base_col;
  if (kSums) {
    *s1 = a1;
    *s2 = a2;
  }
}

// --- epilogue 2: fold a tile's (min, argmin) into the running row state ---
// Strict compare: the earlier centroid tile wins ties.
__device__ __forceinline__ void fold_min(float* best, int* arg, float lmin,
                                         int larg) {
  if (lmin < *best) {
    *best = lmin;
    *arg = larg;
  }
}

// --- epilogue 3: the one-pass update of one row tile ----------------------
// am: the tile's final assignment (shared). Rows >= true_m are padding and
// enter neither sums nor counts. Writes the tile's (kp, fp) partial sums and
// (kp,) counts. Each (k, f) sum starts at 0 and adds its cluster's rows in
// row order, each widened to f32 (exact for 2-byte T). Called by all
// threads of the block.
template <typename T, int BM>
__device__ void emit_update(const int* am, int* key, int* order, int* skey,
                            const T* __restrict__ x, int m0, int true_m,
                            int kp, int fp, float* __restrict__ sums,
                            float* __restrict__ counts) {
  const int tid = threadIdx.x;
  if (tid < BM) key[tid] = (m0 + tid < true_m) ? am[tid] : -1;
  __syncthreads();
  if (tid < BM) {
    const int kr = key[tid];
    int rank = 0;
    for (int r = 0; r < BM; ++r) {
      const int kq = key[r];
      rank += (kq < kr) || (kq == kr && r < tid);
    }
    order[rank] = tid;
  }
  __syncthreads();
  if (tid < BM) skey[tid] = key[order[tid]];
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32;
  for (int k = warp; k < kp; k += kThreads / 32) {
    // [lo, hi): the rows of cluster k in the sorted order
    int lo = 0, hi = BM;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (skey[mid] < k) lo = mid + 1; else hi = mid;
    }
    int end = lo;
    hi = BM;
    while (end < hi) {
      const int mid = (end + hi) / 2;
      if (skey[mid] < k + 1) end = mid + 1; else hi = mid;
    }
    if (lane == 0) counts[k] = float(end - lo);
    for (int f = lane; f < fp; f += 32) {
      float s = 0.0f;
      for (int p = lo; p < end; ++p)
        s += to_f32(x[size_t(m0 + order[p]) * fp + f]);
      sums[size_t(k) * fp + f] = s;
    }
  }
}

// --- epilogue 4: the one-pass update as entries (kEntryUpdate) -----------
// write_entries on the tile's final labels (best_arg of thread tid < BM),
// its ints at es (4 BM) and, for the checksums' warp partials, upart (8 x
// 2 x 128 floats; both in space the tiles' loop no longer needs). kFT: the
// tile's expected update checksums come from the rows the sums load; then
// the simulated SEU of the update slot lands on the tile's entry of the
// cluster, or, where the tile has no row of that cluster, on the spare
// entry row past the tiles' (row ntiles * BM): the dense block's zero row
// plus delta, which idx[cluster][slot] then points at, so the tree and the
// verification see the value the dense route would hold there. spare gets
// (tile, cluster). Called by all threads of the block.
template <typename T, int BM, bool kFT>
__device__ void emit_entries(int* es, float* upart, int best_arg, const T* x,
                             int mt, int true_m, const EntryOut& o,
                             const int* __restrict__ inj,
                             int* __restrict__ spare,
                             float* __restrict__ ucheck,
                             float* __restrict__ ccheck) {
  using S = EntryScratch<BM, kThreads>;
  static_assert(S::kInts <= 4 * BM, "the int region holds the writer's");
  const int nseg = write_entries<T, BM, kThreads, kFT>(
      best_arg, x, mt, true_m, o, false, es, upart,
      kFT ? ucheck + size_t(mt) * 2 * o.fp : nullptr,
      kFT ? ccheck + size_t(mt) * 2 : nullptr);
  if (!kFT) return;
  __syncthreads();
  const UpdInj u = load_upd_inj(inj);
  if (!u.enabled || mt != u.m_tile || u.row < 0 || u.row >= o.kp ||
      u.col < 0 || u.col >= o.fp)
    return;
  int hit = -1;
  for (int e = 0; e < nseg; ++e)
    if (es[S::kKey + es[S::kSeg + e]] / BM == u.row) hit = e;
  const int tid = threadIdx.x;
  if (hit >= 0) {
    if (tid == 0)
      o.entries[(size_t(mt) * BM + hit) * o.fp + u.col] += u.delta;
    return;
  }
  const size_t sp = size_t(o.ntiles) * BM;
  for (int f = tid; f < o.fp; f += kThreads)
    o.entries[sp * o.fp + f] = f == u.col ? 0.0f + u.delta : 0.0f;
  if (tid == 0) {
    o.ecnt[sp] = 0.0f;
    o.ekey[sp] = u.row;
    spare[0] = mt;
    spare[1] = u.row;
    o.idx[(size_t(u.row) << o.levels) + tree_slot(mt, o.ntiles, o.levels)] =
        int(sp);
  }
}

// --- the f32 tile kernel: staging ring, encodings, min/argmin -------------
// lloyd_tile_kernel<BM, kFT, kUpd> (f32 X and C, CUDA-core FMAs). Each
// output element of a centroid tile is one FMA chain, acc = fmaf(x[f],
// c[f], acc) for f = 0 .. Fp-1 in order from 0.0f; any thread layout that
// keeps every chain gives the same bits, so the design below moves
// nothing but where each chain runs and how its operands arrive:
//   * staging: a pre-pass (lloyd_prep_kernel, once a call) writes C
//     feature-major (ct); each step (one kChunk-feature chunk of one
//     centroid tile) copies X's row tile chunk and C's centroid tile chunk
//     feature-major (row f of a slot holds feature f of every row) into a
//     two-slot ring: C by 16-byte cp.async from ct, X by 4-byte cp.async
//     that transposes on the way (a warp copies 4 rows x 8 features at a
//     time, 32-byte sectors of global memory, onto 32 distinct banks: a
//     row of kPX = BM + 4 words); with a tile's first chunk come its norms
//     cn (one of two slots). The next step's copies are issued right after
//     the step's barrier and run under its FMAs, so a step takes one
//     barrier;
//   * FMAs (feature_fma): thread (tx, ty) = (tid % 16, tid / 16) owns rows
//     4 ty .. 4 ty + 3 (and 64 + the same at BM = 128) and columns 4 tx ..
//     4 tx + 3 and 64 + the same (frag_row, frag_col). Per feature it reads
//     two 16-byte words of X and two of C (one and two at BM = 64): 4
//     loads for 64 FMAs and 16 operand registers, where the first design's
//     transposed scalar loads were 16 for 64. (Row-major chunks, 4
//     features of a row a load, took 32 operand registers for an 8 x 8
//     tile and spilled, or 20 loads a 256 FMAs for 4 x 16, and ran slower
//     on an H100);
//   * min/argmin (tile_fold): each thread scans its 8 columns of each row
//     in column order (d = cn - 2 acc, the strict '<' of tile_min_argmin:
//     the lower column wins a tie), then the row's 16 threads combine
//     (value, column) pairs by shuffles, halving the rows a lane holds at
//     each of the first log2(BM / 16) levels, so lane tx ends with row slot
//     tx >> (4 - log2(BM / 16)) and keeps that row's running (min, argmin).
//     Min is exact and the combine keeps the lowest column on equal values,
//     so this is the serial scan's result; the scan's NaN rule (a NaN at
//     the tile's column 0 makes the tile's minimum NaN, which never folds;
//     later NaNs never win) is kept by the pair (-inf, -1) for a NaN at
//     column 0, which wins every combine and is not folded, and +inf for a
//     NaN first column of another thread. No Ds is staged for it;
//   * FT (kFT): the expected checksums accumulate in the registers of
//     thread tid < kBK (column tid: e1^T X and e2^T X against the column's
//     C row) and kBK <= tid < kBK + BM (row tid - kBK: X's row against C's
//     e1 and e2), each an FMA chain over f in order, from the chunk's
//     encodings: C's from the pre-pass, staged with each chunk, and X's
//     computed in the first centroid tile and kept for the row tile in
//     shared memory (xenc, 2 x Fp words), both by chunk_encodings in the
//     order of 8 strided partials a feature and then their fixed-order sum
//     (one more barrier a step in the first centroid tile). At a tile's end
//     the accumulator goes to Ds, its first BM / 2 rows over the ring slot
//     the tile's last step read and the rest in a region of their own (a
//     whole Ds beside the ring would leave one block an SM), so the next
//     tile's first copy is in flight as in the other kernels; the observed
//     checksums and residuals run as before, warp 0 decodes them with
//     the reference's decode rule (locate_tile, fk_abft.cuh) and the thread
//     that holds the located element subtracts the delta in its register.
//     The simulated SEU lands after the FMAs of the same chunk as before;
//   * update: the final labels go to shared memory for emit_update (dense)
//     or emit_entries (entries), whose scratch is the ring.
// Two blocks an SM: __launch_bounds__(kThreads, 2) holds a thread to 128
// registers; the layout (F32Layout) is 70 KB at BM = 128, and the FT
// kernels' 33 KB of Ds rows and 2 x Fp words of X encodings past it.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async16b(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared-memory layout of lloyd_tile_kernel (4-byte words).
template <int BM>
struct F32Layout {
  // a slot: X's chunk then C's, both feature-major (kChunk rows of kPX =
  // BM + 4, resp. kPC = kBK + 4 words: feature f of the tile's rows)
  static constexpr int kPX = BM + 4, kPC = kBK + 4;
  static constexpr int kXs = 0, kCs = kChunk * kPX;
  static constexpr int kSlot = kCs + kChunk * kPC;
  static constexpr int kRing = 2 * kSlot;
  // Ds (BM x (kBK+1), FT): rows < BM / 2 over the ring slot just read,
  // rows >= BM / 2 in their own region past xenc (kDsHi words)
  static constexpr int kDsHi = BM / 2 * (kBK + 1);
  // the entries' checksum partials (emit_entries), over the ring once its
  // last chunk is read
  static constexpr int kDs = 0;
  static constexpr int kCn = kRing;                        // 2 x kBK
  static constexpr int kEnc = kCn + 2 * kBK;     // 2 x C's e1, e2 (kFT)
  static constexpr int kCol1 = kEnc + 4 * kChunk;          // expected
  static constexpr int kCol2 = kCol1 + kBK;
  static constexpr int kRow1 = kCol2 + kBK;
  static constexpr int kRow2 = kRow1 + BM;
  static constexpr int kResC1 = kRow2 + BM;                // residuals
  static constexpr int kResC2 = kResC1 + kBK;
  static constexpr int kResR1 = kResC2 + kBK;
  static constexpr int kResR2 = kResR1 + BM;
  static constexpr int kVerdict = kResR2 + BM;             // 4 words
  // ints of the update, used past the last tile only: over the ring, past
  // the entries' checksum partials (kThreads / 32 x 2 x 128 words at kDs)
  static constexpr int kAm = kThreads / 32 * 2 * 128;
  static constexpr int kKey = kAm + BM;
  static constexpr int kOrder = kKey + BM;
  static constexpr int kSKey = kOrder + BM;
  static constexpr int kLab = kSKey + BM;                  // final labels
  static constexpr int kXenc = kVerdict + 4;     // 2 x fp, then kDsHi (kFT)
  // pruned (never kFT): two tiles' warp bounds (2 x 8 words), the rows'
  // squared norms (BM), then the computed tiles (ntiles + 1 ints: the
  // list, then its length)
  static constexpr int kPrune = kXenc;
  static size_t bytes(bool ft, int fp, int ntiles = 0) {
    return size_t(kXenc + (ft ? 2 * fp + kDsHi : 0) +
                  (ntiles ? 16 + BM + ntiles + 1 : 0)) * 4;
  }
  static_assert(kPX % 4 == 0 && kPC % 4 == 0 && kSlot % 4 == 0 &&
                    kCn % 4 == 0 && kEnc % 4 == 0 && kXenc % 4 == 0,
                "16-byte aligned regions");
  static_assert(kDsHi <= kSlot, "Ds's low rows fit a ring slot");
  static_assert(kLab + BM <= kRing, "the update's ints fit over the ring");
};

// Thread (tx, ty) = (tid % 16, tid / 16) owns rows 4 ty + i (i < 4) and,
// at BM = 128, 64 + 4 ty + i, and columns 4 tx + j and 64 + 4 tx + j (j <
// 4): row slot i < BM / 16, column slot j < kTN, each in increasing order.
__device__ __forceinline__ int frag_row(int ty, int i) {
  return i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4;
}
__device__ __forceinline__ int frag_col(int tx, int j) {
  return j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4;
}

// One feature f of a staged chunk into the thread's kTM x kTN accumulator:
// acc[i][j] = fmaf(x[row i][f], c[col j][f], acc[i][j]). Both chunks are
// feature-major, so a 16-byte load gives 4 rows (or columns) at f.
template <int kTM>
__device__ __forceinline__ void feature_fma(float (&acc)[kTM][kTN],
                                            const float* xs, const float* cs,
                                            int tx, int ty, int f) {
  constexpr int kPX = 16 * kTM + 4, kPC = kBK + 4;
  float a[kTM], b[kTN];
  const float4 a0 = *reinterpret_cast<const float4*>(xs + f * kPX + 4 * ty);
  a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
  if constexpr (kTM == 8) {
    const float4 a1 =
        *reinterpret_cast<const float4*>(xs + f * kPX + 64 + 4 * ty);
    a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
  }
  const float4 b0 = *reinterpret_cast<const float4*>(cs + f * kPC + 4 * tx);
  const float4 b1 =
      *reinterpret_cast<const float4*>(cs + f * kPC + 64 + 4 * tx);
  b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
  b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
}

// The e1 / e2 encodings of one staged chunk over its N rows (row r's
// feature f at base[r * RS + f * FS]): partial p (0..7) sums rows p, p + 8,
// .. in order (v, and (r + 1) v by fmaf), then e = 0 + part_0 + .. +
// part_7 in that order. Warp w takes features 4 w .. 4 w + 3, lane 4 p + q
// partial p of feature 4 w + q; every lane returns its feature's sums
// (lanes q, p = 0, write).
template <int N, int RS, int FS>
__device__ __forceinline__ void chunk_encodings(const float* base, int lane,
                                                int warp, float* e1,
                                                float* e2) {
  static_assert(kThreads / 32 * 4 == kChunk, "a warp takes 4 features");
  const int p = lane / 4, q = lane % 4, f = 4 * warp + q;
  float a1 = 0.0f, a2 = 0.0f;
#pragma unroll 4
  for (int r = p; r < N; r += 8) {
    const float v = base[r * RS + f * FS];
    a1 += v;
    a2 = fmaf(float(r + 1), v, a2);
  }
  float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    s1 += __shfl_sync(0xffffffffu, a1, 4 * k + q);
    s2 += __shfl_sync(0xffffffffu, a2, 4 * k + q);
  }
  *e1 = s1;
  *e2 = s2;
}

// One combine of the min/argmin: the lower value wins, the lower column on
// equal values.
__device__ __forceinline__ void min_pair(float* v, int* c, float ov, int oc) {
  if (ov < *v || (ov == *v && oc < *c)) {
    *v = ov;
    *c = oc;
  }
}

// The pruned step's computed centroid tiles of row tile mt (skip[mt][kt]
// == 0) in order into tiles[0 ..), their count into tiles[nkt], and a
// skipped tile's bound, MIN_INIT (FLT_MAX): warp 0, 32 tiles a ballot.
// Called by all threads (a barrier); returns the count.
__device__ __forceinline__ int list_tiles(const int* __restrict__ skip,
                                          float* __restrict__ tmin, int mt,
                                          int nkt, int* tiles) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int n = 0;
    for (int k0 = 0; k0 < nkt; k0 += 32) {
      const int kt = k0 + lane;
      const bool in = kt < nkt;
      const bool skipped = in && skip[size_t(mt) * nkt + kt] != 0;
      if (skipped) tmin[size_t(mt) * nkt + kt] = FLT_MAX;
      const unsigned keep = __ballot_sync(0xffffffffu, in && !skipped);
      if (in && !skipped) tiles[n + __popc(keep & ((1u << lane) - 1u))] = kt;
      n += __popc(keep);
    }
    if (lane == 0) tiles[nkt] = n;
  }
  __syncthreads();
  return tiles[nkt];
}

// A computed tile's bound: the nw (<= 8) warps' minima of tile ordinal q,
// left in wmin[(q & 1) * 8 ..] by its epilogue, are read by warp 0 past the
// next barrier (a step's, or the update's), so the bound costs no barrier
// of its own; their min goes to the tile's cell. Called by warp 0.
__device__ __forceinline__ void write_bound(const float* wmin, int q, int nw,
                                            float* cell) {
  const int lane = threadIdx.x;
  float e = lane < nw ? wmin[(q & 1) * 8 + lane] : FLT_MAX;
  for (int off = 4; off > 0; off >>= 1)
    e = fminf(e, __shfl_xor_sync(0xffffffffu, e, off));
  if (lane == 0) *cell = e;
}

// The (value, column) pairs of N rows of a lane, reduced over the 16 lanes
// of their rows (bits off, off / 2, .. 1 of the lane's tx): at each level
// while a lane holds several rows it keeps half (the upper half where its
// bit is set) and takes the partner's pairs of that half; then plain
// combines.
template <int N>
__device__ __forceinline__ void row_reduce(float* v, int* c, int tx,
                                           int off) {
  if constexpr (N > 1) {
    const bool upper = (tx & off) != 0;
#pragma unroll
    for (int h = 0; h < N / 2; ++h) {
      const float sv = upper ? v[h] : v[h + N / 2];
      const int sc = upper ? c[h] : c[h + N / 2];
      v[h] = upper ? v[h + N / 2] : v[h];
      c[h] = upper ? c[h + N / 2] : c[h];
      min_pair(&v[h], &c[h], __shfl_xor_sync(0xffffffffu, sv, off),
               __shfl_xor_sync(0xffffffffu, sc, off));
    }
    row_reduce<N / 2>(v, c, tx, off / 2);
  } else {
    for (; off > 0; off /= 2)
      min_pair(&v[0], &c[0], __shfl_xor_sync(0xffffffffu, v[0], off),
               __shfl_xor_sync(0xffffffffu, c[0], off));
  }
}

// The min/argmin of one centroid tile folded into the running row state:
// the lane's own scan of its 8 columns, row_reduce over the row's 16 lanes,
// then fold_min by the lanes that own a row (tx % (16 / kTM) == 0; row
// slot tx >> (4 - log2 kTM)). Returns, on those lanes, the row's tile
// minimum (-inf for a NaN at the tile's column 0).
template <int kTM>
__device__ __forceinline__ float tile_fold(const float (&acc)[kTM][kTN],
                                          const float* cnt, int tx, int c0,
                                          float* best, int* best_arg) {
  float cnr[kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j) cnr[j] = cnt[frag_col(tx, j)];
  float v[kTM];
  int c[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const float d0 = cnr[0] - 2.0f * acc[i][0];
    const bool nan0 = d0 != d0;
    v[i] = nan0 ? __int_as_float(tx == 0 ? int(0xff800000u) : 0x7f800000)
                : d0;
    c[i] = nan0 && tx == 0 ? -1 : frag_col(tx, 0);
#pragma unroll
    for (int j = 1; j < kTN; ++j) {
      float d = cnr[j] - 2.0f * acc[i][j];
      if (d < v[i]) {
        v[i] = d;
        c[i] = frag_col(tx, j);
      }
    }
  }
  row_reduce<kTM>(v, c, tx, 8);
  if (tx % (16 / kTM) == 0 && c[0] >= 0)
    fold_min(best, best_arg, v[0], c[0] + c0);
  return v[0];
}

template <int BM, bool kFT, int kUpd>
__global__ void __launch_bounds__(kThreads, 2)
lloyd_tile_kernel(const float* __restrict__ x, const float* __restrict__ c,
                  const float* __restrict__ cn,
                  const float* __restrict__ cenc,
                  const int* __restrict__ inj, float* __restrict__ mind,
                  int* __restrict__ argmin, int* __restrict__ det,
                  float* __restrict__ sums,
                  float* __restrict__ counts, int* __restrict__ idx,
                  int* __restrict__ ekey, int* __restrict__ spare,
                  float* __restrict__ ucheck, float* __restrict__ ccheck,
                  const float* __restrict__ xn, const int* __restrict__ skip,
                  float* __restrict__ tmin, int kp, int fp, int bf,
                  int true_m, int levels, float thr_factor) {
  using L = F32Layout<BM>;
  constexpr int kTM = BM / 16;
  constexpr bool kPruned = kUpd == kPrunedEntries;
  static_assert(!(kFT && kPruned), "the pruned step has no ABFT");
  static_assert(kTM == 4 || kTM == 8, "row tiles of 64 or 128");
  if (kUpd == kDenseUpdate) {
    // problem blockIdx.y of a batched launch: every base pointer moves to
    // its problem's slab of nt = gridDim.x row tiles (offsets in size_t:
    // B*Mp*Fp passes 2^31). Only this instantiation, which lloyd_step and
    // lloyd_step_batched share, has the problem axis, and it reads the slab
    // size from the grid, so no instantiation takes a parameter for it
    // (with the axis, distance_argmin and distance_argmin_ft ran 2-4 %
    // slower on an H100, PERF.md).
    const size_t pb = blockIdx.y, nt = gridDim.x, mp = nt * BM;
    x += pb * mp * fp;
    c += pb * kp * fp;
    cn += pb * kp;
    mind += pb * mp;
    argmin += pb * mp;
    sums += pb * nt * kp * fp;
    counts += pb * nt * kp;
  }
  extern __shared__ __align__(16) float sm_f32[];
  float* sm = sm_f32;
  float* xencS = sm + L::kXenc;
  int* smi = reinterpret_cast<int*>(sm);

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, warp = tid / 32;
  const int mt = blockIdx.x, m0 = mt * BM;
  const int nkt = kp / kBK, nch = fp / kChunk;
  // the centroid tiles the steps walk: all, or the row tile's computed
  // ones (pruned: listed once, a skipped tile's bound set to MIN_INIT)
  float* wmin = sm + L::kPrune;
  float* xnS = wmin + 16;
  int* tiles = smi + L::kPrune + 16 + BM;
  int ntiles = nkt;
  if constexpr (kPruned) ntiles = list_tiles(skip, tmin, mt, nkt, tiles);
  const int nsteps = ntiles * nch;
  // the step after whose FMAs the distance-slot SEU lands (-1: none)
  int inj_step = -1;
  if (kFT) {
    const DistInj d = load_dist_inj(inj);
    const int ch = (d.f_tile + 1) * (bf / kChunk) - 1;
    if (d.enabled && mt == d.m_tile && d.c_tile >= 0 && d.c_tile < nkt &&
        ch >= 0 && ch < nch)
      inj_step = d.c_tile * nch + ch;
  }
  // the running state of row frag_row(ty, tx >> (4 - log2 kTM)), kept by
  // the lanes tx % (16 / kTM) == 0
  float best = FLT_MAX;
  int best_arg = 0;
  int det_count = 0;      // owned by thread 0

  // step s's copies into ring slot s % 2, feature-major: X's row tile at
  // features f0 .. f0 + 31 by 4-byte copies that transpose (warp w copies
  // blocks of 4 rows x 8 features: 32-byte sectors of global memory onto
  // 32 distinct banks, lane (lane % 4, lane / 4) its (row, feature) in the
  // block), C's centroid tile from the pre-pass's ct by 16-byte copies;
  // with a tile's first chunk its norms (slot: the tile's ordinal % 2);
  // FT: the chunk's C encodings from the pre-pass (kEnc slot s % 2).
  const int rl = lane % 4, fl = lane / 4;
  int st_q = 0, st_f0 = 0;   // the (tile ordinal, feature) stage() copies
  auto stage = [&](int s) {
    const int q = st_q, f0 = st_f0;
    const int kt = kPruned ? tiles[q] : q;
    st_f0 += kChunk;
    if (st_f0 == fp) {
      st_f0 = 0;
      ++st_q;
    }
    float* xs = sm + (s & 1) * L::kSlot + L::kXs + fl * L::kPX + rl;
    float* cs = sm + (s & 1) * L::kSlot + L::kCs;
    const float* xg = x + size_t(m0 + rl) * fp + f0 + fl;
    const float* cgl = c + size_t(f0) * kp + kt * kBK;
#pragma unroll
    for (int it = 0; it < BM / 8; ++it) {
      const int r = warp * (BM / 8) + 4 * (it / 4), f = 8 * (it % 4);
      cp_async4(xs + f * L::kPX + r, xg + size_t(r) * fp + f);
    }
#pragma unroll
    for (int it = 0; it < kChunk * kBK / 4 / kThreads; ++it) {
      const int q = tid + it * kThreads, f = q / (kBK / 4), v = q % (kBK / 4);
      cp_async16(cs + f * L::kPC + 4 * v, cgl + size_t(f) * kp + 4 * v);
    }
    if (f0 == 0 && tid < kBK / 4)
      cp_async16(sm + L::kCn + (q & 1) * kBK + 4 * tid,
                 cn + kt * kBK + 4 * tid);
    if (kFT && tid >= kThreads - 2 * kChunk / 4) {
      const int q = tid - (kThreads - 2 * kChunk / 4);   // 0 .. 15
      const int e = q / (kChunk / 4), v = q % (kChunk / 4);
      cp_async16(sm + L::kEnc + (s & 1) * 2 * kChunk + e * kChunk + 4 * v,
                 cenc + (size_t(kt) * 2 + e) * fp + f0 + 4 * v);
    }
    cp_async_commit();
  };

  // pruned: the rows' norms ride in step 0's group
  if (kPruned && nsteps > 0 && tid < BM / 4)
    cp_async16(xnS + 4 * tid, xn + m0 + 4 * tid);
  if (!kPruned || nsteps > 0) stage(0);
  int s = 0;
  constexpr int kOwnShift = kTM == 8 ? 1 : 2;
  for (int q = 0; q < ntiles; ++q) {
    const int kt = kPruned ? tiles[q] : q, c0 = kt * kBK;
    float acc[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;
    // FT: the expected checksums of column tid (tid < kBK) or of row
    // tid - kBK (kBK <= tid < kBK + BM)
    float ce1 = 0.0f, ce2 = 0.0f;

    for (int ch = 0; ch < nch; ++ch, ++s) {
      const int f0 = ch * kChunk;
      cp_async_wait_all();
      __syncthreads();
      if (kPruned && tid < 32 && ch == 0 && q > 0)
        write_bound(wmin, q - 1, kThreads / 32,
                    tmin + size_t(mt) * nkt + tiles[q - 1]);
      // the next step's copies (the next tile's first, at a tile's last
      // step) run under this one's FMAs
      if (s + 1 < nsteps) stage(s + 1);
      const float* xs = sm + (s & 1) * L::kSlot + L::kXs;
      const float* cs = sm + (s & 1) * L::kSlot + L::kCs;
      if (kFT && kt == 0) {   // X's encodings, once a row tile
        float e1, e2;
        chunk_encodings<BM, 1, L::kPX>(xs, lane, warp, &e1, &e2);
        if (lane < 4) {
          xencS[f0 + 4 * warp + lane] = e1;
          xencS[fp + f0 + 4 * warp + lane] = e2;
        }
      }
      // the chunk's FMAs, unrolled kU features at a time: the whole chunk,
      // or half of it in the FT and entries kernels at BM = 128, whose
      // extra state spilled more registers at the full unroll (ptxas)
      constexpr int kU =
          (kFT || kUpd == kEntryUpdate || kPruned) && kTM == 8 ? kChunk / 2
                                                               : kChunk;
#pragma unroll 1
      for (int f1 = 0; f1 < kChunk; f1 += kU)
#pragma unroll
        for (int u = 0; u < kU; ++u)
          feature_fma<kTM>(acc, xs, cs, tx, ty, f1 + u);
      if (kFT) {
        if (kt == 0) __syncthreads();   // X's encodings are in place
        const float* enc = sm + L::kEnc + (s & 1) * 2 * kChunk;
        if (tid < kBK) {
#pragma unroll
          for (int f = 0; f < kChunk; f += 4) {
            const float4 e1 =
                *reinterpret_cast<const float4*>(xencS + f0 + f);
            const float4 e2 =
                *reinterpret_cast<const float4*>(xencS + fp + f0 + f);
            const float w1[4] = {e1.x, e1.y, e1.z, e1.w};
            const float w2[4] = {e2.x, e2.y, e2.z, e2.w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float cv = cs[(f + k) * L::kPC + tid];
              ce1 = fmaf(w1[k], cv, ce1);
              ce2 = fmaf(w2[k], cv, ce2);
            }
          }
        } else if (tid - kBK < BM) {
          const float* xcol = xs + (tid - kBK);
#pragma unroll
          for (int f = 0; f < kChunk; f += 4) {
            const float4 e1 = *reinterpret_cast<const float4*>(enc + f);
            const float4 e2 =
                *reinterpret_cast<const float4*>(enc + kChunk + f);
            const float w1[4] = {e1.x, e1.y, e1.z, e1.w};
            const float w2[4] = {e2.x, e2.y, e2.z, e2.w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float xv = xcol[(f + k) * L::kPX];
              ce1 = fmaf(xv, w1[k], ce1);
              ce2 = fmaf(xv, w2[k], ce2);
            }
          }
        }
        // simulated SEU: after the last chunk of feature tile f_tile
        if (s == inj_step) {
          const DistInj d = load_dist_inj(inj);
#pragma unroll
          for (int i = 0; i < kTM; ++i)
#pragma unroll
            for (int j = 0; j < kTN; ++j)
              if (frag_row(ty, i) == d.row && frag_col(tx, j) == d.col)
                acc[i][j] += d.delta;
        }
      }
    }

    if (kFT) {
      // Ds: rows < BM / 2 over the slot this tile's last step read (free
      // once every warp is past its FMAs: the barrier), the rest in DsHi
      float* ds_lo = sm + ((s - 1) & 1) * L::kSlot;
      float* ds_hi = xencS + 2 * fp;
      auto ds_row = [&](int r) {
        return r < BM / 2 ? ds_lo + r * (kBK + 1)
                          : ds_hi + (r - BM / 2) * (kBK + 1);
      };
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j)
          ds_row(frag_row(ty, i))[frag_col(tx, j)] = acc[i][j];
      if (tid < kBK) {
        sm[L::kCol1 + tid] = ce1;
        sm[L::kCol2 + tid] = ce2;
      } else if (tid - kBK < BM) {
        sm[L::kRow1 + tid - kBK] = ce1;
        sm[L::kRow2 + tid - kBK] = ce2;
      }
      __syncthreads();
      if (tid < kBK) {
        float s1 = 0.0f, s2 = 0.0f;
        for (int r = 0; r < BM / 2; ++r) {
          const float v = ds_lo[r * (kBK + 1) + tid];
          s1 += v;
          s2 += float(r + 1) * v;
        }
        for (int r = BM / 2; r < BM; ++r) {
          const float v = ds_hi[(r - BM / 2) * (kBK + 1) + tid];
          s1 += v;
          s2 += float(r + 1) * v;
        }
        sm[L::kResC1 + tid] = s1 - sm[L::kCol1 + tid];
        sm[L::kResC2 + tid] = s2 - sm[L::kCol2 + tid];
      } else if (tid - kBK < BM) {
        const int r = tid - kBK;
        const float* dr = ds_row(r);
        float s1 = 0.0f, s2 = 0.0f;
        for (int cc = 0; cc < kBK; ++cc) {
          const float v = dr[cc];
          s1 += v;
          s2 += float(cc + 1) * v;
        }
        sm[L::kResR1 + r] = s1 - sm[L::kRow1 + r];
        sm[L::kResR2 + r] = s2 - sm[L::kRow2 + r];
      }
      __syncthreads();
      // warp 0 decodes (the reference's rule, locate_tile); the
      // thread that holds the located element subtracts the delta
      if (tid < 32) {
        int li, lj;
        float dl;
        const int d = locate_tile(sm + L::kCol1, sm + L::kRow1,
                                  sm + L::kResC1, sm + L::kResC2,
                                  sm + L::kResR1, sm + L::kResR2, BM, kBK,
                                  lane, thr_factor, &li, &lj, &dl);
        if (tid == 0) {
          det_count += d;
          smi[L::kVerdict] = d;
          smi[L::kVerdict + 1] = li;
          smi[L::kVerdict + 2] = lj;
          sm[L::kVerdict + 3] = dl;
        }
      }
      __syncthreads();
      if (smi[L::kVerdict]) {   // block-uniform
        const int li = smi[L::kVerdict + 1], lj = smi[L::kVerdict + 2];
        const float dl = sm[L::kVerdict + 3];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j)
            if (frag_row(ty, i) == li && frag_col(tx, j) == lj)
              acc[i][j] -= dl;
      }
    }

    const float lmin = tile_fold<kTM>(acc, sm + L::kCn + (q & 1) * kBK, tx,
                                      c0, &best, &best_arg);
    if constexpr (kPruned) {
      // the tile's bound: each owner's row distance to the tile, padding
      // rows bounding nothing (-inf, a NaN at column 0, gives 0, as the
      // serial scan's NaN), the min over the warp, then (write_bound) over
      // the block
      const int r = frag_row(ty, tx >> kOwnShift);
      float e = tx % (16 / kTM) == 0 && m0 + r < true_m
                    ? sqrtf(fmaxf(lmin + xnS[r], 0.0f))
                    : FLT_MAX;
      for (int off = 16; off > 0; off >>= 1)
        e = fminf(e, __shfl_xor_sync(0xffffffffu, e, off));
      if (lane == 0) wmin[(q & 1) * 8 + warp] = e;
    }
  }

  // the final labels, by row, for the writes and the update
  const int row = frag_row(ty, tx >> kOwnShift);
  const bool owner = tx % (16 / kTM) == 0;
  if (owner) {
    mind[m0 + row] = best;
    argmin[m0 + row] = best_arg;
  }
  if (kFT && tid == 0) det[mt] = det_count;
  if constexpr (kUpd != kNoUpdate) {
    int* lab = smi + (kUpd == kDenseUpdate ? L::kAm : L::kLab);
    __syncthreads();   // the ring is free: every warp is past its last chunk
    if (kPruned && tid < 32 && ntiles > 0)
      write_bound(wmin, ntiles - 1, kThreads / 32,
                  tmin + size_t(mt) * nkt + tiles[ntiles - 1]);
    if (owner) lab[row] = best_arg;
    __syncthreads();
    if constexpr (kUpd == kEntryUpdate || kPruned) {
      const int label = tid < BM ? lab[tid] : 0;
      const EntryOut o{sums,   counts, idx,    ekey,
                       kp,     fp,     levels, int(gridDim.x)};
      emit_entries<float, BM, kFT>(smi + L::kAm, sm + L::kDs, label, x, mt,
                                   true_m, o, inj, spare, ucheck, ccheck);
    } else {
      emit_update<float, BM>(lab, smi + L::kKey, smi + L::kOrder,
                             smi + L::kSKey, x, m0, true_m, kp, fp,
                             sums + size_t(mt) * kp * fp,
                             counts + size_t(mt) * kp);
    }
  }
}

// The f32 tile kernel's pre-pass, once a call (it depends on C alone): C
// feature-major, ct (Fp, Kp) a problem, the layout its stage() copies 16
// bytes at a time, and, for the FT instantiations, C's e1 / e2 encodings
// per centroid tile, cenc (Kp / kBK, 2, Fp) a problem, by chunk_encodings
// over the same staged chunk layout (the order of the 8 strided partials
// a feature, then their fixed-order sum). Block (chunk, centroid tile,
// problem). Bound by the bytes of C, read once and written once.
__global__ void __launch_bounds__(kThreads)
lloyd_prep_kernel(const float* __restrict__ c, float* __restrict__ ct,
                  float* __restrict__ cenc, int kp, int fp) {
  constexpr int kPC = kBK + 4;
  __shared__ __align__(16) float cs[kChunk * kPC];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int f0 = blockIdx.x * kChunk, kt = blockIdx.y, c0 = kt * kBK;
  const size_t pb = blockIdx.z;
  c += pb * kp * fp;
  ct += pb * kp * fp;
  // the chunk feature-major, by the tile kernel's lane map: warp w reads
  // blocks of 4 rows x 8 features (32-byte sectors; 32 distinct banks)
  const int rl = lane % 4, fl = lane / 4;
#pragma unroll
  for (int it = 0; it < kBK / 8; ++it) {
    const int r = warp * (kBK / 8) + 4 * (it / 4) + rl, f = 8 * (it % 4) + fl;
    cs[f * kPC + r] = c[size_t(c0 + r) * fp + f0 + f];
  }
  __syncthreads();
  for (int q = tid; q < kChunk * kBK; q += kThreads) {
    const int f = q / kBK, r = q % kBK;
    ct[size_t(f0 + f) * kp + c0 + r] = cs[f * kPC + r];
  }
  if (cenc != nullptr) {
    float e1, e2;
    chunk_encodings<kBK, 1, kPC>(cs, lane, warp, &e1, &e2);
    if (lane < 4) {
      float* e = cenc + (pb * (kp / kBK) + kt) * 2 * fp + f0 + 4 * warp + lane;
      e[0] = e1;
      e[fp] = e2;
    }
  }
}

// --- bf16 / fp16: the tile kernel on the tensor cores ----------------------
// lloyd_tile_mma_kernel<T, BM, kFT, kUpd> is lloyd_tile_kernel above with
// its f32 product replaced by MmaProduct<T, BM>: mma.sync m16n8k16 with f32
// accumulation, each accumulator one chain of k16 steps over the features
// in order from 0.0f, so any staging that feeds the same instruction the
// same operands in that order gives the same bits. The loop is the int8
// kernel's (int8_tile_kernel below):
//   * staging: X's row tile is copied once a block by 16-byte cp.async at a
//     pitch of Fp + 8 elements (ldmatrix's 8 rows of a matrix on distinct
//     banks) and kept for every centroid tile where it fits (MmaLayout: at
//     most kMmaStashMax bytes, and two blocks an SM), else X's chunk streams
//     with C's. C's chunks (with a tile's first chunk its norms cn, by tile
//     ordinal into one of kMmaStages slots; at kFT with its 8 split encoding
//     rows) run through a ring of kMmaStages slots: the copies of step s +
//     kMmaStages - 1 are issued right after step s's barrier and run under
//     its MMAs, so a step takes one barrier. A step is ck features: 64 with
//     X kept (four k16 steps), 32 where X streams or at kFT;
//   * fragments: ldmatrix_x4 (fk_mma.cuh) over X's rows and C's, the 8
//     warps tiling the BM x 128 accumulator 2 x 4, each warp (BM/2) x 32 as
//     (BM/32) x 4 m16n8 fragments: a k16 step takes BM/32 + 2 ldmatrix.x4
//     and BM/8 MMAs;
//   * epilogue in registers, no Ds (kFT false): each lane forms d = cn - 2
//     acc over its fragment columns (tile_min_argmin's d), scans them in
//     column order with a strict '<', the quad combines (value, column)
//     pairs by shuffles and the 4 warps of a row band through shared memory
//     (min_pair), and the row's owner (thread tid < BM) folds the tile with
//     fold_min: the serial scan's result (tile_fold's and the int8 kernel's
//     rule; a NaN at the tile's column 0 becomes (-inf, -1), never folded);
//   * pruned (kPrunedEntries): the row tile's computed centroid tiles are
//     listed in shared memory once (a skipped tile's bound is MIN_INIT), the
//     steps walk that list, so the ring prefetches the next computed tile,
//     and each computed tile writes its bound from the owners' tile minima,
//     tmin = min over valid rows of sqrt(max(lmin + xn, 0)) (0 for the
//     (-inf, -1) pair, as the serial scan's NaN gives); the update is the
//     entries, as kEntryUpdate's.
// Its ABFT (kFT) is the paper's tensor-core scheme (as the 2-byte ABFT
// GEMM's, fk_abft_gemm.cu), where the f32 kernel's runs on the CUDA cores:
//   * C's e1 / e2 encodings over each centroid tile come once a step from
//     lloyd_encode_kernel, split into three T parts a value (cenc (Kp/kBK,
//     8, Fp): rows 0-2 e1 2^-7, rows 3-5 e2 2^-14, rows 6-7 zero), staged
//     with each C chunk as 8 more rows. The expected row checksums X C^T e
//     are one more n8 fragment of mma.sync a k-step (chk): warp w takes its
//     m fragment w % 4, so each row is done once and a warp adds one MMA to
//     its 16; at the tile's end a quad's shuffles gather the parts, summed
//     (hi + mid) + lo and scaled back;
//   * X's e1 / e2 encodings over the row tile are computed once, in the
//     first centroid tile, from the staged chunks (8 partials a feature,
//     then a fixed-order sum), and kept in shared memory (2 x Fp floats); the
//     expected column checksums e^T X C^T are CUDA-core FMAs on them with no
//     barrier of their own: lane 4g + q of warp w takes columns 16 w + g and
//     16 w + g + 8, words q, q + 4, .. of the staged C rows (conflict-free),
//     and a quad's shuffles sum the four partials at the tile's end;
//   * the observed checksums are sums over the stored tile in shared memory
//     (Ds, laid over the ring: at kFT the ring prefetches no further than
//     the tile's own chunks, so at its end the ring is idle, and the next
//     tile's first copies are issued once Ds is read): a row's in the pass
//     that takes its min / argmin (tile_min_argmin <true>), a column's by
//     one more thread (conflict-free; all 256 threads at BM = 128), in the
//     same step as the residuals and the block's maxima; a tile that detects
//     is decoded (locate_tile, fk_abft.cuh), corrected and scanned again
//     (taking the sums from the accumulator registers by warp shuffles
//     instead made ptxas spill under the 128-register cap, and ran slower);
//   * detection (the threshold rule on the expected side), location by the
//     e2/e1 ratio, correction in Ds and the first-min are the f32 kernel's
//     rule; the block first takes the same maxima (residuals, expected
//     side) from its warps' maxima, so warp 0's decode runs only on a tile
//     that detects;
//   * two blocks an SM at every instantiation (__launch_bounds__ min 2: at
//     most 128 registers a thread, and MmaLayout's bytes within
//     kTwoBlockBytes). Left to itself ptxas took 128 and more registers for
//     the first design's kernels, one block an SM; on an H100 every variant
//     then ran slower, the distance-only one by 40 % and the batched one by
//     57 % at M = 2^20, F = 128, K = 1000 and the PQ shape.
constexpr int kMmaStages = 3;               // ring slots
constexpr int kMmaStashMax = 48 * 1024;     // bytes of X's row tile kept whole
constexpr int kMmaPad = 8;                  // elements past a staged row
constexpr int kMmaWide = 64;                // features a step with X kept
constexpr size_t kTwoBlockBytes = 113 * 1024;   // a block's, two an SM
constexpr size_t kMmaEntryScratch = 8 * 1024;   // the FT writer's partials

// Shared-memory layout of lloyd_tile_mma_kernel (byte offsets, each
// 16-byte aligned): X's stash at 0 (BM rows of xpitch elements) when kept;
// at un the ring (kMmaStages slots: C's chunk, at kFT its 8 encoding rows,
// then X's chunk when X streams), with at kFT Ds (BM x (kBK + 1) f32) over
// it and past the last tile the update's scratch; cn (kMmaStages x kBK);
// the row bands' (value, column) pairs (4 x BM, kFT false); at kFT the
// expected and residual checksums (col1, col2, resC1, resC2, then row1,
// row2, resR1, resR2), the expected column sums [kBK][2] followed by X's
// encodings' partials (2 x 8 x kChunk, also the warps' maxima), the
// detection count and the injection's step (16 bytes), then X's encodings
// (2 x Fp); pruned: two tiles' warp bounds (2 x 8), the rows' squared
// norms (BM), the computed tiles (ntiles + 1 ints: the list, then its
// length).
struct MmaLayout {
  bool stash;
  int ck, cpitch, xpitch;
  size_t slot, un, cn, xch, chk, part, xenc, prune, bytes;
  __host__ __device__ MmaLayout(int bm, int fp, bool ft, int ntiles) {
    place(bm, fp, ft, ntiles,
          size_t(bm) * (fp + kMmaPad) * 2 <= size_t(kMmaStashMax));
    if (stash && bytes > kTwoBlockBytes) place(bm, fp, ft, ntiles, false);
  }
  __host__ __device__ void place(int bm, int fp, bool ft, int ntiles,
                                 bool s) {
    stash = s;
    ck = s && !ft && fp >= kMmaWide ? kMmaWide : kChunk;
    cpitch = ck + kMmaPad;
    xpitch = s ? fp + kMmaPad : cpitch;
    un = s ? size_t(bm) * xpitch * 2 : 0;
    slot = size_t(kBK + (ft ? 8 : 0) + (s ? 0 : bm)) * cpitch * 2;
    size_t body = kMmaStages * slot;
    if (ft && size_t(bm) * (kBK + 1) * 4 > body)
      body = size_t(bm) * (kBK + 1) * 4;
    cn = un + (body + 15) / 16 * 16;
    xch = cn + size_t(kMmaStages) * kBK * 4;
    chk = xch + (ft ? 0 : size_t(4) * bm * 8);
    part = chk + (ft ? size_t(4) * (kBK + bm) * 4 : 0);
    xenc = part + (ft ? size_t(2) * (kBK + 8 * kChunk) * 4 + 16 : 0);
    prune = xenc + (ft ? size_t(2) * fp * 4 : 0);
    bytes = prune + (ntiles ? size_t(16 + bm + ntiles + 1) * 4 : 0);
  }
};

// MmaProduct: the accumulator of a warp's fragments and its operations.
// Warp w owns rows (w / 4) * BM/2 .. + BM/2 and columns (w % 4) * 32 .. + 32,
// as kMF x kNF m16n8 fragments (fk_mma.cuh); element (i, j, 2 h + e) of lane
// 4 g + t is row r0 + 16 i + g + 8 h, column n0 + 8 j + 2 t + e.
template <typename T, int BM>
struct MmaProduct {
  static constexpr int kWM = BM / 2;                 // rows of a warp
  static constexpr int kMF = kWM / 16, kNF = 32 / 8;
  static_assert(sizeof(T) == 2, "2-byte input types only");
  static_assert(kMF == 2 || kMF == 4, "row tiles of 64 or 128");
  static_assert(kThreads / 32 * 16 == kBK, "a warp's 16 expected columns");

  // the expected column checksums' FMAs of one staged kChunk-feature chunk
  // (C's rows at cs, pitch cp): this lane's columns 16 w + g (+ 8), words
  // q + 4 s, on the chunk's X encodings e1 / e2
  __device__ __forceinline__ static void col_fma(const T* cs, int cp,
                                                 const float* e1p,
                                                 const float* e2p,
                                                 float* ce1, float* ce2) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int col = 16 * warp + lane / 4, q = lane % 4;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int f = 2 * (q + 4 * s);
      const float2 e1 = *reinterpret_cast<const float2*>(e1p + f);
      const float2 e2 = *reinterpret_cast<const float2*>(e2p + f);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t w = ld32(cs + (col + 8 * h) * cp + f);
        const T* v = reinterpret_cast<const T*>(&w);
        const float v0 = to_f32(v[0]), v1 = to_f32(v[1]);
        ce1[h] = fmaf(e1.y, v1, fmaf(e1.x, v0, ce1[h]));
        ce2[h] = fmaf(e2.y, v1, fmaf(e2.x, v0, ce2[h]));
      }
    }
  }

  // a lane's expected column partials summed over its quad, into
  // part[col * 2]
  __device__ __forceinline__ static void col_out(float* part, float* ce1,
                                                 float* ce2) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float a = ce1[h], b = ce2[h];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, off);
        b += __shfl_xor_sync(0xffffffffu, b, off);
      }
      if (lane % 4 == 0) {
        const int col = 16 * warp + lane / 4 + 8 * h;
        part[col * 2] = a;
        part[col * 2 + 1] = b;
      }
    }
  }
  float acc[kMF][kNF][4];
  float chk[4];   // expected row checksums: row g / g + 8, parts 2t, 2t + 1

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kMF; ++i)
#pragma unroll
      for (int j = 0; j < kNF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
#pragma unroll
    for (int e = 0; e < 4; ++e) chk[e] = 0.0f;
  }

  // nk k16 steps of one staged chunk, in feature order: X's rows at xs
  // (pitch xp elements), C's at cs (pitch cp; kChk: C's 8 encoding rows
  // below them, rows kBK ..). This lane's ldmatrix rows: X's matrices rows
  // r0 + 0..7 / 8..15 at +0 / +8 elements, C's rows n0 + 0..7 / 8..15 of a
  // pair of n8 fragments at +0 / +8.
  template <bool kChk>
  __device__ __forceinline__ void mac(const T* xs, int xp, const T* cs,
                                      int cp, int nk) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = (warp / 4) * kWM, n0 = (warp % 4) * 32;
    const T* ap =
        xs + (r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * xp + 8 * (lane >> 4);
    const T* bp =
        cs + (n0 + (lane & 7) + 8 * (lane >> 4)) * cp + 8 * ((lane >> 3) & 1);
    const T* ep = cs + (kBK + g) * cp + 2 * t;
    auto kstep = [&](int kk) {
      uint32_t b[kNF][2];
#pragma unroll
      for (int jj = 0; jj < kNF / 2; ++jj) {
        uint32_t r[4];
        ldmatrix_x4(r, bp + 16 * jj * cp + 16 * kk);
        b[2 * jj][0] = r[0];
        b[2 * jj][1] = r[1];
        b[2 * jj + 1][0] = r[2];
        b[2 * jj + 1][1] = r[3];
      }
      uint32_t e0 = 0, e1 = 0;
      if (kChk) {
        e0 = ld32(ep + 16 * kk);
        e1 = ld32(ep + 16 * kk + 8);
      }
#pragma unroll
      for (int i = 0; i < kMF; ++i) {
        uint32_t a[4];
        ldmatrix_x4(a, ap + 16 * i * xp + 16 * kk);
#pragma unroll
        for (int j = 0; j < kNF; ++j)
          mma_16816<T>(acc[i][j], a, b[j][0], b[j][1]);
        if (kChk && i == warp % 4) mma_16816<T>(chk, a, e0, e1);
      }
    };
    // kChk: the k16 steps stay a loop (unrolled, the FT kernels' extra
    // state spilled under the 128-register cap)
    if constexpr (kChk) {
#pragma unroll 1
      for (int kk = 0; kk < nk; ++kk) kstep(kk);
    } else {
      for (int kk = 0; kk < nk; ++kk) kstep(kk);
    }
  }

  // element e of fragment (i, j) of this lane: row r0 + 16 i + g + 8 (e / 2),
  // column n0 + 8 j + 2 t + e % 2
  __device__ __forceinline__ void add_at(int row, int col, float delta) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = (warp / 4) * kWM, n0 = (warp % 4) * 32;
#pragma unroll
    for (int i = 0; i < kMF; ++i)
#pragma unroll
      for (int j = 0; j < kNF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (r0 + 16 * i + g + 8 * (e / 2) == row &&
              n0 + 8 * j + 2 * t + e % 2 == col)
            acc[i][j][e] += delta;
  }

  __device__ __forceinline__ void store(float* Ds) const {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = (warp / 4) * kWM, n0 = (warp % 4) * 32;
#pragma unroll
    for (int i = 0; i < kMF; ++i)
#pragma unroll
      for (int j = 0; j < kNF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          Ds[(r0 + 16 * i + g + 8 * (e / 2)) * (kBK + 1) + n0 + 8 * j + 2 * t +
             e % 2] = acc[i][j][e];
  }

  // The finished tile's expected row checksums from chk into erow1 /
  // erow2. Called by all threads.
  __device__ __forceinline__ void expected_rows(float* erow1,
                                                float* erow2) const {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = (warp / 4) * kWM;
    // chk: lane 4g + t holds parts 2t, 2t + 1 of rows g and g + 8 (e1 hi,
    // mid, lo, e2 hi, mid, lo, 0, 0); lane 4g gathers them
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float p0 = chk[2 * h], p1 = chk[2 * h + 1];
      const float p2 = __shfl_down_sync(0xffffffffu, p0, 1);
      const float p3 = __shfl_down_sync(0xffffffffu, p1, 1);
      const float p4 = __shfl_down_sync(0xffffffffu, p0, 2);
      const float p5 = __shfl_down_sync(0xffffffffu, p1, 2);
      if (warp % 4 < kMF && t == 0) {
        const int r = r0 + 16 * (warp % 4) + g + 8 * h;
        erow1[r] = ldexpf((p0 + p1) + p2, kEnc1Shift);
        erow2[r] = ldexpf((p3 + p4) + p5, kEnc2Shift);
      }
    }
  }

  // The tile's (value, column) of each of this lane's rows: d = cn - 2 acc
  // over its fragment columns in column order (the strict '<' of
  // tile_min_argmin; a NaN first column: (-inf, -1) at the tile's column 0,
  // else +inf), combined over the quad (min_pair); lane t = 0 writes row
  // band (w % 4)'s pair of each row to xch[(w % 4) * BM + row].
  __device__ __forceinline__ void scan(const float* cnt, float2* xch) const {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = (warp / 4) * kWM, n0 = (warp % 4) * 32;
    float cnr[kNF][2];
#pragma unroll
    for (int j = 0; j < kNF; ++j) {
      const float2 v = *reinterpret_cast<const float2*>(cnt + n0 + 8 * j +
                                                         2 * t);
      cnr[j][0] = v.x;
      cnr[j][1] = v.y;
    }
    const bool col0 = n0 == 0 && t == 0;   // the lane of the tile's column 0
#pragma unroll
    for (int i = 0; i < kMF; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = 0.0f;
        int col = 0;
#pragma unroll
        for (int j = 0; j < kNF; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float d = cnr[j][e] - 2.0f * acc[i][j][2 * h + e];
            const int cc = n0 + 8 * j + 2 * t + e;
            if (j == 0 && e == 0) {
              const bool nan0 = d != d;
              v = nan0 ? __int_as_float(col0 ? int(0xff800000u) : 0x7f800000)
                       : d;
              col = nan0 && col0 ? -1 : cc;
            } else if (d < v) {
              v = d;
              col = cc;
            }
          }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1)
          min_pair(&v, &col, __shfl_xor_sync(0xffffffffu, v, off),
                   __shfl_xor_sync(0xffffffffu, col, off));
        if (t == 0)
          xch[(warp % 4) * BM + r0 + 16 * i + g + 8 * h] =
              make_float2(v, __int_as_float(col));
      }
  }
};

template <typename T, int BM, bool kFT, int kUpd>
__global__ void __launch_bounds__(kThreads, 2)
lloyd_tile_mma_kernel(const T* __restrict__ x, const T* __restrict__ c,
                      const float* __restrict__ cn,
                      const T* __restrict__ cenc,
                      const int* __restrict__ inj, float* __restrict__ mind,
                      int* __restrict__ argmin, int* __restrict__ det,
                      float* __restrict__ sums,
                      float* __restrict__ counts, int* __restrict__ idx,
                      int* __restrict__ ekey, int* __restrict__ spare,
                      float* __restrict__ ucheck, float* __restrict__ ccheck,
                      const float* __restrict__ xn,
                      const int* __restrict__ skip, float* __restrict__ tmin,
                      int kp, int fp, int bf, int true_m, int levels,
                      float thr_factor) {
  using P = MmaProduct<T, BM>;
  constexpr bool kPruned = kUpd == kPrunedEntries;
  static_assert(kUpd != kDenseUpdate, "the 2-byte batched step writes entries");
  static_assert(!(kFT && kPruned), "the pruned step has no ABFT");
  if (kUpd == kBatchedEntries) {
    // problem blockIdx.y of a batched launch: the one instantiation that
    // lloyd_step_batched launches moves X's, C's, cn's and the labels' base
    // pointers to its problem's slab (a slab of 2-byte X is mp * fp * 2
    // bytes, fp a multiple of 32: 16-byte alignment holds) and its idx to
    // the problem's kp rows; its entries go to rows pb * mp .. (the tile's
    // writer, EntryOut::row0, below). Every other line is lloyd_step's, so
    // problem b runs, bit for bit, the code one problem's launch runs.
    const size_t pb = blockIdx.y, nt = gridDim.x, mp = nt * BM;
    x += pb * mp * fp;
    c += pb * kp * fp;
    cn += pb * kp;
    mind += pb * mp;
    argmin += pb * mp;
    idx += (pb * kp) << levels;
  }
  extern __shared__ __align__(16) unsigned char sm_mma[];
  const int nkt = kp / kBK;
  const MmaLayout L(BM, fp, kFT, kPruned ? nkt : 0);
  T* stash = reinterpret_cast<T*>(sm_mma);
  unsigned char* ring = sm_mma + L.un;
  float* Ds = reinterpret_cast<float*>(ring);   // kFT: over the ring
  float* cnS = reinterpret_cast<float*>(sm_mma + L.cn);
  float2* xch = reinterpret_cast<float2*>(sm_mma + L.xch);
  float* part = reinterpret_cast<float*>(sm_mma + L.part);
  float* xpart = part + 2 * kBK;   // also the warps' maxima
  float* xencS = reinterpret_cast<float*>(sm_mma + L.xenc);
  // kFT: the row tile's detections, and the step after whose MMAs the
  // distance slot lands (-1: none), in shared memory: as registers they
  // spilled under the 128-register cap
  int* det_count = reinterpret_cast<int*>(xpart + 2 * 8 * kChunk);
  int* inj_step = det_count + 1;
  float* wmin = reinterpret_cast<float*>(sm_mma + L.prune);
  float* xnS = wmin + 16;
  int* tiles = reinterpret_cast<int*>(xnS + BM);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int mt = blockIdx.x, m0 = mt * BM;
  // a step's features and staged pitch: constants at kFT (kChunk, which
  // the injection's chunk rule and the column checksums' FMAs take)
  const int ck = kFT ? kChunk : L.ck, cpitch = kFT ? kChunk + kMmaPad
                                                   : L.cpitch;
  const int nch = (fp + ck - 1) / ck, erows = kFT ? 8 : 0;
  // the injection's step: centroid tile c_tile, the last chunk of feature
  // tile f_tile (kFT: ck = kChunk); the rest of the descriptor is read
  // where it lands
  if (kFT && tid == 0) {
    *det_count = 0;
    *inj_step = -1;
    const int ch = (inj[3] + 1) * (bf / kChunk) - 1;
    if (inj[0] && inj[1] == mt && inj[2] >= 0 && inj[2] < nkt && ch >= 0 &&
        ch < nch)
      *inj_step = inj[2] * nch + ch;
  }
  // the centroid tiles the steps walk: all, or the row tile's computed ones
  int ntiles = nkt;
  if constexpr (kPruned) ntiles = list_tiles(skip, tmin, mt, nkt, tiles);
  const int nsteps = ntiles * nch;

  // the copies of step s (tile ordinal s / nch, chunk s % nch) into its
  // slot as one cp.async group; an empty group past the last step or where
  // real is false (kFT: a step of a later tile than the current one)
  auto issue = [&](int s, bool real) {
    if (real && s < nsteps) {
      const int q = s / nch, ch = s - q * nch;
      const int kt = kPruned ? tiles[q] : q;
      const int f0 = ch * ck, words = min(ck, fp - f0) / 8;
      const int wpr = ck / 8;   // 16-byte words a staged row
      T* slot = reinterpret_cast<T*>(ring + size_t(s % kMmaStages) * L.slot);
      for (int i = tid; i < kBK * wpr; i += kThreads) {
        const int r = i / wpr, v = i - r * wpr;
        if (v < words)
          cp_async16b(slot + r * cpitch + 8 * v,
                      c + size_t(kt * kBK + r) * fp + f0 + 8 * v);
      }
      if (kFT && tid < 8 * wpr) {
        const int r = tid / wpr, v = tid - r * wpr;
        if (v < words)
          cp_async16b(slot + (kBK + r) * cpitch + 8 * v,
                      cenc + size_t(kt * 8 + r) * fp + f0 + 8 * v);
      }
      if (!L.stash)
        for (int i = tid; i < BM * wpr; i += kThreads) {
          const int r = i / wpr, v = i - r * wpr;
          if (v < words)
            cp_async16b(slot + (kBK + erows + r) * cpitch + 8 * v,
                        x + size_t(m0 + r) * fp + f0 + 8 * v);
        }
      if (ch == 0 && tid < kBK / 4)
        cp_async16b(cnS + (q % kMmaStages) * kBK + 4 * tid,
                    cn + size_t(kt) * kBK + 4 * tid);
    }
    cp_async_commit();
  };

  if (L.stash) {   // X's row tile, in step 0's group
    const int words = fp / 8;
    for (int i = tid; i < BM * words; i += kThreads) {
      const int r = i / words, v = i - r * words;
      cp_async16b(stash + r * L.xpitch + 8 * v,
                  x + size_t(m0 + r) * fp + 8 * v);
    }
  }
  if (kPruned && tid < BM / 4)   // the rows' norms, in step 0's group
    cp_async16b(xnS + 4 * tid, xn + m0 + 4 * tid);
#pragma unroll
  for (int s = 0; s < kMmaStages - 1; ++s) issue(s, !kFT || s < nch);

  P prod;
  prod.zero();
  float ce1[2] = {0.0f, 0.0f}, ce2[2] = {0.0f, 0.0f};
  float best = FLT_MAX;   // running row state, owned by thread tid < BM
  int best_arg = 0;

  for (int s = 0, q = 0, ch = 0; s < nsteps; ++s) {
    cp_async_wait<kMmaStages - 2>();
    __syncthreads();
    if (kPruned && tid < 32 && ch == 0 && q > 0)
      write_bound(wmin, q - 1, BM / 32, tmin + size_t(mt) * nkt + tiles[q - 1]);
    issue(s + kMmaStages - 1, !kFT || (s + kMmaStages - 1) / nch == q);
    const T* cs = reinterpret_cast<const T*>(ring +
                                             size_t(s % kMmaStages) * L.slot);
    const int f0 = ch * ck;
    const T* xs = L.stash ? stash + f0 : cs + (kBK + erows) * cpitch;
    const int xp = L.stash ? L.xpitch : cpitch;
    prod.template mac<kFT>(xs, xp, cs, cpitch,
                           kFT ? kChunk / 16 : min(ck, fp - f0) / 16);
    if (kFT) {
      if (q == 0) {
        // X's encodings of the chunk, once a row tile: 8 partials a
        // feature, then a fixed-order sum, kept for the later tiles
        {
          const int f = tid % kChunk, sp = tid / kChunk;
          float x1 = 0.0f, x2 = 0.0f;
          for (int r = sp; r < BM; r += 8) {
            const float v = to_f32(xs[r * xp + f]);
            x1 += v;
            x2 = fmaf(float(r + 1), v, x2);
          }
          xpart[(0 * 8 + sp) * kChunk + f] = x1;
          xpart[(1 * 8 + sp) * kChunk + f] = x2;
        }
        __syncthreads();
        if (tid < 2 * kChunk) {
          const int h = tid / kChunk, f = tid % kChunk;
          float sum = 0.0f;
          for (int p = 0; p < 8; ++p) sum += xpart[(h * 8 + p) * kChunk + f];
          xencS[h * fp + f0 + f] = sum;
        }
        __syncthreads();
      }
      // expected column checksums on the CUDA cores: e^T X_chunk C_chunk^T
      P::col_fma(cs, cpitch, xencS + f0, xencS + fp + f0, ce1, ce2);
      // simulated SEU: after the last chunk of feature tile f_tile, into
      // the accumulator element of the thread (lane) that holds it
      if (s == *inj_step) {
        const DistInj dinj = load_dist_inj(inj);
        prod.add_at(dinj.row, dinj.col, dinj.delta);
      }
    }
    if (++ch < nch) continue;

    // the tile's end
    ch = 0;
    const int kt = kPruned ? tiles[q] : q, c0 = kt * kBK;
    const float* cq = cnS + (q % kMmaStages) * kBK;
    if (kFT) {
      float* col1 = reinterpret_cast<float*>(sm_mma + L.chk);
      float* col2 = col1 + kBK;
      float* resc1 = col2 + kBK;
      float* resc2 = resc1 + kBK;
      float* row1 = resc2 + kBK;
      float* row2 = row1 + BM;
      float* resr1 = row2 + BM;
      float* resr2 = resr1 + BM;
      __syncthreads();   // every warp is past its reads of the ring
      prod.store(Ds);
      prod.expected_rows(row1, row2);
      P::col_out(part, ce1, ce2);
      __syncthreads();
      // the observed checksums of Ds: row tid's in its min/argmin pass,
      // column tid - BM's by thread tid (conflict-free, all 256 threads at
      // BM = 128); residuals against the expected ones, and the block's
      // largest |residual| and |expected| (locate_tile's detection rule)
      // from the warps' maxima
      float lmin = 0.0f;   // row tid < BM's (min, argmin) in this tile
      int larg = 0;
      float res = 0.0f, mag = 0.0f;
      if (tid < BM) {
        float o1, o2;
        tile_min_argmin<true>(Ds + tid * (kBK + 1), cq, c0, &lmin, &larg,
                              &o1, &o2);
        const float e1 = row1[tid];
        resr1[tid] = o1 - e1;
        resr2[tid] = o2 - row2[tid];
        res = fabsf(o1 - e1);
        mag = fabsf(e1);
      } else if (tid - BM < kBK) {
        const int cc = tid - BM;
        float o1 = 0.0f, o2 = 0.0f;
        for (int r = 0; r < BM; ++r) {
          const float v = Ds[r * (kBK + 1) + cc];
          o1 += v;
          o2 = fmaf(float(r + 1), v, o2);
        }
        const float e1 = part[cc * 2];
        col1[cc] = e1;
        resc1[cc] = o1 - e1;
        resc2[cc] = o2 - part[cc * 2 + 1];
        res = fabsf(o1 - e1);
        mag = fabsf(e1);
      }
      float* wmax = xpart;   // [warp][2]
      res = warp_max(res);
      mag = warp_max(mag);
      if (lane == 0) {
        wmax[2 * warp] = res;
        wmax[2 * warp + 1] = mag;
      }
      __syncthreads();
      for (int w = 0; w < kThreads / 32; ++w) {
        res = fmaxf(res, wmax[2 * w]);
        mag = fmaxf(mag, wmax[2 * w + 1]);
      }
      if (res > thr_factor * fmaxf(mag, 1.0f)) {  // uniform
        // a detecting tile: decode and correct Ds, then its rows' min /
        // argmin again on the corrected tile
        if (tid < 32) {
          int li, lj;
          float dl;
          const int d = locate_tile(col1, row1, resc1, resc2, resr1, resr2,
                                    BM, kBK, lane, thr_factor, &li, &lj, &dl);
          if (tid == 0 && d) {
            ++*det_count;
            Ds[li * (kBK + 1) + lj] -= dl;
          }
        }
        __syncthreads();
        if (tid < BM)
          tile_min_argmin(Ds + tid * (kBK + 1), cq, c0, &lmin, &larg);
      }
      if (tid < BM) fold_min(&best, &best_arg, lmin, larg);
      __syncthreads();   // Ds is read: the ring takes the next tile's copies
#pragma unroll
      for (int i = 1; i < kMmaStages; ++i) issue(s + i, (s + i) / nch == q + 1);
      ce1[0] = ce1[1] = ce2[0] = ce2[1] = 0.0f;
    } else {
      prod.scan(cq, xch);
      __syncthreads();
      if (tid < BM) {
        const float2 p = xch[tid];
        float v = p.x;
        int col = __float_as_int(p.y);
#pragma unroll
        for (int w = 1; w < 4; ++w) {
          const float2 o = xch[w * BM + tid];
          min_pair(&v, &col, o.x, __float_as_int(o.y));
        }
        if (col >= 0) fold_min(&best, &best_arg, v, col + c0);
        if (kPruned) {
          // the row's Euclidean distance to this tile; padding rows bound
          // nothing (a (-inf, -1) pair gives 0, as the serial scan's NaN)
          float e = m0 + tid < true_m ? sqrtf(fmaxf(v + xnS[tid], 0.0f))
                                      : FLT_MAX;
          for (int off = 16; off > 0; off >>= 1)
            e = fminf(e, __shfl_xor_sync(0xffffffffu, e, off));
          if (lane == 0) wmin[(q & 1) * 8 + warp] = e;
        }
      }
    }
    prod.zero();
    ++q;
  }
  cp_async_wait<0>();

  if (tid < BM) {
    mind[m0 + tid] = best;
    argmin[m0 + tid] = best_arg;
  }
  if (kFT && tid == 0) det[mt] = *det_count;
  if constexpr (kUpd == kEntryUpdate || kUpd == kBatchedEntries || kPruned) {
    __syncthreads();   // the ring is free: every warp is past its last read
    if (kPruned && tid < 32 && ntiles > 0)
      write_bound(wmin, ntiles - 1, BM / 32,
                  tmin + size_t(mt) * nkt + tiles[ntiles - 1]);
    EntryOut o{sums, counts, idx, ekey, kp, fp, levels, int(gridDim.x)};
    if (kUpd == kBatchedEntries) o.row0 = size_t(blockIdx.y) * gridDim.x * BM;
    emit_entries<T, BM, kFT>(
        reinterpret_cast<int*>(ring + (kFT ? kMmaEntryScratch : 0)),
        reinterpret_cast<float*>(ring), best_arg, x, mt, true_m, o, inj,
        spare, ucheck, ccheck);
  }
}

// C's split encodings for lloyd_tile_mma_kernel's row checksums, once a
// step: thread (centroid tile kt = blockIdx.y, feature f) sums e1 = sum_j
// C[kt kBK + j][f] and e2 = sum_j (j + 1) C[..][f] over the tile's kBK rows
// in j order (2-byte values widened, exactly) and writes e1 2^-kEnc1Shift
// and e2 2^-kEnc2Shift, each split into three T parts (split3), as cenc
// rows kt * 8 + 0..5, zeros in rows 6-7. Reads C once.
template <typename T>
__global__ void __launch_bounds__(kThreads)
lloyd_encode_kernel(const T* __restrict__ c, T* __restrict__ cenc, int fp) {
  const int kt = blockIdx.y, f = blockIdx.x * kThreads + threadIdx.x;
  if (f >= fp) return;
  float e1 = 0.0f, e2 = 0.0f;
  for (int j = 0; j < kBK; ++j) {
    const float v = to_f32(c[(size_t(kt) * kBK + j) * fp + f]);
    e1 += v;
    e2 = fmaf(float(j + 1), v, e2);
  }
  T p[8];
  split3(ldexpf(e1, -kEnc1Shift), p[0], p[1], p[2]);
  split3(ldexpf(e2, -kEnc2Shift), p[3], p[4], p[5]);
  p[6] = p[7] = from_f32<T>(0.0f);
#pragma unroll
  for (int q = 0; q < 8; ++q) cenc[(size_t(kt) * 8 + q) * fp + f] = p[q];
}

// emit_update on the argmin rows of row tiles, one block per tile: tile
// blockIdx.x, or the one tile *tile when tile is given. When gate is given
// the launch is a no-op while *gate == 0. Tile index and gate live on the
// device, so a caller that recomputes on a mismatch never synchronises.
template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
update_tiles_kernel(const T* __restrict__ x,
                    const int* __restrict__ argmin,
                    const int* __restrict__ tile, const int* __restrict__ gate,
                    float* __restrict__ sums, float* __restrict__ counts,
                    int kp, int fp, int true_m) {
  using L = UpdLayout<BM>;
  __shared__ int smi[L::kWords];
  if (gate != nullptr && *gate == 0) return;
  const int mt = tile != nullptr ? *tile : int(blockIdx.x);
  const int m0 = mt * BM, tid = threadIdx.x;
  if (tid < BM) smi[L::kAm + tid] = argmin[m0 + tid];
  emit_update<T, BM>(smi + L::kAm, smi + L::kKey, smi + L::kOrder,
                     smi + L::kSKey, x, m0, true_m, kp, fp,
                     sums + size_t(mt) * kp * fp, counts + size_t(mt) * kp);
}

// --- the int8 tile kernel: s8 tensor cores, an epilogue in registers ------
// int8_tile_kernel<BM> (one block of 256 threads a row tile of BM rows, a
// walk over the centroid tiles of kBK = 128 in feature chunks of up to
// kI8Chunk = 128 int8 values, one ring step each):
//   * products: mma.sync m16n8k32 s8 -> s32 (fk_mma.cuh). The 8 warps tile
//     the BM x 128 block 2 x 4: warp w owns rows (w / 4) BM/2 .. + BM/2 and
//     columns (w % 4) 32 .. + 32 as (BM/32) x 4 m16n8 fragments, and a
//     32-deep k-step takes BM/32 + 2 ldmatrix.x4 and BM/8 MMAs. The sums
//     are exact int32 while Fp 128^2 < 2^31 (check_int8 refuses a wider
//     Fp), so any order gives the integers the first design's __dp4a gave;
//   * staging: X's row tile is copied once a block by 16-byte cp.async and
//     kept for every centroid tile (the reference's stash) where BM (Fp +
//     16) <= kI8StashMax bytes, else X's chunk streams with C's. C's chunks
//     (with a tile's first chunk its scales sc and norms cn) run through a
//     ring of kI8Stages slots: the copies of step s + kI8Stages - 1 are
//     issued right after step s's barrier and run under its MMAs and
//     epilogue, so a step takes one barrier. Rows lie at a pitch of the
//     chunk + 16 bytes: ldmatrix's 8 rows of a matrix on distinct banks;
//   * epilogue in registers, no Ds: at a tile's last chunk each lane turns
//     its accumulators into d = cn_j - 2 (sx_i (float(acc_ij) sc_j)), in
//     that order and rounded at each step (__fmul_rn, __fsub_rn: nothing
//     contracts), the reference's _scaled_acc and tile_min_argmin's d; it
//     scans its 8 columns of a row in column order with a strict '<', the
//     quad combines (value, column) pairs by shuffles and the 4 warps of a
//     row band through shared memory (min_pair: the lower value, the lower
//     column on equal values), and the row's owner (thread tid < BM) folds
//     the tile with fold_min. That is the serial scan's result: min is
//     exact, and the scan's NaN rule is tile_fold's (a NaN at the tile's
//     column 0 becomes (-inf, -1), which wins every combine and is never
//     folded; a NaN first column of another lane starts its scan at +inf).
// Bound on the H100: 2 Mp Kp Fp int8 operations at 1,979 Tera-op/s (0.136
// ms at M = 2^20, K = 1000, F = 128, above X's bytes); the epilogue's
// ~7 CUDA-core operations a distance, 2^30 distances there, come next, so
// mma.sync (not wgmma) feeds the tensor cores fast enough. Two blocks an
// SM: __launch_bounds__(kThreads, 2), 81 KB of shared memory at BM = 128
// and Fp = 128.
constexpr int kI8Chunk = 128;             // int8 features a ring step
constexpr int kI8Pitch = kI8Chunk + 16;   // bytes a staged chunk row
constexpr int kI8Stages = 3;              // ring slots
constexpr int kI8StashMax = 48 * 1024;    // bytes of X's row tile kept whole
// the widest Fp whose int32 sums are exact for any int8 values
constexpr int kI8MaxFeatures = (0x7fffffff / (128 * 128));


// Shared-memory layout of int8_tile_kernel (byte offsets, each 16-byte
// aligned): X's stash at 0 (BM rows of Fp + 16 bytes) when it fits, the
// ring (kI8Stages slots: C's chunk, then X's when X streams), the tiles'
// sc and cn (kBK floats each, a pair a slot, by centroid tile), the rows'
// sx, the row bands' (value, column) pairs (4 x BM).
struct Int8Layout {
  bool stash;
  int xpitch;
  size_t slot, ring, par, sx, xch, bytes;
  __host__ __device__ Int8Layout(int bm, int fp) {
    stash = size_t(bm) * (fp + 16) <= size_t(kI8StashMax);
    xpitch = stash ? fp + 16 : kI8Pitch;
    slot = size_t(kBK + (stash ? 0 : bm)) * kI8Pitch;
    ring = stash ? size_t(bm) * xpitch : 0;
    par = ring + kI8Stages * slot;
    sx = par + size_t(kI8Stages) * 2 * kBK * 4;
    xch = sx + size_t(bm) * 4;
    bytes = xch + size_t(4) * bm * 8;
  }
};

template <int BM>
__global__ void __launch_bounds__(kThreads, 2)
int8_tile_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ cq,
                 const float* __restrict__ sx, const float* __restrict__ sc,
                 const float* __restrict__ cn, float* __restrict__ mind,
                 int* __restrict__ argmin, int kp, int fp) {
  constexpr int kWM = BM / 2, kMF = kWM / 16, kNF = 4;
  static_assert(kMF == 2 || kMF == 4, "row tiles of 64 or 128");
  extern __shared__ __align__(16) unsigned char sm_i8[];
  const Int8Layout L(BM, fp);
  unsigned char* ring = sm_i8 + L.ring;
  float* par = reinterpret_cast<float*>(sm_i8 + L.par);
  float* sxS = reinterpret_cast<float*>(sm_i8 + L.sx);
  float2* xch = reinterpret_cast<float2*>(sm_i8 + L.xch);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = (warp / 4) * kWM, n0 = (warp % 4) * 32;
  const int m0 = blockIdx.x * BM;
  const int nkt = kp / kBK, nch = (fp + kI8Chunk - 1) / kI8Chunk;
  const int nsteps = nkt * nch;

  // the copies of step s (centroid tile s / nch, chunk s % nch) into its
  // slot as one cp.async group; an empty group past the last step
  auto issue = [&](int s) {
    if (s < nsteps) {
      const int kt = s / nch, f0 = (s % nch) * kI8Chunk;
      const int words = min(kI8Chunk, fp - f0) / 16;
      unsigned char* slot = ring + size_t(s % kI8Stages) * L.slot;
      for (int i = tid; i < kBK * 8; i += kThreads) {
        const int r = i / 8, q = i % 8;
        if (q < words)
          cp_async16b(slot + r * kI8Pitch + 16 * q,
                      cq + size_t(kt * kBK + r) * fp + f0 + 16 * q);
      }
      if (!L.stash)
        for (int i = tid; i < BM * 8; i += kThreads) {
          const int r = i / 8, q = i % 8;
          if (q < words)
            cp_async16b(slot + (kBK + r) * kI8Pitch + 16 * q,
                        xq + size_t(m0 + r) * fp + f0 + 16 * q);
        }
      if (f0 == 0 && tid < kBK / 2) {
        float* p = par + (kt % kI8Stages) * 2 * kBK;
        const int h = tid / (kBK / 4), q = tid % (kBK / 4);
        cp_async16b(p + h * kBK + 4 * q,
                    (h == 0 ? sc : cn) + size_t(kt) * kBK + 4 * q);
      }
    }
    cp_async_commit();
  };

  if (tid < BM) sxS[tid] = sx[m0 + tid];
  if (L.stash) {   // X's row tile, in step 0's group
    const int words = fp / 16;
    for (int i = tid; i < BM * words; i += kThreads) {
      const int r = i / words, q = i - r * words;
      cp_async16b(sm_i8 + r * L.xpitch + 16 * q,
                  xq + size_t(m0 + r) * fp + 16 * q);
    }
  }
#pragma unroll
  for (int s = 0; s < kI8Stages - 1; ++s) issue(s);

  int acc[kMF][kNF][4];
#pragma unroll
  for (int i = 0; i < kMF; ++i)
#pragma unroll
    for (int j = 0; j < kNF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  float best = FLT_MAX;   // running row state, owned by thread tid < BM
  int best_arg = 0;

  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<kI8Stages - 2>();
    __syncthreads();
    issue(s + kI8Stages - 1);
    const int kt = s / nch, ch = s % nch;
    const unsigned char* cs = ring + size_t(s % kI8Stages) * L.slot;
    const unsigned char* xs =
        L.stash ? sm_i8 + ch * kI8Chunk : cs + kBK * kI8Pitch;
    const int nk = min(kI8Chunk, fp - ch * kI8Chunk) / 32;
    // this lane's ldmatrix rows: C's matrices (rows n0 + 0..7 / 8..15,
    // bytes +0 / +16) and X's (rows r0 + 0..7 / 8..15, bytes +0 / +16)
    const unsigned char* bp = cs + (n0 + (lane & 7) + 8 * (lane >> 4)) *
                                       kI8Pitch + 16 * ((lane >> 3) & 1);
    const unsigned char* ap = xs + (r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                                       L.xpitch + 16 * (lane >> 4);
    for (int kk = 0; kk < nk; ++kk) {
      uint32_t b[kNF][2];
#pragma unroll
      for (int jj = 0; jj < kNF / 2; ++jj) {
        uint32_t r[4];
        ldmatrix_x4(r, bp + 16 * jj * kI8Pitch + 32 * kk);
        b[2 * jj][0] = r[0];
        b[2 * jj][1] = r[1];
        b[2 * jj + 1][0] = r[2];
        b[2 * jj + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < kMF; ++i) {
        uint32_t a[4];
        ldmatrix_x4(a, ap + 16 * i * L.xpitch + 32 * kk);
#pragma unroll
        for (int j = 0; j < kNF; ++j)
          mma_s8_16832(acc[i][j], a, b[j][0], b[j][1]);
      }
    }
    if (ch != nch - 1) continue;

    // the tile's epilogue: element (i, j, 2 h + e) of this lane is row r0
    // + 16 i + g + 8 h, column n0 + 8 j + 2 t + e
    const int c0 = kt * kBK;
    const float* scS = par + (kt % kI8Stages) * 2 * kBK;
    float scr[kNF][2], cnr[kNF][2];
#pragma unroll
    for (int j = 0; j < kNF; ++j) {
      const float2 a =
          *reinterpret_cast<const float2*>(scS + n0 + 8 * j + 2 * t);
      const float2 b =
          *reinterpret_cast<const float2*>(scS + kBK + n0 + 8 * j + 2 * t);
      scr[j][0] = a.x;
      scr[j][1] = a.y;
      cnr[j][0] = b.x;
      cnr[j][1] = b.y;
    }
    const bool col0 = n0 == 0 && t == 0;   // the lane of the tile's column 0
#pragma unroll
    for (int i = 0; i < kMF; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 16 * i + g + 8 * h;
        const float sxr = sxS[row];
        float v = 0.0f;
        int col = 0;
#pragma unroll
        for (int j = 0; j < kNF; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float w = __fmul_rn(
                sxr, __fmul_rn(__int2float_rn(acc[i][j][2 * h + e]),
                               scr[j][e]));
            const float d = __fsub_rn(cnr[j][e], __fmul_rn(2.0f, w));
            const int cc = n0 + 8 * j + 2 * t + e;
            if (j == 0 && e == 0) {
              const bool nan0 = d != d;
              v = nan0 ? __int_as_float(col0 ? int(0xff800000u) : 0x7f800000)
                       : d;
              col = nan0 && col0 ? -1 : cc;
            } else if (d < v) {
              v = d;
              col = cc;
            }
          }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1)
          min_pair(&v, &col, __shfl_xor_sync(0xffffffffu, v, off),
                   __shfl_xor_sync(0xffffffffu, col, off));
        if (t == 0)
          xch[(warp % 4) * BM + row] = make_float2(v, __int_as_float(col));
      }
    __syncthreads();
    if (tid < BM) {
      const float2 p = xch[tid];
      float v = p.x;
      int col = __float_as_int(p.y);
#pragma unroll
      for (int w = 1; w < 4; ++w) {
        const float2 q = xch[w * BM + tid];
        min_pair(&v, &col, q.x, __float_as_int(q.y));
      }
      if (col >= 0) fold_min(&best, &best_arg, v, col + c0);
    }
#pragma unroll
    for (int i = 0; i < kMF; ++i)
#pragma unroll
      for (int j = 0; j < kNF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  }
  cp_async_wait<0>();

  if (tid < BM) {
    mind[m0 + tid] = best;
    argmin[m0 + tid] = best_arg;
  }
}

// One k-means++ D^2 round: problem blockIdx.y, row tile blockIdx.x of bn
// rows of its (np, f) stack. For every row
//   d2o = min(d2, max(xn - 2 <x, c> + ||c||^2, 0))
// and ts[problem, tile] = the tile's sum of d2o. Padded rows come in with
// d2 = 0 and stay 0. The block stages kRoundRows rows x kChunk features of
// its tile in shared memory (consecutive threads read consecutive floats),
// thread r dots row r with the centroid row in feature order, and the tile
// sum is each thread's rows in order, a warp butterfly, then the 8 warp
// partials in order: no atomics, the same bits on every run.
__global__ void __launch_bounds__(kThreads)
kmeanspp_round_kernel(const float* __restrict__ x,
                      const float* __restrict__ xn,
                      const float* __restrict__ c,
                      const float* __restrict__ d2, float* __restrict__ d2o,
                      float* __restrict__ ts, int np, int f, int bn) {
  __shared__ float xs[kRoundRows * (kChunk + 1)];
  __shared__ float cs[kChunk];
  __shared__ float wsum[kThreads / 32];
  const int tid = threadIdx.x;
  const size_t b = blockIdx.y;
  const size_t tile0 = b * np + size_t(blockIdx.x) * bn;
  c += b * f;
  float part = 0.0f;
  for (int s0 = 0; s0 < bn; s0 += kRoundRows) {
    const int rows = min(kRoundRows, bn - s0);
    const float* xt = x + (tile0 + s0) * f;
    float cross = 0.0f, cn = 0.0f;
    for (int f0 = 0; f0 < f; f0 += kChunk) {
      const int cw = min(kChunk, f - f0);
      __syncthreads();  // the previous chunk is consumed
      if (tid < cw) cs[tid] = c[f0 + tid];
      for (int e = tid; e < rows * cw; e += kThreads) {
        const int r = e / cw, q = e - r * cw;
        xs[r * (kChunk + 1) + q] = xt[size_t(r) * f + f0 + q];
      }
      __syncthreads();
      for (int q = 0; q < cw; ++q) cn = fmaf(cs[q], cs[q], cn);
      if (tid < rows)
        for (int q = 0; q < cw; ++q)
          cross = fmaf(xs[tid * (kChunk + 1) + q], cs[q], cross);
    }
    if (tid < rows) {
      const size_t r = tile0 + s0 + tid;
      const float nd = fmaxf(xn[r] - 2.0f * cross + cn, 0.0f);
      const float v = fminf(d2[r], nd);
      d2o[r] = v;
      part += v;
    }
  }
  part = warp_sum(part);
  if (tid % 32 == 0) wsum[tid / 32] = part;
  __syncthreads();
  if (tid == 0) {
    float s = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) s += wsum[w];
    ts[b * gridDim.x + blockIdx.x] = s;
  }
}

// the tile kernel of input type T: the f32 kernel or the tensor-core one
template <typename T, int BM, bool kFT, int kUpd>
constexpr auto tile_kernel() {
  if constexpr (std::is_same<T, float>::value)
    return lloyd_tile_kernel<BM, kFT, kUpd>;
  else
    return lloyd_tile_mma_kernel<T, BM, kFT, kUpd>;
}

// dynamic shared memory of a tile kernel: the f32 kernel's F32Layout (with
// X's encodings, 2 x fp words, at kFT) or the 2-byte kernels' MmaLayout;
// pruned, with the list of the kp / kBK centroid tiles
template <typename T, int BM, bool kFT, int kUpd>
size_t tile_bytes(int fp, int kp) {
  const int ntiles = kUpd == kPrunedEntries ? kp / kBK : 0;
  if constexpr (std::is_same<T, float>::value)
    return F32Layout<BM>::bytes(kFT, fp, ntiles);
  else
    return MmaLayout(BM, fp, kFT, ntiles).bytes;
}

// A kernel's resources with `bytes` of dynamic shared memory: out[0]
// resident blocks an SM, out[1] registers a thread, out[2] local-memory
// bytes a thread (spills), out[3] dynamic shared memory bytes.
template <typename K>
int kernel_resources(K kernel, size_t bytes, int* out) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (e != cudaSuccess) return int(e);
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return int(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel,
                                                    kThreads, bytes);
  out[1] = attr.numRegs;
  out[2] = int(attr.localSizeBytes);
  out[3] = int(bytes);
  return int(e);
}

// A tile kernel's resources at one (T, BM, kFT, kUpd), Fp = fp and Kp =
// kp (the pruned mode's list of centroid tiles).
template <typename T, int BM, bool kFT, int kUpd>
int tile_resources(int fp, int kp, int* out) {
  return kernel_resources(tile_kernel<T, BM, kFT, kUpd>(),
                          tile_bytes<T, BM, kFT, kUpd>(fp, kp), out);
}

// tile_resources at bm 64 or 128, ft 0 / 1 and upd (a kUpd: 0 none, 1
// dense (f32), 2 entries, 3 batched entries (2 bytes), 4 pruned entries;
// ft only with 0 or 2)
template <typename T>
int tile_resources_of(int bm, int ft, int upd, int fp, int kp, int* out) {
  const int v = (bm == 128 ? 100 : bm == 64 ? 0 : -1000) + 10 * ft + upd;
  constexpr bool kF32 = std::is_same<T, float>::value;
  switch (v) {
    case 0: return tile_resources<T, 64, false, kNoUpdate>(fp, kp, out);
    case 2: return tile_resources<T, 64, false, kEntryUpdate>(fp, kp, out);
    case 4: return tile_resources<T, 64, false, kPrunedEntries>(fp, kp, out);
    case 10: return tile_resources<T, 64, true, kNoUpdate>(fp, kp, out);
    case 12: return tile_resources<T, 64, true, kEntryUpdate>(fp, kp, out);
    case 100: return tile_resources<T, 128, false, kNoUpdate>(fp, kp, out);
    case 102: return tile_resources<T, 128, false, kEntryUpdate>(fp, kp, out);
    case 104:
      return tile_resources<T, 128, false, kPrunedEntries>(fp, kp, out);
    case 110: return tile_resources<T, 128, true, kNoUpdate>(fp, kp, out);
    case 112: return tile_resources<T, 128, true, kEntryUpdate>(fp, kp, out);
    default: break;
  }
  if constexpr (kF32) {
    if (v == 1) return tile_resources<T, 64, false, kDenseUpdate>(fp, kp, out);
    if (v == 101)
      return tile_resources<T, 128, false, kDenseUpdate>(fp, kp, out);
  } else {
    if (v == 3)
      return tile_resources<T, 64, false, kBatchedEntries>(fp, kp, out);
    if (v == 103)
      return tile_resources<T, 128, false, kBatchedEntries>(fp, kp, out);
  }
  return int(cudaErrorInvalidValue);
}

// A tile kernel's outputs and scratch past its distances: the FT ones (cenc
// C's encodings, the injection descriptor, det), the dense update's (sums,
// counts) or the entries' (sums, counts as entries, ecnt; idx, ekey, spare,
// levels), the update checksums, the pruned step's. Pointers an
// instantiation does not use are null.
template <typename T>
struct TileArgs {
  const T* cenc;
  const int* inj;
  int* det;
  float* sums;
  float* counts;
  int* idx;
  int* ekey;
  int* spare;
  float* ucheck;
  float* ccheck;
  int levels;
  float thr_factor;
  const float* xn;   // pruned: the rows' squared norms, the skip mask and
  const int* skip;   // the tile bounds out
  float* tmin;
};

template <typename T, int BM, bool kFT, int kUpd>
int launch_tile(const T* x, const T* c, const float* cn, float* mind,
                int* argmin, const TileArgs<T>& a, int nb, int mp, int kp,
                int fp, int bf, int true_m, cudaStream_t stream) {
  auto kernel = tile_kernel<T, BM, kFT, kUpd>();
  const size_t bytes = tile_bytes<T, BM, kFT, kUpd>(fp, kp);
  // the kernels stage X, C, cn (the FT kernels' cenc, the pruned ones' xn)
  // 16 bytes a copy (cp.async)
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(c) |
       reinterpret_cast<uintptr_t>(cn) | reinterpret_cast<uintptr_t>(a.cenc) |
       reinterpret_cast<uintptr_t>(a.xn)) %
      16)
    return int(cudaErrorMisalignedAddress);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (e != cudaSuccess) return int(e);
  kernel<<<dim3(mp / BM, nb), kThreads, bytes, stream>>>(
      x, c, cn, a.cenc, a.inj, mind, argmin, a.det, a.sums, a.counts, a.idx, a.ekey, a.spare, a.ucheck, a.ccheck, a.xn, a.skip, a.tmin, kp,
      fp, bf, true_m, a.levels, a.thr_factor);
  return int(cudaGetLastError());
}

template <typename T, bool kFT, int kUpd>
int dispatch(int bm, const T* x, const T* c, const float* cn, float* mind,
             int* argmin, const TileArgs<T>& a, int nb, int mp, int kp,
             int fp, int bf, int true_m, cudaStream_t stream) {
  if ((bm != 64 && bm != 128) || mp % bm || kp % kBK || bf < kChunk ||
      bf % kChunk || fp % bf || nb < 1 || nb > kMaxProblems ||
      (nb > 1 && kUpd != kDenseUpdate && kUpd != kBatchedEntries) ||
      (kUpd == kBatchedEntries && size_t(nb) * mp > size_t(INT_MAX)) ||
      (kFT && a.cenc == nullptr) ||
      (kUpd == kPrunedEntries &&
       (a.xn == nullptr || a.skip == nullptr || a.tmin == nullptr)))
    return int(cudaErrorInvalidValue);
  if (bm == 128)
    return launch_tile<T, 128, kFT, kUpd>(x, c, cn, mind, argmin, a, nb, mp,
                                          kp, fp, bf, true_m, stream);
  return launch_tile<T, 64, kFT, kUpd>(x, c, cn, mind, argmin, a, nb, mp, kp,
                                       fp, bf, true_m, stream);
}

// the entries' tree levels of mp / bm row tiles (0 when mp does not split)
inline int entry_levels(int mp, int bm) {
  return (bm == 64 || bm == 128) && mp > 0 && mp % bm == 0
             ? tree_levels(mp / bm)
             : 0;
}

// C's split encodings (lloyd_encode_kernel): c (kp, fp) 2-byte, cenc
// (kp / kBK, 8, fp)
template <typename T>
int launch_encode(const T* c, T* cenc, int kp, int fp, cudaStream_t s) {
  if (kp <= 0 || kp % kBK || fp <= 0 || fp % kChunk || kp / kBK > 65535)
    return int(cudaErrorInvalidValue);
  lloyd_encode_kernel<T><<<dim3((fp + kThreads - 1) / kThreads, kp / kBK),
                           kThreads, 0, s>>>(c, cenc, fp);
  return int(cudaGetLastError());
}

// emit_update alone over n_tiles row tiles, or the one tile *tile
template <typename T>
int launch_update(const T* x, const int* argmin, const int* tile,
                  const int* gate, float* sums, float* counts, int true_m,
                  int kp, int fp, int bm, int n_tiles, cudaStream_t s) {
  const int grid = tile != nullptr ? 1 : n_tiles;
  if (grid < 1) return int(cudaErrorInvalidValue);
  if (bm == 128)
    update_tiles_kernel<T, 128><<<grid, kThreads, 0, s>>>(
        x, argmin, tile, gate, sums, counts, kp, fp, true_m);
  else if (bm == 64)
    update_tiles_kernel<T, 64><<<grid, kThreads, 0, s>>>(
        x, argmin, tile, gate, sums, counts, kp, fp, true_m);
  else
    return int(cudaErrorInvalidValue);
  return int(cudaGetLastError());
}

// Runs fn(Tag<T>{}) for the 2-byte type named by half: 0 __nv_bfloat16,
// 1 __half (the *_lp entry points' dtype code).
template <typename T>
struct Tag {
  using type = T;
};
template <typename Fn>
int by_half(int half, Fn fn) {
  if (half == 0) return fn(Tag<__nv_bfloat16>{});
  if (half == 1) return fn(Tag<__half>{});
  return int(cudaErrorInvalidValue);
}

template <int BM>
int launch_int8(const int8_t* xq, const int8_t* cq, const float* sx,
                const float* sc, const float* cn, float* mind, int* argmin,
                int mp, int kp, int fp, cudaStream_t stream) {
  if (fp > kI8MaxFeatures) return int(cudaErrorInvalidValue);
  // 16-byte copies of X's and C's rows and of sc, cn
  if ((reinterpret_cast<uintptr_t>(xq) | reinterpret_cast<uintptr_t>(cq) |
       reinterpret_cast<uintptr_t>(sc) | reinterpret_cast<uintptr_t>(cn)) %
      16)
    return int(cudaErrorMisalignedAddress);
  auto kernel = int8_tile_kernel<BM>;
  const size_t bytes = Int8Layout(BM, fp).bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (e != cudaSuccess) return int(e);
  kernel<<<mp / BM, kThreads, bytes, stream>>>(xq, cq, sx, sc, cn, mind,
                                               argmin, kp, fp);
  return int(cudaGetLastError());
}

// --- DMR centroid update (centroid_update_dmr) ------------------------------
// Bucket each slab's rows by cluster (a stable counting sort), then gather:
// a warp owns (slab, a chunk of one cluster's bucket, a feature group),
// knows its rows ahead and keeps kDmrGroup row loads in flight. See the
// header of this file and kernels/centroid_update_dmr.py.
constexpr int kDmrChunk = 512;        // bucket rows a gather warp walks
constexpr int kDmrGroup = 8;          // rows it loads at once
constexpr int kDmrHistRows = 1024;    // rows a bucketing warp walks (least)
constexpr int kDmrHistCells = 1 << 17;  // clusters x chunks of a slab, most
constexpr int kDmrScanThreads = 1024;
constexpr int kDmrPrefetch = 8;       // 32-row groups of labels a warp loads
constexpr int kDmrScanBatch = 4;      // 16-byte loads a lane has in flight

// The launch's scratch: int offsets (pos, off, cst, items, nitems, idx,
// wcnt) and float offsets (part, red), in elements.
struct DmrPlan {
  int slabs, hrows, nch, hstride, cap, nred;
  size_t pos, off, cst, items, nitems, idx, wcnt, ints;
  size_t part, red, floats;
};

DmrPlan dmr_plan(int m, int f, int k, int slab_rows) {
  DmrPlan p;
  p.slabs = m > slab_rows ? (m + slab_rows - 1) / slab_rows : 1;
  p.hrows = kDmrHistRows < slab_rows ? kDmrHistRows : slab_rows;
  p.nch = (slab_rows + p.hrows - 1) / p.hrows;
  while ((long long)k * p.nch > kDmrHistCells && p.hrows < slab_rows) {
    p.hrows = 2 * p.hrows < slab_rows ? 2 * p.hrows : slab_rows;
    p.nch = (slab_rows + p.hrows - 1) / p.hrows;
  }
  p.hstride = (k * p.nch + 3) / 4 * 4;   // a slab's cells, 16-byte rows
  // a slab's chunks: sum over clusters of ceil(n_a / kDmrChunk)
  p.cap = (slab_rows + kDmrChunk - 1) / kDmrChunk + k;
  p.nred = int((size_t(k) * f + kThreads - 1) / kThreads);
  const size_t s = size_t(p.slabs);
  p.pos = 0;
  p.off = p.pos + s * p.hstride;
  p.cst = p.off + s * (k + 1);
  p.items = p.cst + s * k;
  p.nitems = p.items + s * p.cap;
  p.idx = p.nitems + s;
  p.wcnt = p.idx + size_t(m > 0 ? m : 1);
  p.ints = p.wcnt + s * p.cap;
  p.part = 0;
  p.red = 2 * s * p.cap * f;
  p.floats = p.red + size_t(p.nred) * 3;
  return p;
}

// Passes 1 and 3: warp (slab s, chunk c) walks its rows 32 at a time in
// row order, kDmrPrefetch groups of labels loaded at once, each group's
// rows of one cluster found by __match_any_sync. Pass 1 (kPlace false)
// counts them into the cell pos[s hstride + a nch + c]; the counts do not
// depend on the order. Pass 3 (kPlace true), after the scan has made each
// cell the first free bucket slot of that chunk's rows of that cluster,
// places each row at the cell's next slot plus its rank among the group's
// rows of its cluster, so each bucket holds its rows in row order,
// whatever order the warps run in. Each cell is one warp's, so its
// integer atomics return the slots in the warp's order.
template <bool kPlace>
__global__ void __launch_bounds__(kThreads)
dmr_bucket_kernel(const int* __restrict__ assign, int* __restrict__ pos,
                  int* __restrict__ idx, int m, int k, int slab_rows,
                  DmrPlan p) {
  const int lane = threadIdx.x & 31;
  const int gw = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (gw >= p.slabs * p.nch) return;
  const int s = gw / p.nch, c = gw - s * p.nch;
  const int r0 = s * slab_rows + c * p.hrows;
  const int r1 = min(min(r0 + p.hrows, s * slab_rows + slab_rows), m);
  int* cell = pos + size_t(s) * p.hstride + c;
  for (int g = r0; g < r1; g += 32 * kDmrPrefetch) {
    int lab[kDmrPrefetch];
#pragma unroll
    for (int u = 0; u < kDmrPrefetch; ++u) {
      const int r = g + 32 * u + lane;
      lab[u] = r < r1 ? __ldg(assign + r) : -1;
    }
#pragma unroll
    for (int u = 0; u < kDmrPrefetch; ++u) {
      const int a = lab[u];
      const bool valid = a >= 0 && a < k;
      const unsigned peers = __match_any_sync(0xffffffffu, valid ? a : -1);
      const int leader = __ffs(peers) - 1;
      int first = 0;
      if (valid && lane == leader)
        first = atomicAdd(cell + size_t(a) * p.nch, __popc(peers));
      if constexpr (kPlace) {
        first = __shfl_sync(0xffffffffu, first, leader);
        if (valid)
          idx[first + __popc(peers & ((1u << lane) - 1u))] =
              g + 32 * u + lane;
      }
    }
  }
}

// Exclusive prefix of v over the block's threads (in thread order), and
// the block's total; wsum holds 33 ints.
__device__ int block_exclusive_scan(int v, int* wsum, int& total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) wsum[w] = incl;
  __syncthreads();
  if (w == 0) {
    const int x = lane < nw ? wsum[lane] : 0;
    int xi = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, xi, o);
      if (lane >= o) xi += t;
    }
    wsum[lane] = xi - x;
    if (lane == 31) wsum[32] = xi;
  }
  __syncthreads();
  const int r = wsum[w] + incl - v;
  total = wsum[32];
  __syncthreads();
  return r;
}

// Pass 2, a block a slab: the histogram's exclusive scan in (cluster,
// chunk) order turns each cell into the slab's first bucket position of
// that chunk's rows of that cluster (pos, absolute in idx); off[a] is
// cluster a's bucket start in the slab (off[k]: the slab's valid rows);
// then each cluster's ceil(n_a / kDmrChunk) gather items from cst[a], in
// cluster order, items[t] naming the cluster of item t, nitems the count.
__global__ void __launch_bounds__(kDmrScanThreads)
dmr_scan_kernel(int* __restrict__ pos, int* __restrict__ off,
                int* __restrict__ cst, int* __restrict__ items,
                int* __restrict__ nitems, int k, int slab_rows, DmrPlan p) {
  __shared__ int wsum[33];
  const int s = blockIdx.x, t = threadIdx.x, lane = t & 31, w = t >> 5;
  int* cell = pos + size_t(s) * p.hstride;
  int* o = off + size_t(s) * (k + 1);
  // warp w scans the cells [e0, e1) (e0 a multiple of 128), each lane 4
  // cells of a 16-byte load, kDmrScanBatch loads in flight
  const int n = k * p.nch;
  constexpr int kSpan = 128 * kDmrScanBatch;
  const int per = (n + kDmrScanThreads / 32 - 1) / (kDmrScanThreads / 32);
  const int seg = (per + 127) / 128 * 128;
  const int e0 = min(w * seg, n), e1 = min(e0 + seg, n);
  const int4* cell4 = reinterpret_cast<const int4*>(cell);
  auto load = [&](int g, int4* v) {
#pragma unroll
    for (int b = 0; b < kDmrScanBatch; ++b) {
      const int e = g + 128 * b + 4 * lane;   // cells past e1 are padding
      v[b] = e < e1 ? cell4[e / 4] : make_int4(0, 0, 0, 0);
    }
  };
  int sum = 0;
  for (int g = e0; g < e1; g += kSpan) {
    int4 v[kDmrScanBatch];
    load(g, v);
#pragma unroll
    for (int b = 0; b < kDmrScanBatch; ++b) sum += v[b].x + v[b].y + v[b].z
                                                   + v[b].w;
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, d);
  int total;
  int run = block_exclusive_scan(lane == 0 ? sum : 0, wsum, total);
  run = __shfl_sync(0xffffffffu, run, 0);
  const int base = s * slab_rows;
  for (int g = e0; g < e1; g += kSpan) {
    int4 v[kDmrScanBatch];
    load(g, v);
#pragma unroll
    for (int b = 0; b < kDmrScanBatch; ++b) {
      const int c4[4] = {v[b].x, v[b].y, v[b].z, v[b].w};
      const int mine = c4[0] + c4[1] + c4[2] + c4[3];
      int incl = mine;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += u;
      }
      int excl = run + incl - mine;
      const int e = g + 128 * b + 4 * lane;
      int out[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (e + q < e1 && (e + q) % p.nch == 0) o[(e + q) / p.nch] = excl;
        out[q] = base + excl;
        excl += c4[q];
      }
      if (e < e1)
        reinterpret_cast<int4*>(cell)[e / 4] =
            make_int4(out[0], out[1], out[2], out[3]);
      run += __shfl_sync(0xffffffffu, incl, 31);
    }
  }
  if (t == 0) o[k] = total;
  __syncthreads();
  const int perk = (k + kDmrScanThreads - 1) / kDmrScanThreads;
  const int a0 = min(t * perk, k), a1 = min(a0 + perk, k);
  int nc = 0;
  for (int a = a0; a < a1; ++a)
    nc += (o[a + 1] - o[a] + kDmrChunk - 1) / kDmrChunk;
  int ctotal;
  int crun = block_exclusive_scan(nc, wsum, ctotal);
  int* cs = cst + size_t(s) * k;
  int* it = items + size_t(s) * p.cap;
  for (int a = a0; a < a1; ++a) {
    const int na = (o[a + 1] - o[a] + kDmrChunk - 1) / kDmrChunk;
    cs[a] = crun;
    for (int j = 0; j < na; ++j) it[crun + j] = a;
    crun += na;
  }
  if (t == 0) nitems[s] = ctotal;
}

// Pass 4: warp (item t of slab s, feature group blockIdx.z) walks the
// item's chunk of its cluster's bucket: up to kDmrChunk rows, in row
// order, kDmrGroup rows loaded at once (V features a lane: 16-byte loads
// when V = 4). The primary replica adds a group's rows in ascending order,
// the shadow the same loaded values in descending order within the group,
// each into its own registers; rows past the chunk add +0.0 (exact: a sum
// from +0.0 is never -0.0). Writes the item's two partials and, for the
// shadow's counts, the rows it walked.
template <int V>
__global__ void __launch_bounds__(kThreads)
dmr_gather_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                  const int* __restrict__ off, const int* __restrict__ cst,
                  const int* __restrict__ items,
                  const int* __restrict__ nitems, float* __restrict__ part1,
                  float* __restrict__ part2, int* __restrict__ wcnt, int f,
                  int k, int slab_rows, DmrPlan p) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int s = blockIdx.y;
  if (t >= nitems[s]) return;
  const int a = items[size_t(s) * p.cap + t];
  const int j = t - cst[size_t(s) * k + a];
  const int* o = off + size_t(s) * (k + 1);
  const int b0 = o[a] + j * kDmrChunk;
  const int n = min(kDmrChunk, o[a + 1] - b0);
  const int* rows = idx + size_t(s) * slab_rows + b0;
  const int col = (blockIdx.z * 32 + lane) * V;
  const bool has = col < f;
  float acc1[V], acc2[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc1[e] = acc2[e] = 0.0f;
  int walked = 0;
  for (int g0 = 0; g0 < n; g0 += 32) {
    const int nr = min(32, n - g0);
    const int mine = lane < nr ? __ldg(rows + g0 + lane) : 0;
    for (int h = 0; h < nr; h += kDmrGroup) {
      float v[kDmrGroup][V];
#pragma unroll
      for (int q = 0; q < kDmrGroup; ++q) {
        const int r = __shfl_sync(0xffffffffu, mine, h + q);
        if (h + q < nr && has) {
          const float* src = x + size_t(r) * f + col;
          if constexpr (V == 4) {
            const float4 w = __ldg(reinterpret_cast<const float4*>(src));
            v[q][0] = w.x;
            v[q][1] = w.y;
            v[q][2] = w.z;
            v[q][3] = w.w;
          } else {
            v[q][0] = __ldg(src);
          }
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) v[q][e] = 0.0f;
        }
      }
#pragma unroll
      for (int q = 0; q < kDmrGroup; ++q)
#pragma unroll
        for (int e = 0; e < V; ++e) acc1[e] += v[q][e];
#pragma unroll
      for (int q = kDmrGroup - 1; q >= 0; --q)
#pragma unroll
        for (int e = 0; e < V; ++e) acc2[e] += v[q][e];
      walked += min(kDmrGroup, nr - h);
    }
  }
  const size_t it = size_t(s) * p.cap + t;
  if (has) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      part1[it * f + col + e] = acc1[e];
      part2[it * f + col + e] = acc2[e];
    }
  }
  if (blockIdx.z == 0 && lane == 0) wcnt[it] = walked;
}

// Pass 5: thread (a, col) sums slab s's partial of cluster a -- its
// chunks' partials in chunk order, from +0.0 -- then the slabs in slab
// order, for each replica; the debug fault lands on slab fs's shadow
// partial; counts: the primary's from the buckets, the shadow's from the
// rows the gather walked. Per block the largest |sums - sums2|, the
// largest |sums| and whether a count differs, into red (3 floats a block).
__global__ void __launch_bounds__(kThreads)
dmr_reduce_kernel(const float* __restrict__ part1,
                  const float* __restrict__ part2,
                  const int* __restrict__ off, const int* __restrict__ cst,
                  const int* __restrict__ wcnt, int f, int k, DmrPlan p,
                  int fs, int fk, int ff, float fdelta,
                  float* __restrict__ sums, float* __restrict__ counts,
                  float* __restrict__ red) {
  __shared__ float wred[3][kThreads / 32];
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  const size_t i = size_t(blockIdx.x) * kThreads + tid;
  float diff = 0.0f, mag = 0.0f, cbad = 0.0f;
  if (i < size_t(k) * f) {
    const int a = int(i / f), col = int(i - size_t(a) * f);
    float s1 = 0.0f, s2 = 0.0f;
    int c1 = 0, c2 = 0;
    for (int s = 0; s < p.slabs; ++s) {
      const int* o = off + size_t(s) * (k + 1);
      const int na = o[a + 1] - o[a];
      const int nc = (na + kDmrChunk - 1) / kDmrChunk;
      const size_t t0 = size_t(s) * p.cap + cst[size_t(s) * k + a];
      float q1 = 0.0f, q2 = 0.0f;
#pragma unroll 16
      for (int j = 0; j < nc; ++j) {
        q1 += part1[(t0 + j) * f + col];
        q2 += part2[(t0 + j) * f + col];
      }
      if (col == 0)
        for (int j = 0; j < nc; ++j) c2 += wcnt[t0 + j];
      if (s == fs && a == fk && col == ff) q2 += fdelta;  // debug fault
      s1 += q1;
      s2 += q2;
      c1 += na;
    }
    sums[i] = s1;
    diff = fabsf(s1 - s2);
    mag = fabsf(s1);
    if (col == 0) {
      counts[a] = float(c1);
      cbad = c1 != c2 ? 1.0f : 0.0f;
    }
  }
  diff = warp_max(diff);
  mag = warp_max(mag);
  cbad = warp_max(cbad);
  if (lane == 0) {
    wred[0][w] = diff;
    wred[1][w] = mag;
    wred[2][w] = cbad;
  }
  __syncthreads();
  if (tid < 3) {
    float v = 0.0f;
    for (int q = 0; q < kThreads / 32; ++q) v = fmaxf(v, wred[tid][q]);
    red[size_t(blockIdx.x) * 3 + tid] = v;
  }
}

// Pass 6: bad = max|sums - sums2| > 1e-4 * max(max|sums|, 1) or a count
// differs (the reference's comparison).
__global__ void __launch_bounds__(kThreads)
dmr_verdict_kernel(const float* __restrict__ red, int nblocks,
                   int* __restrict__ bad) {
  __shared__ float wred[3][kThreads / 32];
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  float v[3] = {0.0f, 0.0f, 0.0f};
  for (int b = tid; b < nblocks; b += kThreads)
    for (int q = 0; q < 3; ++q) v[q] = fmaxf(v[q], red[size_t(b) * 3 + q]);
  for (int q = 0; q < 3; ++q) {
    const float r = warp_max(v[q]);
    if (lane == 0) wred[q][w] = r;
  }
  __syncthreads();
  if (tid == 0) {
    float diff = 0.0f, mag = 0.0f, cbad = 0.0f;
    for (int i = 0; i < kThreads / 32; ++i) {
      diff = fmaxf(diff, wred[0][i]);
      mag = fmaxf(mag, wred[1][i]);
      cbad = fmaxf(cbad, wred[2][i]);
    }
    *bad = (diff > 1e-4f * fmaxf(mag, 1.0f)) || cbad > 0.0f;
  }
}

bool tile_shape_ok(int bm, int mp, int kp, int fp) {
  return (bm == 64 || bm == 128) && mp > 0 && mp % bm == 0 && kp > 0 &&
         kp % kBK == 0 && fp > 0 && fp % kChunk == 0;
}

}  // namespace

extern "C" {

// The f32 tile kernel's pre-pass (lloyd_prep_kernel) over nb stacked
// problems: c (nb, kp, fp) -> ct (nb, fp, kp) and, when cenc is not null,
// cenc (nb, kp / 128, 2, fp). The f32 entry points below take ct where
// their 2-byte twins take c, and the FT ones cenc.
int fk_lloyd_prep(const float* c, float* ct, float* cenc, int nb, int kp,
                  int fp, void* stream) {
  if (nb < 1 || nb > 65535 || kp <= 0 || kp % kBK || kp / kBK > 65535 ||
      fp <= 0 || fp % kChunk)
    return int(cudaErrorInvalidValue);
  lloyd_prep_kernel<<<dim3(fp / kChunk, kp / kBK, nb), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(c, ct, cenc, kp,
                                                           fp);
  return int(cudaGetLastError());
}

// c: at f32 the pre-pass's ct (fp, kp) (fk_lloyd_prep), not C.
int fk_distance_argmin(const float* x, const float* c, const float* cn,
                       float* mind, int* argmin, int mp, int kp, int fp,
                       int bm, int bf, void* stream) {
  return dispatch<float, false, kNoUpdate>(
      bm, x, c, cn, mind, argmin, TileArgs<float>{}, 1, mp, kp, fp, bf, mp,
      static_cast<cudaStream_t>(stream));
}

// The one-pass step's update as entries (fk_entries.cuh): entries (mp, fp)
// f32, ecnt (mp,) f32, idx (kp, 2^ceil(log2 (mp / bm))) int32 filled with
// -1 by the caller.
int fk_lloyd_step(const float* x, const float* c, const float* cn,
                  float* mind, int* argmin, float* entries, float* ecnt,
                  int* idx, int true_m, int mp, int kp, int fp, int bm,
                  int bf, void* stream) {
  TileArgs<float> a{};
  a.sums = entries;
  a.counts = ecnt;
  a.idx = idx;
  a.levels = entry_levels(mp, bm);
  return dispatch<float, false, kEntryUpdate>(
      bm, x, c, cn, mind, argmin, a, 1, mp, kp, fp, bf, true_m,
      static_cast<cudaStream_t>(stream));
}

// nb stacked problems, each (mp, fp) rows against its own (kp, fp)
// centroids; they share true_m (padded together). The dense update: sums
// (nb, mp / bm, kp, fp), counts (nb, mp / bm, kp).
int fk_lloyd_step_batched(const float* x, const float* c, const float* cn,
                          float* mind, int* argmin, float* sums,
                          float* counts, int true_m, int nb, int mp, int kp,
                          int fp, int bm, int bf, void* stream) {
  TileArgs<float> a{};
  a.sums = sums;
  a.counts = counts;
  return dispatch<float, false, kDenseUpdate>(
      bm, x, c, cn, mind, argmin, a, nb, mp, kp, fp, bf, true_m,
      static_cast<cudaStream_t>(stream));
}

// cenc: the 2-byte kernels' split C encodings, at f32 the pre-pass's
// cenc (fk_lloyd_prep). X's encodings stay in the kernels' shared memory.
int fk_distance_argmin_ft(const float* x, const float* c, const float* cn,
                          const void* cenc, const int* inj, float* mind,
                          int* argmin, int* det, float thr_factor, int mp, int kp, int fp, int bm,
                          int bf, void* stream) {
  TileArgs<float> a{};
  a.cenc = static_cast<const float*>(cenc);
  a.inj = inj;
  a.det = det;
  a.thr_factor = thr_factor;
  return dispatch<float, true, kNoUpdate>(
      bm, x, c, cn, mind, argmin, a, 1, mp, kp, fp, bf, mp,
      static_cast<cudaStream_t>(stream));
}

// As fk_lloyd_step, keyed (ekey (mp + 1,) int32; the entries one row
// longer: the spare row, spare (2,) int32 = -1, -1 from the caller), with
// ucheck (mp / bm, 2, fp) and ccheck (mp / bm, 2).
int fk_lloyd_step_ft(const float* x, const float* c, const float* cn,
                     const void* cenc, const int* inj, float* mind,
                     int* argmin, int* det, float* entries, float* ecnt,
                     int* idx, int* ekey, int* spare, float* ucheck,
                     float* ccheck, float thr_factor, int true_m, int mp,
                     int kp, int fp, int bm, int bf, void* stream) {
  const TileArgs<float> a{static_cast<const float*>(cenc),
                          inj,    det,    entries, ecnt,
                          idx,    ekey,   spare,   ucheck,
                          ccheck, entry_levels(mp, bm), thr_factor};
  return dispatch<float, true, kEntryUpdate>(
      bm, x, c, cn, mind, argmin, a, 1, mp, kp, fp, bf, true_m,
      static_cast<cudaStream_t>(stream));
}

// A tile kernel's resources (tile_resources_of) at bm 64 or 128, ft 0/1,
// upd (0 none, 1 dense (f32), 2 entries, 3 batched entries (2 bytes), 4
// pruned entries; ft only with 0 or 2), Fp = fp and Kp = kp, for f32 (half
// = -1), bf16 (0) or fp16 (1) X and C.
int fk_tile_resources(int bm, int ft, int upd, int fp, int kp, int half,
                      int* out) {
  if (fp <= 0 || fp % kChunk || kp <= 0 || kp % kBK)
    return int(cudaErrorInvalidValue);
  if (half < 0) return tile_resources_of<float>(bm, ft, upd, fp, kp, out);
  return by_half(half, [&](auto tag) {
    return tile_resources_of<typename decltype(tag)::type>(bm, ft, upd, fp,
                                                           kp, out);
  });
}

// tile and gate may be null: every one of n_tiles row tiles, ungated.
int fk_update_tiles(const float* x, const int* argmin, const int* tile,
                    const int* gate, float* sums, float* counts, int true_m,
                    int kp, int fp, int bm, int n_tiles, void* stream) {
  return launch_update<float>(x, argmin, tile, gate, sums, counts, true_m, kp,
                              fp, bm, n_tiles,
                              static_cast<cudaStream_t>(stream));
}

// --- 2-byte inputs: the entry points above for X and C (and the update's X)
// of one type, bf16 (half = 0) or fp16 (half = 1), 16-byte aligned; norms,
// outputs and scratch stay f32 / int32.
int fk_distance_argmin_lp(const void* x, const void* c, const float* cn,
                          float* mind, int* argmin, int mp, int kp, int fp,
                          int bm, int bf, int half, void* stream) {
  return by_half(half, [&](auto tag) {
    using T = typename decltype(tag)::type;
    return dispatch<T, false, kNoUpdate>(
        bm, static_cast<const T*>(x), static_cast<const T*>(c), cn, mind,
        argmin, TileArgs<T>{}, 1, mp, kp, fp, bf, mp,
        static_cast<cudaStream_t>(stream));
  });
}

int fk_lloyd_step_lp(const void* x, const void* c, const float* cn,
                     float* mind, int* argmin, float* entries, float* ecnt,
                     int* idx, int true_m, int mp, int kp, int fp, int bm,
                     int bf, int half, void* stream) {
  return by_half(half, [&](auto tag) {
    using T = typename decltype(tag)::type;
    TileArgs<T> a{};
    a.sums = entries;
    a.counts = ecnt;
    a.idx = idx;
    a.levels = entry_levels(mp, bm);
    return dispatch<T, false, kEntryUpdate>(
        bm, static_cast<const T*>(x), static_cast<const T*>(c), cn, mind,
        argmin, a, 1, mp, kp, fp, bf, true_m,
        static_cast<cudaStream_t>(stream));
  });
}

// The batched step at 2-byte X and C: nb stacked problems as
// fk_lloyd_step_batched's, each problem's update as fk_lloyd_step_lp's
// entries. Problem b's row tile t writes entry rows (b mp / bm + t) bm ..
// of entries (nb mp, fp) f32 and ecnt (nb mp,) f32, and problem b's
// clusters are rows b kp .. of idx (nb kp, 2^ceil(log2 (mp / bm))) int32,
// filled with -1 by the caller: one tree over the entries, rows nb kp,
// sums every problem (update.reduce_entries).
int fk_lloyd_step_batched_lp(const void* x, const void* c, const float* cn,
                             float* mind, int* argmin, float* entries,
                             float* ecnt, int* idx, int true_m, int nb,
                             int mp, int kp, int fp, int bm, int bf,
                             int half, void* stream) {
  return by_half(half, [&](auto tag) {
    using T = typename decltype(tag)::type;
    TileArgs<T> a{};
    a.sums = entries;
    a.counts = ecnt;
    a.idx = idx;
    a.levels = entry_levels(mp, bm);
    return dispatch<T, false, kBatchedEntries>(
        bm, static_cast<const T*>(x), static_cast<const T*>(c), cn, mind,
        argmin, a, nb, mp, kp, fp, bf, true_m,
        static_cast<cudaStream_t>(stream));
  });
}

// cenc (kp / 128, 8, fp) from fk_lloyd_encode_lp
int fk_distance_argmin_ft_lp(const void* x, const void* c, const float* cn,
                             const void* cenc, const int* inj, float* mind,
                             int* argmin, int* det, float thr_factor, int mp, int kp, int fp,
                             int bm, int bf, int half, void* stream) {
  return by_half(half, [&](auto tag) {
    using T = typename decltype(tag)::type;
    TileArgs<T> a{};
    a.cenc = static_cast<const T*>(cenc);
    a.inj = inj;
    a.det = det;
    a.thr_factor = thr_factor;
    return dispatch<T, true, kNoUpdate>(
        bm, static_cast<const T*>(x), static_cast<const T*>(c), cn, mind,
        argmin, a, 1, mp, kp, fp, bf, mp, static_cast<cudaStream_t>(stream));
  });
}

int fk_lloyd_step_ft_lp(const void* x, const void* c, const float* cn,
                        const void* cenc, const int* inj, float* mind,
                        int* argmin, int* det, float* entries, float* ecnt,
                        int* idx, int* ekey, int* spare, float* ucheck,
                        float* ccheck, float thr_factor, int true_m, int mp,
                        int kp, int fp, int bm, int bf, int half,
                        void* stream) {
  return by_half(half, [&](auto tag) {
    using T = typename decltype(tag)::type;
    const TileArgs<T> a{static_cast<const T*>(cenc), inj, det, entries,
                        ecnt, idx, ekey, spare, ucheck, ccheck,
                        entry_levels(mp, bm), thr_factor};
    return dispatch<T, true, kEntryUpdate>(
        bm, static_cast<const T*>(x), static_cast<const T*>(c), cn, mind,
        argmin, a, 1, mp, kp, fp, bf, true_m,
        static_cast<cudaStream_t>(stream));
  });
}

// c (kp, fp) 2-byte, 16-byte aligned -> cenc (kp / 128, 8, fp): the split
// C encodings the 2-byte FT kernels take
int fk_lloyd_encode_lp(const void* c, void* cenc, int kp, int fp, int half,
                       void* stream) {
  return by_half(half, [&](auto tag) {
    using T = typename decltype(tag)::type;
    return launch_encode<T>(static_cast<const T*>(c), static_cast<T*>(cenc),
                            kp, fp, static_cast<cudaStream_t>(stream));
  });
}

int fk_update_tiles_lp(const void* x, const int* argmin, const int* tile,
                       const int* gate, float* sums, float* counts, int true_m,
                       int kp, int fp, int bm, int n_tiles, int half,
                       void* stream) {
  return by_half(half, [&](auto tag) {
    using T = typename decltype(tag)::type;
    return launch_update<T>(static_cast<const T*>(x), argmin, tile, gate, sums,
                            counts, true_m, kp, fp, bm, n_tiles,
                            static_cast<cudaStream_t>(stream));
  });
}

// The pruned one-pass step: lloyd_step's outputs (at f32 c is the
// pre-pass's ct) over the centroid tiles skip (mp / bm, kp / 128) int32
// leaves (1: skipped), and tmin (mp / bm, kp / 128) f32, each computed
// tile's bound (xn (mp,): the rows' squared norms, 0 in padded rows; a
// skipped tile gets FLT_MAX).
int fk_lloyd_step_pruned(const float* x, const float* c, const float* cn,
                         const float* xn, const int* skip, float* mind,
                         int* argmin, float* entries, float* ecnt, int* idx,
                         float* tmin, int true_m, int mp, int kp, int fp,
                         int bm, int bf, void* stream) {
  TileArgs<float> a{};
  a.sums = entries;
  a.counts = ecnt;
  a.idx = idx;
  a.levels = entry_levels(mp, bm);
  a.xn = xn;
  a.skip = skip;
  a.tmin = tmin;
  return dispatch<float, false, kPrunedEntries>(
      bm, x, c, cn, mind, argmin, a, 1, mp, kp, fp, bf, true_m,
      static_cast<cudaStream_t>(stream));
}

// fk_lloyd_step_pruned for bf16 (half = 0) or fp16 (half = 1) X and C
int fk_lloyd_step_pruned_lp(const void* x, const void* c, const float* cn,
                            const float* xn, const int* skip, float* mind,
                            int* argmin, float* entries, float* ecnt,
                            int* idx, float* tmin, int true_m, int mp, int kp,
                            int fp, int bm, int bf, int half, void* stream) {
  return by_half(half, [&](auto tag) {
    using T = typename decltype(tag)::type;
    TileArgs<T> a{};
    a.sums = entries;
    a.counts = ecnt;
    a.idx = idx;
    a.levels = entry_levels(mp, bm);
    a.xn = xn;
    a.skip = skip;
    a.tmin = tmin;
    return dispatch<T, false, kPrunedEntries>(
        bm, static_cast<const T*>(x), static_cast<const T*>(c), cn, mind,
        argmin, a, 1, mp, kp, fp, bf, true_m,
        static_cast<cudaStream_t>(stream));
  });
}

// xq (mp, fp) and cq (kp, fp) int8, sc (kp,) and cn (kp,) f32, each
// 16-byte aligned; sx (mp,) f32; fp <= kI8MaxFeatures.
int fk_distance_argmin_int8(const void* xq, const void* cq, const float* sx,
                            const float* sc, const float* cn, float* mind,
                            int* argmin, int mp, int kp, int fp, int bm,
                            void* stream) {
  if (!tile_shape_ok(bm, mp, kp, fp)) return int(cudaErrorInvalidValue);
  const int8_t* x8 = static_cast<const int8_t*>(xq);
  const int8_t* c8 = static_cast<const int8_t*>(cq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm == 128)
    return launch_int8<128>(x8, c8, sx, sc, cn, mind, argmin, mp, kp, fp, s);
  return launch_int8<64>(x8, c8, sx, sc, cn, mind, argmin, mp, kp, fp, s);
}

// The int8 tile kernel's resources at bm 64 or 128 and Fp = fp, as
// fk_tile_resources'.
int fk_int8_resources(int bm, int fp, int* out) {
  if (fp <= 0 || fp > kI8MaxFeatures) return int(cudaErrorInvalidValue);
  const size_t bytes = Int8Layout(bm, fp).bytes;
  if (bm == 128) return kernel_resources(int8_tile_kernel<128>, bytes, out);
  if (bm == 64) return kernel_resources(int8_tile_kernel<64>, bytes, out);
  return int(cudaErrorInvalidValue);
}

// nb problems of np = (np / bn) * bn rows and f features each.
int fk_kmeanspp_round(const float* x, const float* xn, const float* c,
                      const float* d2, float* d2o, float* ts, int nb, int np,
                      int f, int bn, void* stream) {
  if (nb < 1 || nb > kMaxProblems || f < 1 || bn < 1 || np < bn || np % bn)
    return int(cudaErrorInvalidValue);
  kmeanspp_round_kernel<<<dim3(np / bn, nb), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      x, xn, c, d2, d2o, ts, np, f, bn);
  return int(cudaGetLastError());
}

// The DMR gather kernel's resources at V = 1 or 4 features a lane:
// resident blocks an SM, registers and local bytes a thread, shared bytes.
int fk_dmr_resources(int v, int* out) {
  if (v == 4) return kernel_resources(dmr_gather_kernel<4>, 0, out);
  if (v == 1) return kernel_resources(dmr_gather_kernel<1>, 0, out);
  return int(cudaErrorInvalidValue);
}

// Scratch of fk_centroid_update_dmr for these shapes: sizes[0] ints,
// sizes[1] floats.
int fk_dmr_workspace(int m, int f, int k, int slab_rows, long long* sizes) {
  if (m < 0 || f < 1 || k < 1 || slab_rows < 32 || slab_rows % 32)
    return int(cudaErrorInvalidValue);
  const DmrPlan p = dmr_plan(m, f, k, slab_rows);
  sizes[0] = (long long)p.ints;
  sizes[1] = (long long)p.floats;
  return 0;
}

// x (m, f) f32, assign (m,) int32; iwork and fwork the scratch
// fk_dmr_workspace sizes (no state kept between launches); sums (k, f),
// counts (k,) f32; bad a 0-d int32. fs < 0: no debug fault. Six launches
// and a memset: histogram, scan, scatter, gather, slab sums, verdict.
int fk_centroid_update_dmr(const float* x, const int* assign, int* iwork,
                           float* fwork, float* sums, float* counts,
                           int* bad, int m, int f, int k, int slab_rows,
                           int fs, int fk, int ff, float fdelta,
                           void* stream) {
  if (m < 0 || f < 1 || k < 1 || slab_rows < 32 || slab_rows % 32)
    return int(cudaErrorInvalidValue);
  const DmrPlan p = dmr_plan(m, f, k, slab_rows);
  const int fgroups4 = (f + 127) / 128, fgroups1 = (f + 31) / 32;
  if (p.slabs > kMaxProblems || fgroups1 > kMaxProblems)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* pos = iwork + p.pos;
  int* off = iwork + p.off;
  int* cst = iwork + p.cst;
  int* items = iwork + p.items;
  int* nitems = iwork + p.nitems;
  int* idx = iwork + p.idx;
  int* wcnt = iwork + p.wcnt;
  float* part1 = fwork + p.part;
  float* part2 = part1 + size_t(p.slabs) * p.cap * f;
  float* red = fwork + p.red;
  cudaError_t e = cudaMemsetAsync(pos, 0, size_t(p.slabs) * p.hstride * 4, s);
  if (e != cudaSuccess) return int(e);
  const int hblocks = (p.slabs * p.nch + kThreads / 32 - 1) / (kThreads / 32);
  dmr_bucket_kernel<false><<<hblocks, kThreads, 0, s>>>(assign, pos, idx, m,
                                                        k, slab_rows, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  dmr_scan_kernel<<<p.slabs, kDmrScanThreads, 0, s>>>(pos, off, cst, items,
                                                      nitems, k, slab_rows, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  dmr_bucket_kernel<true><<<hblocks, kThreads, 0, s>>>(assign, pos, idx, m, k,
                                                       slab_rows, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  const bool vec = f % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 ggrid((p.cap + kThreads / 32 - 1) / (kThreads / 32), p.slabs,
                   vec ? fgroups4 : fgroups1);
  if (vec)
    dmr_gather_kernel<4><<<ggrid, kThreads, 0, s>>>(
        x, idx, off, cst, items, nitems, part1, part2, wcnt, f, k, slab_rows,
        p);
  else
    dmr_gather_kernel<1><<<ggrid, kThreads, 0, s>>>(
        x, idx, off, cst, items, nitems, part1, part2, wcnt, f, k, slab_rows,
        p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  dmr_reduce_kernel<<<p.nred, kThreads, 0, s>>>(part1, part2, off, cst, wcnt,
                                                f, k, p, fs, fk, ff, fdelta,
                                                sums, counts, red);
  e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  dmr_verdict_kernel<<<1, kThreads, 0, s>>>(red, p.nred, bad);
  return int(cudaGetLastError());
}

const char* fk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
