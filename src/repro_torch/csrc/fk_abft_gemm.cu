// Hand-written Hopper (sm_90a) ABFT GEMM for bf16 / fp16 X and Y.
//
// Replaces the Pallas TPU kernel matmul_abft of
// src/repro/kernels/matmul_abft.py (body _kernel) at 2-byte inputs: D = X Y
// in f32 for X (mp, kp) and Y (kp, np), with the dual-checksum invariant per
// verification tile of bm x bn. Each tile's expected checksums
//
//   col1 = (e1^T X_t) Y_t   col2 = (e2^T X_t) Y_t
//   row1 = X_t (Y_t e1)     row2 = X_t (Y_t e2)    e1 = 1, e2 = 1..b
//
// are compared with its observed ones against threshold_factor(kp, dtype) *
// max(max|col1|, max|row1|, 1) (the expected, clean side); a fault is
// located by the e2/e1 ratio and one element corrected (locate_tile,
// fk_abft.cuh, shared with the f32 kernel); inj = [enabled, m_tile,
// n_tile, k_step, row, col, delta bits] plants one fault after k-step
// k_step of bk. det (mp/bm, np/bn) gets each tile's detection. The f32
// kernel, matmul_abft_kernel, stays in fk_kernels.cu.
//
// Bound on the H100: 2 mp np kp FLOPs on the tensor cores (989 TFLOP/s) or,
// for a short kp, the bytes of the f32 D (3.35 TB/s). The design keeps the
// checksums off the product's path:
//
//   * abft_encode_kernel<T> (a pre-pass, fk_abft_encode): the encodings
//     once per call, not once per output tile: E_X[mt, k] =
//     (e1^T X_t, e2^T X_t)[k] for each m-tile and E_Y[nt, k] = (Y_t e1,
//     Y_t e2)[k] for each n-tile, f32 sums of the 2-byte values widened
//     exactly, in a fixed order, as (tiles, kpe, 2) float pairs (kpe = kp
//     rounded up to 64; zeros past kp), and E_Y split for the tensor cores
//     (esy). The weights are the row or column index within the tile, plus
//     1. It reads X and Y once.
//   * abft_gemm_kernel<T, Smem> (fk_abft_gemm): persistent, one block of
//     384 threads an SM walks the jobs, a job being two m-tiles (one a
//     consumer warpgroup) x one n-tile, in sub-tiles of 128 rows x 128
//     columns; the jobs go out in groups of kGroupM m-tile pairs so the
//     blocks in flight share X and Y through L2. Warpgroup 2 produces: one
//     thread TMA-loads each 64-deep k-stage into a ring guarded by a
//     "full" mbarrier (the bytes) and an "empty" one (the 256 consumer
//     threads): X as 64-row boxes (K-major), Y as two 64-column panels read
//     as they lie (MN-major), all 128-byte swizzled, and the stage's
//     encodings by bulk copy. It gives its registers to the consumers
//     (setmaxnreg 40 / 232, the role broadcast warp-uniform), whose 128 f32
//     accumulators a thread would not fit the 168 that 12 warps leave. Each
//     consumer warpgroup runs its 128 x 128 product as wgmma.mma_async
//     m64n128k16 on its two X boxes and the shared Y panels (B with
//     imm-trans-b, so Y is never transposed), one stage's group kept in
//     flight. The row checksums row{1,2} = X E_Y run on the tensor cores
//     in the same groups: the pre-pass splits E_Y (scaled by powers of two
//     so fp16 holds it) into three 2-byte parts a value, an 8-column
//     K-major operand loaded with the stage, and wgmma m64n8k16 gives the
//     parts' products, summed (hi + mid) + lo in the epilogue. While a
//     stage's product runs, the threads compute the column checksums
//     col{1,2} += E_X Y_stage on the CUDA cores from the same resident
//     stage, reading through the swizzle (a thread: 8 columns, 8 k rows);
//     2 K 128 FMAs a 128 x 128 sub-tile.
//   * the epilogue from registers: observed row sums (a quad's shuffles)
//     and column sums (a reduce-scatter over the 8 row groups of a warp,
//     then the 4 warps in order through shared memory), the expected row
//     sums gathered in a quad, the column ones' partials in order; rows
//     past a tile under 128 rows are masked out of every sum and never
//     stored. The warpgroup's maxima of
//     |residual| and |expected| decide detection; only a tile over its
//     threshold is decoded, by warp 0 (locate_tile). When the tile is one
//     sub-tile (bm <= 128, bn = 128: the default tiles) the lane holding
//     the located element corrects it in registers, then each warp stages
//     its rows in 8-row bands (128-byte swizzle) and TMA-stores them while
//     it goes on. A larger tile keeps its checksum state in a workspace,
//     stores each sub-tile after its sums and patches the one element in D
//     afterwards.
//   * two configurations (Smem<stages, bands>): a 3-stage ring where the k
//     loop is long (the product sets the pace), a 2-stage ring with twice
//     the D staging where it is at most four stages, Kp <= 256 (the f32
//     D's stores and the epilogue set the pace; timed on the H100, the
//     2-stage ring is 11 % faster at Kp 128, 6-7 % at 192, 1-2 % at 256
//     and 11-13 % slower at 512).
//   * the fault is added to the accumulator register that holds (row,
//     col), after the stage that ends k-step k_step; a k-step shallower
//     than a stage (bk = 32) lands at that stage's end.
//
// Every sum has a fixed order (wgmma's own within a product), so two
// launches on the same inputs give bitwise-equal D and detections. Tiles:
// bm a multiple of 8 up to 128 or of 128 up to 1024, bn a multiple of 128 up
// to 1024, bk a multiple of 32 (kernels/matmul_abft.check_cuda_tiles).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (no --use_fast_math: the e2/e1 division must round correctly).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "fk_abft.cuh"
#include "fk_tma.cuh"
#include "fk_wgmma.cuh"

namespace {

constexpr int kThreads = 384;     // two consumer warpgroups, a producer one
constexpr int kProducerRegs = 40;  // a thread, after setmaxnreg
constexpr int kConsumerRegs = 232;
constexpr int kSubM = 128;        // rows of a warpgroup's sub-tile
constexpr int kSubN = 128;        // columns of a sub-tile
constexpr int kStageK = 64;       // k of a ring stage
constexpr int kMaxTile = 1024;    // the largest bm and bn
constexpr int kEncThreads = 256;

// Measurement builds only (python -m repro_torch.launch.abft_profile):
// FK_ABFT_CUT leaves parts of abft_gemm_kernel out to split its time (bit
// 0: the D stores of a one-sub-tile tile, 1: the column checksum products,
// 2: the verification epilogue; D and the detections are then wrong), and
// FK_ABFT_RING forces a ring configuration (1: SmemDeep, 2: SmemWide). The
// port's own build sets neither.
#ifndef FK_ABFT_CUT
#define FK_ABFT_CUT 0
#endif
#ifndef FK_ABFT_RING
#define FK_ABFT_RING 0
#endif
constexpr int kCut = FK_ABFT_CUT;

// Shared memory of abft_gemm_kernel, in bytes from a 1024-aligned base: the
// ring, then one region a consumer warpgroup.
template <int S, int NB>
struct Smem {
  static constexpr int stages = S;      // the ring's k-stages
  static constexpr int bands = NB;      // 8-row D bands a warp stages
  static constexpr int box = 64 * 128;              // 64 rows x 128 bytes
  static constexpr int stage = 6 * box;             // X 4 boxes, Y 2 panels
  static constexpr int ring = 0;
  // a stage's split E_Y block (8 rows x 64 k of T, 128-byte swizzled)
  static constexpr int esy_stage = 8 * 128;
  static constexpr int esy = ring + S * stage;
  static constexpr int enc_stage = 2 * kStageK * 8; // E_X of the 2 tiles
  static constexpr int enc = esy + S * esy_stage;
  // a warpgroup's job state when its tile is one sub-tile (bm <= 128, bn =
  // 128; a larger tile's lives in the workspace), f32 [128] each: the
  // expected e1 column sums and the column residuals (e1, e2), then the
  // same for rows
  static constexpr int state = 0;
  // float2 partials of a sub-tile: observed column sums [4 warps][128],
  // the column checksum products [4 k-group pairs][128]; then the warps'
  // maxima [4][4] and the verdict (4 words)
  static constexpr int oc = state + 6 * kSubN * 4;
  static constexpr int ec = oc + 4 * kSubN * 8;
  static constexpr int mx = ec + 4 * kSubN * 8;
  static constexpr int verdict = mx + 16 * 4;
  static constexpr int wg_bytes = verdict + 16;
  static constexpr int wgs = enc + S * enc_stage;
  // D staging for TMA stores: NB bands of 8 rows x 128 columns of f32 a
  // warp, each as four 128-byte-swizzled boxes of 32 columns
  static constexpr int band = 4 * 8 * 128;
  static constexpr int dstage = (wgs + 2 * wg_bytes + 1023) / 1024 * 1024;
  static constexpr int dstage_warp = NB * band;
  static constexpr int bars = dstage + 8 * dstage_warp;       // full, empty
  static constexpr size_t bytes = size_t(bars) + 2 * S * 8 + 1024;
};
// the two configurations: a deep ring for a long k loop (the product
// sets the pace), a shallow one and twice the D staging for a short one
// (the f32 D's stores set it)
using SmemDeep = Smem<3, 1>;
using SmemWide = Smem<2, 2>;
static_assert(SmemDeep::bytes <= 232448 && SmemWide::bytes <= 232448,
              "one block an SM");

__device__ __forceinline__ void unpack2(uint32_t w, float& lo, float& hi,
                                        __nv_bfloat16) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void unpack2(uint32_t w, float& lo, float& hi,
                                        __half) {
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w));
  lo = f.x;
  hi = f.y;
}
// eight 2-byte values of a 16-byte chunk, widened exactly
template <typename T>
__device__ __forceinline__ void unpack8(const uint4& v, float* f) {
  unpack2(v.x, f[0], f[1], T());
  unpack2(v.y, f[2], f[3], T());
  unpack2(v.z, f[4], f[5], T());
  unpack2(v.w, f[6], f[7], T());
}

// one step of a warp's reduce-scatter: lanes with bit o of the lane set
// keep the upper N of v[0, 2N), the others the lower N, each adding its
// partner's (lane ^ o) copy: v[0, N) holds the kept sums
template <int N>
__device__ __forceinline__ void reduce_scatter_half(float* v, int lane,
                                                    int o) {
  const bool up = lane & o;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float send = up ? v[i] : v[i + N];
    const float keep = up ? v[i + N] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
  }
}



// Job j's (m-tile pair, n-tile): jobs run in groups of kGroupM pairs, the
// pairs fastest, so the blocks in flight share their X rows and Y columns
// through L2.
constexpr int kGroupM = 8;
__device__ __forceinline__ void job_coords(int job, int njm, int nnt,
                                           int& jm, int& jn) {
  const int per_group = kGroupM * nnt;
  const int first = job / per_group * kGroupM;
  const int size = njm - first < kGroupM ? njm - first : kGroupM;
  const int r = job - first * nnt;
  jm = first + r % size;
  jn = r / size;
}

// TMA stores: one box from shared memory, committed in groups; wait until
// the groups have read shared memory (the staging may be rewritten) or are
// done
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}],"
      " [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0),
        "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// order this thread's shared-memory writes before the async proxy's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the 128 threads of one consumer warpgroup (named barrier id, 1 or 2)
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

template <typename T>
__device__ __forceinline__ T to_t(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 to_t(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half to_t(float v) {
  return __float2half_rn(v);
}
__device__ __forceinline__ float from_t(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float from_t(__half v) { return __half2float(v); }
// v = hi + mid + lo in three T values, each rounded to nearest from what
// the earlier ones leave (exact for a bf16 split of an f32; for fp16 up to
// its 33 bits and its range)
template <typename T>
__device__ __forceinline__ void split3(float v, T& hi, T& mid, T& lo) {
  hi = to_t<T>(v);
  const float r = v - from_t(hi);
  mid = to_t<T>(r);
  lo = to_t<T>(r - from_t(mid));
}

// Blocks [0, nxb): E_X of (m-tile, 64 k), 32 lanes a k pair x 8 row groups
// (rows r = group mod 8), the groups summed in order. Blocks past nxb: E_Y,
// one warp a (n-tile, k), lane l summing chunks l, l + 32, .. of 8 columns,
// then a butterfly; lane 0 also writes the split E_Y (esy, (np/bn, 8, kpe)
// in T) that the GEMM's row checksums take on the tensor cores.
template <typename T>
__global__ void __launch_bounds__(kEncThreads)
abft_encode_kernel(const T* __restrict__ x, const T* __restrict__ y,
                   float* __restrict__ ex, float* __restrict__ ey,
                   T* __restrict__ esy, int np, int kp, int kpe, int bm,
                   int bn, int nxb, int es1, int es2) {
  __shared__ float4 part[8][32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kc = kpe / kStageK;
  if (int(blockIdx.x) < nxb) {
    const int mt = blockIdx.x / kc, kb = blockIdx.x - mt * kc;
    const int k = kb * kStageK + 2 * lane;
    float a1 = 0.0f, a2 = 0.0f, b1 = 0.0f, b2 = 0.0f;
    if (k < kp) {
      const T* xc = x + size_t(mt) * bm * kp + k;
      for (int r = warp; r < bm; r += 8) {
        float f0, f1;
        unpack2(*reinterpret_cast<const uint32_t*>(xc + size_t(r) * kp), f0,
                f1, T());
        const float w = float(r + 1);
        a1 += f0;
        a2 = fmaf(w, f0, a2);
        b1 += f1;
        b2 = fmaf(w, f1, b2);
      }
    }
    part[warp][lane] = make_float4(a1, a2, b1, b2);
    __syncthreads();
    if (tid < kStageK) {
      const int l = tid >> 1, odd = tid & 1;
      float e1 = 0.0f, e2 = 0.0f;
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        const float4 p = part[w][l];
        e1 += odd ? p.z : p.x;
        e2 += odd ? p.w : p.y;
      }
      reinterpret_cast<float2*>(ex)[size_t(mt) * kpe + kb * kStageK + tid] =
          make_float2(e1, e2);
    }
    return;
  }
  const long long wid = (long long)(blockIdx.x - nxb) * 8 + warp;
  const int nt = int(wid / kpe), k = int(wid - (long long)nt * kpe);
  if (nt >= np / bn) return;
  float s1 = 0.0f, s2 = 0.0f;
  if (k < kp) {
    const T* yr = y + size_t(k) * np + size_t(nt) * bn;
    for (int c = lane; c < bn / 8; c += 32) {
      float f[8];
      unpack8<T>(*reinterpret_cast<const uint4*>(yr + 8 * c), f);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s1 += f[i];
        s2 = fmaf(float(8 * c + i + 1), f[i], s2);
      }
    }
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0)
    reinterpret_cast<float2*>(ey)[size_t(nt) * kpe + k] = make_float2(s1, s2);
  // the row checksums' B operand: e1 2^-es1 and e2 2^-es2, each split into
  // three T parts (hi + mid + lo), rows 0-2 and 3-5 of the n-tile's 8;
  // lane q writes row q
  if (lane < 8) {
    T part[3];
    split3(ldexpf(lane < 3 ? s1 : s2, lane < 3 ? -es1 : -es2), part[0],
           part[1], part[2]);
    const int q = lane < 3 ? lane : lane - 3;
    esy[(size_t(nt) * 8 + lane) * kpe + k] =
        lane >= 6 ? to_t<T>(0.0f)
                  : q == 0 ? part[0] : q == 1 ? part[1] : part[2];
  }
}

template <typename T, typename Smem>
__global__ void __launch_bounds__(kThreads, 1)
abft_gemm_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap ymap,
                 const __grid_constant__ CUtensorMap emap,
                 const __grid_constant__ CUtensorMap dmap,
                 const float* __restrict__ ex, const int* __restrict__ inj,
                 float* __restrict__ d, int* __restrict__ det,
                 float* __restrict__ ws, int mp, int np, int kp, int kpe,
                 int bm, int bn, int bk, int es1, int es2, float thr_factor) {
  extern __shared__ unsigned char sm_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(sm_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + Smem::bars);
  uint64_t* empty = full + Smem::stages;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nmt = mp / bm, nnt = np / bn;
  const int njm = (nmt + 1) / 2;
  const int njobs = njm * nnt;         // two m-tiles x one n-tile
  const int nbox = bm <= 64 ? 1 : 2;   // 64-row X boxes a sub-tile
  const int rbs = bm > kSubM ? bm / kSubM : 1;
  const int cbs = bn / kSubN;
  const int nks = kpe / kStageK;
  const int spj = rbs * cbs * nks;     // ring stages a job

  if (tid == 0) {
    for (int s = 0; s < Smem::stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warpgroup cw takes m-tile 2 jm + cw of job (jm, jn)
  const int cw = warp >> 2;
  const int wi = warp & 3, g = lane >> 2, t = lane & 3;
  const int ct = tid - 128 * cw;
  unsigned char* wsm = sm + Smem::wgs + cw * Smem::wg_bytes;
  const bool multi = rbs * cbs > 1;
  // the job state: six arrays of bn or bm floats (ecol1, rc1, rc2; erow1,
  // rr1, rr2) in shared memory for a one-sub-tile tile, else in this
  // warpgroup's slice of the workspace (written and read by this SM only)
  const int len = multi ? kMaxTile : kSubN;
  float* ecol1 = multi ? ws + size_t(2 * blockIdx.x + cw) * 6 * kMaxTile
                       : reinterpret_cast<float*>(wsm + Smem::state);
  float* rc1 = ecol1 + len;
  float* rc2 = rc1 + len;
  float* erow1 = rc2 + len;
  float* rr1 = erow1 + len;
  float* rr2 = rr1 + len;
  float2* oc_part = reinterpret_cast<float2*>(wsm + Smem::oc);
  float2* ec_part = reinterpret_cast<float2*>(wsm + Smem::ec);
  uint32_t* wmx = reinterpret_cast<uint32_t*>(wsm + Smem::mx);
  int* verdict = reinterpret_cast<int*>(wsm + Smem::verdict);
  const int bar_id = 1 + cw;
  // checksum-product roles: row ct of the sub-tile (all of a stage's k);
  // columns 8 cc .. 8 cc + 7 over k rows 8 cq .. 8 cq + 7 of a stage
  const int cc = ct & 15, cq = ct >> 4;
  const bool inj_on = inj[0] > 0;
  const int inj_mt = inj[1], inj_nt = inj[2], inj_ks = inj[3];
  const int inj_row = inj[4], inj_col = inj[5];
  const float inj_delta = __int_as_float(inj[6]);
  const bool inj_ok = inj_on && inj_ks >= 0 && inj_ks < kp / bk &&
                      inj_row >= 0 && inj_row < bm && inj_col >= 0 &&
                      inj_col < bn;
  // The producer fills the ring in the CTA's stage order (its jobs in turn,
  // each job's sub-tiles and k-stages in order); a slot is reloaded once all
  // 256 consumer threads have released it.
  const int cta_jobs =
      njobs > int(blockIdx.x)
          ? (njobs - int(blockIdx.x) + int(gridDim.x) - 1) / int(gridDim.x)
          : 0;
  const int total = cta_jobs * spj;
  const uint32_t tx_bytes =
      (2 * nbox + 2) * Smem::box + Smem::esy_stage + Smem::enc_stage;
  auto load_stage = [&](int G) {
    if (G >= total) return;
    const int st = G % Smem::stages;
    const int li = G / spj, r = G - li * spj;
    const int job = int(blockIdx.x) + li * int(gridDim.x);
    int jm, jn;
    job_coords(job, njm, nnt, jm, jn);
    const int rb = r / (cbs * nks), cb = (r / nks) % cbs, s = r % nks;
    const int n0 = jn * bn + cb * kSubN, k0 = s * kStageK;
    unsigned char* xs = sm + Smem::ring + st * Smem::stage;
    unsigned char* es = sm + Smem::enc + st * Smem::enc_stage;
    if (G >= Smem::stages)
      mbar_wait(empty + st, ((G / Smem::stages) & 1) ^ 1);
    mbar_expect_tx(full + st, tx_bytes);
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      // a missing second m-tile loads the first's rows again, unused
      const int mt = 2 * jm + w < nmt ? 2 * jm + w : 2 * jm;
      const int row0 = mt * bm + rb * kSubM;
      tma_load_2d(xs + 2 * w * Smem::box, &xmap, full + st, k0, row0);
      if (nbox == 2)
        tma_load_2d(xs + (2 * w + 1) * Smem::box, &xmap, full + st, k0,
                    row0 + 64);
      bulk_load(es + w * 512, ex + (size_t(mt) * kpe + k0) * 2, 512,
                full + st);
    }
    tma_load_2d(xs + 4 * Smem::box, &ymap, full + st, n0, k0);
    tma_load_2d(xs + 5 * Smem::box, &ymap, full + st, n0 + 64, k0);
    tma_load_2d(sm + Smem::esy + st * Smem::esy_stage, &emap, full + st, k0,
                8 * jn);
  };
  // release stage G: all of this thread's reads of it are done
  auto release = [&](int G) { mbar_arrive(empty + G % Smem::stages); };
  {
    // warpgroup 2 produces. The role is broadcast from lane 0 so that it
    // is visibly warp-uniform: ptxas then gives each role the register
    // count its setmaxnreg sets (the consumers' 128 accumulators a thread
    // need more than the 168 that 12 warps an SM leave otherwise).
    const int role = __shfl_sync(0xffffffffu, warp >> 2, 0);
    if (role == 2) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                   ::"n"(kProducerRegs) : "memory");
      if (warp == 8 && lane == 0)
        for (int G = 0; G < total; ++G) load_stage(G);
      return;
    }
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 ::"n"(kConsumerRegs) : "memory");
  }

  int it = 0;
  // this warp's D bands staged so far, across its jobs: band i goes to
  // staging buffer i % NB
  int nstored = 0;
  for (int job = blockIdx.x; job < njobs; job += gridDim.x) {
    int jm, jn;
    job_coords(job, njm, nnt, jm, jn);
    const int mt = 2 * jm + cw;
    const bool own = mt < nmt;          // a last odd m-tile: one warpgroup
    float acc[2][64];
    for (int rb = 0; rb < rbs; ++rb)
      for (int cb = 0; cb < cbs; ++cb) {
        // the fault, when it lands in this sub-tile: its stage, row, col
        int inj_stage = -1;
        const int inj_lr = inj_row - rb * kSubM, inj_lc = inj_col - cb * kSubN;
        if (inj_ok && inj_mt == mt && inj_nt == jn && inj_lr >= 0 &&
            inj_lr < kSubM && inj_lc >= 0 && inj_lc < kSubN)
          inj_stage = ((inj_ks + 1) * bk - 1) / kStageK;
#pragma unroll
        for (int b = 0; b < 2; ++b)
#pragma unroll
          for (int q = 0; q < 64; ++q) acc[b][q] = 0.0f;
        // the row checksums' split parts (64 x 8 a box, on the tensor
        // cores), the column ones' partials [8]
        float racc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
        float c1[8], c2[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) c1[q] = c2[q] = 0.0f;
        for (int s = 0; s < nks; ++s, ++it) {
          const int st = it % Smem::stages;
          mbar_wait(full + st, (it / Smem::stages) & 1);
          const unsigned char* xs =
              sm + Smem::ring + st * Smem::stage + 2 * cw * Smem::box;
          const unsigned char* ys =
              sm + Smem::ring + st * Smem::stage + 4 * Smem::box;
          const unsigned char* es = sm + Smem::enc + st * Smem::enc_stage;
          const unsigned char* eys = sm + Smem::esy + st * Smem::esy_stage;
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < kStageK / 16; ++kk)
            wgmma_ss_tb_n128(acc[0], sw128_desc(xs + kk * 32, 16),
                             sw128_desc(ys + kk * 16 * 128, Smem::box), T());
          if (nbox == 2) {
#pragma unroll
            for (int kk = 0; kk < kStageK / 16; ++kk)
              wgmma_ss_tb_n128(acc[1],
                               sw128_desc(xs + Smem::box + kk * 32, 16),
                               sw128_desc(ys + kk * 16 * 128, Smem::box),
                               T());
          }
          // row{1,2} += X_stage E_Y on the tensor cores: the split E_Y as an
          // 8-column K-major B
#pragma unroll
          for (int kk = 0; kk < kStageK / 16; ++kk)
            wgmma_ss_n8(racc[0], sw128_desc(xs + kk * 32, 16),
                        sw128_desc(eys + kk * 32, 16), T());
          if (nbox == 2) {
#pragma unroll
            for (int kk = 0; kk < kStageK / 16; ++kk)
              wgmma_ss_n8(racc[1], sw128_desc(xs + Smem::box + kk * 32, 16),
                          sw128_desc(eys + kk * 32, 16), T());
          }
          wg_commit();
          // stage it - 1's product is done: release it before this stage's
          // checksum products, so its slot refills sooner
          wg_wait<1>();
          if (s > 0) release(it - 1);
          // col{1,2} += E_X Y_stage: columns 8 cc .., k rows 8 cq ..
          if (!(kCut & 2)) {
            const unsigned char* yp = ys + (cc >> 3) * Smem::box;
            const float2* exv = reinterpret_cast<const float2*>(es + cw * 512);
            const int ch = cc & 7;
#pragma unroll
            for (int q = 0; q < 8; ++q) {
              const int kr = 8 * cq + q;
              float yv[8];
              unpack8<T>(*reinterpret_cast<const uint4*>(
                             yp + kr * 128 + ((ch ^ (kr & 7)) << 4)), yv);
              const float2 e = exv[kr];
#pragma unroll
              for (int u = 0; u < 8; ++u) {
                c1[u] = fmaf(e.x, yv[u], c1[u]);
                c2[u] = fmaf(e.y, yv[u], c2[u]);
              }
            }
          }
          if (s == inj_stage) {
            // simulated SEU after the stage that ends k-step k_step
            wg_wait<0>();
            fence_regs<128>(&acc[0][0]);
#pragma unroll
            for (int b = 0; b < 2; ++b)
#pragma unroll
              for (int j = 0; j < 16; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  if (64 * b + 16 * wi + g + 8 * (e >> 1) == inj_lr &&
                      8 * j + 2 * t + (e & 1) == inj_lc)
                    acc[b][4 * j + e] += inj_delta;
          }
        }
        wg_wait<0>();
        fence_regs<128>(&acc[0][0]);
        fence_regs<8>(&racc[0][0]);
        release(it - 1);

        // this thread's rows (box b, half h): sub-tile row 64 b + 16 wi +
        // g + 8 h, counted when it lies in the tile
        bool valid[2][2];
#pragma unroll
        for (int b = 0; b < 2; ++b)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int lr = 64 * b + 16 * wi + g + 8 * h;
            valid[b][h] = own && b < nbox && (bm >= kSubM || lr < bm);
          }
        if (!(kCut & 4)) {
          // observed row sums: a row's 32 values here, then its quad; lane t
          // keeps row (b, h) = (t >> 1, t & 1)
          float os1 = 0.0f, os2 = 0.0f;
#pragma unroll
          for (int b = 0; b < 2; ++b)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
              for (int j = 0; j < 16; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const float v = acc[b][4 * j + 2 * h + e];
                  s1 += v;
                  s2 = fmaf(float(cb * kSubN + 8 * j + 2 * t + e + 1), v, s2);
                }
              s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
              s2 += __shfl_xor_sync(0xffffffffu, s2, 1);
              s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
              s2 += __shfl_xor_sync(0xffffffffu, s2, 2);
              if (2 * b + h == t) {
                os1 = s1;
                os2 = s2;
              }
            }
          // observed column sums of the warp's 32 rows, in two halves of 8
          // column blocks: the 4 rows here, then a reduce-scatter over the 8
          // row groups (lane bits 2..4, offsets 16, 8, 4) leaving lane (g, t)
          // the e1 and e2 sums of columns 8 (8 hh + g) + 2 t + e
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float v[32];     // v[4 jj + 2 e + {0: e1, 1: e2}]
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
                for (int b = 0; b < 2; ++b)
#pragma unroll
                  for (int h = 0; h < 2; ++h) {
                    const float w =
                        float(rb * kSubM + 64 * b + 16 * wi + g + 8 * h + 1);
                    const float x =
                        valid[b][h] ? acc[b][4 * (8 * hh + jj) + 2 * h + e]
                                    : 0.0f;
                    s1 += x;
                    s2 = fmaf(w, x, s2);
                  }
                v[4 * jj + 2 * e] = s1;
                v[4 * jj + 2 * e + 1] = s2;
              }
            reduce_scatter_half<16>(v, lane, 16);
            reduce_scatter_half<8>(v, lane, 8);
            reduce_scatter_half<4>(v, lane, 4);
#pragma unroll
            for (int e = 0; e < 2; ++e)
              oc_part[wi * kSubN + 8 * (8 * hh + g) + 2 * t + e] =
                  make_float2(v[2 * e], v[2 * e + 1]);
          }
          // the checksum products' partials
          // expected row sums: the quad's 8 split parts of each of its 4 rows
          // gathered in every lane, (hi + mid) + lo unscaled; lane t keeps row
          // (t >> 1, t & 1)
          float er1 = 0.0f, er2 = 0.0f;
#pragma unroll
          for (int b = 0; b < 2; ++b)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float c[8];
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                const int src = (lane & ~3) | u;
                c[2 * u] = __shfl_sync(0xffffffffu, racc[b][2 * h], src);
                c[2 * u + 1] =
                    __shfl_sync(0xffffffffu, racc[b][2 * h + 1], src);
              }
              if (2 * b + h == t) {
                er1 = ldexpf((c[0] + c[1]) + c[2], es1);
                er2 = ldexpf((c[3] + c[4]) + c[5], es2);
              }
            }
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            // k-groups 2 w and 2 w + 1 sit in lanes l and l ^ 16 of warp w
            const float a = c1[u] + __shfl_xor_sync(0xffffffffu, c1[u], 16);
            const float b = c2[u] + __shfl_xor_sync(0xffffffffu, c2[u], 16);
            if (lane < 16)
              ec_part[wi * kSubN + 8 * cc + u] = make_float2(a, b);
          }
          wg_sync(bar_id);
          {
            // column ct: the warps' sums, then the k-groups', in order
            float o1 = 0.0f, o2 = 0.0f, e1 = 0.0f, e2 = 0.0f;
#pragma unroll
            for (int w = 0; w < 4; ++w) {
              const float2 p = oc_part[w * kSubN + ct];
              o1 += p.x;
              o2 += p.y;
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float2 p = ec_part[q * kSubN + ct];
              e1 += p.x;
              e2 += p.y;
            }
            const int c = cb * kSubN + ct;
            if (rb == 0) {
              ecol1[c] = e1;
              rc1[c] = o1 - e1;
              rc2[c] = o2 - e2;
            } else {
              rc1[c] += o1;
              rc2[c] += o2;
            }
          }
          {
            // row (t >> 1, t & 1) of the quad: observed minus expected
            const int b = t >> 1;
            const int lr = 64 * b + 16 * wi + g + 8 * (t & 1);
            if (b < nbox) {
              const int r = rb * kSubM + lr;
              if (cb == 0) {
                erow1[r] = er1;
                rr1[r] = os1 - er1;
                rr2[r] = os2 - er2;
              } else {
                rr1[r] += os1;
                rr2[r] += os2;
              }
            }
          }
        } else {
          // a build without the epilogue keeps the column products' work
          fence_regs<8>(c1);
          fence_regs<8>(c2);
        }
        if (multi) {
          // a tile of several sub-tiles: this one goes out now
          wg_sync(bar_id);
#pragma unroll
          for (int b = 0; b < 2; ++b)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (!valid[b][h]) continue;
              const size_t grow =
                  size_t(mt) * bm + rb * kSubM + 64 * b + 16 * wi + g + 8 * h;
              float* drow = d + grow * np + size_t(jn) * bn + cb * kSubN +
                            2 * t;
#pragma unroll
              for (int j = 0; j < 16; ++j)
                __stcs(reinterpret_cast<float2*>(drow + 8 * j),
                       make_float2(acc[b][4 * j + 2 * h],
                                   acc[b][4 * j + 2 * h + 1]));
            }
        }
      }

    // verification: max |residual| and max |expected| of the tile (NaN as
    // 0, as locate_tile's compares skip it; non-negative floats order as
    // their bits), a warp's by reduction, then the four warps'; a tile over
    // its threshold is decoded by warp 0 (locate_tile)
    bool hit = false;
    if (!(kCut & 4)) {
      wg_sync(bar_id);
      {
        uint32_t m[4] = {0u, 0u, 0u, 0u};
        for (int c = ct; c < bn; c += 128) {
          const float a = fabsf(rc1[c]), e = fabsf(ecol1[c]);
          m[0] = max(m[0], a == a ? __float_as_uint(a) : 0u);
          m[1] = max(m[1], e == e ? __float_as_uint(e) : 0u);
        }
        for (int r = ct; r < bm; r += 128) {
          const float a = fabsf(rr1[r]), e = fabsf(erow1[r]);
          m[2] = max(m[2], a == a ? __float_as_uint(a) : 0u);
          m[3] = max(m[3], e == e ? __float_as_uint(e) : 0u);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t v = __reduce_max_sync(0xffffffffu, m[q]);
          if (lane == 0) wmx[4 * wi + q] = v;
        }
      }
      wg_sync(bar_id);
      {
        uint32_t m[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int w = 0; w < 4; ++w)
#pragma unroll
          for (int q = 0; q < 4; ++q) m[q] = max(m[q], wmx[4 * w + q]);
        const float thr = thr_factor *
            fmaxf(fmaxf(__uint_as_float(m[1]), __uint_as_float(m[3])), 1.0f);
        hit = own &&
              (__uint_as_float(m[0]) > thr || __uint_as_float(m[2]) > thr);
      }
      if (hit) {
        if (wi == 0) {
          int i, j;
          float delta;
          const int found = locate_tile(ecol1, erow1, rc1, rc2, rr1, rr2, bm,
                                        bn, lane, thr_factor, &i, &j, &delta);
          if (lane == 0) {
            verdict[0] = found;
            verdict[1] = i;
            verdict[2] = j;
            verdict[3] = __float_as_int(delta);
            det[size_t(mt) * nnt + jn] = found;
          }
        }
        wg_sync(bar_id);
      } else if (own && ct == 0) {
        det[size_t(mt) * nnt + jn] = 0;
      }
    }
    if (!multi) {
      // one sub-tile: correct in registers, then store
      if (hit && verdict[0]) {
        const int lr = verdict[1], lc = verdict[2];
        const float delta = __int_as_float(verdict[3]);
#pragma unroll
        for (int b = 0; b < 2; ++b)
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (64 * b + 16 * wi + g + 8 * (e >> 1) == lr &&
                  8 * j + 2 * t + (e & 1) == lc)
                acc[b][4 * j + e] -= delta;
      }
      // D out by TMA: the warp's rows in four 8-row bands (box b, half h),
      // each staged in one of the warp's NB 4 KB buffers and stored as four
      // 32-column boxes while the warp goes on. A band lies wholly inside
      // or outside the tile (bm is a multiple of 8), the same for all the
      // warp's lanes.
      if (!(kCut & 1)) {
        unsigned char* stg0 = sm + Smem::dstage + warp * Smem::dstage_warp;
#pragma unroll
        for (int b = 0; b < 2; ++b)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r0 = 64 * b + 16 * wi + 8 * h;
            if (!own || b >= nbox || r0 >= bm) continue;
            // the warp's buffers in turn, across jobs (a job may store an odd
            // number of bands): this one was last read by the store group
            // NB back, done once at most NB - 1 groups still read the staging
            unsigned char* stg =
                stg0 + (nstored++ % Smem::bands) * Smem::band;
            if (lane == 0) bulk_wait_read<Smem::bands - 1>();
            __syncwarp();
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              const int q = 2 * (j & 3) + (t >> 1);
              *reinterpret_cast<float2*>(stg + (j >> 2) * 1024 + g * 128 +
                                         ((q ^ g) << 4) + 8 * (t & 1)) =
                  make_float2(acc[b][4 * j + 2 * h],
                              acc[b][4 * j + 2 * h + 1]);
            }
            fence_async_smem();
            __syncwarp();
            if (lane == 0) {
              const int row = mt * bm + r0, col = jn * bn;
#pragma unroll
              for (int c = 0; c < 4; ++c)
                tma_store_2d(&dmap, stg + c * 1024, col + 32 * c, row);
              bulk_commit();
            }
          }
      }
    } else if (hit && ct == 0 && verdict[0]) {
      // several sub-tiles, already stored by this warpgroup: patch the one
      // element
      float* p = d + (size_t(mt) * bm + verdict[1]) * np + size_t(jn) * bn +
                 verdict[2];
      *p = __ldcg(p) - __int_as_float(verdict[3]);
    }
  }
  if (lane == 0) bulk_wait_all();   // the D stores done before the block ends
}

// a 2-d map over (inner, outer) of a row-major tensor of 2-byte (bf16 or
// fp16) or 4-byte (f32) values, boxes of {box_inner, box_outer}, 128-byte
// swizzle, zeros past the end
bool map_2d(CUtensorMap* map, const void* base, CUtensorMapDataType type,
            int elt, int inner, int outer, int box_inner, int box_outer) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {cuuint64_t(inner), cuuint64_t(outer)};
  const cuuint64_t strides[1] = {cuuint64_t(inner) * elt};
  const cuuint32_t box[2] = {cuuint32_t(box_inner), cuuint32_t(box_outer)};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool bad_tiles(int mp, int np, int kp, int bm, int bn, int bk) {
  return bm < 8 || bm % 8 || (bm > kSubM && bm % kSubM) || bm > kMaxTile ||
         bn < kSubN || bn % kSubN || bn > kMaxTile || bk < 32 || bk % 32 ||
         mp < bm || mp % bm || np < bn || np % bn || kp < bk || kp % bk;
}

int k_padded(int kp) { return (kp + kStageK - 1) / kStageK * kStageK; }

// the split E_Y's power-of-two scales 2^-e: |e1| <= bn max|y| and |e2| <=
// bn (bn + 1) / 2 max|y|, so a scaled part never exceeds max|y| (fp16's
// range holds it)
int ceil_log2(long long v) {
  int e = 0;
  while ((1LL << e) < v) ++e;
  return e;
}
int scale_e1(int bn) { return ceil_log2(bn); }
int scale_e2(int bn) { return ceil_log2((long long)bn * (bn + 1) / 2); }

template <typename T>
int launch_encode(const T* x, const T* y, float* ex, float* ey, T* esy,
                  int mp, int np, int kp, int bm, int bn, cudaStream_t s) {
  const int kpe = k_padded(kp);
  const long long nxb = (long long)(mp / bm) * (kpe / kStageK);
  const long long nyb = ((long long)(np / bn) * kpe + 7) / 8;
  if (nxb + nyb > INT_MAX) return int(cudaErrorInvalidValue);
  abft_encode_kernel<T><<<int(nxb + nyb), kEncThreads, 0, s>>>(
      x, y, ex, ey, esy, np, kp, kpe, bm, bn, int(nxb), scale_e1(bn),
      scale_e2(bn));
  return int(cudaGetLastError());
}

template <typename T>
int launch_gemm(const T* x, const T* y, const int* inj, const float* ex,
                const T* esy, float* d, int* det, float* ws, int cap,
                float thr_factor, int mp, int np, int kp, int bm, int bn,
                int bk, cudaStream_t s) {
  // a job: two m-tiles (one a warpgroup) x one n-tile
  const long long njobs = (long long)(mp / bm + 1) / 2 * (np / bn);
  if (njobs > INT_MAX) return int(cudaErrorInvalidValue);
  CUtensorMap xm, ym, em, dm;
  const CUtensorMapDataType ty = std::is_same<T, __nv_bfloat16>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  if (!map_2d(&xm, x, ty, 2, kp, mp, 64, 64) ||
      !map_2d(&ym, y, ty, 2, np, kp, 64, 64) ||
      !map_2d(&em, esy, ty, 2, k_padded(kp), 8 * (np / bn), 64, 8) ||
      !map_2d(&dm, d, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, np, mp, 32, 8))
    return int(cudaErrorInvalidValue);
  // a job of at most four k-stages a sub-tile: the f32 D and the
  // epilogue set the pace
  const bool wide = FK_ABFT_RING ? FK_ABFT_RING == 2
                                  : (kp + kStageK - 1) / kStageK <= 4;
  auto kern = wide ? abft_gemm_kernel<T, SmemWide>
                   : abft_gemm_kernel<T, SmemDeep>;
  const size_t bytes = wide ? SmemWide::bytes : SmemDeep::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (e != cudaSuccess) return int(e);
  long long grid = njobs < sm_count() ? njobs : sm_count();
  grid = grid < cap ? grid : cap;
  kern<<<int(grid), kThreads, bytes, s>>>(
      xm, ym, em, dm, ex, inj, d, det, ws, mp, np, kp, k_padded(kp), bm, bn,
      bk, scale_e1(bn), scale_e2(bn), thr_factor);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// The encodings of abft_gemm_kernel: x (mp, kp), y (kp, np) bf16 (half = 0)
// or fp16 (half = 1), 16-byte aligned; ex (mp/bm, kpe, 2) and ey (np/bn,
// kpe, 2) f32, kpe = kp rounded up to 64 (zeros past kp); esy (np/bn, 8,
// kpe) of x's type: per n-tile, e1 2^-ceil(log2 bn) and e2 2^-ceil(log2
// (bn (bn + 1) / 2)) each split into three parts, then two zero rows.
int fk_abft_encode(const void* x, const void* y, float* ex, float* ey,
                   void* esy, int mp, int np, int kp, int bm, int bn,
                   int half, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_tiles(mp, np, kp, bm, bn, 32)) return int(cudaErrorInvalidValue);
  if (half == 0)
    return launch_encode(static_cast<const __nv_bfloat16*>(x),
                         static_cast<const __nv_bfloat16*>(y), ex, ey,
                         static_cast<__nv_bfloat16*>(esy), mp, np, kp, bm,
                         bn, s);
  if (half == 1)
    return launch_encode(static_cast<const __half*>(x),
                         static_cast<const __half*>(y), ex, ey,
                         static_cast<__half*>(esy), mp, np, kp, bm, bn, s);
  return int(cudaErrorInvalidValue);
}

// D = X Y with the ABFT per (bm x bn) tile, from fk_abft_encode's ex and esy
// of the same x, y and tiles: d (mp, np) f32, det (mp/bm, np/bn) int32, inj
// 7 int32 words on the device. ws (ws_floats f32) holds the job state of a
// tile larger than 128 x 128, 12 288 floats a block (a block an SM; unused
// otherwise, may be null).
int fk_abft_gemm(const void* x, const void* y, const int* inj,
                 const float* ex, const void* esy, float* d, int* det,
                 float* ws, long long ws_floats, float thr_factor, int mp,
                 int np, int kp, int bm, int bn, int bk, int half,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_tiles(mp, np, kp, bm, bn, bk)) return int(cudaErrorInvalidValue);
  // a tile larger than a sub-tile keeps its state in ws: blocks are capped
  // to the slices it holds
  const long long cap =
      bm > kSubM || bn > kSubN ? ws_floats / (2LL * 6 * kMaxTile) : INT_MAX;
  if (cap < 1) return int(cudaErrorInvalidValue);
  if (half == 0)
    return launch_gemm(static_cast<const __nv_bfloat16*>(x),
                       static_cast<const __nv_bfloat16*>(y), inj, ex,
                       static_cast<const __nv_bfloat16*>(esy), d, det, ws,
                       int(cap), thr_factor, mp, np, kp, bm, bn, bk, s);
  if (half == 1)
    return launch_gemm(static_cast<const __half*>(x),
                       static_cast<const __half*>(y), inj, ex,
                       static_cast<const __half*>(esy), d, det, ws, int(cap),
                       thr_factor, mp, np, kp, bm, bn, bk, s);
  return int(cudaErrorInvalidValue);
}

const char* fk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
