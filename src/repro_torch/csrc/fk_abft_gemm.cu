// Hand-written Hopper (sm_90a) ABFT GEMM for f32, bf16 and fp16 X and Y.
//
// Replaces the Pallas TPU kernel matmul_abft of
// src/repro/kernels/matmul_abft.py (body _kernel) at every input dtype: D =
// X Y in f32 for X (mp, kp) and Y (kp, np), with the dual-checksum
// invariant per verification tile of bm x bn. Each tile's expected checksums
//
//   col1 = (e1^T X_t) Y_t   col2 = (e2^T X_t) Y_t
//   row1 = X_t (Y_t e1)     row2 = X_t (Y_t e2)    e1 = 1, e2 = 1..b
//
// are compared with its observed ones against threshold_factor(kp, dtype) *
// max(max|col1|, max|row1|, 1) (the expected, clean side); a fault is
// located by the e2/e1 ratio and one element corrected (locate_tile,
// fk_abft.cuh); inj = [enabled, m_tile, n_tile, k_step, row, col, delta
// bits] plants one fault after k-step k_step of bk. det (mp/bm, np/bn) gets
// each tile's detection.
//
// Bound on the H100: at 2 bytes, 2 mp np kp FLOPs on the tensor cores (989
// TFLOP/s) or, for a short kp, the bytes of the f32 D (3.35 TB/s); at f32,
// the six bf16 products of the split below, 6 x 2 mp np kp FLOPs on the
// tensor cores (an f32 product on the CUDA cores, 67 TFLOP/s, is 2.5x
// that), or the f32 D's bytes. The design keeps the checksums off the
// product's path:
//
//   * abft_encode_kernel<T> (a pre-pass, fk_abft_encode): the encodings
//     once per call, not once per output tile: E_X[mt, k] =
//     (e1^T X_t, e2^T X_t)[k] for each m-tile and E_Y[nt, k] = (Y_t e1,
//     Y_t e2)[k] for each n-tile, f32 sums of the values (2-byte ones
//     widened exactly), in a fixed order, as (tiles, kpe, 2) float pairs
//     (kpe = kp rounded up to 64; zeros past kp); at 2 bytes also E_Y split
//     for the tensor cores (esy), at f32 Y's three bf16 planes (below),
//     then abft_colsum_kernel and abft_rowsum_kernel, the expected column
//     and row checksums. The weights are the row or column index within
//     the tile, plus 1. It reads X and Y once (at f32 twice).
//   * abft_gemm_kernel<T, Smem> (fk_abft_gemm): persistent, one block of
//     384 threads an SM walks the jobs, a job being two m-tiles (one a
//     consumer warpgroup) x one n-tile, in sub-tiles of 128 rows x 128
//     columns; the jobs go out in groups of kGroupM m-tile pairs so the
//     blocks in flight share X and Y through L2. Warpgroup 2 produces: one
//     thread TMA-loads each k-stage into a ring guarded by a "full"
//     mbarrier (the bytes) and an "empty" one (the 256 consumer threads): X
//     as 64-row boxes of 128-byte rows (K-major), Y as two 64-column panels
//     read as they lie (MN-major), all 128-byte swizzled, and at 2 bytes
//     the stage's encodings by bulk copy. It gives its registers to the consumers
//     (setmaxnreg 40 / 232, the role broadcast warp-uniform), whose 128 f32
//     accumulators a thread would not fit the 168 that 12 warps leave. Each
//     consumer warpgroup runs its 128 x 128 product with wgmma.mma_async
//     on its two X boxes and the shared Y panels (B with imm-trans-b, so Y
//     is never transposed).
//   * at 2 bytes (stages 64 deep): wgmma m64n128k16 with X and Y from
//     shared memory, one stage's group kept in flight. While a stage's
//     product runs, the threads compute the column checksums col{1,2} +=
//     E_X Y_stage on the CUDA cores from the same resident stage, reading
//     through the swizzle (a thread: 8 columns, 8 k rows); 2 K 128 FMAs a
//     128 x 128 sub-tile. The row checksums row{1,2} = X E_Y run on the
//     tensor cores in the same groups: the pre-pass splits E_Y (scaled by
//     powers of two so fp16 holds it) into three 2-byte parts a value, an
//     8-column K-major operand loaded with the stage, and wgmma m64n8k16
//     gives the parts' products, summed (hi + mid) + lo in the epilogue.
//   * at f32 (stages 32 deep, so a 64-row box of f32 X is 128-byte rows):
//     an f32-exact split on the bf16 tensor cores. A value v is split as
//     hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid), each
//     rounded to nearest (split3_bf16x2; hi saturates at bf16's largest
//     finite value, so every finite f32 of magnitude 2^-110 or more, f32's
//     largest included, is hi + mid + lo exactly: bf16 has f32's exponent
//     range and each part takes the next 8 bits); D accumulates the six
//     products with i + j <= 2 (hi hi, hi mid, mid hi, hi lo, mid mid, lo
//     hi), each exact in f32; the three dropped ones are at most 2^-23
//     |x||y| together (|mid| <= 2^-8 |v|, |lo| <= 2^-16 |v|), under f32's
//     own rounding of the sum. The pre-pass writes Y's three planes (bf16,
//     (3, kp, np)); X is TMA-loaded as f32 and each consumer thread splits
//     its wgmma A fragment in registers (wgmma with A from registers, K-major
//     as X lies): no copy of X, the largest operand (512 MiB at M 2^20, K
//     128). Accumulation: the tensor cores' f32 accumulation does not
//     round each add to nearest, and a first design that chained all six
//     products of every 16-deep k-step in the one accumulator (768 chained
//     wgmma at K 2048) put D 8.4e-5 off the f32 product on the H100, over
//     the 1e-5 of max |D| the checks hold it to. So each (box, 16-deep
//     k-step, 64-column half) runs its six products as wgmma m64n64k16 into
//     a fresh f32 partial (the first with scale-d 0), and the partial is
//     added to the accumulator on the CUDA cores, rounded to nearest: the
//     cut adds stay within a partial and their signs vary from one partial
//     to the next (D then lies closer to the exact product than
//     torch.matmul's f32 on the same card). The partial's 32 registers and
//     the fragment's 12 beside the accumulator's 128 leave one group in
//     flight a warpgroup; the other warpgroup's products fill the tensor
//     cores while one adds. Timed on the H100, a partial a stage (two
//     k-steps, both fragments live) ran 5-9 % slower: the kernel spilled
//     more. The expected checksums come from the pre-pass and are read in
//     the epilogue: abft_colsum_kernel (E_X Y per m-tile, 4 (mp/bm) kp np
//     FLOPs) and abft_rowsum_kernel (X E_Y per n-tile, 4 mp kp (np/bn)),
//     each about 2/b of the product's FLOPs on the CUDA cores in f32 FMAs,
//     the reference's precision. In the loop (as at 2 bytes, or as FMAs on
//     the X fragments in registers) their accumulators beside the
//     partial's and the fragment's made the kernel spill: timed on the
//     H100 at 8192 x 2048 x 8192, the column ones cost 2.2 ms of 5.9, the
//     row ones 1.0 of 3.8, where the two pre-pass kernels take 0.45.
//     3xTF32 (hi hi + hi lo + lo hi at 495 TFLOP/s) was not taken: its
//     error is ~2^-20 of |x||y|, 16x f32's, which eats the clean residual's
//     margin under the f32 threshold, and TF32 wgmma takes K-major operands
//     only, so Y would need a transposed copy. A stage is X 32 KB + Y 24 KB (three planes x
//     two 4 KB panels): three stages (96 k in flight) fit beside the
//     epilogue's state and one D staging band a warp. A stage is released
//     once its last group is done.
//   * the epilogue from registers: observed row sums (a quad's shuffles)
//     and column sums (a reduce-scatter over the 8 row groups of a warp,
//     then the 4 warps in order through shared memory), the expected row
//     sums gathered in a quad, the column ones' partials in order (at f32
//     both read from the pre-pass, the loads issued first); rows
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
//   * two configurations (Smem<stages, bands, f32>): a 3-stage ring where
//     the k loop is long (the product sets the pace), a 2-stage ring with
//     twice the D staging where Kp <= 256 at 2 bytes (the f32 D's stores
//     and the epilogue set the pace; timed on the H100 at 2 bytes, the
//     2-stage ring is 11 % faster at Kp 128, 6-7 % at 192, 1-2 % at 256 and
//     11-13 % slower at 512). At f32 the 3-stage ring at every Kp: there the
//     2-stage one was 1.8-5.6 % slower at Kp 128-512 (timed on the H100).
//   * the fault is added to the accumulator register that holds (row,
//     col), after the stage that ends k-step k_step; a k-step shallower
//     than a stage (bk = 32 at 2 bytes) lands at that stage's end, at f32
//     every k-step ends at a stage's end.
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
constexpr int kStageK = 64;       // k of a 2-byte ring stage, of E_X blocks
constexpr int kStageKF32 = 32;    // k of an f32 ring stage
constexpr int kMaxTile = 1024;    // the largest bm and bn
constexpr int kEncThreads = 256;

// Measurement builds only (python -m repro_torch.launch.abft_profile):
// FK_ABFT_CUT leaves parts of abft_gemm_kernel out to split its time (bit
// 0: the D stores of a one-sub-tile tile, 1: the column checksum products
// (2 bytes; at f32 they are the pre-pass's),
// 2: the verification epilogue; D and the detections are then wrong), and
// FK_ABFT_RING forces a 2-byte ring configuration (1: the deep ring, 2:
// the wide one). The port's own build sets neither.
#ifndef FK_ABFT_CUT
#define FK_ABFT_CUT 0
#endif
#ifndef FK_ABFT_RING
#define FK_ABFT_RING 0
#endif
constexpr int kCut = FK_ABFT_CUT;

// Shared memory of abft_gemm_kernel, in bytes from a 1024-aligned base: the
// ring, then one region a consumer warpgroup.
template <int S, int NB, bool F32 = false>
struct Smem {
  static constexpr int stages = S;      // the ring's k-stages
  static constexpr int bands = NB;      // 8-row D bands a warp stages
  // k of a stage: a 128-byte X row holds 64 2-byte values or 32 f32 ones
  static constexpr int stage_k = F32 ? kStageKF32 : kStageK;
  static constexpr int box = 64 * 128;              // X: 64 rows x 128 bytes
  // Y: a panel of stage_k rows x 64 2-byte columns, two a plane; one plane
  // at 2 bytes (Y itself), three at f32 (hi, mid, lo)
  static constexpr int ypanel = stage_k * 128;
  static constexpr int yplanes = F32 ? 3 : 1;
  static constexpr int stage = 4 * box + 2 * yplanes * ypanel;
  static constexpr int ring = 0;
  // a 2-byte stage's split E_Y block (8 rows x 64 k of T, 128-byte
  // swizzled); none at f32
  static constexpr int esy_stage = F32 ? 0 : 8 * 128;
  static constexpr int esy = ring + S * stage;
  // E_X of the 2 tiles, (e1, e2) pairs (2 bytes: the column checksums'
  // operand; none at f32, whose checksums come from the pre-pass)
  static constexpr int enc_stage = F32 ? 0 : 2 * stage_k * 8;
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
// the configurations: at 2 bytes a deep ring for a long k loop (the
// product sets the pace), a shallow one and twice the D staging for a short
// one (the f32 D's stores set it); at f32 the deep ring
using SmemDeep = Smem<3, 1>;
using SmemWide = Smem<2, 2>;
using SmemDeepF32 = Smem<3, 1, true>;
static_assert(SmemDeep::bytes <= 232448 && SmemWide::bytes <= 232448 &&
                  SmemDeepF32::bytes <= 232448,
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

// The f32 operand split: v = hi + mid + lo in three bf16 values, each
// rounded to nearest from what the earlier ones leave, hi saturated at
// bf16's largest finite value (f32's largest then splits exactly too);
// two values at once, as the bf16x2 words wgmma takes (the first value in
// the low half). +-inf gives (+-max, +-inf, NaN) and NaN (-max, NaN, NaN):
// a non-finite value makes its products NaN. Plain version:
// kernels/matmul_abft.split3_plain.
constexpr float kBf16Max = 0x1.fep+127f;
__device__ __forceinline__ uint32_t bf16x2_rn(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ void split3_bf16x2(float a, float b, uint32_t& hi,
                                              uint32_t& mid, uint32_t& lo) {
  hi = bf16x2_rn(fminf(fmaxf(a, -kBf16Max), kBf16Max),
                 fminf(fmaxf(b, -kBf16Max), kBf16Max));
  const float ra = a - __uint_as_float(hi << 16);
  const float rb = b - __uint_as_float(hi & 0xffff0000u);
  mid = bf16x2_rn(ra, rb);
  lo = bf16x2_rn(ra - __uint_as_float(mid << 16),
                 rb - __uint_as_float(mid & 0xffff0000u));
}

// two / eight consecutive input values as f32 (2-byte ones widened exactly)
__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}
template <typename T>
__device__ __forceinline__ void load2(const T* p, float& a, float& b) {
  unpack2(*reinterpret_cast<const uint32_t*>(p), a, b, T());
}
__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  const float4 v = *reinterpret_cast<const float4*>(p + 4);
  f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
  f[4] = v.x; f[5] = v.y; f[6] = v.z; f[7] = v.w;
}
template <typename T>
__device__ __forceinline__ void load8(const T* p, float* f) {
  unpack8<T>(*reinterpret_cast<const uint4*>(p), f);
}

// Blocks [0, nxb): E_X of (m-tile, 64 k), 32 lanes a k pair x 8 row groups
// (rows r = group mod 8), the groups summed in order. Blocks past nxb: E_Y,
// one warp a (n-tile, k), lane l summing chunks l, l + 32, .. of 8 columns,
// then a butterfly. At 2 bytes lane 0 also writes the split E_Y (esy,
// (np/bn, 8, kpe) in T) that the GEMM's row checksums take on the tensor
// cores; at f32 each lane writes its chunks' split into Y's planes (esy,
// (3, kp, np) bf16: hi, mid, lo), the GEMM's B operands.
template <typename T>
__global__ void __launch_bounds__(kEncThreads)
abft_encode_kernel(const T* __restrict__ x, const T* __restrict__ y,
                   float* __restrict__ ex, float* __restrict__ ey,
                   void* __restrict__ esy_out, int np, int kp, int kpe,
                   int bm, int bn, int nxb, int es1, int es2) {
  constexpr bool kF32 = std::is_same<T, float>::value;
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
        load2(xc + size_t(r) * kp, f0, f1);
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
      load8(yr + 8 * c, f);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s1 += f[i];
        s2 = fmaf(float(8 * c + i + 1), f[i], s2);
      }
      if constexpr (kF32) {
        uint4 hi, mid, lo;
        split3_bf16x2(f[0], f[1], hi.x, mid.x, lo.x);
        split3_bf16x2(f[2], f[3], hi.y, mid.y, lo.y);
        split3_bf16x2(f[4], f[5], hi.z, mid.z, lo.z);
        split3_bf16x2(f[6], f[7], hi.w, mid.w, lo.w);
        const size_t plane = size_t(kp) * np;
        __nv_bfloat16* o = static_cast<__nv_bfloat16*>(esy_out) +
                           size_t(k) * np + size_t(nt) * bn + 8 * c;
        *reinterpret_cast<uint4*>(o) = hi;
        *reinterpret_cast<uint4*>(o + plane) = mid;
        *reinterpret_cast<uint4*>(o + 2 * plane) = lo;
      }
    }
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0)
    reinterpret_cast<float2*>(ey)[size_t(nt) * kpe + k] = make_float2(s1, s2);
  if constexpr (!kF32) {
    // the row checksums' B operand: e1 2^-es1 and e2 2^-es2, each split
    // into three T parts (hi + mid + lo), rows 0-2 and 3-5 of the n-tile's
    // 8; lane q writes row q
    if (lane < 8) {
      T part[3];
      split3(ldexpf(lane < 3 ? s1 : s2, lane < 3 ? -es1 : -es2), part[0],
             part[1], part[2]);
      const int q = lane < 3 ? lane : lane - 3;
      static_cast<T*>(esy_out)[(size_t(nt) * 8 + lane) * kpe + k] =
          lane >= 6 ? to_t<T>(0.0f)
                    : q == 0 ? part[0] : q == 1 ? part[1] : part[2];
    }
  }
}

// The f32 GEMM's expected column checksums, once per call: ecol[mt, n] =
// (sum_k E_X[mt, k].e1 Y[k, n], sum_k E_X[mt, k].e2 Y[k, n]) in f32 FMAs, as
// (nmt, np) float pairs. A block takes kColTiles m-tiles x 256 columns, its
// four slices of 64 threads a quarter of the 64-k chunks each; a thread owns
// 4 columns of Y (one 16-byte load a k), 64 accumulators, its slice's E_X
// staged in shared memory and read as broadcasts. The slices' sums are
// added in slice order: a fixed order, so launches repeat bit for bit.
constexpr int kColTiles = 8;
constexpr int kColSlices = 4;
constexpr int kColSliceThreads = 64;
constexpr int kColThreads = kColSlices * kColSliceThreads;
__global__ void __launch_bounds__(kColThreads)
abft_colsum_kernel(const float* __restrict__ ex, const float* __restrict__ y,
                   float* __restrict__ ecol, int nmt, int np, int kp,
                   int kpe) {
  // e[slice][kk][i]: (e1, e2) of m-tiles 2 i and 2 i + 1 at k kk of the
  // slice's chunk; then the slices' partial sums, one slice at a time
  __shared__ float4 e[kColSlices][kStageK][kColTiles / 2];
  float* red = reinterpret_cast<float*>(&e[0][0][0]);
  const int slice = threadIdx.x / kColSliceThreads;
  const int lt = threadIdx.x % kColSliceThreads;
  const int n = (blockIdx.x * kColSliceThreads + lt) * 4;
  const int mt0 = blockIdx.y * kColTiles;
  const float2* ex2 = reinterpret_cast<const float2*>(ex);
  const int chunks = (kp + kStageK - 1) / kStageK;
  const int per = (chunks + kColSlices - 1) / kColSlices;
  float a1[kColTiles][4], a2[kColTiles][4];
#pragma unroll
  for (int i = 0; i < kColTiles; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) a1[i][c] = a2[i][c] = 0.0f;
  for (int ci = 0; ci < per; ++ci) {
    const int chunk = slice * per + ci;
    const int k0 = chunk * kStageK;
    for (int i = lt; i < kColTiles * kStageK; i += kColSliceThreads) {
      const int tile = i / kStageK, kk = i % kStageK, mt = mt0 + tile;
      reinterpret_cast<float2*>(&e[slice][kk][0])[tile] =
          mt < nmt && chunk < chunks ? ex2[size_t(mt) * kpe + k0 + kk]
                                     : make_float2(0.0f, 0.0f);
    }
    __syncthreads();
    const int kn = chunk >= chunks ? 0
                   : kp - k0 < kStageK ? kp - k0 : kStageK;
    if (n < np) {
      const float* yc = y + size_t(k0) * np + n;
#pragma unroll 8
      for (int kk = 0; kk < kn; ++kk) {
        const float4 v =
            *reinterpret_cast<const float4*>(yc + size_t(kk) * np);
        const float vy[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < kColTiles / 2; ++i) {
          const float4 w = e[slice][kk][i];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            a1[2 * i][c] = fmaf(w.x, vy[c], a1[2 * i][c]);
            a2[2 * i][c] = fmaf(w.y, vy[c], a2[2 * i][c]);
            a1[2 * i + 1][c] = fmaf(w.z, vy[c], a1[2 * i + 1][c]);
            a2[2 * i + 1][c] = fmaf(w.w, vy[c], a2[2 * i + 1][c]);
          }
        }
      }
    }
    __syncthreads();
  }
  // slice 0 adds the other slices that had chunks in turn (64 floats a
  // thread through shared memory, 16 KB a round), then writes
  const int used = (chunks + per - 1) / per;
  for (int sl = 1; sl < used; ++sl) {
    if (slice == sl)
#pragma unroll
      for (int i = 0; i < kColTiles; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          red[((i * 4 + c) * 2) * kColSliceThreads + lt] = a1[i][c];
          red[((i * 4 + c) * 2 + 1) * kColSliceThreads + lt] = a2[i][c];
        }
    __syncthreads();
    if (slice == 0)
#pragma unroll
      for (int i = 0; i < kColTiles; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          a1[i][c] += red[((i * 4 + c) * 2) * kColSliceThreads + lt];
          a2[i][c] += red[((i * 4 + c) * 2 + 1) * kColSliceThreads + lt];
        }
    __syncthreads();
  }
  if (slice == 0 && n < np)
#pragma unroll
    for (int i = 0; i < kColTiles; ++i)
      if (mt0 + i < nmt) {
        float4* o = reinterpret_cast<float4*>(
            ecol + (size_t(mt0 + i) * np + n) * 2);
        o[0] = make_float4(a1[i][0], a2[i][0], a1[i][1], a2[i][1]);
        o[1] = make_float4(a1[i][2], a2[i][2], a1[i][3], a2[i][3]);
      }
}

// The f32 GEMM's expected row checksums, once per call: erow[nt, m] =
// (sum_k X[m, k] E_Y[nt, k].e1, sum_k X[m, k] E_Y[nt, k].e2) in f32 FMAs, k
// in order, as (np/bn, mp) float pairs. A block of 256 threads takes 256 /
// G rows and 8 G n-tiles (blockIdx.y: the n-tile group), a thread one row
// and 8 n-tiles: G = 1 when there are at most 8 n-tiles (one thread a
// row), else 4 (more blocks). It stages 32 k of its rows (padded against
// bank conflicts; rows past mp are zeros, not written) and of its n-tiles'
// E_Y, read as broadcasts, 16 bytes at a time, each chunk fetched while
// the chunk before is summed.
constexpr int kRowThreads = 256;
constexpr int kRowTilesThread = 8;
template <int G>
__global__ void __launch_bounds__(kRowThreads)
abft_rowsum_kernel(const float* __restrict__ x, const float* __restrict__ ey,
                   float* __restrict__ erow, int mp, int kp, int kpe,
                   int nnt) {
  constexpr int R = kRowThreads / G, KC = kStageKF32;
  __shared__ float xs[R][KC + 1];
  __shared__ float4 es[KC][G][kRowTilesThread / 2];
  const int tid = threadIdx.x;
  const int r = tid % R, jq = tid / R;
  const int m0 = blockIdx.x * R;
  const int j0 = blockIdx.y * G * kRowTilesThread + jq * kRowTilesThread;
  const float2* ey2 = reinterpret_cast<const float2*>(ey);
  float a1[kRowTilesThread], a2[kRowTilesThread];
#pragma unroll
  for (int i = 0; i < kRowTilesThread; ++i) a1[i] = a2[i] = 0.0f;
  // a chunk's staging, a thread's share: XL values of X, EL pairs of E_Y,
  // fetched into registers one chunk ahead so the loads run under the
  // FMAs of the chunk before
  constexpr int XL = R * KC / kRowThreads;
  constexpr int EL = G * kRowTilesThread * KC / kRowThreads;
  float xr[XL];
  float2 er[EL];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int q = 0; q < XL; ++q) {
      const int i = tid + q * kRowThreads, row = i / KC, kk = i % KC;
      xr[q] = m0 + row < mp ? x[size_t(m0 + row) * kp + k0 + kk] : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < EL; ++q) {
      const int i = tid + q * kRowThreads, tile = i / KC, kk = i % KC;
      const int j = blockIdx.y * G * kRowTilesThread + tile;
      er[q] = j < nnt ? ey2[size_t(j) * kpe + k0 + kk]
                      : make_float2(0.0f, 0.0f);
    }
  };
  fetch(0);
  for (int k0 = 0; k0 < kp; k0 += KC) {
#pragma unroll
    for (int q = 0; q < XL; ++q) {
      const int i = tid + q * kRowThreads;
      xs[i / KC][i % KC] = xr[q];
    }
#pragma unroll
    for (int q = 0; q < EL; ++q) {
      const int i = tid + q * kRowThreads;
      reinterpret_cast<float2*>(&es[i % KC][0][0])[i / KC] = er[q];
    }
    __syncthreads();
    if (k0 + KC < kp) fetch(k0 + KC);
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      const float v = xs[r][kk];
#pragma unroll
      for (int i = 0; i < kRowTilesThread / 2; ++i) {
        const float4 e = es[kk][jq][i];
        a1[2 * i] = fmaf(v, e.x, a1[2 * i]);
        a2[2 * i] = fmaf(v, e.y, a2[2 * i]);
        a1[2 * i + 1] = fmaf(v, e.z, a1[2 * i + 1]);
        a2[2 * i + 1] = fmaf(v, e.w, a2[2 * i + 1]);
      }
    }
    __syncthreads();
  }
  if (m0 + r < mp)
#pragma unroll
    for (int i = 0; i < kRowTilesThread; ++i)
      if (j0 + i < nnt)
        reinterpret_cast<float2*>(erow)[size_t(j0 + i) * mp + m0 + r] =
            make_float2(a1[i], a2[i]);
}

// A warpgroup's job state (the arrays locate_tile reads), from its base
// pointer pinned where it is used (an opaque copy): the base is live across
// the whole k loop, where ptxas spilled it and reloaded it at every access
// (timed on the H100, pinned the 2-byte kernel spills 12 bytes of loads
// instead of 188 and runs up to 3 % faster)
struct JobState {
  float *ecol1, *rc1, *rc2, *erow1, *rr1, *rr2;
};
__device__ __forceinline__ JobState job_state(float* base, int len) {
  asm volatile("" : "+l"(base));
  return {base,           base + len,     base + 2 * len,
          base + 3 * len, base + 4 * len, base + 5 * len};
}

template <typename T, typename Smem>
__global__ void __launch_bounds__(kThreads, 1)
abft_gemm_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap ymap,
                 const __grid_constant__ CUtensorMap emap,
                 const __grid_constant__ CUtensorMap dmap,
                 const float* __restrict__ ex, const float* __restrict__ erow,
                 const float* __restrict__ ecol,
                 const int* __restrict__ inj, float* __restrict__ d,
                 int* __restrict__ det, float* __restrict__ ws, int mp,
                 int np, int kp, int kpe, int bm, int bn, int bk, int es1,
                 int es2, float thr_factor) {
  // f32: the split on bf16 wgmma with A from registers; else T's wgmma
  // from shared memory
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int SK = Smem::stage_k;
  static_assert(kF32 == (Smem::yplanes == 3), "stage layout of T");
  extern __shared__ unsigned char sm_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(sm_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + Smem::bars);
  uint64_t* empty = full + Smem::stages;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nmt = mp / bm, nnt = np / bn;
  const int njm = (nmt + 1) / 2;
  const int njobs = njm * nnt;         // two m-tiles x one n-tile
  const int nbox = bm <= 64 ? 1 : 2;   // 64-row X boxes a sub-tile holds
  // X boxes loaded and multiplied: at f32 always two (a box past a tile
  // under 64 rows is masked like its rows past bm)
  const int nxb = kF32 ? 2 : nbox;
  const int rbs = bm > kSubM ? bm / kSubM : 1;
  const int cbs = bn / kSubN;
  const int nks = (kp + SK - 1) / SK;
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
  float* const state0 =
      multi ? ws + size_t(2 * blockIdx.x + cw) * 6 * kMaxTile
            : reinterpret_cast<float*>(wsm + Smem::state);
  float2* oc_part = reinterpret_cast<float2*>(wsm + Smem::oc);
  float2* ec_part = reinterpret_cast<float2*>(wsm + Smem::ec);
  uint32_t* wmx = reinterpret_cast<uint32_t*>(wsm + Smem::mx);
  int* verdict = reinterpret_cast<int*>(wsm + Smem::verdict);
  const int bar_id = 1 + cw;
  // checksum-product roles: row ct of the sub-tile (all of a stage's k);
  // at 2 bytes columns 8 cc .. 8 cc + 7 over k rows 8 cq .. 8 cq + 7 of a
  // stage
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
  const uint32_t tx_bytes = 2 * nxb * Smem::box +
                            2 * Smem::yplanes * Smem::ypanel +
                            Smem::esy_stage + Smem::enc_stage;
  auto load_stage = [&](int G) {
    if (G >= total) return;
    const int st = G % Smem::stages;
    const int li = G / spj, r = G - li * spj;
    const int job = int(blockIdx.x) + li * int(gridDim.x);
    int jm, jn;
    job_coords(job, njm, nnt, jm, jn);
    const int rb = r / (cbs * nks), cb = (r / nks) % cbs, s = r % nks;
    const int n0 = jn * bn + cb * kSubN, k0 = s * SK;
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
      if (nxb == 2)
        tma_load_2d(xs + (2 * w + 1) * Smem::box, &xmap, full + st, k0,
                    row0 + 64);
      if constexpr (!kF32)
        bulk_load(es + w * SK * 8, ex + (size_t(mt) * kpe + k0) * 2, SK * 8,
                  full + st);
    }
    // Y's planes (one at 2 bytes), each as two 64-column panels; the f32
    // planes lie stacked, plane p's row k at row p kp + k of the map
#pragma unroll
    for (int p = 0; p < Smem::yplanes; ++p)
#pragma unroll
      for (int q = 0; q < 2; ++q)
        tma_load_2d(xs + 4 * Smem::box + (2 * p + q) * Smem::ypanel, &ymap,
                    full + st, n0 + 64 * q, p * kp + k0);
    if constexpr (!kF32)
      tma_load_2d(sm + Smem::esy + st * Smem::esy_stage, &emap, full + st,
                  k0, 8 * jn);
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
          inj_stage = ((inj_ks + 1) * bk - 1) / SK;
#pragma unroll
        for (int b = 0; b < 2; ++b)
#pragma unroll
          for (int q = 0; q < 64; ++q) acc[b][q] = 0.0f;
        // at 2 bytes the row checksums' split parts' products (64 x 8 a
        // box, on the tensor cores) and the column ones' partials [8]
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
          if constexpr (kF32) {
#pragma unroll
            for (int b = 0; b < 2; ++b)
#pragma unroll
              for (int kk = 0; kk < SK / 16; ++kk) {
                // the fragment of box b and 16-k step kk: this thread's X,
                // rows 16 wi + g + 8 h, k 16 kk + 2 t + {0, 1} (q = 0) and
                // + 8 (q = 1) as v[2 q + h] (wgmma's A register order),
                // split into hi, mid, lo x wgmma's four A words
                const unsigned char* xb = xs + b * Smem::box;
                float2 v[4];
#pragma unroll
                for (int q = 0; q < 2; ++q)
#pragma unroll
                  for (int h = 0; h < 2; ++h) {
                    const int r = 16 * wi + g + 8 * h;
                    const int chunk = (4 * kk + (t >> 1) + 2 * q) ^ (r & 7);
                    v[2 * q + h] = *reinterpret_cast<const float2*>(
                        xb + r * 128 + (chunk << 4) + 8 * (t & 1));
                  }
                uint32_t fa[3][4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                  split3_bf16x2(v[i].x, v[i].y, fa[0][i], fa[1][i], fa[2][i]);
                // each 64-column half: the six products into a fresh f32
                // partial on the tensor cores (the first with scale-d 0),
                // then added to the accumulator on the CUDA cores, rounded
                // to nearest
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {
                  const unsigned char* yk =
                      ys + hf * Smem::ypanel + kk * 16 * 128;
                  const uint64_t yh = sw128_desc(yk, Smem::ypanel);
                  const uint64_t ym =
                      sw128_desc(yk + 2 * Smem::ypanel, Smem::ypanel);
                  const uint64_t yl =
                      sw128_desc(yk + 4 * Smem::ypanel, Smem::ypanel);
                  float part[32];
                  wg_fence();
                  wgmma_rs_n64(part, fa[0], yh, 0, __nv_bfloat16());
                  wgmma_rs_n64(part, fa[0], ym, 1, __nv_bfloat16());
                  wgmma_rs_n64(part, fa[1], yh, 1, __nv_bfloat16());
                  wgmma_rs_n64(part, fa[0], yl, 1, __nv_bfloat16());
                  wgmma_rs_n64(part, fa[1], ym, 1, __nv_bfloat16());
                  wgmma_rs_n64(part, fa[2], yh, 1, __nv_bfloat16());
                  wg_commit();
                  wg_wait<0>();
                  fence_regs<32>(part);
#pragma unroll
                  for (int i = 0; i < 32; ++i) acc[b][32 * hf + i] += part[i];
                }
              }
            // every read of the stage is done: release it (the last one
            // of the sub-tile after the loop)
            if (s + 1 < nks) release(it);
          } else {
            const unsigned char* es = sm + Smem::enc + st * Smem::enc_stage;
            const unsigned char* eys = sm + Smem::esy + st * Smem::esy_stage;
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < SK / 16; ++kk)
              wgmma_ss_tb_n128(acc[0], sw128_desc(xs + kk * 32, 16),
                               sw128_desc(ys + kk * 16 * 128, Smem::ypanel),
                               T());
            if (nbox == 2) {
#pragma unroll
              for (int kk = 0; kk < SK / 16; ++kk)
                wgmma_ss_tb_n128(acc[1],
                                 sw128_desc(xs + Smem::box + kk * 32, 16),
                                 sw128_desc(ys + kk * 16 * 128, Smem::ypanel),
                                 T());
            }
            // row{1,2} += X_stage E_Y on the tensor cores: the split E_Y as
            // an 8-column K-major B
#pragma unroll
            for (int kk = 0; kk < SK / 16; ++kk)
              wgmma_ss_n8(racc[0], sw128_desc(xs + kk * 32, 16),
                          sw128_desc(eys + kk * 32, 16), T());
            if (nbox == 2) {
#pragma unroll
              for (int kk = 0; kk < SK / 16; ++kk)
                wgmma_ss_n8(racc[1], sw128_desc(xs + Smem::box + kk * 32, 16),
                            sw128_desc(eys + kk * 32, 16), T());
            }
            wg_commit();
            // stage it - 1's product is done: release it before this
            // stage's checksum products, so its slot refills sooner
            wg_wait<1>();
            if (s > 0) release(it - 1);
            // col{1,2} += E_X Y_stage: columns 8 cc .., k rows 8 cq ..
            if (!(kCut & 2)) {
              const unsigned char* yp = ys + (cc >> 3) * Smem::ypanel;
              const float2* exv =
                  reinterpret_cast<const float2*>(es + cw * SK * 8);
              const int ch = cc & 7;
#pragma unroll
              for (int q = 0; q < SK / 8; ++q) {
                const int kr = SK / 8 * cq + q;
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
          // f32: the pre-pass's expected checksums, loaded first so that
          // the loads run under the observed sums: (e1, e2) of column ct
          // and of row (t >> 1, t & 1) of the quad; where the tile holds
          // them (the first sub-tile row or column of a larger tile)
          float2 ecp = make_float2(0.0f, 0.0f), erp = ecp;
          if constexpr (kF32) {
            if (own && rb == 0)
              ecp = reinterpret_cast<const float2*>(ecol)[
                  size_t(mt) * np + size_t(jn) * bn + cb * kSubN + ct];
            const int lr = 64 * (t >> 1) + 16 * wi + g + 8 * (t & 1);
            if (own && cb == 0 && (t >> 1) < nbox && (bm >= kSubM || lr < bm))
              erp = reinterpret_cast<const float2*>(erow)[
                  size_t(jn) * mp + size_t(mt) * bm + rb * kSubM + lr];
          }
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
          // expected row sums: at 2 bytes the quad's 8 split parts of each
          // of its 4 rows gathered in every lane, (hi + mid) + lo unscaled;
          // at f32 the pre-pass's; lane t keeps row (t >> 1, t & 1)
          float er1 = erp.x, er2 = erp.y;
          if constexpr (!kF32) {
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
          }
          if constexpr (!kF32) {
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              // k-groups 2 w and 2 w + 1 sit in lanes l and l ^ 16 of warp
              // w
              const float a = c1[u] + __shfl_xor_sync(0xffffffffu, c1[u], 16);
              const float b = c2[u] + __shfl_xor_sync(0xffffffffu, c2[u], 16);
              if (lane < 16)
                ec_part[wi * kSubN + 8 * cc + u] = make_float2(a, b);
            }
          }
          wg_sync(bar_id);
          {
            // column ct: the warps' sums, then the k-groups' (at f32 the
            // pre-pass's expected sums of the m-tile), in order
            float o1 = 0.0f, o2 = 0.0f, e1 = 0.0f, e2 = 0.0f;
#pragma unroll
            for (int w = 0; w < 4; ++w) {
              const float2 p = oc_part[w * kSubN + ct];
              o1 += p.x;
              o2 += p.y;
            }
            if constexpr (kF32) {
              e1 = ecp.x;
              e2 = ecp.y;
            } else {
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const float2 p = ec_part[q * kSubN + ct];
                e1 += p.x;
                e2 += p.y;
              }
            }
            const int c = cb * kSubN + ct;
            const JobState js = job_state(state0, len);
            if (rb == 0) {
              js.ecol1[c] = e1;
              js.rc1[c] = o1 - e1;
              js.rc2[c] = o2 - e2;
            } else {
              js.rc1[c] += o1;
              js.rc2[c] += o2;
            }
          }
          {
            // row (t >> 1, t & 1) of the quad: observed minus expected
            const int b = t >> 1;
            const int lr = 64 * b + 16 * wi + g + 8 * (t & 1);
            if (b < nbox) {
              const int r = rb * kSubM + lr;
              const JobState js = job_state(state0, len);
              if (cb == 0) {
                js.erow1[r] = er1;
                js.rr1[r] = os1 - er1;
                js.rr2[r] = os2 - er2;
              } else {
                js.rr1[r] += os1;
                js.rr2[r] += os2;
              }
            }
          }
        } else if constexpr (!kF32) {
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
      const JobState js = job_state(state0, len);
      wg_sync(bar_id);
      {
        uint32_t m[4] = {0u, 0u, 0u, 0u};
        for (int c = ct; c < bn; c += 128) {
          const float a = fabsf(js.rc1[c]), e = fabsf(js.ecol1[c]);
          m[0] = max(m[0], a == a ? __float_as_uint(a) : 0u);
          m[1] = max(m[1], e == e ? __float_as_uint(e) : 0u);
        }
        for (int r = ct; r < bm; r += 128) {
          const float a = fabsf(js.rr1[r]), e = fabsf(js.erow1[r]);
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
          const int found =
              locate_tile(js.ecol1, js.erow1, js.rc1, js.rc2, js.rr1, js.rr2,
                          bm, bn, lane, thr_factor, &i, &j, &delta);
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
int launch_encode(const T* x, const T* y, float* ex, float* ey, void* esy,
                  float* ecol, float* erow, int mp, int np, int kp, int bm,
                  int bn, cudaStream_t s) {
  const int kpe = k_padded(kp);
  const long long nxb = (long long)(mp / bm) * (kpe / kStageK);
  const long long nyb = ((long long)(np / bn) * kpe + 7) / 8;
  if (nxb + nyb > INT_MAX) return int(cudaErrorInvalidValue);
  abft_encode_kernel<T><<<int(nxb + nyb), kEncThreads, 0, s>>>(
      x, y, ex, ey, esy, np, kp, kpe, bm, bn, int(nxb), scale_e1(bn),
      scale_e2(bn));
  if constexpr (std::is_same<T, float>::value) {
    // the f32 GEMM's expected checksums from the E_X and E_Y just written
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return int(e);
    const int nmt = mp / bm;
    const dim3 grid((np / 4 + kColSliceThreads - 1) / kColSliceThreads,
                    (nmt + kColTiles - 1) / kColTiles);
    if (grid.y > 65535u) return int(cudaErrorInvalidValue);
    abft_colsum_kernel<<<grid, kColThreads, 0, s>>>(ex, y, ecol, nmt, np, kp,
                                                   kpe);
    e = cudaGetLastError();
    if (e != cudaSuccess) return int(e);
    const int nnt = np / bn;
    if (nnt <= kRowTilesThread) {
      abft_rowsum_kernel<1><<<(mp + kRowThreads - 1) / kRowThreads,
                              kRowThreads, 0, s>>>(x, ey, erow, mp, kp, kpe,
                                                   nnt);
    } else {
      constexpr int kTiles = 4 * kRowTilesThread, kRows = kRowThreads / 4;
      const dim3 rgrid((mp + kRows - 1) / kRows,
                       (nnt + kTiles - 1) / kTiles);
      if (rgrid.y > 65535u) return int(cudaErrorInvalidValue);
      abft_rowsum_kernel<4><<<rgrid, kRowThreads, 0, s>>>(x, ey, erow, mp,
                                                          kp, kpe, nnt);
    }
  }
  return int(cudaGetLastError());
}

// yb: Y (T) at 2 bytes, Y's three bf16 planes (3, kp, np) at f32; ea, eb:
// E_X (f32) and the split E_Y (T) at 2 bytes, the expected row checksums
// (np/bn, mp, 2) and column checksums (mp/bm, np, 2) f32 at f32
template <typename T>
int launch_gemm(const T* x, const void* yb, const int* inj, const float* ea,
                const void* eb, float* d, int* det, float* ws, int cap,
                float thr_factor, int mp, int np, int kp, int bm, int bn,
                int bk, cudaStream_t s) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  using Deep = std::conditional_t<kF32, SmemDeepF32, SmemDeep>;
  // a job: two m-tiles (one a warpgroup) x one n-tile
  const long long njobs = (long long)(mp / bm + 1) / 2 * (np / bn);
  if (njobs > INT_MAX) return int(cudaErrorInvalidValue);
  CUtensorMap xm, ym, em, dm;
  bool ok;
  if constexpr (kF32) {
    // f32 X in boxes of 32 k (128 bytes) x 64 rows; the planes stacked as
    // one (3 kp, np) bf16 tensor, boxes of 64 columns x 32 k
    ok = map_2d(&xm, x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, kp, mp,
                kStageKF32, 64) &&
         map_2d(&ym, yb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, np, 3 * kp, 64,
                kStageKF32);
    em = ym;
  } else {
    const CUtensorMapDataType ty = std::is_same<T, __nv_bfloat16>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
    ok = map_2d(&xm, x, ty, 2, kp, mp, 64, 64) &&
         map_2d(&ym, yb, ty, 2, np, kp, 64, 64) &&
         map_2d(&em, eb, ty, 2, k_padded(kp), 8 * (np / bn), 64, 8);
  }
  if (!ok ||
      !map_2d(&dm, d, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, np, mp, 32, 8))
    return int(cudaErrorInvalidValue);
  // at 2 bytes the shallow ring where Kp <= 256 (at most four k-stages a
  // sub-tile: the f32 D and the epilogue set the pace); at f32 the deep
  // ring at every Kp (timed on the H100 at M 2^20, N 1024, the shallow one
  // was 1.8-5.6 % slower at Kp 128-512)
  auto kern = abft_gemm_kernel<T, Deep>;
  size_t bytes = Deep::bytes;
  if constexpr (!kF32) {
    if (FK_ABFT_RING ? FK_ABFT_RING == 2 : kp <= 256) {
      kern = abft_gemm_kernel<T, SmemWide>;
      bytes = SmemWide::bytes;
    }
  }
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (e != cudaSuccess) return int(e);
  long long grid = njobs < sm_count() ? njobs : sm_count();
  grid = grid < cap ? grid : cap;
  // the kernel's E_X (2 bytes), expected rows and columns (f32)
  const float* e32 = static_cast<const float*>(eb);
  kern<<<int(grid), kThreads, bytes, s>>>(
      xm, ym, em, dm, kF32 ? nullptr : ea, kF32 ? ea : nullptr,
      kF32 ? e32 : nullptr, inj, d, det, ws, mp, np, kp, k_padded(kp), bm,
      bn, bk, scale_e1(bn), scale_e2(bn), thr_factor);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// The encodings of abft_gemm_kernel: x (mp, kp), y (kp, np) bf16 (kind 0),
// fp16 (1) or f32 (2), 16-byte aligned; ex (mp/bm, kpe, 2) and ey (np/bn,
// kpe, 2) f32, kpe = kp rounded up to 64 (zeros past kp). esy at 2 bytes:
// (np/bn, 8, kpe) of x's type, per n-tile e1 2^-ceil(log2 bn) and e2
// 2^-ceil(log2 (bn (bn + 1) / 2)) each split into three parts, then two
// zero rows; at f32: Y's planes (3, kp, np) bf16, y = hi + mid + lo, ecol
// (mp/bm, np, 2) f32, the expected column checksums E_X Y of each m-tile,
// and erow (np/bn, mp, 2) f32, the expected row checksums X E_Y of each
// n-tile (both unused at 2 bytes, may be null).
int fk_abft_encode(const void* x, const void* y, float* ex, float* ey,
                   void* esy, float* ecol, float* erow, int mp, int np,
                   int kp, int bm, int bn, int kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_tiles(mp, np, kp, bm, bn, 32)) return int(cudaErrorInvalidValue);
  if (kind == 0)
    return launch_encode(static_cast<const __nv_bfloat16*>(x),
                         static_cast<const __nv_bfloat16*>(y), ex, ey, esy,
                         ecol, erow, mp, np, kp, bm, bn, s);
  if (kind == 1)
    return launch_encode(static_cast<const __half*>(x),
                         static_cast<const __half*>(y), ex, ey, esy, ecol,
                         erow, mp, np, kp, bm, bn, s);
  if (kind == 2)
    return launch_encode(static_cast<const float*>(x),
                         static_cast<const float*>(y), ex, ey, esy, ecol,
                         erow, mp, np, kp, bm, bn, s);
  return int(cudaErrorInvalidValue);
}

// D = X Y with the ABFT per (bm x bn) tile, from fk_abft_encode's outputs
// for the same x, y and tiles: yb is y at 2 bytes and the planes (its esy)
// at f32; ea, eb are ex and esy at 2 bytes, erow and ecol at f32. d (mp,
// np) f32, det (mp/bm, np/bn) int32, inj 7 int32 words on the device. ws
// (ws_floats f32) holds the job state of a tile larger than 128 x 128, 12
// 288 floats a block (a block an SM; unused otherwise, may be null). kind
// as fk_abft_encode's.
int fk_abft_gemm(const void* x, const void* yb, const int* inj,
                 const float* ea, const void* eb, float* d, int* det,
                 float* ws, long long ws_floats, float thr_factor, int mp,
                 int np, int kp, int bm, int bn, int bk, int kind,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_tiles(mp, np, kp, bm, bn, bk)) return int(cudaErrorInvalidValue);
  // a tile larger than a sub-tile keeps its state in ws: blocks are capped
  // to the slices it holds
  const long long cap =
      bm > kSubM || bn > kSubN ? ws_floats / (2LL * 6 * kMaxTile) : INT_MAX;
  if (cap < 1) return int(cudaErrorInvalidValue);
  if (kind == 0)
    return launch_gemm(static_cast<const __nv_bfloat16*>(x), yb, inj, ea, eb,
                       d, det, ws, int(cap), thr_factor, mp, np, kp, bm, bn,
                       bk, s);
  if (kind == 1)
    return launch_gemm(static_cast<const __half*>(x), yb, inj, ea, eb, d,
                       det, ws, int(cap), thr_factor, mp, np, kp, bm, bn, bk,
                       s);
  if (kind == 2)
    return launch_gemm(static_cast<const float*>(x), yb, inj, ea, eb, d, det,
                       ws, int(cap), thr_factor, mp, np, kp, bm, bn, bk, s);
  return int(cudaErrorInvalidValue);
}

const char* fk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
