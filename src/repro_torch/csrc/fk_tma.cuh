// Hopper (sm_90a) plumbing shared by the kernels fed by the Tensor Memory
// Accelerator: fk_attention.cu's flash_prefill_kernel, fk_attention_bwd.cu's
// flash_bwd_dkdv_kernel and flash_bwd_dq_kernel, and fk_abft_gemm.cu's
// abft_gemm_kernel.
//
//   mbarriers        mbar_init, mbar_expect_tx, mbar_arrive, mbar_wait
//                    (one phase at a time, waited on by parity);
//   TMA loads        tma_load (a 4-d box), tma_load_2d (a 2-d box) and
//                    bulk_load (a contiguous run of bytes), each completing
//                    on an mbarrier's transaction count;
//   wgmma operands   sw128_desc, the descriptor of a 128-byte-swizzled
//                    operand as TMA writes it (8-row groups 1024 bytes
//                    apart); wg_fence / wg_commit / wg_wait<N> around
//                    wgmma.mma_async (fk_wgmma.cuh), fence_regs to keep the
//                    compiler from moving accumulator accesses across them;
//   host             encode_tiled (cuTensorMapEncodeTiled, reached through
//                    cudaGetDriverEntryPoint: no link against the driver
//                    library), head_map (the attention kernels' 4-d map of
//                    a (B, heads, S, hd) operand) and sm_count (the
//                    device's SMs, cached).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cstdint>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// one box {64 values, rows, 1, 1} of a 4-d tensor map into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
        "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// one box of a 2-d tensor map at (inner c0, outer c1) into shared memory
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
        "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// bytes (a multiple of 16) from 16-byte aligned global src to shared dst
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// descriptor of a 128-byte-swizzled operand in shared memory: 8-row groups
// 1024 bytes apart, lbo bytes between 64-value panels (MN-major operands)
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4)
         | (uint64_t((lbo >> 4) & 0x3FFF) << 16)
         | (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are pending
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wg_wait0() { wg_wait<0>(); }
// keep the compiler from moving accesses of accumulator registers across
// the asynchronous wgmma that writes them
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 4-d map over (hd, S, heads, B) of a 2-byte tensor with the given element
// strides, boxes of {64, rows, 1, 1}, 128-byte swizzle, zeros past the end
inline bool head_map(CUtensorMap* map, const void* base, bool bf16, int hd,
                     int S, int heads, int B, long long ss, long long sh,
                     long long sb, int rows) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[4] = {cuuint64_t(hd), cuuint64_t(S),
                              cuuint64_t(heads), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(ss) * 2, cuuint64_t(sh) * 2,
                                 cuuint64_t(sb) * 2};
  const cuuint32_t box[4] = {64, cuuint32_t(rows), 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
            4, const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (!count[dev]) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n < 1)
      n = 132;
    count[dev] = n;
  }
  return count[dev];
}
