// ABFT decode helpers shared by fk_kernels.cu (the tile kernels'
// verification) and fk_abft_gemm.cu (the ABFT GEMM's, at every dtype):
// warp-wide reductions in a fixed order and locate_tile, the reference's
// detect / locate rule on one verification tile's checksums in shared
// memory.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ int clamp_index(float v, int hi) {
  // (round(r) - 1) -> int32 -> clip(0, hi - 1), saturating like XLA's convert
  v = fminf(fmaxf(v, -1.0f), float(hi));
  int i = int(v);
  return i < 0 ? 0 : (i > hi - 1 ? hi - 1 : i);
}

// Warp-wide (max |v|, first index) over n values.
__device__ __forceinline__ void warp_absmax(const float* v, int n, int lane,
                                            float* out_v, int* out_i) {
  float bv = -1.0f;
  int bi = 0x7fffffff;
  for (int t = lane; t < n; t += 32) {
    float a = fabsf(v[t]);
    if (a > bv) {
      bv = a;
      bi = t;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (ov > bv || (ov == bv && oi < bi)) {
      bv = ov;
      bi = oi;
    }
  }
  *out_v = bv;
  *out_i = bi;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Butterfly sum: a fixed order, and every lane ends with the same bits
// (a + b == b + a at each step).
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ABFT verification of one output tile, run by warp 0: the reference's
// detect / locate rule (a threshold on the expected side's scale, the
// e2/e1 ratio) with the tile's sizes at run time. col1/row1 are the expected
// checksums, rc*/rr* the residuals. Returns 1 if detected, with the element
// (i, j) and the delta to subtract.
__device__ int locate_tile(const float* col1, const float* row1,
                           const float* rc1, const float* rc2,
                           const float* rr1, const float* rr2, int bm,
                           int bn, int lane, float thr_factor, int* oi,
                           int* oj, float* odelta) {
  float sc = 0.0f;
  for (int t = lane; t < bn; t += 32) sc = fmaxf(sc, fabsf(col1[t]));
  for (int t = lane; t < bm; t += 32) sc = fmaxf(sc, fabsf(row1[t]));
  const float thr = thr_factor * fmaxf(warp_max(sc), 1.0f);
  float max_c, max_r;
  int j, i_direct;
  warp_absmax(rc1, bn, lane, &max_c, &j);
  warp_absmax(rr1, bm, lane, &max_r, &i_direct);
  const float dcol = rc1[j];
  const float safe = dcol == 0.0f ? 1.0f : dcol;
  const bool use_ratio = fabsf(dcol) > thr;
  const int i = use_ratio ? clamp_index(rintf(rc2[j] / safe) - 1.0f, bm)
                          : i_direct;
  const float drow = rr1[i];
  const float safe_r = drow == 0.0f ? 1.0f : drow;
  *oi = i;
  *oj = use_ratio ? j : clamp_index(rintf(rr2[i] / safe_r) - 1.0f, bn);
  *odelta = fabsf(dcol) > fabsf(drow) ? dcol : drow;
  return (max_c > thr) || (max_r > thr);
}
