"""NVIDIA H100 SXM constants and the port's default kernel tiles.

The peak rates are NVIDIA's data-sheet numbers for the SXM part at its full
700 W power limit (dense, no sparsity). A card capped below 700 W runs
slower under load; measurements name the card and its limit beside them.
None of the reference package's TPU numbers apply here.
"""
from __future__ import annotations

SMS: int = 132
SMEM_PER_BLOCK: int = 232_448          # bytes, opt-in dynamic shared memory
HBM_BW: float = 3.35e12                # bytes/s

PEAK_FLOPS_F32: float = 67e12          # CUDA cores, FMA = 2 FLOPs
PEAK_FLOPS_TF32: float = 495e12        # tensor cores
PEAK_FLOPS_BF16: float = 989e12        # tensor cores (fp16 the same)
PEAK_OPS_INT8: float = 1979e12         # tensor cores, int8 op/s (MAC = 2)
# shared memory: 128 bytes a clock an SM at the 1,980 MHz boost clock
SM_CLOCK_HZ: float = 1.98e9
SMEM_BW: float = SMS * 128 * SM_CLOCK_HZ   # 33.45e12 bytes/s
# The serve model's per-launch cost (core.autotune.model_score, kind
# "serve"): one CUDA graph replay of a one-kernel cell and a synchronize,
# host clock, median of 200: 22.4 us (chip_smoke.py phase 15 (b),
# "serve_launch_us", NVIDIA H100 80GB HBM3 at 700.00 W)
SERVE_LAUNCH_S: float = 22.4e-6

# Default verification tile of the port's kernels (KernelParams): one thread
# block of 256 threads owns BLOCK_M rows; the kernel walks centroid
# tiles of BLOCK_K and stages features in chunks of 32. BLOCK_M = 128 keeps
# the (M/BLOCK_M, Kp, Fp) f32 partial-sum buffer of the one-pass kernels at
# 4.3 GB for M = 2**20, Kp = 1024, Fp = 128 (256 would halve it, but needs
# twice the shared-memory distance tile); BLOCK_F = 32 makes the padded
# feature width a multiple of 32 only.
BLOCK_M: int = 128
BLOCK_K: int = 128
BLOCK_F: int = 32

# Tiles the CUDA kernels are built for, and the alignment clamp_params
# keeps when it shrinks a tile to a small problem.
SUPPORTED_BLOCK_M: tuple[int, ...] = (64, 128)
SUPPORTED_BLOCK_K: tuple[int, ...] = (128,)
FEATURE_CHUNK: int = 32
ALIGN_M: int = 64
ALIGN_K: int = 128
ALIGN_F: int = 32

# Default row tile of the k-means++ D^2 round (kmeanspp_round): one thread
# block per (problem, INIT_BLOCK_N rows). 512 gives B * N / 512 blocks
# (6,144 at B = 48, N = 65,536: ~47 per SM, enough to hide the latency of a
# bytes-bound GEMV) while keeping the selection short: a cumulative sum
# over N / 512 tile sums, then over the chosen tile's 512 rows. The CPU
# path uses the same tile, so both walk the same two-level CDF.
INIT_BLOCK_N: int = 512

# Default verification tile of the ABFT GEMM (ops.abft_matmul, kernel
# matmul_abft): each ABFT_BLOCK_M x ABFT_BLOCK_N output tile is verified on
# its own; ABFT_BLOCK_K is the k-step an injection descriptor counts. At
# f32 one thread block owns a tile and walks it in 128 x 128 sub-tiles over
# 32-deep chunks; at bf16 / fp16 a consumer warpgroup owns it (128 x 128
# sub-tiles, 64-deep k-stages; a fault lands at the end of the stage that
# ends its k-step). The clamp keeps the reference's alignments (rows 8,
# columns 128, k 128), so the reference's tiles, passed explicitly, stay the
# same tiles. The kernels take rows a multiple of 8 up to 128 or a multiple
# of 128 up to 1024, columns a multiple of 128 up to 1024, k a multiple of
# 32.
ABFT_BLOCK_M: int = 128
ABFT_BLOCK_N: int = 128
ABFT_BLOCK_K: int = 128
ABFT_ALIGN_M: int = 8
ABFT_ALIGN_N: int = 128
ABFT_ALIGN_K: int = 128

# Rows per slab of the DMR centroid update (centroid_update_dmr): each
# slab's rows are bucketed by cluster and gathered in chunks of up to
# centroid_update_dmr.WALK_CHUNK rows of one cluster, so the two replicas'
# chunk partials take 2 * slabs * (DMR_BLOCK_M / WALK_CHUNK + K) * F * 4
# bytes (18.5 MB at M = 2**20, K = 1000, F = 128) and X is read once.
DMR_BLOCK_M: int = 65_536

# Tiles of the flash-attention kernels (flash_attention), fixed in
# csrc/fk_attention.cu and picked there from Sq, the dtype and the head dim:
# these record them and set nothing. Sq <= FLASH_DECODE_MAX_SQ runs the
# decode kernel (every dtype): one block of 4 warps per (batch, KV head,
# row chunk of up to 16 packed group x Sq rows, 8 at head dim 256, KV
# split), K/V tiles of up to FLASH_DECODE_TILE_BYTES (K and V: 64 keys at 2
# bytes and head dim 128) in two stages, ~78 KB of shared memory at bf16
# and head dim 128, two blocks an SM. bf16 / fp16 at Sq > 16 run the prefill
# kernel: FLASH_BLOCK_Q = 128 query rows (two warpgroups of 64 and a
# producer warp, 288 threads) against KV tiles of FLASH_BLOCK_K keys (32 at
# head dim 256) in a ring of three stages, Q and K/V as 2-byte values: 65,
# 129 and 161 KB of shared memory at head dims 64, 128 and 256 (one block
# an SM at 128). f32 at Sq > 16 runs the CUDA-core kernel: FLASH_F32_ROWS
# packed rows (GQA heads x positions; 64 at head dim 256) against KV tiles
# of FLASH_F32_BLOCK_K keys (32 at 256) in a two-stage ring, staged as f32
# (128, 224 and 200 KB at head dims 64, 128 and 256, one block an SM;
# flash_attention.f32_tiles gives a launch's tiles). The
# widest head dim built is 256 (64 and 128 are the others; narrower ones
# are zero-padded to 64).
FLASH_DECODE_MAX_SQ: int = 16
FLASH_DECODE_TILE_BYTES: int = 32_768
FLASH_BLOCK_Q: int = 128
FLASH_BLOCK_K: int = 64
FLASH_F32_ROWS: int = 128
FLASH_F32_BLOCK_K: int = 64
FLASH_HEAD_DIMS: tuple[int, ...] = (64, 128, 256)
