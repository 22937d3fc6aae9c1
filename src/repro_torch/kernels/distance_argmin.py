"""Fused distance + nearest-centroid kernel (paper §III, Fig. 4) on Hopper.

Replaces the Pallas TPU kernel ``distance_argmin`` of
``src/repro/kernels/distance_argmin.py`` (bodies ``_kernel`` and
``_kernel_smallk``, epilogue ``tile_min_argmin``/``fold_min``). For padded
X (Mp, Fp), C (Kp, Fp) and centroid norms cn (Kp,) with +inf in padded
slots it returns, per row, the min of d = ||c||^2 - 2 x.c and its argmin
(lowest index on ties, the earlier centroid tile across tiles).

X and C are f32, bf16 or fp16 (one dtype, the reference's template axis);
norms, distances and the accumulator are f32.

CUDA kernels: ``lloyd_tile_kernel<BM, false, false>`` (f32) and
``lloyd_tile_mma_kernel<T, BM, false, false>`` (bf16, fp16) in
``csrc/fk_kernels.cu``. One thread block per row tile of ``block_m`` rows
walks the centroid tiles (128) and 32-feature chunks staged in shared
memory; the running row minimum lives in a register of the row's thread.
At f32 each thread accumulates X C^T with FMAs on the CUDA cores; at bf16 /
fp16 each warp runs ``mma.sync`` m16n8k16 tiles on the tensor cores with
f32 accumulation (products of 2-byte values are exact in f32, so the plain
version's f32 product of the widened values is the same function). The
reference's ``_kernel_smallk`` body (padded K of one centroid tile) needs no
body of its own here: the same loop then runs one centroid tile and folds
it once.

Bound on the H100: 2 * Mp * Kp * Fp FLOPs on the f32 CUDA cores; the bytes
(X once, C once per row tile from L2, two (M,) outputs) are far below it at
K = 1000. At bf16 / fp16 the tensor cores' 989 TFLOP/s bound the GEMM
(0.27 ms at M = 2**20, K = 1000, F = 128), near the bytes of X. The f32
design issues one shared-memory load per two FMAs (8x8 register tile); the
2-byte one stages without ``cp.async`` or TMA and runs ``mma.sync``, not
``wgmma``: pipelining is later work.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

def check_padded(x: torch.Tensor, c: torch.Tensor, cn: torch.Tensor,
                 block_m: int, block_k: int, block_f: int) -> None:
    mp, fp = x.shape
    kp = c.shape[0]
    if mp % block_m or kp % block_k or fp % block_f or c.shape[1] != fp \
            or cn.shape != (kp,):
        raise ValueError(f"unpadded shapes x {tuple(x.shape)}, c "
                         f"{tuple(c.shape)}, cn {tuple(cn.shape)} vs blocks "
                         f"{(block_m, block_k, block_f)}")


def distance_argmin_plain(x: torch.Tensor, c: torch.Tensor,
                          cn: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (min (M,) f32, argmin (M,) int32). The product
    runs in f32 on the widened values: a 2-byte product would round its
    output to 2 bytes, where the kernels (and the reference's MXU) keep
    f32."""
    ref.full_f32(x.device)
    return ref.first_min(cn[None, :] - 2.0 * (x.float() @ c.float().T))


def distance_argmin(x: torch.Tensor, c: torch.Tensor, cn: torch.Tensor, *,
                    block_m: int, block_k: int, block_f: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw kernel entry on pre-padded inputs: X and C f32, bf16 or fp16 (one
    dtype), cn f32. CPU tensors take the plain version; CUDA tensors launch
    the kernel of their dtype. Returns (min (Mp,) f32, argmin (Mp,))."""
    check_padded(x, c, cn, block_m, block_k, block_f)
    dt = _build.input_dtype(x, c)
    if _build.on_cpu(x, c, cn):
        return distance_argmin_plain(x, c, cn)
    mp, fp = x.shape
    mind = torch.empty(mp, dtype=torch.float32, device=x.device)
    am = torch.empty(mp, dtype=torch.int32, device=x.device)
    code = _build.launch(
        "fk_distance_argmin", dt, _build.ptr(x, dt, "x"),
        _build.ptr(c, dt, "c"), _build.ptr(cn, torch.float32, "cn"),
        mind.data_ptr(), am.data_ptr(), mp, c.shape[0], fp, block_m, block_f,
        _build.stream_of(x))
    _build.check(code, "distance_argmin")
    distance_argmin.launches += 1
    return mind, am


distance_argmin.launches = 0
