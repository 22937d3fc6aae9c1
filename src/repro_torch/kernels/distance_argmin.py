"""Fused distance + nearest-centroid kernel (paper §III, Fig. 4) on Hopper.

Replaces the Pallas TPU kernel ``distance_argmin`` of
``src/repro/kernels/distance_argmin.py`` (bodies ``_kernel`` and
``_kernel_smallk``, epilogue ``tile_min_argmin``/``fold_min``). For padded
X (Mp, Fp), C (Kp, Fp) and centroid norms cn (Kp,) with +inf in padded
slots it returns, per row, the min of d = ||c||^2 - 2 x.c and its argmin
(lowest index on ties, the earlier centroid tile across tiles).

CUDA kernel: ``lloyd_tile_kernel<BM, false, false>`` in
``csrc/fk_kernels.cu``. One thread block per row tile of ``block_m`` rows
walks the centroid tiles (128) and 32-feature chunks staged in shared
memory, accumulating X C^T with f32 FMAs in registers; the running row
minimum lives in a register of the row's thread. The reference's
``_kernel_smallk`` body (padded K of one centroid tile) needs no body of its
own here: the same loop then runs one centroid tile and folds it once.

Bound on the H100: 2 * Mp * Kp * Fp FLOPs on the f32 CUDA cores; the bytes
(X once, C once per row tile from L2, two (M,) outputs) are far below it at
K = 1000. The simple design issues one shared-memory load per two FMAs
(8x8 register tile) and does not use the tensor cores; wgmma with a
checksum-exact f32 emulation is later work.
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
    """Plain PyTorch version: (min (M,) f32, argmin (M,) int32)."""
    ref.full_f32(x.device)
    return ref.first_min(cn[None, :] - 2.0 * (x @ c.T))


def distance_argmin(x: torch.Tensor, c: torch.Tensor, cn: torch.Tensor, *,
                    block_m: int, block_k: int, block_f: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw kernel entry on pre-padded f32 inputs. CPU tensors take the plain
    version; CUDA tensors launch the kernel. Returns (min (Mp,), argmin
    (Mp,))."""
    check_padded(x, c, cn, block_m, block_k, block_f)
    if _build.on_cpu(x, c, cn):
        return distance_argmin_plain(x, c, cn)
    mp, fp = x.shape
    mind = torch.empty(mp, dtype=torch.float32, device=x.device)
    am = torch.empty(mp, dtype=torch.int32, device=x.device)
    f32 = torch.float32
    code = _build.library().lib.fk_distance_argmin(
        _build.ptr(x, f32, "x"), _build.ptr(c, f32, "c"),
        _build.ptr(cn, f32, "cn"), mind.data_ptr(), am.data_ptr(),
        mp, c.shape[0], fp, block_m, block_f, _build.stream_of(x))
    _build.check(code, "distance_argmin")
    distance_argmin.launches += 1
    return mind, am


distance_argmin.launches = 0
