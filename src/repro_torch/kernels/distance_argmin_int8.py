"""int8 distance + nearest-centroid kernel (one dtype notch past the paper's
fp16 floor).

Replaces the Pallas TPU kernel ``distance_argmin_int8`` of
``src/repro/kernels/distance_argmin_int8.py`` (bodies ``_kernel_int8`` and
``_kernel_int8_smallk``, epilogue ``_scaled_acc``). X and C come quantised
per row (``repro_torch.dist.compression.quantize_rows``: int8 values and
f32 scales sx, sc); the tile product is exact in int32 and the epilogue
corrects the scales in f32 before the shared min/argmin:

    d_ij = ||c_j||^2 - 2 * (sx_i * (float(acc_ij) * sc_j))

with ``||c_j||^2`` from the unquantised centroids (+inf in padded slots).
On quantisation-safe data (integers in [-127, 127] with a +-127 in every
row, so every scale is 1.0) ``acc`` holds the integers the f32 kernel sums
and the result is bit for bit ``distance_argmin``'s.

CUDA kernel: ``int8_tile_kernel<BM>`` in ``csrc/fk_kernels.cu``: the f32
tile kernel's loop (row tile per block, centroid tiles of 128, 32-feature
chunks in shared memory) on packed 32-bit words, four products per
``__dp4a`` on the CUDA cores, then ``tile_min_argmin`` and ``fold_min``.
The reference's ``smallk`` body needs no counterpart (one trip of the loop).

Bound on the H100: 2 * Mp * Kp * Fp int8 operations at the tensor cores'
1,979 Tera-op/s (``hw.PEAK_OPS_INT8``), above X's bytes (1 per value).
``__dp4a`` does not reach that rate; ``mma.sync``/``wgmma`` on int8 tiles
is later work.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.distance_argmin import check_padded


def check_int8(xq: torch.Tensor, cq: torch.Tensor, sx: torch.Tensor,
               sc: torch.Tensor, cn: torch.Tensor, block_m: int, block_k: int,
               block_f: int) -> None:
    check_padded(xq, cq, cn, block_m, block_k, block_f)
    if xq.dtype != torch.int8 or cq.dtype != torch.int8:
        raise ValueError(f"the int8 kernel takes int8 tiles, got {xq.dtype} "
                         f"and {cq.dtype}; quantise at the plan boundary "
                         f"(ops.plan_data_int8)")
    if sx.shape != (xq.shape[0],) or sc.shape != (cq.shape[0],):
        raise ValueError(f"scales sx {tuple(sx.shape)}, sc {tuple(sc.shape)} "
                         f"must be ({xq.shape[0]},), ({cq.shape[0]},)")


def int8_products(xq: torch.Tensor, cq: torch.Tensor) -> torch.Tensor:
    """The exact int32 products xq cq^T. On the CPU an int64 matrix product;
    on the card, where integer matrix products are not offered, f32 products
    over feature slices of at most 1024 (every partial sum is an integer
    below 1024 * 127^2 < 2^24, so exact in any order), summed in int32."""
    if xq.device.type == "cpu":
        return (xq.long() @ cq.long().T).to(torch.int32)
    ref.full_f32(xq.device)
    acc = None
    for f0 in range(0, xq.shape[1], 1024):
        part = (xq[:, f0:f0 + 1024].float() @ cq[:, f0:f0 + 1024].float().T
                ).to(torch.int32)
        acc = part if acc is None else acc + part
    return acc


def distance_argmin_int8_plain(xq: torch.Tensor, cq: torch.Tensor,
                               sx: torch.Tensor, sc: torch.Tensor,
                               cn: torch.Tensor
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: exact products, the kernel's epilogue in its
    order, first-min tie-break. Returns (min (M,) f32, argmin (M,) int32),
    bit for bit the kernel's at any F."""
    v = sx[:, None] * (int8_products(xq, cq).float() * sc[None, :])
    return ref.first_min(cn[None, :] - 2.0 * v)


def distance_argmin_int8(xq: torch.Tensor, cq: torch.Tensor,
                         sx: torch.Tensor, sc: torch.Tensor, cn: torch.Tensor,
                         *, block_m: int, block_k: int, block_f: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw int8 kernel entry on pre-padded inputs: xq (Mp, Fp) and cq
    (Kp, Fp) int8, sx (Mp,) and sc (Kp,) f32 scales (1.0 in padded slots),
    cn (Kp,) f32 norms of the unquantised centroids (+inf in padded slots).
    Returns (min (Mp,), argmin (Mp,)) under ``distance_argmin``'s
    partial-distance contract (add ||x||^2 for true distances)."""
    check_int8(xq, cq, sx, sc, cn, block_m, block_k, block_f)
    if _build.on_cpu(xq, cq, sx, sc, cn):
        return distance_argmin_int8_plain(xq, cq, sx, sc, cn)
    if xq.data_ptr() % 4 or cq.data_ptr() % 4:
        raise ValueError("int8 tiles must start on a 4-byte boundary (the "
                         "kernel reads them as packed 32-bit words)")
    mp, fp = xq.shape
    mind = torch.empty(mp, dtype=torch.float32, device=xq.device)
    am = torch.empty(mp, dtype=torch.int32, device=xq.device)
    f32 = torch.float32
    code = _build.library().lib.fk_distance_argmin_int8(
        _build.ptr(xq, torch.int8, "xq"), _build.ptr(cq, torch.int8, "cq"),
        _build.ptr(sx, f32, "sx"), _build.ptr(sc, f32, "sc"),
        _build.ptr(cn, f32, "cn"), mind.data_ptr(), am.data_ptr(), mp,
        cq.shape[0], fp, block_m, _build.stream_of(xq))
    _build.check(code, "distance_argmin_int8")
    distance_argmin_int8.launches += 1
    return mind, am


distance_argmin_int8.launches = 0
