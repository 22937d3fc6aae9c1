"""ABFT-protected GEMM (paper §IV applied to a plain product) on Hopper.

Replaces the Pallas TPU kernel ``matmul_abft`` of
``src/repro/kernels/matmul_abft.py`` (body ``_kernel``): D = X @ Y for X
(Mp, Kp) and Y (Kp, Np) of one dtype, f32, bf16 or fp16, into an f32 D,
with the dual-checksum invariant per output tile of ``block_m`` x
``block_n``. While the k loop runs, each tile accumulates its product and
the expected checksums

    col1 += (e1^T X_t) Y_t   col2 += (e2^T X_t) Y_t
    row1 += X_t (Y_t e1)     row2 += X_t (Y_t e2)     e1 = 1, e2 = 1..b

At the tile's last k-step the observed checksums of the tile are compared
with ``threshold_factor(Kp, dtype) * max(max|col1|, max|row1|, 1)`` (the
expected, clean side; the input dtype's rounding, as the reference's); a
fault is located by the e2/e1 ratio (the row residuals when the column
residual is degenerate) and one element corrected. An 8-word descriptor
(:func:`make_injection`, the distance kernel's format: m-tile, n-tile,
k-step of ``block_k``, row, col, delta) plants one fault after a k-step;
the kernel returns the detections per (m-tile, n-tile).

CUDA kernels: ``matmul_abft_kernel`` (f32) and
``matmul_abft_mma_kernel<T>`` (bf16, fp16) in ``csrc/fk_kernels.cu``,
``__global__``s of their own. The TPU grid carries the accumulator across
a sequential k axis in VMEM; here one thread block owns one output tile
and runs the k loop inside. It walks the tile in 128 x 128 sub-tiles (a
tile of at most 128 rows is one sub-tile, its missing rows masked), each
over 32-deep chunks staged in shared memory: at f32 a CUDA-core SGEMM with
an 8 x 8 register tile per thread, like the port's distance kernel; at
2-byte inputs an ``mma.sync`` m16n8k16 product with f32 accumulation (each
warp 64 x 32 of the sub-tile; X chunks staged row-major, Y chunks
transposed), whose expected checksums are encoded in f32 from the same
2-byte values, widened exactly. A finished sub-tile goes through shared
memory, where fixed-order column and row sums build the observed
checksums, and on to D; warp 0 then verifies the whole tile and corrects D
in place. Every sum has a fixed order, so a launch repeats bit for bit.
Detections are written per tile (no atomics) and summed per m-tile by the
wrapper.

Bound on the H100: at f32, 2 * M * N * K FLOPs on the CUDA cores
(67 TFLOP/s); at bf16 / fp16 the same FLOPs on the tensor cores (989
TFLOP/s) or, for a short K, the bytes of the f32 D. The checksums add
O((bm + bn) * K) work per tile, a shared-memory pass over each sub-tile
and no extra pass over D in device memory. f32 tensor cores (``wgmma``
with an f32-exact split), ``cp.async``/TMA staging and ``wgmma`` for the
2-byte product are later work.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.distance_argmin_ft import (  # noqa: F401 (re-export)
    INJ_LEN, abft_correct_plain, make_injection, no_injection)


def check_tiles(x: torch.Tensor, y: torch.Tensor, block_m: int,
                block_n: int, block_k: int) -> None:
    """Raise unless x (Mp, Kp) and y (Kp, Np) are padded to the tiles."""
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[0] \
            or x.shape[0] % block_m or y.shape[1] % block_n \
            or x.shape[1] % block_k:
        raise ValueError(f"unpadded shapes x {tuple(x.shape)}, y "
                         f"{tuple(y.shape)} vs tiles "
                         f"{(block_m, block_n, block_k)}")


def check_cuda_tiles(block_m: int, block_n: int, block_k: int) -> None:
    """Raise for a tile the CUDA kernel is not built for."""
    if (block_m < 8 or block_m % 8 or (block_m > 128 and block_m % 128)
            or block_m > 1024 or block_n < 128 or block_n % 128
            or block_n > 1024 or block_k < 32 or block_k % 32):
        raise ValueError(
            f"({block_m}, {block_n}, {block_k}) is not a tile of the CUDA "
            f"ABFT GEMM: rows a multiple of 8 up to 128 or of 128 up to 1024, "
            f"columns a multiple of 128 up to 1024, k a multiple of 32")


def matmul_abft_plain(x: torch.Tensor, y: torch.Tensor, inj: torch.Tensor,
                      block_m: int, block_n: int, block_k: int,
                      factor: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the full-f32 product (2-byte X and Y
    widened first, so every term is exact, as on the tensor cores), then
    the kernel's per-tile detection and correction (``abft_correct_plain``,
    the plain ABFT of the distance kernel, with Y^T in the centroids'
    place). The fault is added to the finished product, not after k-step
    ``k_step``. Returns (D (Mp, Np) f32, det (Mp/bm,) int32)."""
    ref.full_f32(x.device)
    xf, yf = x.float(), y.float()
    return abft_correct_plain(xf @ yf, xf, yf.T.contiguous(), inj, block_m,
                              block_n, block_k, factor)


def matmul_abft(x: torch.Tensor, y: torch.Tensor, inj: torch.Tensor, *,
                block_m: int, block_n: int, block_k: int, factor: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw ABFT GEMM entry on pre-padded inputs of one dtype (f32, bf16 or
    fp16); ``inj`` is an int32 descriptor on the data's device and
    ``factor`` the static part of the threshold (``threshold_factor(Kp,
    dtype)``). Returns (D (Mp, Np) f32, det (Mp/bm,) int32)."""
    check_tiles(x, y, block_m, block_n, block_k)
    dt = _build.input_dtype(x, y)
    if inj.shape[0] < 7:
        raise ValueError(f"injection descriptor too short: {inj.shape}")
    if _build.on_cpu(x, y, inj):
        return matmul_abft_plain(x, y, inj, block_m, block_n, block_k,
                                 factor)
    check_cuda_tiles(block_m, block_n, block_k)
    mp, kp = x.shape
    np_ = y.shape[1]
    dev = x.device
    d = torch.empty((mp, np_), dtype=torch.float32, device=dev)
    det = torch.empty((mp // block_m, np_ // block_n), dtype=torch.int32,
                      device=dev)
    code = _build.launch(
        "fk_matmul_abft", dt, _build.ptr(x, dt, "x"), _build.ptr(y, dt, "y"),
        _build.ptr(inj, torch.int32, "inj"), d.data_ptr(), det.data_ptr(),
        factor, mp, np_, kp, block_m, block_n, block_k, _build.stream_of(x))
    _build.check(code, "matmul_abft")
    matmul_abft.launches += 1
    return d, det.sum(1, dtype=torch.int32)


matmul_abft.launches = 0
