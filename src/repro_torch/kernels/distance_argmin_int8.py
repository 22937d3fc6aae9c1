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

CUDA kernel: ``int8_tile_kernel<BM>`` in ``csrc/fk_kernels.cu``. A block
owns a row tile of BM rows and walks the centroid tiles of 128 in feature
chunks of up to 128: the products on the int8 tensor cores
(``mma.sync.m16n8k32`` s8 -> s32, fragments by ``ldmatrix``; the 8 warps
tile the BM x 128 block 2 x 4), X's row tile copied once a block and kept
(the reference's stash; where BM (Fp + 16) passes 48 KB, X's chunks stream
with C's), C's chunks with their scales and norms through a three-slot
``cp.async`` ring, and the epilogue in registers: each lane's distances
in the order above, rounded at each step, a scan of its columns with a
strict '<', the (value, column) pairs combined over the quad and over the
4 warps of a row band, then ``fold_min`` across tiles -- the serial scan's
result bit for bit (``tests/test_torch_int8_mma.py`` mirrors the
fragments and the combines). The reference's ``smallk`` body needs no
counterpart (one trip of the loop).

Bound on the H100: 2 * Mp * Kp * Fp int8 operations at the tensor cores'
1,979 Tera-op/s (``hw.PEAK_OPS_INT8``), above X's bytes (1 per value);
the epilogue's few CUDA-core operations a distance come next. The int32
sums are exact while Fp * 128**2 < 2**31 (:data:`MAX_FEATURES`, which
:func:`check_int8` holds), so any order of the products gives the plain
version's integers.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.distance_argmin import check_padded


# the widest padded feature count whose int32 sums are exact for any int8
# values (|product| <= 128**2)
MAX_FEATURES = (2 ** 31 - 1) // 128 ** 2


def check_int8(xq: torch.Tensor, cq: torch.Tensor, sx: torch.Tensor,
               sc: torch.Tensor, cn: torch.Tensor, block_m: int, block_k: int,
               block_f: int) -> None:
    check_padded(xq, cq, cn, block_m, block_k, block_f)
    if xq.shape[1] > MAX_FEATURES:
        raise ValueError(f"{xq.shape[1]} padded features: the int8 kernel's "
                         f"int32 sums are exact up to {MAX_FEATURES} "
                         f"(Fp * 128**2 < 2**31)")
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
    mp, fp = xq.shape
    mind = torch.empty(mp, dtype=torch.float32, device=xq.device)
    am = torch.empty(mp, dtype=torch.int32, device=xq.device)
    f32 = torch.float32
    # the kernel copies X's and C's rows, sc and cn 16 bytes at a time
    code = _build.library().lib.fk_distance_argmin_int8(
        _build.ptr(xq, torch.int8, "xq", vec16=True),
        _build.ptr(cq, torch.int8, "cq", vec16=True),
        _build.ptr(sx, f32, "sx"), _build.ptr(sc, f32, "sc", vec16=True),
        _build.ptr(cn, f32, "cn", vec16=True), mind.data_ptr(),
        am.data_ptr(), mp, cq.shape[0], fp, block_m, _build.stream_of(xq))
    _build.check(code, "distance_argmin_int8")
    distance_argmin_int8.launches += 1
    return mind, am


distance_argmin_int8.launches = 0


def resources(block_m: int, fp: int) -> dict:
    """``int8_tile_kernel<block_m>`` on the card at Fp = ``fp``: resident
    blocks an SM, registers and local-memory (spill) bytes a thread, and
    its dynamic shared memory. Needs a CUDA card (the library's build)."""
    import ctypes
    out = (ctypes.c_int * 4)()
    code = _build.library().lib.fk_int8_resources(block_m, fp, out)
    _build.check(code, "int8 resources")
    return dict(zip(("blocks_per_sm", "registers", "local_bytes",
                     "smem_bytes"), out))

