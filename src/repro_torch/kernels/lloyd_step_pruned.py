"""Tile-pruned one-pass Lloyd iteration kernel (Hamerly bounds per tile).

Replaces the Pallas TPU kernel ``lloyd_step_pruned`` of
``src/repro/kernels/lloyd_step_pruned.py`` (bodies ``_kernel_pruned`` and
``_kernel_smallk_pruned``, bound ``_tile_bound``). It is
:func:`~repro_torch.kernels.lloyd_step.lloyd_step` with an int32 skip mask
(Mp/bm, Kp/bk): a set cell's centroid tile is not multiplied, scanned or
folded for that row tile. Computed cells also return ``tmin``, the minimum
over the row tile's valid rows of sqrt(max(local min + ||x||^2, 0)), the
Euclidean distance of the row to its nearest centroid of that tile. Skipped
cells hold a ``MIN_INIT`` placeholder that ``ops.fused_lloyd_pruned``
replaces by the decayed bound. The update and the final min/argmin writes
run whatever the mask says. Where the mask only skips tiles that lose
strictly, every output is bit for bit ``lloyd_step``'s.

CUDA kernels: the tile kernels' pruned mode, ``lloyd_tile_kernel<BM, false,
kPrunedEntries>`` (f32) and ``lloyd_tile_mma_kernel<T, BM, false,
kPrunedEntries>`` (bf16 and fp16 X and C, the reference's 2-byte
templates) in ``csrc/fk_kernels.cu``. A block lists its row tile's
computed centroid tiles once and its staging ring walks that list, so the
next computed tile's first chunk is what is prefetched; a computed tile is
the one-pass kernel's own code of that dtype (the same product, min /
argmin in registers and ``fold_min``), and its bound comes from the
owners' tile minima (0 for a NaN at the tile's column 0, as the serial
scan's NaN gives). The update is ``lloyd_step``'s entries (``csrc/
fk_entries.cuh``: one row per present (tile, cluster) pair, ``update.
reduce_entries`` sums them), so no card route writes a dense (Kp, Fp)
block a row tile. The reference's ``smallk`` body needs no counterpart:
with one centroid tile the caller forces the mask to zero.

Bound on the H100: the GEMM of the computed cells, 2 * bm * bk * Fp FLOPs
each on the f32 CUDA cores (or the bf16 / fp16 tensor cores), against the
bytes of X read once, the entries, idx and the labels (as ``lloyd_step``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import update as _up
from repro_torch.kernels.distance_argmin import c_operand, check_padded
from repro_torch.kernels.update import tile_update_plain

# the kernels' running-min start and the placeholder of a skipped cell
MIN_INIT = float(torch.finfo(torch.float32).max)


def lloyd_step_pruned_plain(x: torch.Tensor, c: torch.Tensor,
                            cn: torch.Tensor, xn: torch.Tensor,
                            skip: torch.Tensor, true_m: int, block_m: int,
                            block_k: int):
    """Plain PyTorch version: the full distance matrix as
    ``distance_argmin_plain`` computes it, skipped cells set to ``MIN_INIT``
    (they never win: the kernel never folds them, and a row tile whose
    every cell is skipped keeps the kernel's start, ``MIN_INIT`` at
    index 0). 2-byte X and C are widened to f32 before the product, which
    is then exact per term, as on the tensor cores. Returns (min (Mp,),
    argmin (Mp,), sums (T, Kp, Fp), counts (T, Kp), tmin (T, Kp/bk))."""
    ref.full_f32(x.device)
    mp, fp = x.shape
    kp = c.shape[0]
    nt, nkt = mp // block_m, kp // block_k
    d = cn[None, :] - 2.0 * (x.float() @ c.float().T)          # (Mp, Kp)
    cells = d.view(nt, block_m, nkt, block_k)
    local = cells.amin(3)                                      # (T, bm, nkt)
    rows = torch.arange(mp, device=x.device).view(nt, block_m, 1)
    row_e = (local + xn.view(nt, block_m, 1)).clamp_min(0.0).sqrt()
    row_e = torch.where(rows < true_m, row_e, MIN_INIT)
    dead = skip.bool()                                         # (T, nkt)
    tmin = torch.where(dead, MIN_INIT, row_e.amin(1))
    cells = cells.masked_fill(dead[:, None, :, None], MIN_INIT)
    mind, am = ref.first_min(cells.reshape(mp, kp))
    sums, counts = tile_update_plain(x.view(nt, block_m, fp),
                                     am.view(nt, block_m),
                                     rows.view(nt, block_m) < true_m, kp)
    return mind, am, sums, counts, tmin


def lloyd_step_pruned(x: torch.Tensor, c: torch.Tensor, cn: torch.Tensor,
                      xn: torch.Tensor, skip: torch.Tensor, true_m: int, *,
                      block_m: int, block_k: int, block_f: int):
    """Raw pruned one-pass entry on pre-padded inputs: x (Mp, Fp) and c
    (Kp, Fp) of one dtype (f32, bf16 or fp16), cn (Kp,) f32 with +inf in
    padded slots, xn (Mp,) f32 row squared norms (0 in padded rows), skip
    (Mp/bm, Kp/bk) int32. Returns (min (Mp,), argmin (Mp,), entries (Mp,
    Fp), ecnt (Mp,), idx (Kp, 2**L), tmin (Mp/bm, Kp/bk)): the update in
    ``lloyd_step``'s entries layout (``update.reduce_entries`` sums it).
    On the CPU: :func:`lloyd_step_pruned_plain`'s dense blocks in that
    layout (``update.dense_to_entries``)."""
    check_padded(x, c, cn, block_m, block_k, block_f)
    dt = _build.input_dtype(x, c)
    mp, fp = x.shape
    kp = c.shape[0]
    nt, nkt = mp // block_m, kp // block_k
    if xn.shape != (mp,) or skip.shape != (nt, nkt):
        raise ValueError(f"xn {tuple(xn.shape)} and skip {tuple(skip.shape)} "
                         f"must be ({mp},) and ({nt}, {nkt})")
    if _build.on_cpu(x, c, cn, xn, skip):
        mind, am, sums, counts, tmin = lloyd_step_pruned_plain(
            x, c, cn, xn, skip, true_m, block_m, block_k)
        return (mind, am) + _up.dense_to_entries(sums, counts,
                                                 block_m) + (tmin,)
    dev = x.device
    f32, i32 = torch.float32, torch.int32
    mind = torch.empty(mp, dtype=f32, device=dev)
    am = torch.empty(mp, dtype=i32, device=dev)
    entries = torch.empty((mp, fp), dtype=f32, device=dev)
    ecnt = torch.empty(mp, dtype=f32, device=dev)
    idx = torch.full((kp, 1 << _up.tree_levels(nt)), -1, dtype=i32,
                     device=dev)
    tmin = torch.empty((nt, nkt), dtype=f32, device=dev)
    code = _build.launch(
        "fk_lloyd_step_pruned", dt, _build.ptr(x, dt, "x", vec16=True),
        _build.ptr(c_operand(c), dt, "c", vec16=True),
        _build.ptr(cn, f32, "cn", vec16=True),
        _build.ptr(xn, f32, "xn", vec16=True),
        _build.ptr(skip, i32, "skip"), mind.data_ptr(), am.data_ptr(),
        entries.data_ptr(), ecnt.data_ptr(), idx.data_ptr(),
        tmin.data_ptr(), true_m, mp, kp, fp, block_m, block_f,
        _build.stream_of(x))
    _build.check(code, "lloyd_step_pruned")
    lloyd_step_pruned.launches += 1
    return mind, am, entries, ecnt, idx, tmin


lloyd_step_pruned.launches = 0
