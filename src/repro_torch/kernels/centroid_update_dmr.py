"""DMR-protected centroid update (paper §I/§IV: DMR protects the
memory-bound update phase) on Hopper.

Replaces the Pallas TPU kernel ``centroid_update_dmr`` of
``src/repro/kernels/centroid_update_dmr.py`` (body ``_kernel``): the
per-cluster sums (K, F) and counts (K,) computed twice from ONE load of X,
a primary replica and a shadow replica in reversed row order, and a
mismatch flag ``bad = max|sums - sums2| > 1e-4 * max(max|sums|, 1)`` or
any count differs. Rows whose assignment lies outside [0, K) (padding
carries -1) match no cluster.

The TPU kernel revisits its (K, F) outputs over a sequential grid; Hopper
blocks run in no order, so the design has two passes and no float atomics:

1. ``dmr_partials_kernel``: the rows are cut into slabs of ``block_m``.
   One thread block owns (64 clusters, one slab, 32 features); warp w owns
   8 of the clusters and lane l one feature. The block stages the slab's
   assignments in shared memory; each warp finds its rows with a ballot
   over 32 rows at a time and loads each of them once from device memory,
   so every X element is read once in all. The primary replica adds the
   rows in row order; the shadow replica adds the same loaded values
   (held in shared memory) in reversed order within each 32-row group.
   Each writes its own (slab, K, F) partial, counts as exact integers.
2. ``dmr_reduce_kernel`` sums the slabs in slab order per (k, f), and
   ``dmr_verdict_kernel`` compares the replicas.

Every sum has a fixed order, so a launch repeats bit for bit. The two
replicas are two computations: different association orders of the same
values in separate accumulators, which ``nvcc`` cannot merge without
changing results. ``shadow_fault`` is a debug argument (off on every real
path) that adds a delta to one shadow partial, in the kernel and in the
plain version alike, to show the comparison firing.

Bound on the H100: the bytes of X and the assignments, read once
(0.54 GB at M = 2**20, F = 128: 0.16 ms at 3.35 TB/s); the partials
(2 * slabs * K * F * 4 bytes) live in L2 at the default slab.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import hw
from repro_torch.kernels import _build, ref

# clusters per thread block of the partials kernel (8 warps x 8)
CLUSTERS_PER_BLOCK = 64


def _slabs(m: int, block_m: int) -> int:
    return max(1, -(-m // block_m))


def centroid_update_dmr_plain(x: torch.Tensor, assign: torch.Tensor, k: int,
                              block_m: int,
                              shadow_fault: Optional[tuple] = None):
    """Plain PyTorch version with the kernel's slab structure: per slab of
    ``block_m`` rows a primary partial (one-hot product in row order) and a
    shadow partial (the slab's rows reversed), the slabs summed, the
    replicas compared. Returns (sums (K, F), counts (K,), bad 0-d int32)."""
    ref.full_f32(x.device)
    m, f = x.shape
    s = _slabs(m, block_m)
    mp = s * block_m
    a = torch.nn.functional.pad(assign.to(torch.int32), (0, mp - m),
                                value=-1)
    valid = (a >= 0) & (a < k)
    onehot = ref.one_hot(torch.where(valid, a, 0), k)
    onehot.mul_(valid[:, None].float())
    oh = onehot.view(s, block_m, k)
    xs = torch.nn.functional.pad(x.float(), (0, 0, 0, mp - m)).view(
        s, block_m, f)
    part1 = torch.bmm(oh.transpose(1, 2), xs)
    cnt1 = oh.sum(1)
    oh_r, xs_r = oh.flip(1), xs.flip(1)
    part2 = torch.bmm(oh_r.transpose(1, 2), xs_r)
    cnt2 = oh_r.sum(1)
    if shadow_fault is not None:
        fs, fk, ff, delta = shadow_fault
        part2[fs, fk, ff] += delta
    sums, sums2 = part1.sum(0), part2.sum(0)
    counts, counts2 = cnt1.sum(0), cnt2.sum(0)
    tol = 1e-4 * torch.clamp_min(sums.abs().max(), 1.0)
    bad = ((sums - sums2).abs().max() > tol) | (counts != counts2).any()
    return sums, counts, bad.to(torch.int32)


def centroid_update_dmr(x: torch.Tensor, assign: torch.Tensor, k: int, *,
                        block_m: int = hw.DMR_BLOCK_M,
                        shadow_fault: Optional[tuple] = None):
    """Per-cluster sums and counts with in-kernel DMR. ``x`` (M, F) f32,
    ``assign`` (M,) int32 (rows outside [0, k) count nowhere); any M, the
    last slab may be short. ``shadow_fault`` = (slab, cluster, feature,
    delta) perturbs one shadow partial (debug only). Returns (sums (K, F)
    f32, counts (K,) f32, bad 0-d int32)."""
    if x.dim() != 2 or assign.shape != (x.shape[0],) or k < 1 \
            or block_m < 32 or block_m % 32:
        raise ValueError(f"centroid_update_dmr: x {tuple(x.shape)}, assign "
                         f"{tuple(assign.shape)}, k {k}, block_m {block_m} "
                         f"(a multiple of 32)")
    if _build.on_cpu(x, assign):
        return centroid_update_dmr_plain(x, assign, k, block_m, shadow_fault)
    m, f = x.shape
    s = _slabs(m, block_m)
    dev = x.device
    part = torch.empty((2, s, k, f), dtype=torch.float32, device=dev)
    cnt = torch.empty((2, s, k), dtype=torch.int32, device=dev)
    sums = torch.empty((k, f), dtype=torch.float32, device=dev)
    counts = torch.empty(k, dtype=torch.float32, device=dev)
    nred = -(-k * f // 256)
    red = torch.empty((nred, 3), dtype=torch.float32, device=dev)
    bad = torch.empty((), dtype=torch.int32, device=dev)
    fs, fk, ff, fdelta = shadow_fault if shadow_fault is not None \
        else (-1, -1, -1, 0.0)
    code = _build.library().lib.fk_centroid_update_dmr(
        _build.ptr(x, torch.float32, "x"),
        _build.ptr(assign, torch.int32, "assign"), part.data_ptr(),
        cnt.data_ptr(), sums.data_ptr(), counts.data_ptr(), red.data_ptr(),
        bad.data_ptr(), m, f, k, block_m, int(fs), int(fk), int(ff),
        float(fdelta), _build.stream_of(x))
    _build.check(code, "centroid_update_dmr")
    centroid_update_dmr.launches += 1
    return sums, counts, bad


centroid_update_dmr.launches = 0
