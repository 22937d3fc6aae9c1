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
blocks run in no order, so the design buckets the rows first and has no
float atomics (``csrc/fk_kernels.cu``):

1. ``dmr_bucket_kernel`` (a histogram, then a scatter) around
   ``dmr_scan_kernel``: the rows are cut into slabs of ``block_m``, and
   each slab's valid rows are bucketed by cluster with a stable counting
   sort: a histogram per (cluster, chunk of rows), its exclusive scan,
   and each row's rank among the rows of its cluster in a 32-row group
   (``__match_any_sync``), groups in row order. A bucket holds its rows
   in row order whatever order the blocks run in. The histogram gives the
   primary counts.
2. ``dmr_gather_kernel``: one warp owns (slab, a chunk of up to
   ``WALK_CHUNK`` rows of one cluster's bucket, 128 features; 32 when F is
   not a multiple of 4). It knows its rows ahead, so it loads
   ``WALK_GROUP`` rows at once, each as one 16-byte load a lane, and adds
   them in ascending order into the primary replica and in descending
   order within the group into the shadow replica, both in registers. The
   shadow counts the rows it walked. A cluster that holds most of a slab
   splits into chunks in a fixed order, so label skew costs at most the
   chunks' sum below.
3. ``dmr_reduce_kernel`` sums each slab's chunk partials in chunk order,
   then the slabs in slab order, per replica, and ``dmr_verdict_kernel``
   compares them.

Every sum has a fixed order, so a launch repeats bit for bit;
:func:`dmr_walk_plain` states that order in PyTorch (the kernel's result
bit for bit; for the tests and ``chip_smoke.py``, never on the card's
path). The two replicas are two computations: different association
orders of the same loaded values in separate accumulators, which ``nvcc``
cannot merge without changing results. ``shadow_fault`` is a debug
argument (off on every real path) that adds a delta to one slab's shadow
partial, in the kernel and in the plain versions alike, to show the
comparison firing.

Bound on the H100: the bytes of X and the assignments, read once
(0.54 GB at M = 2**20, F = 128: 0.16 ms at 3.35 TB/s). The bucketing
reads the assignments twice and writes M row indices that the gather
reads (16 MB); the chunk partials (2 x 18.5 MB at the default slab) live
in L2.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch import hw
from repro_torch.kernels import _build, ref

# rows of a cluster's bucket one gather warp walks, and the rows it loads
# at once (csrc/fk_kernels.cu: kDmrChunk, kDmrGroup)
WALK_CHUNK = 512
WALK_GROUP = 8


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


def dmr_walk_plain(x: torch.Tensor, assign: torch.Tensor, k: int,
                   block_m: int, shadow_fault: Optional[tuple] = None):
    """The kernel's walk in plain PyTorch, in its order of f32 adds: per
    slab the valid rows in buckets by cluster (rows in order), each
    bucket cut into chunks of ``WALK_CHUNK`` rows; a chunk's primary
    partial adds its rows in order from +0.0, its shadow partial adds each
    group of ``WALK_GROUP`` rows in reverse (groups in order); a slab's
    partial of a cluster is its chunks' partials added in order from +0.0,
    the debug fault lands on it, and the slabs add in slab order. Counts:
    the buckets' sizes (primary) and the rows the chunks walked (shadow).
    Returns what the kernel returns, bit for bit on the card."""
    m, f = x.shape
    dev = x.device
    xf = x.float()
    lab = assign.to(torch.int64)
    zeros = functools.partial(torch.zeros, device=dev)
    sums, sums2 = zeros(k, f), zeros(k, f)
    counts = zeros(k, dtype=torch.int64)
    counts2 = zeros(k, dtype=torch.int64)
    step = torch.arange(WALK_CHUNK, device=dev)
    for s in range(_slabs(m, block_m)):
        a = lab[s * block_m:(s + 1) * block_m]
        rows = torch.nonzero((a >= 0) & (a < k)).squeeze(1)
        order = torch.sort(a[rows], stable=True).indices
        rows = rows[order] + s * block_m         # the slab's buckets
        n = torch.bincount(a[rows - s * block_m], minlength=k)
        nch = (n + WALK_CHUNK - 1) // WALK_CHUNK
        item_a = torch.repeat_interleave(torch.arange(k, device=dev), nch)
        item_j = torch.arange(item_a.numel(), device=dev) \
            - (torch.cumsum(nch, 0) - nch)[item_a]
        first = (torch.cumsum(n, 0) - n)[item_a] + item_j * WALK_CHUNK
        walked = torch.clamp(n[item_a] - item_j * WALK_CHUNK, max=WALK_CHUNK)
        live = step[None, :] < walked[:, None]
        at = torch.where(live, first[:, None] + step[None, :], 0)
        ridx = rows[at.clamp(max=max(rows.numel() - 1, 0))] \
            if rows.numel() else at

        def row(j):
            return torch.where(live[:, j, None], xf[ridx[:, j]], 0.0)
        p1, p2 = zeros(item_a.numel(), f), zeros(item_a.numel(), f)
        for j in range(WALK_CHUNK):
            p1 += row(j)
        for g0 in range(0, WALK_CHUNK, WALK_GROUP):
            for j in reversed(range(g0, g0 + WALK_GROUP)):
                p2 += row(j)
        q1, q2 = zeros(k, f), zeros(k, f)
        for j in range(int(nch.max())):
            sel = item_j == j
            q1[item_a[sel]] = q1[item_a[sel]] + p1[sel]
            q2[item_a[sel]] = q2[item_a[sel]] + p2[sel]
        if shadow_fault is not None and shadow_fault[0] == s:
            q2[shadow_fault[1], shadow_fault[2]] += shadow_fault[3]
        sums += q1
        sums2 += q2
        counts += n
        counts2.index_add_(0, item_a, walked)
    tol = 1e-4 * torch.clamp_min(sums.abs().max(), 1.0)
    bad = ((sums - sums2).abs().max() > tol) | (counts != counts2).any()
    return sums, counts.float(), bad.to(torch.int32)


def centroid_update_dmr(x: torch.Tensor, assign: torch.Tensor, k: int, *,
                        block_m: int = hw.DMR_BLOCK_M,
                        shadow_fault: Optional[tuple] = None):
    """Per-cluster sums and counts with in-kernel DMR. ``x`` (M, F) f32,
    ``assign`` (M,) int32 (rows outside [0, k) count nowhere); any M, the
    last slab may be short. ``shadow_fault`` = (slab, cluster, feature,
    delta) perturbs one slab's shadow partial (debug only). Returns (sums
    (K, F) f32, counts (K,) f32, bad 0-d int32)."""
    if x.dim() != 2 or assign.shape != (x.shape[0],) or k < 1 \
            or block_m < 32 or block_m % 32:
        raise ValueError(f"centroid_update_dmr: x {tuple(x.shape)}, assign "
                         f"{tuple(assign.shape)}, k {k}, block_m {block_m} "
                         f"(a multiple of 32)")
    if _build.on_cpu(x, assign):
        return centroid_update_dmr_plain(x, assign, k, block_m, shadow_fault)
    m, f = x.shape
    dev = x.device
    lib = _build.library().lib
    sizes = (ctypes.c_longlong * 2)()
    _build.check(lib.fk_dmr_workspace(m, f, k, block_m,
                                      ctypes.addressof(sizes)),
                 "centroid_update_dmr workspace")
    iwork = torch.empty(int(sizes[0]), dtype=torch.int32, device=dev)
    fwork = torch.empty(int(sizes[1]), dtype=torch.float32, device=dev)
    sums = torch.empty((k, f), dtype=torch.float32, device=dev)
    counts = torch.empty(k, dtype=torch.float32, device=dev)
    bad = torch.empty((), dtype=torch.int32, device=dev)
    fs, fk, ff, fdelta = shadow_fault if shadow_fault is not None \
        else (-1, -1, -1, 0.0)
    code = lib.fk_centroid_update_dmr(
        _build.ptr(x, torch.float32, "x"),
        _build.ptr(assign, torch.int32, "assign"), iwork.data_ptr(),
        fwork.data_ptr(), sums.data_ptr(), counts.data_ptr(), bad.data_ptr(),
        m, f, k, block_m, int(fs), int(fk), int(ff), float(fdelta),
        _build.stream_of(x))
    _build.check(code, "centroid_update_dmr")
    centroid_update_dmr.launches += 1
    return sums, counts, bad


centroid_update_dmr.launches = 0


def gather_resources(v: int) -> dict:
    """``dmr_gather_kernel<v>`` on the card (v = 4: 16-byte row loads, 1:
    a feature a lane): resident blocks an SM, registers and local-memory
    (spill) bytes a thread. Needs a CUDA card (the library's build)."""
    out = (ctypes.c_int * 4)()
    _build.check(_build.library().lib.fk_dmr_resources(v, out),
                 "centroid_update_dmr resources")
    return dict(zip(("blocks_per_sm", "registers", "local_bytes",
                     "smem_bytes"), out))
