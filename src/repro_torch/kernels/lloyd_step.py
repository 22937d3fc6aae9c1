"""One-pass Lloyd iteration kernel (paper §III, Fig. 4, fused update).

Replaces the Pallas TPU kernels ``lloyd_step`` of
``src/repro/kernels/lloyd_step.py`` (bodies ``_kernel``/``_kernel_smallk``,
update epilogue ``_emit_update``) and, for B stacked problems,
``lloyd_step_batched`` (body ``_kernel_batched``). It is ``distance_argmin``
plus, once a row tile's argmin is final, that tile's per-cluster sums and
counts; rows >= ``true_m`` are padding and enter neither.

CUDA kernels: ``lloyd_tile_kernel<BM, false, kEntryUpdate>`` (f32) and
``lloyd_tile_mma_kernel<T, BM, false, kEntryUpdate>`` (bf16, fp16) in
``csrc/fk_kernels.cu`` (T the input dtype: f32 on the CUDA cores, bf16 or
fp16 on the tensor cores, each on ``distance_argmin``'s loop: at 2 bytes
X's row tile kept in shared memory, C's chunks on a ``cp.async`` ring,
``ldmatrix`` fragments, the min / argmin in registers). The reference's
epilogue
writes a dense (Kp, Fp) block per row tile, ~97 % zeros at K = 1000 with
rows in random order (4.3 GB a step at M = 2**20, F = 128); this one writes
the tile's entries with the shared writer of ``csrc/fk_entries.cuh``
(``update.update_entries``' layout): the tile's rows ranked by (cluster,
row) with a bitonic sort in shared memory, one row per present cluster,
each (k, f) sum one lane's f32 sum over its cluster's rows in row order
from 0 (2-byte rows widened exactly), its count and ``idx[k][slot(t)]``.
``ops.fused_lloyd`` sums them with the tree kernel over entries
(``update.reduce_entries``), which gives the dense blocks' tree bits, so a
``lloyd`` step sums bit for bit as a ``fused`` step (``update.compact_
update``: the same writer) and as the plain dense specification
(:func:`lloyd_step_plain`, then ``update.tree_sum_plain``). No atomics.

Batched: B stacked problems in one launch over a (row tile, problem)
grid; ``blockIdx.y`` moves every base pointer to its problem's slab, so
problem b of the launch runs, bit for bit, one problem's code. At f32
:func:`lloyd_step_batched` keeps the dense layout (``<.., false,
kDenseUpdate>``, ``emit_update``), whose tree (``ops._tree_sum``) is the
single-problem entries' tree (the reference's contract,
``tests/test_batched.py``). At bf16 / fp16 on the card
:func:`lloyd_step_batched_entries` (``<T, .., false, kBatchedEntries>``)
writes each problem's entries with ``lloyd_step``'s writer: problem b's
row tile t at entry rows (b Np / bm + t) bm .., its clusters at idx rows
b Kp .., so one tree over B Kp rows (``update.reduce_entries``) sums
every problem, where the dense route wrote (B, Np / bm, Kp, Fp) f32
blocks, ~60 % zeros at the PQ shape, and read them back. The TPU kernel
wants padded K to be one centroid tile; this one loops over 128-wide
centroid tiles as the single-problem kernel does, so any K works.
:func:`tile_update` launches ``emit_update`` alone (``update_tiles_kernel
<T, BM>``): the dense route every other route is held to, and the CPU's
two-pass update.

Bound on the H100: the distance GEMM (2 * M * K * F FLOPs on f32 CUDA
cores, or the bf16 / fp16 tensor cores: 0.27 ms at the shape above) and,
at 2 bytes, about as much in bytes: 2-byte X once and the f32 entries
(~0.5 GB). The f32 batched step's dense partial-sum buffer bounds it by
bytes; the 2-byte one by X, its present entries, idx and the labels. X
rows of the update are re-read from global memory (L2-resident right
after the tile's GEMM): the entry writer is shared with the two-pass
update, which has no stash.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import update as _up
from repro_torch.kernels.distance_argmin import (c_operand, check_padded,
                                                 distance_argmin_plain)
from repro_torch.kernels.update import tile_update_plain


def lloyd_step_plain(x: torch.Tensor, c: torch.Tensor, cn: torch.Tensor,
                     true_m: int, block_m: int):
    """Plain PyTorch version: (min, argmin, sums (T, Kp, Fp), counts (T, Kp))."""
    mind, am = distance_argmin_plain(x, c, cn)
    mp, fp = x.shape
    nt = mp // block_m
    rows = torch.arange(mp, device=x.device).view(nt, block_m)
    sums, counts = tile_update_plain(x.view(nt, block_m, fp),
                                     am.view(nt, block_m), rows < true_m,
                                     c.shape[0])
    return mind, am, sums, counts


def lloyd_step(x: torch.Tensor, c: torch.Tensor, cn: torch.Tensor,
               true_m: int, *, block_m: int, block_k: int, block_f: int):
    """Raw one-pass kernel entry on pre-padded inputs (X and C f32, bf16 or
    fp16, as :func:`distance_argmin`). Returns (min (Mp,), argmin (Mp,),
    entries (Mp, Fp), ecnt (Mp,), idx (Kp, 2**L)): the update in
    ``update.update_entries``' layout (one row per present (tile, cluster)
    pair; ``update.reduce_entries`` sums it), all f32 but argmin and idx.
    On the CPU: :func:`lloyd_step_plain`'s dense blocks in that layout."""
    check_padded(x, c, cn, block_m, block_k, block_f)
    dt = _build.input_dtype(x, c)
    if _build.on_cpu(x, c, cn):
        mind, am, sums, counts = lloyd_step_plain(x, c, cn, true_m, block_m)
        return (mind, am) + _up.dense_to_entries(sums, counts, block_m)
    mp, fp = x.shape
    kp = c.shape[0]
    nt = mp // block_m
    dev = x.device
    mind = torch.empty(mp, dtype=torch.float32, device=dev)
    am = torch.empty(mp, dtype=torch.int32, device=dev)
    entries = torch.empty((mp, fp), dtype=torch.float32, device=dev)
    ecnt = torch.empty(mp, dtype=torch.float32, device=dev)
    idx = torch.full((kp, 1 << _up.tree_levels(nt)), -1, dtype=torch.int32,
                     device=dev)
    c_op = c_operand(c)
    code = _build.launch(
        "fk_lloyd_step", dt, _build.ptr(x, dt, "x", vec16=True),
        _build.ptr(c_op, dt, "c", vec16=True),
        _build.ptr(cn, torch.float32, "cn", vec16=True), mind.data_ptr(),
        am.data_ptr(), entries.data_ptr(), ecnt.data_ptr(), idx.data_ptr(),
        true_m, mp, kp, fp, block_m, block_f, _build.stream_of(x))
    _build.check(code, "lloyd_step")
    lloyd_step.launches += 1
    return mind, am, entries, ecnt, idx


lloyd_step.launches = 0


def tile_update(xp: torch.Tensor, am: torch.Tensor, sums_p: torch.Tensor,
                counts_p: torch.Tensor, *, true_m: int, block_m: int,
                tile: Optional[torch.Tensor] = None,
                gate: Optional[torch.Tensor] = None) -> None:
    """Write the update of row tiles into ``sums_p`` (T, Kp, Fp) and
    ``counts_p`` (T, Kp) in place (f32), from padded X (Mp, Fp; f32, bf16
    or fp16) and the padded assignment ``am`` (Mp,) int32: every tile, or
    only tile ``tile`` (0-d int32). With ``gate`` (0-d int32) it writes
    only when ``gate > 0``.
    Both stay on the data's device, so the caller never synchronises.

    On the card this launches ``emit_update`` alone (``update_tiles_kernel``),
    the dense epilogue the f32 batched kernel runs, whose sums the
    entry writer's equal: over all tiles it is the dense route the compact
    update (``update.compact_update``) and the one-pass entries are held to
    bit for bit (no card path launches it). On the CPU it is
    :func:`tile_update_plain` on the same tiles, over all tiles the two-pass
    update of ``ops.tiled_update``."""
    nt, kp, fp = sums_p.shape
    if _build.on_cpu(xp, am, sums_p):
        if tile is None:
            idx = torch.arange(nt)
            x_t, am_t = xp.view(nt, block_m, fp), am.view(nt, block_m)
        else:
            idx = tile.view(1).long()
            x_t = xp.view(nt, block_m, fp).index_select(0, idx)
            am_t = am.view(nt, block_m).index_select(0, idx)
        rows = idx[:, None] * block_m + torch.arange(block_m)[None, :]
        new_s, new_c = tile_update_plain(x_t, am_t, rows < true_m, kp)
        if gate is not None:
            keep = gate.view(1, 1) > 0
            new_s = torch.where(keep[..., None], new_s,
                                sums_p.index_select(0, idx))
            new_c = torch.where(keep, new_c, counts_p.index_select(0, idx))
        sums_p.index_copy_(0, idx, new_s)
        counts_p.index_copy_(0, idx, new_c)
        return
    i32, f32 = torch.int32, torch.float32
    dt = _build.input_dtype(xp)
    code = _build.launch(
        "fk_update_tiles", dt, _build.ptr(xp, dt, "xp"),
        _build.ptr(am, i32, "am"),
        None if tile is None else _build.ptr(tile, i32, "tile"),
        None if gate is None else _build.ptr(gate, i32, "gate"),
        _build.ptr(sums_p, f32, "sums_p"),
        _build.ptr(counts_p, f32, "counts_p"), true_m, kp, fp, block_m, nt,
        _build.stream_of(xp))
    _build.check(code, "tile_update")
    tile_update.launches += 1


tile_update.launches = 0


# problems per batched launch: one per grid row (gridDim.y <= 65535)
MAX_PROBLEMS = 65_535


def check_padded_batched(x: torch.Tensor, c: torch.Tensor, cn: torch.Tensor,
                         block_m: int, block_k: int, block_f: int) -> None:
    if x.dim() != 3 or c.dim() != 3 or cn.dim() != 2 or x.shape[0] < 1 \
            or not x.shape[0] == c.shape[0] == cn.shape[0]:
        raise ValueError(f"batched shapes must be x (B, Np, Fp), c (B, Kp, "
                         f"Fp), cn (B, Kp) with B >= 1; got {tuple(x.shape)}, "
                         f"{tuple(c.shape)}, {tuple(cn.shape)}")
    check_padded(x[0], c[0], cn[0], block_m, block_k, block_f)
    _build.input_dtype(x, c)        # f32, bf16 or fp16, else it raises
    if x.shape[0] > MAX_PROBLEMS:
        raise ValueError(f"{x.shape[0]} problems in one launch; the kernel's "
                         f"grid holds at most {MAX_PROBLEMS} (gridDim.y)")


def lloyd_step_batched_plain(x: torch.Tensor, c: torch.Tensor,
                             cn: torch.Tensor, true_m: int, block_m: int):
    """Plain PyTorch version: :func:`lloyd_step_plain` per problem, stacked,
    so each problem is bit for bit the single-problem plain step."""
    outs = [lloyd_step_plain(x[b], c[b], cn[b], true_m, block_m)
            for b in range(x.shape[0])]
    return tuple(torch.stack(parts) for parts in zip(*outs))


def lloyd_step_batched(x: torch.Tensor, c: torch.Tensor, cn: torch.Tensor,
                       true_m: int, *, block_m: int, block_k: int,
                       block_f: int):
    """Raw batched one-pass entry on pre-padded inputs, the dense update:
    x (B, Np, Fp) and c (B, Kp, Fp) of one dtype, cn (B, Kp) f32 (+inf in
    padded slots); every problem has ``true_m`` real rows. Returns (min
    (B, Np), argmin (B, Np), sums (B, Np/bm, Kp, Fp), counts (B, Np/bm,
    Kp)), all f32 but argmin. On the card f32 only: a 2-byte stack writes
    entries (:func:`lloyd_step_batched_entries`); on the CPU any dtype
    (:func:`lloyd_step_batched_plain`)."""
    check_padded_batched(x, c, cn, block_m, block_k, block_f)
    if _build.on_cpu(x, c, cn):
        return lloyd_step_batched_plain(x, c, cn, true_m, block_m)
    if x.dtype != torch.float32:
        raise ValueError(f"the {x.dtype} batched step on the card writes "
                         f"entries: lloyd_step_batched_entries")
    nb, mp, fp = x.shape
    kp = c.shape[1]
    nt = mp // block_m
    dev = x.device
    mind = torch.empty((nb, mp), dtype=torch.float32, device=dev)
    am = torch.empty((nb, mp), dtype=torch.int32, device=dev)
    sums = torch.empty((nb, nt, kp, fp), dtype=torch.float32, device=dev)
    counts = torch.empty((nb, nt, kp), dtype=torch.float32, device=dev)
    f32 = torch.float32
    code = _build.library().lib.fk_lloyd_step_batched(
        _build.ptr(x, f32, "x", vec16=True),
        _build.ptr(c_operand(c), f32, "c", vec16=True),
        _build.ptr(cn, f32, "cn", vec16=True),
        mind.data_ptr(), am.data_ptr(), sums.data_ptr(), counts.data_ptr(),
        true_m, nb, mp, kp, fp, block_m, block_f, _build.stream_of(x))
    _build.check(code, "lloyd_step_batched")
    lloyd_step_batched.launches += 1
    return mind, am, sums, counts


lloyd_step_batched.launches = 0


def lloyd_step_batched_entries(x: torch.Tensor, c: torch.Tensor,
                               cn: torch.Tensor, true_m: int, *,
                               block_m: int, block_k: int, block_f: int):
    """Raw batched one-pass entry whose update is each problem's entries:
    x (B, Np, Fp) and c (B, Kp, Fp) bf16 or fp16 on the card (any dtype on
    the CPU), cn (B, Kp) f32; every problem has ``true_m`` real rows.
    Returns (min (B, Np), argmin (B, Np), entries (B Np, Fp), ecnt (B Np,),
    idx (B Kp, 2**L)), L = ceil(log2(Np / bm)): problem b's entries in
    :func:`lloyd_step`'s layout at entry rows b Np .. and idx rows b Kp ..
    (``update.reduce_entries`` over ``Np / bm`` tiles sums every problem).
    On the CPU: :func:`lloyd_step_batched_plain`'s dense blocks in that
    layout (``update.dense_to_entries_batched``)."""
    check_padded_batched(x, c, cn, block_m, block_k, block_f)
    if _build.on_cpu(x, c, cn):
        mind, am, sums, counts = lloyd_step_batched_plain(x, c, cn, true_m,
                                                          block_m)
        return (mind, am) + _up.dense_to_entries_batched(sums, counts,
                                                         block_m)
    code = _build.HALF_KINDS.get(str(x.dtype).replace("torch.", ""))
    if code is None:
        raise ValueError(f"the {x.dtype} batched step on the card keeps the "
                         f"dense update: lloyd_step_batched")
    nb, mp, fp = x.shape
    kp = c.shape[1]
    dev = x.device
    mind = torch.empty((nb, mp), dtype=torch.float32, device=dev)
    am = torch.empty((nb, mp), dtype=torch.int32, device=dev)
    entries = torch.empty((nb * mp, fp), dtype=torch.float32, device=dev)
    ecnt = torch.empty(nb * mp, dtype=torch.float32, device=dev)
    idx = torch.full((nb * kp, 1 << _up.tree_levels(mp // block_m)), -1,
                     dtype=torch.int32, device=dev)
    dt = x.dtype
    rc = _build.library().lib.fk_lloyd_step_batched_lp(
        _build.ptr(x, dt, "x"), _build.ptr(c, dt, "c"),
        _build.ptr(cn, torch.float32, "cn"), mind.data_ptr(), am.data_ptr(),
        entries.data_ptr(), ecnt.data_ptr(), idx.data_ptr(), true_m, nb, mp,
        kp, fp, block_m, block_f, code, _build.stream_of(x))
    _build.check(rc, "lloyd_step_batched_entries")
    lloyd_step_batched_entries.launches += 1
    return mind, am, entries, ecnt, idx


lloyd_step_batched_entries.launches = 0
