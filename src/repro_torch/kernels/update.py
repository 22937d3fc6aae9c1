"""Two-pass centroid update and the fixed-order tree sum of per-tile
partials on Hopper.

Replaces, on the card's path, the dense update of the reference: the
update epilogue ``_emit_update`` (``src/repro/kernels/lloyd_step.py:162``)
over every row tile, which writes (num_m, Kp, Fp) partial sums, collapsed
by ``_tree_sum`` (``src/repro/kernels/ops.py:510``, XLA code in the
reference: log2(num_m) halving rounds). The port's own order is kept bit
for bit: each (tile, k, f) partial starts at +0.0 and adds its cluster's
rows in row order, widened to f32, and the tiles combine in
:func:`tree_sum_plain`'s halving tree (at a level of s nodes, node i < s // 2
becomes a[i] + a[i + s // 2], an odd last node moves to index s // 2). Such
a partial is never -0.0 and x + (+0.0) == x for every other x, so the tree
over the dense, mostly zero leaves equals the same tree over the present
(tile, cluster) entries alone, a node with one present child being that
child (:func:`sparse_tree_plain`). The update therefore needs no new
tolerance and no new contract.

Slots: leaf t of the tree over T leaves sits at slot :func:`tree_slots`
(t), whose bit l says whether t's node is the right operand at level l.
The halving tree is then the perfect tree of adjacent pairs over 2**L
slots (L = ceil(log2 T)), read left to right, the slots no tile maps to
being absent (:func:`pair_tree_plain`). A chunk of 2**c aligned slots is a
subtree, so a reduction splits at chunk boundaries and combines the
chunks' nodes in a second pass.

Two CUDA kernels in ``csrc/fk_update.cu``:

* :func:`update_entries` (``update_entries_kernel<T, BM>``): one block a
  row tile sorts the tile's rows by (cluster, row) (bitonic, in shared
  memory) and writes one entry per present cluster: row t * bm + j holds the
  Fp sums of the tile's j-th present cluster (each one lane's f32 sum in row
  order, from 0, as ``emit_update`` sums), ``ecnt`` its count, and
  ``idx[k, slot(t)] = t * bm + j`` (-1 where the tile has no row of k). The
  buffers are (Mp, Fp) and (Kp, 2**L): O(M Fp), never O(T Kp Fp).
* :func:`tree_reduce` (``tree_reduce_kernel<V, dense>``): one pass over
  chunks of at most 2**8 slots; a block owns (row, V-wide feature group,
  chunk), lists its chunk's present slots in order and walks them once,
  each thread's features in registers, with a shift-reduce stack: two
  neighbours meet at the highest bit in which their slots differ. It reads
  sparse entries through ``idx`` or dense partials (T, rows, width) through
  a tile stride and a row (problem) stride. No atomics. Besides its
  ``launches``, the wrapper counts each variant's in
  ``tree_reduce.kernel_launches`` (``sparse``, ``dense``).

:func:`compact_update` (the update: entries, then
:func:`reduce_entries`, the tree over sums and over counts) is what
``ops.tiled_update`` runs on the card; the one-pass kernels write the same
entries from their epilogue (the writer of ``csrc/fk_entries.cuh``), and
``ops.fused_lloyd`` / ``fused_lloyd_ft`` reduce them with
:func:`reduce_entries`; :func:`update_entries` of one tile, keyed, is the
FT step's recompute; the 2-byte batched step writes each problem's
entries at its own entry and idx rows, and :func:`reduce_entries` over B
Kp rows sums the stack (:func:`dense_to_entries_batched`, its layout from
dense blocks); the pruned step writes ``lloyd_step``'s entries.
:func:`tree_sum` is ``ops._tree_sum`` (the f32 batched kernel's dense
partials, one problem or a stack of them).
Plain versions, used by the tests and on the CPU: :func:`update_plain`
(the specification: dense :func:`tile_update_plain`, its present entries,
the sparse tree), :func:`update_entries_plain` / :func:`dense_to_entries`,
:func:`tree_reduce_plain` and :func:`tree_sum_plain` (the torch halving
tree).

Bound on the H100 (bytes, 3.35 TB/s): the update reads X and the labels
once and writes and reads its entries once, ~1.55 GB at M = 2**20,
F = 128, K = 1000 with rows in random order (~985k present pairs): 0.46 ms
(0.38 with 2-byte X). The tree sum reads the dense partials once: 4.33 GB,
1.29 ms, at ``lloyd_step``'s partials.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import hw
from repro_torch.kernels import _build, ref

# slots a tree chunk holds at most, as a power of two (kTreeMaxLevels)
MAX_CHUNK_LOG2 = 8
# a pass splits its slots no finer than this, whatever the parallelism
MIN_CHUNK_LOG2 = 5
TREE_THREADS = 128
# dtype code of fk_update_entries
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def tile_update_plain(x_tiles: torch.Tensor, am_tiles: torch.Tensor,
                      valid: torch.Tensor, kp: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain update of row tiles: x_tiles (T, bm, Fp), am_tiles (T, bm),
    valid (T, bm) bool -> sums (T, Kp, Fp), counts (T, Kp), f32 whatever
    the rows' dtype. The single definition used for every tile and for a
    recomputed one, so both sum in one order (the dense specification of
    every update route)."""
    ref.full_f32(x_tiles.device)
    onehot = ref.one_hot(am_tiles, kp) * valid[..., None].float()
    return torch.bmm(onehot.transpose(1, 2), x_tiles.float()), onehot.sum(1)


def tree_levels(n: int) -> int:
    """Levels of the halving tree over ``n >= 1`` leaves: ceil(log2 n)."""
    return (n - 1).bit_length()


def tree_slots(n: int, device=None) -> torch.Tensor:
    """Slot of each of the ``n`` leaves of the halving tree (int64 (n,)):
    bit l is set where the leaf's node is the right operand at level l."""
    node = torch.arange(n, device=device)
    slot = torch.zeros_like(node)
    for level in range(tree_levels(n)):
        half = (((n - 1) >> level) + 1) // 2
        right = (node >= half) & (node < 2 * half)
        slot |= right.long() << level
        node = torch.where(node >= 2 * half, half,
                           torch.where(right, node - half, node))
    return slot


def tree_sum_plain(a: torch.Tensor) -> torch.Tensor:
    """Balanced pairwise reduction over axis 0 (deterministic on every
    device: elementwise adds in a fixed tree)."""
    while a.shape[0] > 1:
        half = a.shape[0] // 2
        a = torch.cat([a[:half] + a[half:2 * half], a[2 * half:]], 0)
    return a[0]


def _combine(vals, group, parent, right, n_parents):
    """One tree level over a sparse node list: nodes of a group with the
    same parent add, left + right; a lone node moves up as it is."""
    key = group * n_parents + parent
    order = torch.argsort(key * 2 + right.long(), stable=True)
    vals, key = vals[order], key[order]
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    head = first.nonzero().squeeze(1)
    nxt = (head + 1).clamp(max=key.shape[0] - 1)
    pair = (head + 1 < key.shape[0]) & (key[nxt] == key[head])
    out = vals[head]
    out[pair] = vals[head[pair]] + vals[head[pair] + 1]
    key = key[head]
    return out, key // n_parents, key % n_parents


def _scatter(vals, group, n_groups):
    out = torch.zeros((n_groups,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    out[group] = vals
    return out


def sparse_tree_plain(vals: torch.Tensor, leaf: torch.Tensor,
                      group: torch.Tensor, n_leaves: int,
                      n_groups: int) -> torch.Tensor:
    """:func:`tree_sum_plain` over ``n_leaves`` leaves for each of
    ``n_groups`` groups, where only the entries given are present: entry i
    is leaf ``leaf[i]`` of group ``group[i]`` with value ``vals[i]``. A node
    with one present child is that child; a group without entries sums to
    +0.0. Returns (n_groups, *vals.shape[1:])."""
    size = n_leaves
    while size > 1 and vals.shape[0]:
        half = size // 2
        right = (leaf >= half) & (leaf < 2 * half)
        parent = torch.where(leaf < half, leaf,
                             torch.where(right, leaf - half, half))
        size = half + size % 2
        vals, group, leaf = _combine(vals, group, parent, right, size)
    return _scatter(vals, group, n_groups)


def pair_tree_plain(vals: torch.Tensor, pos: torch.Tensor,
                    group: torch.Tensor, levels: int,
                    n_groups: int) -> torch.Tensor:
    """The perfect tree of adjacent pairs over 2**levels positions per
    group ((2p, 2p + 1) first), only the given entries present, as
    :func:`sparse_tree_plain`. Over :func:`tree_slots` positions it is the
    halving tree."""
    for level in range(levels):
        if not vals.shape[0]:
            break
        vals, group, pos = _combine(vals, group, pos >> 1, (pos & 1) == 1,
                                    1 << (levels - level - 1))
    return _scatter(vals, group, n_groups)


def update_plain(x_tiles: torch.Tensor, am_tiles: torch.Tensor,
                 valid: torch.Tensor, kp: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The update's specification: x_tiles (T, bm, Fp), am_tiles (T, bm),
    valid (T, bm) bool -> sums (Kp, Fp), counts (Kp,), f32. The present
    (tile, cluster) entries of :func:`tile_update_plain`, then
    :func:`sparse_tree_plain` over the T tiles: bit for bit
    ``tree_sum_plain(tile_update_plain(...))``."""
    sums_p, counts_p = tile_update_plain(x_tiles, am_tiles, valid, kp)
    tile, k = (counts_p > 0).nonzero(as_tuple=True)
    nt = x_tiles.shape[0]
    return (sparse_tree_plain(sums_p[tile, k], tile, k, nt, kp),
            sparse_tree_plain(counts_p[tile, k], tile, k, nt, kp))


def update_entries_plain(x_tiles: torch.Tensor, am_tiles: torch.Tensor,
                         valid: torch.Tensor, kp: int,
                         keys: bool = False) -> tuple:
    """Plain version of :func:`update_entries` in its layout: entries
    (T * bm, Fp) and ecnt (T * bm,) f32 (zeros where the kernel writes
    nothing), idx (Kp, 2**L) int32; with ``keys`` also ekey (T * bm,)
    int32, each entry row's cluster, -1 past a tile's last entry (the keyed
    layout: those rows are zeros)."""
    sums_p, counts_p = tile_update_plain(x_tiles, am_tiles, valid, kp)
    return dense_to_entries(sums_p, counts_p, x_tiles.shape[1], keys)


def dense_to_entries(sums_p: torch.Tensor, counts_p: torch.Tensor, bm: int,
                     keys: bool = False) -> tuple:
    """Dense per-tile blocks (sums (T, Kp, Fp), counts (T, Kp); a pair is
    present where its count is > 0) in :func:`update_entries`' layout for
    row tiles of ``bm`` rows, as :func:`update_entries_plain` returns it."""
    nt, kp, fp = sums_p.shape
    present = counts_p > 0
    tile, k = present.nonzero(as_tuple=True)      # by tile, then cluster
    row = tile * bm + present.cumsum(1)[tile, k] - 1
    dev = sums_p.device
    entries = torch.zeros((nt * bm, fp), dtype=torch.float32, device=dev)
    ecnt = torch.zeros(nt * bm, dtype=torch.float32, device=dev)
    idx = torch.full((kp, 1 << tree_levels(nt)), -1, dtype=torch.int32,
                     device=dev)
    entries[row] = sums_p[tile, k]
    ecnt[row] = counts_p[tile, k]
    idx[k, tree_slots(nt, dev)[tile]] = row.to(torch.int32)
    if not keys:
        return entries, ecnt, idx
    ekey = torch.full((nt * bm,), -1, dtype=torch.int32, device=dev)
    ekey[row] = k.to(torch.int32)
    return entries, ecnt, idx, ekey


def dense_to_entries_batched(sums_p: torch.Tensor, counts_p: torch.Tensor,
                             bm: int) -> tuple:
    """A stack's dense blocks (sums (B, T, Kp, Fp), counts (B, T, Kp)) in
    the 2-byte batched step's layout: problem b's :func:`dense_to_entries`
    at entry rows b T bm .. (its row tile t at global tile b T + t) and
    idx rows b Kp .., the idx values the global rows. Returns (entries
    (B T bm, Fp), ecnt (B T bm,), idx (B Kp, 2**L)); the tree over them
    with rows = B Kp (:func:`reduce_entries`, ``ntiles`` T) is each
    problem's tree."""
    nb, nt = sums_p.shape[:2]
    parts = [dense_to_entries(sums_p[b], counts_p[b], bm) for b in range(nb)]
    idx = [torch.where(p[2] >= 0, p[2] + b * nt * bm, -1)
           for b, p in enumerate(parts)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]),
            torch.cat(idx).to(torch.int32))


def _entries_tile_plain(xp, amp, kp, true_m, block_m, tile, out, ekey):
    """:func:`update_entries` of the one tile ``tile`` into ``out`` (and
    ``ekey``) in place, its idx column cleared first: the plain version of
    the kernel's one-tile launch."""
    entries, ecnt, idx = out
    mp, fp = xp.shape
    t = int(tile)
    rows = torch.arange(t * block_m, (t + 1) * block_m)
    ent, cnt, col, key = update_entries_plain(
        xp[rows].view(1, block_m, fp), amp[rows].view(1, block_m),
        (rows < true_m).view(1, block_m), kp, keys=True)
    written = key >= 0 if ekey is None else slice(None)
    entries[rows[written]] = ent[written]
    ecnt[rows[written]] = cnt[written]
    if ekey is not None:
        ekey[rows] = key
    slot = int(tree_slots(mp // block_m)[t])
    idx[:, slot] = torch.where(col[:, 0] >= 0, col[:, 0] + t * block_m, -1)


def update_entries(xp: torch.Tensor, amp: torch.Tensor, kp: int, *,
                   true_m: int, block_m: int,
                   gate: Optional[torch.Tensor] = None,
                   tile: Optional[torch.Tensor] = None,
                   out: Optional[tuple] = None,
                   ekey: Optional[torch.Tensor] = None) -> tuple:
    """The per-tile pass of :func:`compact_update` on padded X (Mp, Fp; f32,
    bf16 or fp16) and the padded assignment ``amp`` (Mp,) int32. Returns
    (entries (Mp, Fp), ecnt (Mp,), idx (Kp, 2**L)); rows >= ``true_m``
    enter nothing. With ``gate`` (0-d int32) it writes only when
    ``gate > 0`` (idx is -1 throughout otherwise).

    ``out`` (entries, ecnt, idx) takes the result in place (buffers at
    least that large: the one-pass FT step's have a spare row). ``ekey``
    (keyed, as ``lloyd_step_ft`` writes its entries): each written row's
    cluster, and a tile's rows past its last entry zeroed with key -1.
    ``tile`` (0-d int32, with ``out``): only that row tile, its idx column
    cleared first -- the FT recompute of a tile whose update checksums
    mismatched. Tile and gate stay on the device: nothing waits on the
    host."""
    mp, fp = xp.shape
    if mp % block_m or amp.shape != (mp,):
        raise ValueError(f"xp {tuple(xp.shape)} and amp {tuple(amp.shape)} "
                         f"are not padded to row tiles of {block_m}")
    if tile is not None and out is None:
        raise ValueError("update_entries of one tile writes into out")
    nt = mp // block_m
    tensors = [t for t in (xp, amp, gate, tile, ekey) if t is not None]
    if _build.on_cpu(*tensors, *(out or ())):
        closed = gate is not None and int(gate) <= 0
        if tile is not None:
            if not closed:
                _entries_tile_plain(xp, amp, kp, true_m, block_m, tile, out,
                                    ekey)
            return out
        rows = torch.arange(mp).view(nt, block_m)
        new = update_entries_plain(
            xp.view(nt, block_m, fp), amp.view(nt, block_m), rows < true_m,
            kp, keys=True)
        if out is None:
            if closed:
                new[0].zero_()
                new[1].zero_()
                new[2].fill_(-1)
            return new[:3]
        if not closed:
            for dst, src in zip(out, new[:3]):
                dst[:src.shape[0]] = src
            if ekey is not None:
                ekey[:mp] = new[3]
        return out
    i32, f32 = torch.int32, torch.float32
    dt = _build.input_dtype(xp)
    if out is None:
        out = (torch.empty((mp, fp), dtype=f32, device=xp.device),
               torch.empty(mp, dtype=f32, device=xp.device),
               torch.full((kp, 1 << tree_levels(nt)), -1, dtype=i32,
                          device=xp.device))
    entries, ecnt, idx = out
    if (entries.shape[0] < mp or entries.shape[1] != fp
            or ecnt.shape[0] < mp or idx.shape != (kp, 1 << tree_levels(nt))
            or (ekey is not None and ekey.shape[0] < mp)):
        raise ValueError(f"update_entries' buffers "
                         f"{[tuple(t.shape) for t in out]} do not fit Mp "
                         f"{mp}, Fp {fp}, Kp {kp}")
    code = _build.library("fk_update").lib.fk_update_entries(
        _build.ptr(xp, dt, "xp"), _build.ptr(amp, i32, "amp"),
        None if tile is None else _build.ptr(tile, i32, "tile"),
        None if gate is None else _build.ptr(gate, i32, "gate"),
        _build.ptr(entries, f32, "entries"), _build.ptr(ecnt, f32, "ecnt"),
        _build.ptr(idx, i32, "idx"),
        None if ekey is None else _build.ptr(ekey, i32, "ekey"), true_m, kp,
        fp, block_m, nt, DTYPE_CODES[dt], _build.stream_of(xp))
    _build.check(code, "update_entries", "fk_update")
    update_entries.launches += 1
    return out


update_entries.launches = 0


def tree_reduce_plain(vals: torch.Tensor, idx: Optional[torch.Tensor],
                      out: torch.Tensor, out_idx: Optional[torch.Tensor], *,
                      rows: int, slots: int, ntiles: int, rstride: int,
                      tstride: int, width: int, chunk_log2: int) -> None:
    """Plain version of one :func:`tree_reduce` pass, in place: the leaves
    its kernel reads (the same addressing) reduced per chunk of 2**c slots
    by :func:`pair_tree_plain`."""
    flat = vals.reshape(-1)
    feat = torch.arange(width, device=vals.device)
    if idx is None:
        tile = torch.full((slots,), -1, dtype=torch.long, device=vals.device)
        tile[tree_slots(ntiles, vals.device)] = torch.arange(
            ntiles, device=vals.device)
        r, slot = torch.nonzero((tile >= 0)[None, :].expand(rows, slots),
                                as_tuple=True)
        off = r * rstride + tile[slot] * tstride
    else:
        r, slot = torch.nonzero(idx.view(rows, slots) >= 0, as_tuple=True)
        off = idx.view(rows, slots)[r, slot].long() * width
    leaves = flat[off[:, None] + feat[None, :]]
    nchunks = -(-slots >> chunk_log2)
    group = r * nchunks + (slot >> chunk_log2)
    node = pair_tree_plain(leaves, slot & ((1 << chunk_log2) - 1), group,
                           chunk_log2, rows * nchunks)
    out.view(rows * nchunks, width).copy_(node)
    if out_idx is not None:
        present = torch.zeros(rows * nchunks, dtype=torch.bool,
                              device=vals.device)
        present[group] = True
        out_idx.view(-1).copy_(torch.where(
            present, torch.arange(rows * nchunks, device=vals.device), -1))


def tree_reduce(vals: torch.Tensor, idx: Optional[torch.Tensor],
                out: torch.Tensor, out_idx: Optional[torch.Tensor], *,
                rows: int, slots: int, ntiles: int, rstride: int,
                tstride: int, width: int, chunk_log2: int, vec: int,
                gate: Optional[torch.Tensor] = None) -> None:
    """One pass of the tree sum: for each of ``rows`` rows and each chunk of
    2**``chunk_log2`` slots, the chunk's node into ``out`` (rows, nchunks,
    width) f32 and, where given, its row or -1 into ``out_idx`` (rows,
    nchunks) int32. Leaves: ``idx`` None, the dense halving tree over
    ``ntiles`` tiles at ``vals[r * rstride + t * tstride + e]``; else
    ``vals[idx[r, slot] * width + e]`` where ``idx`` (rows, slots) >= 0.
    ``vec`` 4 moves four floats a thread (width, strides and pointers
    multiples of four floats). With ``gate`` it writes only when
    ``gate > 0``."""
    tensors = [t for t in (vals, idx, out, out_idx, gate) if t is not None]
    if _build.on_cpu(*tensors):
        if gate is None or int(gate) > 0:
            tree_reduce_plain(vals, idx, out, out_idx, rows=rows,
                              slots=slots, ntiles=ntiles, rstride=rstride,
                              tstride=tstride, width=width,
                              chunk_log2=chunk_log2)
        return
    i32, f32 = torch.int32, torch.float32
    threads = min(TREE_THREADS, 32 * -(-width // (32 * vec)))
    code = _build.library("fk_update").lib.fk_tree_reduce(
        _build.ptr(vals, f32, "vals"),
        None if idx is None else _build.ptr(idx, i32, "idx"),
        None if gate is None else _build.ptr(gate, i32, "gate"),
        _build.ptr(out, f32, "out"),
        None if out_idx is None else _build.ptr(out_idx, i32, "out_idx"),
        rows, slots, ntiles, rstride, tstride, width, threads, vec,
        chunk_log2, _build.stream_of(vals))
    _build.check(code, "tree_reduce", "fk_update")
    tree_reduce.launches += 1
    tree_reduce.kernel_launches["dense" if idx is None else "sparse"] += 1


tree_reduce.launches = 0
tree_reduce.kernel_launches = dict.fromkeys(("sparse", "dense"), 0)


def _chunk_log2(slots: int, blocks: int, threads: int) -> int:
    """Chunk of a pass: the whole rest of the tree while it fits a chunk,
    split finer (down to 2**MIN_CHUNK_LOG2 slots) while fewer blocks than
    two waves of full SMs would run."""
    target = 2 * hw.SMS * 2048 // threads
    c = min(MAX_CHUNK_LOG2, tree_levels(slots))
    while c > MIN_CHUNK_LOG2 and blocks * (slots >> c) < target:
        c -= 1
    return c


def tree_passes(vals: torch.Tensor, idx: Optional[torch.Tensor],
                out: torch.Tensor, *, rows: int, ntiles: int, width: int,
                rstride: int = 0, tstride: int = 0,
                gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The halving tree over ``ntiles`` leaves for each of ``rows`` rows of
    ``width`` floats into ``out`` (rows * width floats, contiguous), by
    :func:`tree_reduce` passes: the first over the leaves (dense when
    ``idx`` is None, at the given strides; else ``idx`` (rows,
    2**L)), each next one over the chunks' nodes, until one chunk is
    left. Returns ``out``."""
    slots = 1 << tree_levels(ntiles)
    vec = 4 if (width % 4 == 0 and rstride % 4 == 0 and tstride % 4 == 0
                and vals.data_ptr() % 16 == 0
                and out.data_ptr() % 16 == 0) else 1
    threads = min(TREE_THREADS, 32 * -(-width // (32 * vec)))
    blocks = rows * -(-width // (threads * vec))
    f32 = dict(dtype=torch.float32, device=vals.device)
    while True:
        c = _chunk_log2(slots, blocks, threads)
        nchunks = slots >> c
        last = nchunks == 1
        dst = out if last else torch.empty((rows, nchunks, width), **f32)
        dst_idx = None if last else torch.empty(
            (rows, nchunks), dtype=torch.int32, device=vals.device)
        tree_reduce(vals, idx, dst, dst_idx, rows=rows, slots=slots,
                    ntiles=ntiles, rstride=rstride, tstride=tstride,
                    width=width, chunk_log2=c, vec=vec, gate=gate)
        if last:
            return out
        vals, idx, slots = dst, dst_idx, nchunks


def reduce_entries(entries: torch.Tensor, ecnt: torch.Tensor,
                   idx: torch.Tensor, *, ntiles: int,
                   out: Optional[tuple] = None,
                   gate: Optional[torch.Tensor] = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sums (Kp, Fp), counts (Kp,)) f32: the halving tree over ``ntiles``
    row tiles of the entries (:func:`tree_passes` over the sums and over the
    counts, leaves through ``idx`` (Kp, 2**L)), bit for bit
    ``tree_sum_plain`` over the dense per-tile blocks they hold. ``out`` and
    ``gate`` as :func:`compact_update`."""
    kp, fp = idx.shape[0], entries.shape[1]
    if out is None:
        f32 = dict(dtype=torch.float32, device=entries.device)
        out = (torch.empty((kp, fp), **f32), torch.empty(kp, **f32))
    tree_passes(entries, idx, out[0], rows=kp, ntiles=ntiles, width=fp,
                gate=gate)
    tree_passes(ecnt, idx, out[1], rows=kp, ntiles=ntiles, width=1,
                gate=gate)
    return out


def compact_update(xp: torch.Tensor, amp: torch.Tensor, kp: int, *,
                   true_m: int, block_m: int, out: Optional[tuple] = None,
                   gate: Optional[torch.Tensor] = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster (sums (Kp, Fp), counts (Kp,)) f32 of padded X (Mp, Fp)
    under the padded assignment ``amp`` (Mp,) int32, rows >= ``true_m``
    left out, bit for bit ``tree_sum_plain`` over the dense per-tile
    partials (:func:`update_entries`, then :func:`reduce_entries`). ``out``
    takes the result in place; with ``gate`` (0-d int32) it is written only
    when ``gate > 0``, so a recompute on a DMR mismatch never
    synchronises."""
    entries, ecnt, idx = update_entries(xp, amp, kp, true_m=true_m,
                                        block_m=block_m, gate=gate)
    return reduce_entries(entries, ecnt, idx, ntiles=xp.shape[0] // block_m,
                          out=out, gate=gate)


def tree_sum(a: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """:func:`tree_sum_plain` over axis ``dim`` (0, or 1 for a stack of
    problems' partials (P, T, ...)). On the card one :func:`tree_passes`
    with the tile stride and the problem stride, so a stack needs no
    ``movedim`` copy; on the CPU :func:`tree_sum_plain`."""
    if dim not in (0, 1) or a.dim() <= dim:
        raise ValueError(f"tree_sum over axis {dim} of a {a.dim()}-d tensor")
    if _build.on_cpu(a):
        return tree_sum_plain(a.movedim(dim, 0))
    if a.dtype != torch.float32 or not a.is_contiguous():
        raise ValueError(f"tree_sum takes a contiguous float32 tensor, got "
                         f"{a.dtype} (contiguous={a.is_contiguous()})")
    lead, nt, rest = a.shape[:dim], a.shape[dim], a.shape[dim + 1:]
    width = math.prod(rest)
    out = torch.empty(lead + rest, dtype=torch.float32, device=a.device)
    return tree_passes(a, None, out, rows=math.prod(lead), ntiles=nt,
                       width=width, rstride=nt * width, tstride=width)
