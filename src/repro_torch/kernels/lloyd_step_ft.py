"""Fault-tolerant one-pass Lloyd kernel (paper §IV Fig. 6 composed with
§III Fig. 4).

Replaces the Pallas TPU kernel ``lloyd_step_ft`` of
``src/repro/kernels/lloyd_step_ft.py`` (``_kernel``): ``distance_argmin_ft``
composed with ``lloyd_step``. The corrected distance accumulator feeds the
min/argmin and the update; beside each row tile's update the kernel emits
its expected e1/e2 checksums, from the assignment and X and never from the
sums they verify:

    e1^T (onehot^T X) = valid^T X
    e2^T (onehot^T X) = (valid * (argmin + 1))^T X

``ops.fused_lloyd_ft`` compares them with the observed checksums of the
update (:func:`verify_entries`, one launch; its rule
:func:`update_mismatch`) and recomputes the first mismatched tile.
The 12-word descriptor has two slots: the distance GEMM and the update
product.

CUDA kernels: ``lloyd_tile_kernel<BM, true, kEntryUpdate>`` (f32) and
``lloyd_tile_mma_kernel<T, BM, true, kEntryUpdate>`` (bf16, fp16) in
``csrc/fk_kernels.cu``, sharing the product with every instantiation of
its input dtype T, the ABFT with ``distance_argmin_ft`` (at 2 bytes on the
tensor cores, after ``distance_argmin_ft.encode_centroids``) and the entry
writer with ``lloyd_step`` and ``update.update_entries``
(``csrc/fk_entries.cuh``), so it is bit for bit the unprotected kernels of
its dtype plus the checksums. Its update is keyed entries: the layout of
``update.update_entries`` plus each entry row's cluster (``ekey``; a
tile's rows past its last entry are zeros with key -1) and one spare row
past the tiles' (row Mp). The update checksums come from the rows the
entry writer loads (no further pass over X). The update-slot fault lands on
the entry of its (tile, cluster) pair, or, where the tile holds no row of
that cluster, on the spare row -- the dense block's zero row plus delta,
with ``idx`` pointing at it and ``spare`` = (tile, cluster) -- so the
verification and the tree see what the reference's dense block would hold
(:func:`lloyd_step_ft_plain` keeps that dense specification). Bound on the
H100: as ``lloyd_step``, plus the (Mp/bm, 2, Fp) expected-checksum output.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import update as _up
from repro_torch.kernels.distance_argmin import check_padded
from repro_torch.kernels.distance_argmin_ft import (abft_correct_plain,
                                                    f32_bits, ft_scratch)
from repro_torch.kernels.update import tile_update_plain

#   distance slot: [0] enabled, [1] m_tile, [2] c_tile, [3] f_tile,
#                  [4] row_in_tile, [5] col_in_tile, [6] delta (f32 bits)
#   update slot:   [7] enabled, [8] m_tile, [9] cluster_row,
#                  [10] feature_col, [11] delta (f32 bits)
INJ_LEN = 12


def no_injection() -> torch.Tensor:
    return torch.zeros(INJ_LEN, dtype=torch.int32)


def make_injection(*, distance: Optional[tuple] = None,
                   update: Optional[tuple] = None) -> torch.Tensor:
    """Build a descriptor with either or both slots armed.

    distance = (m_tile, c_tile, f_tile, row_in_tile, col_in_tile, delta)
    update   = (m_tile, cluster_row, feature_col, delta), coordinates in the
               padded (Kp, Fp) partial-sum block of that row tile.
    """
    desc = [0] * INJ_LEN
    if distance is not None:
        mt, ct, ft, row, col, delta = distance
        desc[0:7] = [1, mt, ct, ft, row, col, f32_bits(delta)]
    if update is not None:
        mt, row, col, delta = update
        desc[7:12] = [1, mt, row, col, f32_bits(delta)]
    return torch.tensor(desc, dtype=torch.int32)


def lloyd_step_ft_plain(x, c, cn, inj, true_m, block_m, block_k, block_f,
                        factor):
    """Plain PyTorch version: (min, argmin, det, sums, counts, ucheck,
    ccheck), the kernel's shapes, every product in f32 on the widened
    values."""
    ref.full_f32(x.device)
    acc, det = abft_correct_plain(x.float() @ c.float().T, x, c, inj,
                                  block_m, block_k, block_f, factor)
    mind, am = ref.first_min(cn[None, :] - 2.0 * acc)
    mp, fp = x.shape
    kp = c.shape[0]
    nt = mp // block_m
    rows = torch.arange(mp, device=x.device).view(nt, block_m)
    valid = rows < true_m
    xt = x.float().view(nt, block_m, fp)
    sums, counts = tile_update_plain(xt, am.view(nt, block_m), valid, kp)
    vf = valid.float()
    enc = torch.stack([vf, vf * (am.view(nt, block_m) + 1).float()], -1)
    ucheck = torch.bmm(enc.transpose(1, 2), xt)                 # (nt, 2, fp)
    ccheck = enc.sum(1)                                         # (nt, 2)
    # simulated SEU in the update product, after the invariant side
    hit = ((inj[7] > 0) & (inj[8] >= 0) & (inj[8] < nt) & (inj[9] >= 0)
           & (inj[9] < kp) & (inj[10] >= 0) & (inj[10] < fp))
    flat = ((inj[8] * kp + inj[9]) * fp + inj[10]).clamp(0, sums.numel() - 1)
    sums.view(-1).index_put_(
        (flat.long().view(1),),
        torch.where(hit, inj[11:12].view(torch.float32), 0.0),
        accumulate=True)
    return mind, am, det, sums, counts, ucheck, ccheck


def update_mismatch(obs: tuple, ucheck: torch.Tensor, ccheck: torch.Tensor,
                    factor: float) -> torch.Tensor:
    """The update verification's rule, per row tile: observed (e1, e2)
    checksums of the sums (T, Fp) and of the counts (T,) against the
    expected ``ucheck`` (T, 2, Fp) and ``ccheck`` (T, 2); each e1 / e2 pair
    thresholds against its own clean side, factor x max(max |expected|, 1)
    (``factor`` = threshold_factor(bm, dtype): the contraction is the row
    tile). Returns bad (T,) bool."""
    obs1, obs2, cobs1, cobs2 = obs
    one = torch.ones((), device=ucheck.device)
    scale1 = torch.maximum(ucheck[:, 0].abs().amax(1), one)
    scale2 = torch.maximum(ucheck[:, 1].abs().amax(1), one)
    return (((obs1 - ucheck[:, 0]).abs().amax(1) > factor * scale1)
            | ((obs2 - ucheck[:, 1]).abs().amax(1) > factor * scale2)
            | ((cobs1 - ccheck[:, 0]).abs()
               > factor * torch.maximum(ccheck[:, 0].abs(), one))
            | ((cobs2 - ccheck[:, 1]).abs()
               > factor * torch.maximum(ccheck[:, 1].abs(), one)))


def dense_observed(sums_p: torch.Tensor, counts_p: torch.Tensor) -> tuple:
    """Observed update checksums of dense per-tile blocks (T, Kp, Fp) and
    (T, Kp): (e1, e2) over the clusters of the sums, then of the counts."""
    ref.full_f32(sums_p.device)
    w_k = torch.arange(1, sums_p.shape[1] + 1, dtype=torch.float32,
                       device=sums_p.device)
    return (sums_p.sum(1), torch.matmul(w_k, sums_p), counts_p.sum(1),
            (w_k * counts_p).sum(1))


def entries_observed(entries: torch.Tensor, ecnt: torch.Tensor,
                     ekey: torch.Tensor, spare: torch.Tensor,
                     block_m: int) -> tuple:
    """Observed update checksums of keyed entries (as :func:`lloyd_step_ft`
    writes them): per row tile, (e1, e2) over its entry rows -- e2 weighs a
    row by its cluster + 1 (a key of -1, a zeroed row, weighs 0) -- plus the
    spare row for its tile, then the same over the counts. One read of the
    (Mp, Fp) entries, no host synchronisation."""
    ref.full_f32(entries.device)
    mp = ekey.shape[0] - 1
    nt, fp = mp // block_m, entries.shape[1]
    key1 = (ekey[:mp] + 1).float().view(nt, block_m)
    # (e1, e2) weights of every row of a tile: one product reads the
    # entries once (the rows past a tile's last entry are zeros)
    w = torch.stack((torch.ones_like(key1), key1), 1)      # (T, 2, bm)
    obs = torch.bmm(w, entries[:mp].view(nt, block_m, fp))  # (T, 2, Fp)
    obs1, obs2 = obs[:, 0], obs[:, 1]
    cnt = ecnt[:mp].view(nt, block_m)
    cobs1, cobs2 = cnt.sum(1), (key1 * cnt).sum(1)
    # the spare row (count 0) belongs to tile spare[0], when it is used
    at = spare[0].clamp(min=0).long().view(1)
    row = torch.where(spare[0] >= 0, entries[mp], 0.0)
    obs1.index_add_(0, at, row[None])
    obs2.index_add_(0, at, (row * (spare[1] + 1).float())[None])
    return obs1, obs2, cobs1, cobs2


def verify_entries_plain(entries, ecnt, ekey, spare, ucheck, ccheck, *,
                         block_m: int, factor: float) -> tuple:
    """Plain version of :func:`verify_entries`: :func:`update_mismatch` on
    :func:`entries_observed`. Returns (mismatched tiles (0-d int32), the
    first of them (0-d int32; any tile when there is none))."""
    bad = update_mismatch(entries_observed(entries, ecnt, ekey, spare,
                                           block_m), ucheck, ccheck, factor)
    return bad.sum().to(torch.int32), bad.to(torch.int32).argmax().to(
        torch.int32)


def verify_entries(entries: torch.Tensor, ecnt: torch.Tensor,
                   ekey: torch.Tensor, spare: torch.Tensor,
                   ucheck: torch.Tensor, ccheck: torch.Tensor, *,
                   block_m: int, factor: float) -> tuple:
    """The update verification of :func:`lloyd_step_ft`'s keyed entries in
    one launch (``verify_entries_kernel<BM>``, ``csrc/fk_update.cu``): per
    row tile, the observed e1 / e2 checksums of its entry rows (and of the
    spare row, for the tile that holds it) and of its counts, held to the
    expected ``ucheck`` / ``ccheck`` under :func:`update_mismatch`'s rule
    (``factor`` = threshold_factor(bm, dtype)). Both results stay on the
    device. Returns (mismatched tiles (0-d int32), the first of them (0-d
    int32; T when there is none))."""
    if _build.on_cpu(entries, ecnt, ekey, spare, ucheck, ccheck):
        return verify_entries_plain(entries, ecnt, ekey, spare, ucheck,
                                    ccheck, block_m=block_m, factor=factor)
    i32, f32 = torch.int32, torch.float32
    nt, _, fp = ucheck.shape
    verdict = torch.zeros(2, dtype=i32, device=entries.device)
    code = _build.library("fk_update").lib.fk_verify_entries(
        _build.ptr(entries, f32, "entries"), _build.ptr(ecnt, f32, "ecnt"),
        _build.ptr(ekey, i32, "ekey"), _build.ptr(spare, i32, "spare"),
        _build.ptr(ucheck, f32, "ucheck"), _build.ptr(ccheck, f32, "ccheck"),
        verdict.data_ptr(), block_m, nt, fp, factor,
        _build.stream_of(entries))
    _build.check(code, "verify_entries", "fk_update")
    verify_entries.launches += 1
    return verdict[0], nt - verdict[1]


verify_entries.launches = 0


def inject_entries_plain(entries: torch.Tensor, ekey: torch.Tensor,
                         idx: torch.Tensor, spare: torch.Tensor,
                         inj: torch.Tensor, block_m: int) -> None:
    """The kernel's update-slot fault on keyed entries, in place: add delta
    to the entry of (tile inj[8], cluster inj[9]) at feature inj[10]; where
    the tile has no such entry, write the spare row (zeros, 0.0 + delta at
    the feature), point idx at it and record (tile, cluster) in spare. A
    descriptor off the (T, Kp, Fp) grid does nothing."""
    mp = ekey.shape[0] - 1
    nt, kp, fp = mp // block_m, idx.shape[0], entries.shape[1]
    mt, k, f = int(inj[8]), int(inj[9]), int(inj[10])
    if not (int(inj[7]) > 0 and 0 <= mt < nt and 0 <= k < kp
            and 0 <= f < fp):
        return
    delta = inj[11:12].view(torch.float32).to(entries.device)
    keys = ekey[mt * block_m:(mt + 1) * block_m]
    hit = (keys == k).nonzero()
    if hit.numel():
        entries[mt * block_m + int(hit[0, 0]), f] += delta[0]
        return
    entries[mp] = 0.0
    entries[mp, f] = 0.0 + delta[0]
    ekey[mp] = k
    spare[0], spare[1] = mt, k
    idx[k, int(_up.tree_slots(nt)[mt])] = mp


def lloyd_step_ft_entries_plain(x, c, cn, inj, true_m, block_m, block_k,
                                block_f, factor):
    """The kernel's outputs from the plain version: the clean dense
    specification (:func:`lloyd_step_ft_plain`, update slot disarmed) in the
    keyed entries layout with the spare row, then the update-slot fault
    placed as the kernel places it (:func:`inject_entries_plain`)."""
    clean = inj.clone()
    clean[7] = 0
    mind, am, det, sums_p, counts_p, ucheck, ccheck = lloyd_step_ft_plain(
        x, c, cn, clean, true_m, block_m, block_k, block_f, factor)
    entries, ecnt, idx, ekey = _up.dense_to_entries(sums_p, counts_p,
                                                    block_m, keys=True)
    entries = torch.cat([entries, entries.new_zeros(1, entries.shape[1])])
    ecnt = torch.cat([ecnt, ecnt.new_zeros(1)])
    ekey = torch.cat([ekey, ekey.new_full((1,), -1)])
    spare = torch.full((2,), -1, dtype=torch.int32, device=x.device)
    inject_entries_plain(entries, ekey, idx, spare, inj, block_m)
    return mind, am, det, entries, ecnt, idx, ekey, spare, ucheck, ccheck


def lloyd_step_ft(x: torch.Tensor, c: torch.Tensor, cn: torch.Tensor,
                  inj: torch.Tensor, true_m: int, *, block_m: int,
                  block_k: int, block_f: int, factor: float):
    """Raw one-pass FT kernel entry on pre-padded inputs (X and C f32, bf16
    or fp16). Returns (min (Mp,), argmin (Mp,), det (T,), entries (Mp + 1,
    Fp), ecnt (Mp + 1,), idx (Kp, 2**L), ekey (Mp + 1,), spare (2,), ucheck
    (T, 2, Fp), ccheck (T, 2)) with T = Mp / block_m: the keyed entries and
    their spare row (module docstring), all f32 but argmin, det, idx, ekey
    and spare. On the CPU: :func:`lloyd_step_ft_entries_plain`."""
    check_padded(x, c, cn, block_m, block_k, block_f)
    dt = _build.input_dtype(x, c)
    if inj.shape[0] != INJ_LEN:
        raise ValueError(f"lloyd_step_ft takes a {INJ_LEN}-word descriptor, "
                         f"got {tuple(inj.shape)}")
    if _build.on_cpu(x, c, cn, inj):
        return lloyd_step_ft_entries_plain(x, c, cn, inj, true_m, block_m,
                                           block_k, block_f, factor)
    mp, fp = x.shape
    kp = c.shape[0]
    nt = mp // block_m
    dev = x.device
    f32, i32 = torch.float32, torch.int32
    mind = torch.empty(mp, dtype=f32, device=dev)
    am = torch.empty(mp, dtype=i32, device=dev)
    det = torch.empty(nt, dtype=i32, device=dev)
    entries = torch.empty((mp + 1, fp), dtype=f32, device=dev)
    ecnt = torch.empty(mp + 1, dtype=f32, device=dev)
    idx = torch.full((kp, 1 << _up.tree_levels(nt)), -1, dtype=i32,
                     device=dev)
    ekey = torch.empty(mp + 1, dtype=i32, device=dev)
    spare = torch.full((2,), -1, dtype=i32, device=dev)
    ucheck = torch.empty((nt, 2, fp), dtype=f32, device=dev)
    ccheck = torch.empty((nt, 2), dtype=f32, device=dev)
    c_op, cenc = ft_scratch(x, c)
    code = _build.launch(
        "fk_lloyd_step_ft", dt, _build.ptr(x, dt, "x", vec16=True),
        _build.ptr(c_op, dt, "c", vec16=True),
        _build.ptr(cn, f32, "cn", vec16=True),
        _build.ptr(cenc, cenc.dtype, "cenc"),
        _build.ptr(inj, i32, "inj"), mind.data_ptr(), am.data_ptr(),
        det.data_ptr(), entries.data_ptr(), ecnt.data_ptr(), idx.data_ptr(),
        ekey.data_ptr(), spare.data_ptr(), ucheck.data_ptr(),
        ccheck.data_ptr(), factor, true_m, mp, kp, fp, block_m, block_f,
        _build.stream_of(x))
    _build.check(code, "lloyd_step_ft")
    lloyd_step_ft.launches += 1
    return mind, am, det, entries, ecnt, idx, ekey, spare, ucheck, ccheck


lloyd_step_ft.launches = 0


def lloyd_ft_dense_plain(x, c, cn, inj, true_m, block_m, block_k, block_f,
                         factor, update_factor):
    """The dense route of ``ops.fused_lloyd_ft``, its specification, in
    plain PyTorch on any device: :func:`lloyd_step_ft_plain` (the fault in
    the dense block), :func:`update_mismatch` on the dense blocks, the
    first mismatched tile recomputed, the halving tree
    (``update.tree_sum_plain``). Returns (min, argmin, detected (0-d int32:
    distance corrections plus mismatched update tiles), sums (Kp, Fp),
    counts (Kp,))."""
    mind, am, det, sums_p, counts_p, ucheck, ccheck = lloyd_step_ft_plain(
        x, c, cn, inj, true_m, block_m, block_k, block_f, factor)
    bad = update_mismatch(dense_observed(sums_p, counts_p), ucheck, ccheck,
                          update_factor)
    if bool(bad.any()):
        t = int(bad.int().argmax())
        rows = torch.arange(t * block_m, (t + 1) * block_m, device=x.device)
        s_t, c_t = tile_update_plain(
            x[rows].view(1, block_m, -1), am[rows].view(1, block_m),
            (rows < true_m).view(1, block_m), c.shape[0])
        sums_p[t], counts_p[t] = s_t[0], c_t[0]
    return (mind, am, (det.sum() + bad.sum()).to(torch.int32),
            _up.tree_sum_plain(sums_p), _up.tree_sum_plain(counts_p))
