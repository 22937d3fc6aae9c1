"""Padding and planning layer around the CUDA kernels (counterpart of the
main-path part of ``repro.kernels.ops``).

Pads inputs to the kernel tile grid (masked so results are exact), builds
the per-fit :class:`DataPlan` (one problem), :class:`QuantPlan` (one problem,
quantised to int8) or :class:`BatchPlan` (B stacked problems), reduces
per-row-tile partial sums (``update.tree_sum``) or the one-pass kernels'
entries (``update.reduce_entries``), runs the two-pass update
(``update.compact_update`` on the card), verifies the one-pass FT kernel's
update checksums over its entries, carries the pruned step's
:class:`BoundsState` and plans injection descriptors.

The int8 path differs from the reference in one place. Its
:class:`QuantPlan` also holds the padded f32 :class:`DataPlan` of the same
rows, so the two-pass update of an int8 fit runs :func:`tiled_update` as a
``fused`` fit's does: one int8 step on
quantisation-safe X and centroids is then bit for bit one ``fused`` step
(labels, min distances, sums, counts). The reference's update is plain XLA
outside any kernel, so nothing compared across the packages changes.
A tensor on the CPU runs every kernel's plain version; a CUDA tensor runs
the kernels. Tiles come from explicit :class:`KernelParams` or the port's
H100 defaults (``repro_torch.hw``); an autotuned table is later work.

Compute dtypes: every tile entry (:func:`fused_assign`,
:func:`fused_lloyd`, :func:`fused_assign_ft`, :func:`fused_lloyd_ft`,
:func:`tiled_update`, :func:`fused_lloyd_batched`,
:func:`fused_lloyd_pruned`) and :func:`abft_matmul` take X in f32, bf16 or
fp16, as the reference's templates do: the plan keeps X in its dtype, the
centroids are cast to it, and norms, distances, sums, checksums and the
ABFT GEMM's D stay f32. The int8 entry quantises f32 rows (a raw 2-byte X
is widened first, as the reference's plan does).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import hw
from repro_torch.core import dmr as dmr_mod
from repro_torch.core.checksum import threshold_factor
from repro_torch.dist.compression import quantize_rows
from repro_torch.kernels import _build
from repro_torch.kernels import distance_argmin as _da
from repro_torch.kernels import distance_argmin_ft as _daft
from repro_torch.kernels import distance_argmin_int8 as _dai
from repro_torch.kernels import lloyd_step as _ll
from repro_torch.kernels import lloyd_step_ft as _llft
from repro_torch.kernels import lloyd_step_pruned as _llp
from repro_torch.kernels import matmul_abft as _mma
from repro_torch.kernels import ref
from repro_torch.kernels import update as _up


@dataclasses.dataclass(frozen=True)
class KernelParams:
    """Verification tile of the kernels: ``block_m`` rows per thread block,
    ``block_k`` centroids per centroid tile, ``block_f`` features per
    feature tile (the unit an injection descriptor's ``f_tile`` counts).
    The same triple means the same tiling, and the same descriptor the same
    fault, as in the reference package."""

    block_m: int = hw.BLOCK_M
    block_k: int = hw.BLOCK_K
    block_f: int = hw.BLOCK_F


DEFAULT_PARAMS = KernelParams()


def check_cuda_params(params: KernelParams) -> None:
    """Raise for a tile the CUDA kernels are not built for."""
    if (params.block_m not in hw.SUPPORTED_BLOCK_M
            or params.block_k not in hw.SUPPORTED_BLOCK_K
            or params.block_f % hw.FEATURE_CHUNK):
        raise ValueError(
            f"{params} is not a tile of the CUDA kernels: block_m in "
            f"{hw.SUPPORTED_BLOCK_M}, block_k in {hw.SUPPORTED_BLOCK_K}, "
            f"block_f a multiple of {hw.FEATURE_CHUNK}")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class DataPlan:
    """Per-fit data plan: X padded to the tile grid and its f32 row squared
    norms, computed once and reused by every Lloyd iteration. X keeps its
    dtype, the fit's compute dtype (f32, bf16 or fp16).

    x      : (m, f)   the original samples (update pass / reseeding)
    xp     : (mp, fp) X padded to the tile grid (== x when params is None)
    xn     : (m,)     row squared norms of x as it is, summed in f32
    m, f   : true (unpadded) dimensions
    params : the KernelParams the padding was laid out for
    """

    x: torch.Tensor
    xp: torch.Tensor
    xn: torch.Tensor
    m: int
    f: int
    params: Optional[KernelParams]


def plan_data(x: torch.Tensor,
              params: Optional[KernelParams] = None) -> DataPlan:
    """Build the per-fit :class:`DataPlan` (pad + row norms, once)."""
    m, f = x.shape
    xn = (x.float() ** 2).sum(1)
    if params is None:
        return DataPlan(x=x, xp=x, xn=xn, m=m, f=f, params=None)
    mp = _round_up(m, params.block_m)
    fp = _round_up(f, params.block_f)
    xp = F.pad(x, (0, fp - f, 0, mp - m)).contiguous()
    return DataPlan(x=x, xp=xp, xn=xn, m=m, f=f, params=params)


@dataclasses.dataclass(frozen=True)
class QuantPlan:
    """Per-fit plan of the int8 kernel: X quantised per row
    (:func:`~repro_torch.dist.compression.quantize_rows`) and padded to the
    tile grid, once per fit, beside the padded f32 :class:`DataPlan` of the
    same rows (the update pass, reseeding and the exact row norms).

    data : the f32 DataPlan (x, xp, xn, m, f, params)
    xq   : (mp, fp) int8 quantised X, zero padded
    sx   : (mp,)    f32 per-row scales (1.0 in padded rows)
    """

    data: DataPlan
    xq: torch.Tensor
    sx: torch.Tensor


def f32_plan(x):
    """The f32 side of a plan: a :class:`QuantPlan`'s :class:`DataPlan`;
    a :class:`DataPlan` or a raw tensor as given."""
    return x.data if isinstance(x, QuantPlan) else x


def plan_data_int8(x: torch.Tensor, params: KernelParams) -> QuantPlan:
    """Build the per-fit :class:`QuantPlan` (quantise + pad + norms, once)."""
    data = plan_data(x, params)
    q, sx = quantize_rows(x)
    mp, fp = data.xp.shape
    xq = F.pad(q, (0, fp - data.f, 0, mp - data.m)).contiguous()
    sxp = F.pad(sx[:, 0], (0, mp - data.m), value=1.0).contiguous()
    return QuantPlan(data=data, xq=xq, sx=sxp)


def _pad_centroids(c: torch.Tensor, k: int, kp: int,
                   fp: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Pad centroids (..., K, F) to (..., kp, fp); padded slots get +inf
    squared norms (..., kp) so they never win the argmin. Leading axes
    are problems of a stack."""
    cpad = F.pad(c, (0, fp - c.shape[-1], 0, kp - c.shape[-2])).contiguous()
    cn = (cpad.float() ** 2).sum(-1)
    slot = torch.arange(kp, device=c.device)
    cn = torch.where(slot < k, cn, torch.inf).contiguous()
    return cpad, cn


def clamp_params(m: int, k: int, f: int,
                 params: KernelParams) -> KernelParams:
    """Shrink tiles that exceed the (padded) problem, keeping the port's
    alignments (rows 64, centroids 128, features 32)."""
    def shrink(block: int, dim: int, align: int) -> int:
        while block > align and block > _round_up(dim, align):
            block //= 2
        return max(block, align)
    return KernelParams(
        block_m=shrink(params.block_m, m, hw.ALIGN_M),
        block_k=shrink(params.block_k, k, hw.ALIGN_K),
        block_f=shrink(params.block_f, f, hw.ALIGN_F),
    )


def _resolve_padded(x, c: torch.Tensor,
                    params: Optional[KernelParams]) -> tuple:
    """Accept a raw X or a prebuilt :class:`DataPlan`; return (plan, padded
    centroids, masked centroid norms, params)."""
    k = c.shape[0]
    if isinstance(x, DataPlan):
        plan = x
        params = plan.params
        if params is None:
            raise ValueError("DataPlan was built without KernelParams; build "
                             "it with plan_data(x, params) before feeding a "
                             "kernel")
    else:
        params = clamp_params(x.shape[0], k, x.shape[1],
                              params or DEFAULT_PARAMS)
        plan = plan_data(x, params)
    _build.input_dtype(plan.xp)      # f32, bf16 or fp16, else it raises
    if plan.xp.is_cuda:
        check_cuda_params(params)
    # the kernels' product takes one input dtype: C is cast to X's, and its
    # norms are the f32 norms of the cast centroids (the reference's order)
    c = c.to(plan.xp.dtype)
    cp, cn = _pad_centroids(c, k, _round_up(k, params.block_k),
                            plan.xp.shape[1])
    return plan, cp, cn, params


def fused_assign(x, c: torch.Tensor, params: Optional[KernelParams] = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-centroid assignment via the fused kernel. ``x`` is a raw
    (M, F) tensor or a :class:`DataPlan`. Returns (assign (M,) int32,
    partial min distance (M,) f32); add ``sum(x**2, -1)`` for true
    squared distances."""
    if not isinstance(x, DataPlan) and x.shape[0] == 0:
        return (torch.zeros(0, dtype=torch.int32, device=x.device),
                torch.zeros(0, dtype=torch.float32, device=x.device))
    plan, cp, cn, params = _resolve_padded(x, c, params)
    mind, am = _da.distance_argmin(
        plan.xp, cp, cn, block_m=params.block_m, block_k=params.block_k,
        block_f=params.block_f)
    return am[:plan.m], mind[:plan.m]


def _resolve_padded_int8(x, c: torch.Tensor,
                         params: Optional[KernelParams]) -> tuple:
    """int8 front end: a raw X or a :class:`QuantPlan` -> (plan, quantised
    padded centroids (Kp, Fp) int8, their scales (Kp,) with 1.0 in padded
    slots, masked norms (Kp,) of the unquantised centroids, params).
    Centroids move every iteration, so unlike X they are quantised per
    call."""
    k = c.shape[0]
    if isinstance(x, QuantPlan):
        plan, params = x, x.data.params
    else:
        params = clamp_params(x.shape[0], k, x.shape[1],
                              params or DEFAULT_PARAMS)
        # int8 quantises f32 rows; a 2-byte X widens exactly
        plan = plan_data_int8(x.float(), params)
    if plan.xq.is_cuda:
        check_cuda_params(params)
    cf = c.float()
    kp, fp = _round_up(k, params.block_k), plan.xq.shape[1]
    _, cn = _pad_centroids(cf, k, kp, fp)
    cq, sc = quantize_rows(cf)
    cqp = F.pad(cq, (0, fp - cf.shape[1], 0, kp - k)).contiguous()
    scp = F.pad(sc[:, 0], (0, kp - k), value=1.0).contiguous()
    return plan, cqp, scp, cn, params


def fused_assign_int8(x, c: torch.Tensor,
                      params: Optional[KernelParams] = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-centroid assignment via the int8 kernel. ``x`` is a raw
    (M, F) tensor (quantised here) or a :class:`QuantPlan`; ``c`` the
    unquantised (K, F) centroids. Returns (assign (M,) int32, partial min
    distance (M,) f32). On quantisation-safe data it is bit for bit
    :func:`fused_assign`."""
    if not isinstance(x, QuantPlan) and x.shape[0] == 0:
        return (torch.zeros(0, dtype=torch.int32, device=x.device),
                torch.zeros(0, dtype=torch.float32, device=x.device))
    plan, cq, sc, cn, params = _resolve_padded_int8(x, c, params)
    mind, am = _dai.distance_argmin_int8(
        plan.xq, cq, plan.sx, sc, cn, block_m=params.block_m,
        block_k=params.block_k, block_f=params.block_f)
    return am[:plan.data.m], mind[:plan.data.m]


def _tree_sum(a: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Balanced pairwise reduction over axis ``dim`` (0, or 1 for a stack of
    problems) in a fixed tree, deterministic on every device: on the CPU
    the torch halving tree (``update.tree_sum_plain``), on the card the
    ``tree_reduce`` kernel, which reads each partial once and writes no
    level out (:func:`~repro_torch.kernels.update.tree_sum`)."""
    return _up.tree_sum(a, dim)


def tiled_update(plan: DataPlan, am: torch.Tensor, k: int, *,
                 use_dmr: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """The two-pass centroid update in the one-pass kernels' order: each
    row tile's per-cluster sums from 0 in row order, then the tiles in
    :func:`_tree_sum`'s tree. A ``fused`` fit therefore sums bit for bit as
    a ``lloyd`` fit does.

    On the card the compact route
    (:func:`~repro_torch.kernels.update.compact_update`): one entry per
    present (tile, cluster) pair and one tree kernel over them, the same
    bits as the dense partials' tree. On the CPU the dense route
    (:func:`lloyd_step.tile_update` over every tile, then the torch tree).

    ``use_dmr`` runs the update twice and compares the results (on the CPU
    the partial blocks); on a mismatch a third update writes over the first
    in place, gated on the device, so a clean step pays two updates and
    never waits on the host. Returns (sums (K, F), counts (K,))."""
    p = plan.params
    mp, fp = plan.xp.shape
    nt, kp = mp // p.block_m, _round_up(k, p.block_k)
    amp = F.pad(am.to(torch.int32), (0, mp - plan.m)).contiguous()
    if plan.xp.is_cuda:
        update = functools.partial(_up.compact_update, plan.xp, amp, kp,
                                   true_m=plan.m, block_m=p.block_m)
    else:
        def update(out=None, gate=None):
            if out is None:
                f32 = dict(dtype=torch.float32, device=plan.xp.device)
                out = (torch.empty((nt, kp, fp), **f32),
                       torch.empty((nt, kp), **f32))
            _ll.tile_update(plan.xp, amp, *out, true_m=plan.m,
                            block_m=p.block_m, gate=gate)
            return out
    out = update()
    if use_dmr:
        bad = dmr_mod.mismatch(out, update())
        update(out=out, gate=bad.to(torch.int32))
    sums, counts = out if plan.xp.is_cuda else map(_tree_sum, out)
    return sums[:k, :plan.f], counts[:k]


def fused_lloyd(x, c: torch.Tensor, params: Optional[KernelParams] = None):
    """One-pass Lloyd step: assignment plus the per-cluster sums/counts, X
    read once. The kernel emits its update as entries (one row per present
    (row tile, cluster) pair), summed by the tree kernel over them
    (``update.reduce_entries``): bit for bit the tree over the dense
    per-tile blocks, so a ``lloyd`` step sums as a ``fused`` one. Returns
    (assign (M,) int32, true squared distance (M,) f32, sums (K, F) f32,
    counts (K,) f32)."""
    plan, cp, cn, params = _resolve_padded(x, c, params)
    k, m = c.shape[0], plan.m
    mind, am, entries, ecnt, idx = _ll.lloyd_step(
        plan.xp, cp, cn, m, block_m=params.block_m, block_k=params.block_k,
        block_f=params.block_f)
    sums, counts = _up.reduce_entries(
        entries, ecnt, idx, ntiles=plan.xp.shape[0] // params.block_m)
    return am[:m], mind[:m] + plan.xn, sums[:k, :plan.f], counts[:k]


# Relative + absolute slack of the tile skip test: the bounds are f32 and
# come from rounded kernel outputs, so a wrong skip needs a bound error
# orders of magnitude above f32 rounding (the reference's value).
PRUNE_SLACK = 1e-3


@dataclasses.dataclass(frozen=True)
class BoundsState:
    """Hamerly bounds carried between pruned one-pass steps: device tensors
    in a frozen dataclass, built for one (params, k, f). Anything that moves
    centroids outside the step's own update (``partial_fit``,
    ``from_state``, a warm start) starts from :func:`init_bounds`, whose
    ``fresh`` flag makes the next step compute every tile.

    ub     : (m,)       f32 upper bound of each row's distance to its centroid
    assign : (m,)       int32 assignment the upper bounds pair with
    tmin   : (nmt, nkt) f32 per-(row tile, centroid tile) lower bound
    c_prev : (kp, fp)   f32 padded centroids the bounds were computed against
                        (the compute dtype's values, widened)
    fresh  : ()         bool, True = placeholder: skip nothing, seed bounds
    """

    ub: torch.Tensor
    assign: torch.Tensor
    tmin: torch.Tensor
    c_prev: torch.Tensor
    fresh: torch.Tensor


def init_bounds(m: int, k: int, f: int,
                params: Optional[KernelParams] = None, *,
                device: torch.device | str) -> BoundsState:
    """Fresh (all-invalid) :class:`BoundsState` shaped for the clamped tile
    grid of (m, k, f) on ``device`` (the data's), with ``fresh`` set so the
    first step computes every tile."""
    p = clamp_params(m, k, f, params or DEFAULT_PARAMS)
    mp, kp = _round_up(m, p.block_m), _round_up(k, p.block_k)
    fp = _round_up(f, p.block_f)
    return BoundsState(
        ub=torch.zeros(m, device=device),
        assign=torch.zeros(m, dtype=torch.int32, device=device),
        tmin=torch.zeros((mp // p.block_m, kp // p.block_k), device=device),
        c_prev=torch.zeros((kp, fp), device=device),
        fresh=torch.ones((), dtype=torch.bool, device=device))


def prune_mask(bounds: BoundsState, cp: torch.Tensor, m: int,
               params: KernelParams) -> tuple[torch.Tensor, torch.Tensor]:
    """The skip test of one step, on the device: decay each recorded tile
    bound by its centroid tile's largest drift (``tlb``) and skip a cell
    when ``tlb > maxub * (1 + slack) + slack``, ``maxub`` the row tile's
    largest upper bound grown by each row's own centroid drift. The tile
    that holds a row's centroid has ``tlb <= maxub``, so it is never
    skipped. One centroid tile, or a fresh state, skips nothing. Returns
    (skip (nmt, nkt) int32, tlb (nmt, nkt) f32)."""
    bm, bk = params.block_m, params.block_k
    nmt, nkt = bounds.tmin.shape
    # in f32 whatever the compute dtype (the reference's cpf)
    drift = ((cp.float() - bounds.c_prev) ** 2).sum(1).sqrt()     # (kp,)
    maxdrift = drift.view(nkt, bk).amax(1)                        # (nkt,)
    ub_adj = bounds.ub + drift[bounds.assign.long()]              # (m,)
    maxub = F.pad(ub_adj, (0, nmt * bm - m),
                  value=-torch.inf).view(nmt, bm).amax(1)         # (nmt,)
    tlb = bounds.tmin - maxdrift[None, :]
    if nkt == 1:
        return torch.zeros_like(tlb, dtype=torch.int32), tlb
    can_skip = tlb > maxub[:, None] * (1.0 + PRUNE_SLACK) + PRUNE_SLACK
    return torch.where(bounds.fresh, 0, can_skip.to(torch.int32)), tlb


def fused_lloyd_pruned(x, c: torch.Tensor,
                       params: Optional[KernelParams] = None, *,
                       bounds: Optional[BoundsState] = None):
    """One-pass Lloyd step with tile-granular triangle-inequality pruning:
    :func:`fused_lloyd` plus a carried :class:`BoundsState`. Skipping only
    omits folds that lose strictly, so assignments, distances, sums and
    counts are bit for bit :func:`fused_lloyd`'s at the same tiles; the
    kernel's update is its entries, summed as :func:`fused_lloyd` sums them
    (``update.reduce_entries``). ``bounds=None`` (or a fresh state)
    computes every tile and seeds the
    bounds. Nothing here reads the device. Returns (assign (M,) int32, true
    squared distance (M,), sums (K, F), counts (K,), new bounds, pruned
    tile fraction (0-d f32))."""
    plan, cp, cn, params = _resolve_padded(x, c, params)
    k, m = c.shape[0], plan.m
    mp = plan.xp.shape[0]
    if bounds is None:
        bounds = init_bounds(m, k, plan.f, params, device=plan.xp.device)
    skip, tlb = prune_mask(bounds, cp, m, params)
    xnp = F.pad(plan.xn, (0, mp - m)).contiguous()
    mind, am, entries, ecnt, idx, tmin_k = _llp.lloyd_step_pruned(
        plan.xp, cp, cn, xnp, skip.contiguous(), m, block_m=params.block_m,
        block_k=params.block_k, block_f=params.block_f)
    sums, counts = _up.reduce_entries(entries, ecnt, idx,
                                      ntiles=mp // params.block_m)
    md = mind[:m] + plan.xn
    new_bounds = BoundsState(
        ub=md.clamp_min(0.0).sqrt(), assign=am[:m],
        # skipped cells keep the decayed bound; computed cells refresh it
        tmin=torch.where(skip == 1, tlb, tmin_k), c_prev=cp.float(),
        fresh=torch.zeros((), dtype=torch.bool, device=cp.device))
    return (am[:m], md, sums[:k, :plan.f], counts[:k], new_bounds,
            skip.float().mean())


def _verify_update_entries(plan: DataPlan, am: torch.Tensor, out: list,
                           ucheck: torch.Tensor, ccheck: torch.Tensor,
                           params: KernelParams) -> torch.Tensor:
    """Verification interval of the one-pass update: each row tile's
    observed e1/e2 checksums of its keyed entries and counts against the
    expected ones the kernel emitted (``lloyd_step_ft.verify_entries``: one
    launch, one read of the entries; the rule
    ``lloyd_step_ft.update_mismatch``); the first
    mismatched tile is rewritten in place by the entry writer, its idx
    column restored (bit-identical to a clean one; a spare row it pointed
    at is dropped). Every mismatch is counted. Runs without a host
    synchronisation: the recompute is told on the device whether there is
    anything to do. ``am`` is the kernel's padded assignment. Returns the
    count (0-d int32)."""
    entries, ecnt, idx, ekey, spare = out
    bm = params.block_m
    n_bad, worst = _llft.verify_entries(
        entries, ecnt, ekey, spare, ucheck, ccheck, block_m=bm,
        factor=threshold_factor(bm, plan.xp.dtype))
    _up.update_entries(plan.xp, am, idx.shape[0], true_m=plan.m,
                       block_m=bm, tile=worst, gate=n_bad,
                       out=(entries, ecnt, idx), ekey=ekey)
    return n_bad


def fused_lloyd_ft(x, c: torch.Tensor,
                   params: Optional[KernelParams] = None, *,
                   inj: Optional[torch.Tensor] = None):
    """One-pass FT Lloyd step: ABFT around the distance GEMM plus the
    checksum-protected update, emitted as keyed entries and summed by the
    tree kernel over them. ``inj`` is a 12-word
    :func:`~repro_torch.kernels.lloyd_step_ft.make_injection` descriptor.
    Returns (assign (M,) int32, true squared distance (M,) f32, sums (K, F),
    counts (K,), detected (0-d int32): corrected distance errors plus
    recomputed update tiles)."""
    plan, cp, cn, params = _resolve_padded(x, c, params)
    if inj is None:
        inj = _llft.no_injection()
    inj = inj.to(plan.xp.device)
    k, m = c.shape[0], plan.m
    factor = threshold_factor(plan.xp.shape[1], plan.xp.dtype)
    mind, am, det, *out, ucheck, ccheck = _llft.lloyd_step_ft(
        plan.xp, cp, cn, inj, m, block_m=params.block_m,
        block_k=params.block_k, block_f=params.block_f, factor=factor)
    det_up = _verify_update_entries(plan, am, out, ucheck, ccheck, params)
    sums, counts = _up.reduce_entries(
        out[0], out[1], out[2], ntiles=plan.xp.shape[0] // params.block_m)
    return (am[:m], mind[:m] + plan.xn, sums[:k, :plan.f], counts[:k],
            det.sum().to(torch.int32) + det_up)


def fused_assign_ft(x, c: torch.Tensor,
                    params: Optional[KernelParams] = None, *,
                    inj: Optional[torch.Tensor] = None):
    """FT assignment: detect + locate + correct inside the kernel. Returns
    (assign, partial min distance, corrected error count (0-d int32))."""
    plan, cp, cn, params = _resolve_padded(x, c, params)
    if inj is None:
        inj = _daft.no_injection()
    inj = inj.to(plan.xp.device)
    factor = threshold_factor(plan.xp.shape[1], plan.xp.dtype)
    mind, am, det = _daft.distance_argmin_ft(
        plan.xp, cp, cn, inj, block_m=params.block_m,
        block_k=params.block_k, block_f=params.block_f, factor=factor)
    return am[:plan.m], mind[:plan.m], det.sum().to(torch.int32)


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    """Per-fit data plan for B stacked problems: the (B, N, F) block padded
    to the tile grid once, and its per-problem row squared norms.

    x      : (b, n, f)   the original stacked samples (reseeding donors)
    xp     : (b, np, fp) X padded to the tile grid
    xn     : (b, n)      per-problem row squared norms, f32
    n, f   : true (unpadded) dimensions of one problem
    params : the KernelParams the padding was laid out for
    """

    x: torch.Tensor
    xp: torch.Tensor
    xn: torch.Tensor
    n: int
    f: int
    params: KernelParams


def plan_data_batched(x: torch.Tensor, params: KernelParams) -> BatchPlan:
    """Build the per-fit :class:`BatchPlan`: one pad of the whole stack.
    Each problem's norms are :func:`plan_data`'s own op on its (n, f) slab,
    so a problem's true distances are bit for bit a single fit's."""
    _, n, f = x.shape
    xn = torch.stack([(xb.float() ** 2).sum(1) for xb in x])
    np_ = _round_up(n, params.block_m)
    fp = _round_up(f, params.block_f)
    xp = F.pad(x, (0, fp - f, 0, np_ - n)).contiguous()
    return BatchPlan(x=x, xp=xp, xn=xn, n=n, f=f, params=params)


def _resolve_padded_batched(x, c: torch.Tensor,
                            params: Optional[KernelParams]) -> tuple:
    """Batched front end: a raw (B, N, F) stack or a prebuilt
    :class:`BatchPlan` -> (plan, padded centroids (B, Kp, Fp), masked norms
    (B, Kp), params). Tiles come from ``params`` or the port's H100
    defaults, clamped to one problem's shape."""
    k = c.shape[1]
    if isinstance(x, BatchPlan):
        plan, params = x, x.params
    else:
        params = clamp_params(x.shape[1], k, x.shape[2],
                              params or DEFAULT_PARAMS)
        plan = plan_data_batched(x, params)
    _build.input_dtype(plan.xp)      # f32, bf16 or fp16, else it raises
    if plan.xp.is_cuda:
        check_cuda_params(params)
    cp, cn = _pad_centroids(c.to(plan.xp.dtype), k,
                            _round_up(k, params.block_k), plan.xp.shape[2])
    return plan, cp, cn, params


def _batched_writes_entries(xp: torch.Tensor) -> bool:
    """Whether the batched step on ``xp`` runs the entries route: bf16 and
    fp16 on the card; f32, and every dtype on the CPU, keep the dense
    blocks (the same bits either way)."""
    return xp.is_cuda and xp.dtype != torch.float32


def fused_lloyd_batched(x, c: torch.Tensor,
                        params: Optional[KernelParams] = None):
    """One-pass Lloyd step for B stacked problems in one launch. ``x`` is a
    raw (B, N, F) stack or a :class:`BatchPlan`; ``c`` is (B, K, F). Each
    problem's row tiles combine in the single-problem path's pairwise
    tree, so problem b is bit for bit :func:`fused_lloyd` on problem b: at
    bf16 / fp16 on the card the kernel writes each problem's entries and
    one tree over B Kp rows sums them (``update.reduce_entries``); at f32,
    and on the CPU, the dense row-tile partials collapse with
    :func:`_tree_sum` over axis 1. Returns (assign (B, N) int32, true
    squared distance (B, N) f32, sums (B, K, F), counts (B, K))."""
    plan, cp, cn, params = _resolve_padded_batched(x, c, params)
    k, n = c.shape[1], plan.n
    tiles = dict(block_m=params.block_m, block_k=params.block_k,
                 block_f=params.block_f)
    if _batched_writes_entries(plan.xp):
        mind, am, entries, ecnt, idx = _ll.lloyd_step_batched_entries(
            plan.xp, cp, cn, n, **tiles)
        nb, kp = cp.shape[:2]
        sums, counts = _up.reduce_entries(
            entries, ecnt, idx, ntiles=plan.xp.shape[1] // params.block_m)
        sums = sums.view(nb, kp, -1)[:, :k, :plan.f]
        counts = counts.view(nb, kp)[:, :k]
    else:
        mind, am, sums, counts = _ll.lloyd_step_batched(plan.xp, cp, cn, n,
                                                        **tiles)
        sums = _tree_sum(sums, 1)[:, :k, :plan.f]
        counts = _tree_sum(counts, 1)[:, :k]
    return am[:, :n], mind[:, :n] + plan.xn, sums, counts


def _pad_to(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """``t`` zero-padded to (rows, cols), contiguous; no copy when it
    already is."""
    if t.shape == (rows, cols) and t.is_contiguous():
        return t
    return F.pad(t, (0, cols - t.shape[1], 0, rows - t.shape[0])).contiguous()


def abft_tiles(m: int, n: int, k: int, block_m: int = hw.ABFT_BLOCK_M,
               block_n: int = hw.ABFT_BLOCK_N,
               block_k: int = hw.ABFT_BLOCK_K) -> tuple[int, int, int]:
    """The ABFT GEMM's (bm, bn, bk) for an (m, k) x (k, n) product: each
    block halved while it exceeds the padded dimension, with the
    reference's alignments (8, 128, 128), so the reference's clamped tiles
    passed explicitly are kept as they are."""
    def shrink(block: int, dim: int, align: int) -> int:
        while block > align and block > _round_up(dim, align):
            block //= 2
        return max(block, align)
    return (shrink(block_m, m, hw.ABFT_ALIGN_M),
            shrink(block_n, n, hw.ABFT_ALIGN_N),
            shrink(block_k, k, hw.ABFT_ALIGN_K))


def abft_matmul(x: torch.Tensor, y: torch.Tensor, *,
                inj: Optional[torch.Tensor] = None,
                block_m: int = hw.ABFT_BLOCK_M,
                block_n: int = hw.ABFT_BLOCK_N,
                block_k: int = hw.ABFT_BLOCK_K
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """ABFT GEMM D = X @ Y with in-kernel detection and correction, X
    (M, K), Y (K, N) f32, bf16 or fp16. Pads to :func:`abft_tiles`,
    launches :func:`~repro_torch.kernels.matmul_abft.matmul_abft` (its plain
    version on the CPU) on X and Y in their promoted dtype (two 2-byte
    inputs of one dtype stay 2-byte; a mix promotes to f32, as ``jnp.dot``
    does; on the card every dtype runs on the tensor cores, f32 through an
    f32-exact three-way bf16 split) and slices. The detection
    threshold is the inputs' dtype's, as the reference kernel's: a bf16
    product is held to bf16 rounding, not to f32's. ``inj`` is a
    :func:`~repro_torch.kernels.matmul_abft.make_injection` descriptor
    (m-tile, n-tile, k-step, row, col, delta) at those tiles. Returns
    (D (M, N) f32, detected count 0-d int32)."""
    m, k = x.shape
    n = y.shape[1]
    bm, bn, bk = abft_tiles(m, n, k, block_m, block_n, block_k)
    mp, np_, kp = _round_up(m, bm), _round_up(n, bn), _round_up(k, bk)
    dt = torch.promote_types(x.dtype, y.dtype)
    factor = threshold_factor(kp, dt)
    xp = _pad_to(x.to(dt), mp, kp)
    yp = _pad_to(y.to(dt), kp, np_)
    inj = (_mma.no_injection() if inj is None else inj).to(xp.device)
    d, det = _mma.matmul_abft(xp, yp, inj, block_m=bm, block_n=bn,
                              block_k=bk, factor=factor)
    return d[:m, :n], det.sum().to(torch.int32)


def plan_injection_tile(m: int, k: int, f: int, params: KernelParams,
                        row: int, col: int, f_step: int,
                        delta: float) -> torch.Tensor:
    """Translate a global (row, col) error position into tile coordinates."""
    params = clamp_params(m, k, f, params)
    return _daft.make_injection(
        row // params.block_m, col // params.block_k,
        f_step % max(f // params.block_f, 1),
        row % params.block_m, col % params.block_k, delta)
