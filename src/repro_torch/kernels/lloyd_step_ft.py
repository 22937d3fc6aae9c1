"""Fault-tolerant one-pass Lloyd kernel (paper §IV Fig. 6 composed with
§III Fig. 4).

Replaces the Pallas TPU kernel ``lloyd_step_ft`` of
``src/repro/kernels/lloyd_step_ft.py`` (``_kernel``): ``distance_argmin_ft``
composed with ``lloyd_step``. The corrected distance accumulator feeds the
min/argmin and the update; beside each row tile's partial sums/counts the
kernel emits their expected e1/e2 checksums, from the assignment and X and
never from the sums they verify:

    e1^T (onehot^T X) = valid^T X
    e2^T (onehot^T X) = (valid * (argmin + 1))^T X

``ops.fused_lloyd_ft`` compares them with the observed checksums of the
partial blocks and recomputes a mismatched tile
(``lloyd_step.recompute_update``). The 12-word descriptor has two slots:
the distance GEMM and the update product.

CUDA kernels: ``lloyd_tile_kernel<BM, true, true>`` (f32) and
``lloyd_tile_mma_kernel<T, BM, true, true>`` (bf16, fp16) in
``csrc/fk_kernels.cu``, sharing the product with every instantiation of
its input dtype T (f32, bf16 or fp16), ``locate_and_correct`` with
``distance_argmin_ft`` and ``emit_update`` with ``lloyd_step``, so it is bit
for bit the unprotected kernels of its dtype plus the checksums. Bound on
the H100: as ``lloyd_step``, plus the (Mp/bm, 2, Fp) expected-checksum
output.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.distance_argmin import check_padded
from repro_torch.kernels.distance_argmin_ft import (abft_correct_plain,
                                                    f32_bits)
from repro_torch.kernels.lloyd_step import tile_update_plain

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


def lloyd_step_ft(x: torch.Tensor, c: torch.Tensor, cn: torch.Tensor,
                  inj: torch.Tensor, true_m: int, *, block_m: int,
                  block_k: int, block_f: int, factor: float):
    """Raw one-pass FT kernel entry on pre-padded inputs (X and C f32, bf16
    or fp16). Returns (min (Mp,), argmin (Mp,), det (T,), sums (T, Kp, Fp),
    counts (T, Kp), ucheck (T, 2, Fp), ccheck (T, 2)) with T = Mp /
    block_m, all f32 but argmin and det."""
    check_padded(x, c, cn, block_m, block_k, block_f)
    dt = _build.input_dtype(x, c)
    if inj.shape[0] != INJ_LEN:
        raise ValueError(f"lloyd_step_ft takes a {INJ_LEN}-word descriptor, "
                         f"got {tuple(inj.shape)}")
    if _build.on_cpu(x, c, cn, inj):
        return lloyd_step_ft_plain(x, c, cn, inj, true_m, block_m, block_k,
                                   block_f, factor)
    mp, fp = x.shape
    kp = c.shape[0]
    nt = mp // block_m
    dev = x.device
    f32 = torch.float32
    mind = torch.empty(mp, dtype=f32, device=dev)
    am = torch.empty(mp, dtype=torch.int32, device=dev)
    det = torch.empty(nt, dtype=torch.int32, device=dev)
    sums = torch.empty((nt, kp, fp), dtype=f32, device=dev)
    counts = torch.empty((nt, kp), dtype=f32, device=dev)
    ucheck = torch.empty((nt, 2, fp), dtype=f32, device=dev)
    ccheck = torch.empty((nt, 2), dtype=f32, device=dev)
    code = _build.launch(
        "fk_lloyd_step_ft", dt, _build.ptr(x, dt, "x"),
        _build.ptr(c, dt, "c"), _build.ptr(cn, f32, "cn"),
        _build.ptr(inj, torch.int32, "inj"),
        mind.data_ptr(), am.data_ptr(), det.data_ptr(), sums.data_ptr(),
        counts.data_ptr(), ucheck.data_ptr(), ccheck.data_ptr(), factor,
        true_m, mp, kp, fp, block_m, block_f, _build.stream_of(x))
    _build.check(code, "lloyd_step_ft")
    lloyd_step_ft.launches += 1
    return mind, am, det, sums, counts, ucheck, ccheck


lloyd_step_ft.launches = 0
