"""ABFT-protected matrix product with online detection and correction, the
counterpart of ``repro.core.ft_gemm``.

The product itself is ``torch.matmul`` in the operands' dtype, as the
reference leaves it to ``jnp.matmul``: full f32 for f32 operands (TF32 off
on the card), and for bf16 / fp16 operands a product accumulated in f32
(cuBLAS's reduced-precision split-K reductions off on the card) and
rounded to the operands' dtype, with the checksums in that dtype too. It
is the offline ABFT of the ``abft_offline`` backend
(``FaultPolicy.detect()``, the Wu-et-al. baseline the fused kernels beat),
which checks the materialised product after the fact. The kernel that
fuses the same invariant into the tile loop is ``kernels.matmul_abft``.

Overhead model (paper §IV-A): for D = X @ Y with X (m, k), Y (k, n) the
checksums add O((m + n) k) encode work and four one-row products, plus the
passes over D that the observed checksums and the scale need.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import checksum
from repro_torch.core.fault import FaultConfig, inject
from repro_torch.kernels import ref


def _abs_max(d: torch.Tensor) -> torch.Tensor:
    """max |d| without materialising |d| (NaN propagates)."""
    lo, hi = torch.aminmax(d)
    return torch.maximum(-lo, hi)


def ft_matmul(x: torch.Tensor, y: torch.Tensor, *,
              inject_gen: Optional[torch.Generator] = None,
              fault: Optional[FaultConfig] = None,
              threshold_scale: float = 1.0
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x @ y with dual-checksum ABFT detect + correct. Returns (corrected
    product, detected 0-d bool). With ``inject_gen`` and an enabled
    ``fault``, one SEU bit flip lands in the raw product before it is
    verified. The threshold is ``default_threshold(k) * max(max|D|, 1)``
    with D the possibly corrupted product, the reference's scale. Nothing
    is read on the host."""
    ref.full_f32(x.device)
    if x.device.type == "cuda" and x.element_size() == 2:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = False
        torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction \
            = False
    expected = checksum.expected_checksums(x, y)
    d = torch.matmul(x, y)
    if inject_gen is not None and fault is not None and fault.enabled():
        d = inject(inject_gen, d, fault)
    scale = torch.clamp_min(_abs_max(d), 1.0)
    thr = checksum.default_threshold(x.shape[1], d.dtype,
                                     threshold_scale) * scale
    verdict = checksum.verify(d, expected, thr)
    return checksum.correct(d, verdict), verdict.detected


def ft_matmul_col(x: torch.Tensor, y: torch.Tensor, *,
                  threshold_scale: float = 1.0
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Column-checksum-only ABFT product: under the SEU model the e1/e2
    column checksums alone detect and locate (j = argmax residual column,
    delta = r1[j], i = r2[j] / r1[j] - 1). The scale proxy is
    max|e1^T X Y| / m, the threshold ``default_threshold(k) * scale * m``,
    as in the reference. Returns (corrected product, detected)."""
    ref.full_f32(x.device)
    m = x.shape[0]
    c1x, c2x = checksum.encode_cols(x)
    exp_col1 = c1x @ y
    exp_col2 = c2x @ y
    d = torch.matmul(x, y)
    obs_col1, obs_col2 = checksum.encode_cols(d)
    res1 = obs_col1 - exp_col1
    res2 = obs_col2 - exp_col2
    scale = torch.clamp_min(exp_col1.abs().max() / max(m, 1), 1.0)
    thr = checksum.default_threshold(x.shape[1], d.dtype,
                                     threshold_scale) * scale * m
    detected = (res1.abs() > thr).any()
    j = res1.abs().argmax().to(torch.int32)
    delta = checksum._at(res1, j)
    i = checksum._ratio_index(checksum._at(res2, j), delta, m)
    fix = torch.where(detected, delta, torch.zeros_like(delta))
    idx = (i.long().view(1), j.long().view(1))
    d.index_put_(idx, d[idx] - fix)
    return d, detected


class _AbftDot(torch.autograd.Function):
    """Protected product whose backward runs the two protected products
    g @ y^T and x^T @ g (a corrected product's gradient is the clean
    product's under the SEU model)."""

    @staticmethod
    def forward(ctx, x, y, mode):
        ctx.save_for_backward(x, y)
        ctx.mode = mode
        return _protected(mode)(x, y)[0]

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        prot = _protected(ctx.mode)
        gx, _ = prot(g, y.T)
        gy, _ = prot(x.T, g)
        return gx.to(x.dtype), gy.to(y.dtype), None


def _protected(mode: str):
    if mode not in ("col", "full"):
        raise ValueError(f"mode must be 'col' or 'full', got {mode!r}")
    return ft_matmul_col if mode == "col" else ft_matmul


def abft_dot(x: torch.Tensor, y: torch.Tensor, *, enabled: bool = True,
             mode: str = "col") -> torch.Tensor:
    """Drop-in ``torch.matmul`` that silently corrects one SEU per product
    and is differentiable (:class:`_AbftDot`). ``mode="col"`` is the
    column-checksum-only fast path, ``"full"`` the dual row + column
    scheme."""
    if not enabled:
        ref.full_f32(x.device)
        return torch.matmul(x, y)
    return _AbftDot.apply(x, y, mode)
