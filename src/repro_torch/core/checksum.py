"""Dual-checksum (e1/e2) ABFT encodings with location decoding, the
counterpart of ``repro.core.checksum`` (paper §IV):

  e1 = [1, 1, ..., 1]      detects an error (non-zero residual)
  e2 = [1, 2, ..., n]      locates it: index = round(r2 / r1) - 1

For D = X @ Y (X (m, k), Y (k, n)) the column checksums e1^T D, e2^T D
equal (e1^T X) Y, (e2^T X) Y and the row checksums D e1, D e2 equal
X (Y e1), X (Y e2). One corrupted element D[i, j] += delta leaves
residuals delta and (i + 1) * delta in column j, delta and (j + 1) * delta
in row i, so it is located and subtracted.

The thresholds are dtype-aware: a clean length-k checksummed contraction
leaves a residual of about sqrt(k) * eps * |magnitude|; a tile is flagged
when a residual exceeds ``threshold_factor(k) * scale``. The kernels take
``scale`` from the expected (clean) checksums; :func:`verify` takes the
threshold its caller computed (``ft_gemm.ft_matmul`` scales by max |D|, as
the reference does). Products here run in whatever precision the caller
pinned; ``kernels.ref.full_f32`` switches TF32 off on the card.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch


def _torch_dtype(dtype: Any) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "name", None) or str(dtype)
    return getattr(torch, name.replace("torch.", ""))


def e1(n: int, dtype: torch.dtype = torch.float32,
       device: Any = None) -> torch.Tensor:
    """The detection vector [1, 1, ..., 1]."""
    return torch.ones(n, dtype=dtype, device=device)


def e2(n: int, dtype: torch.dtype = torch.float32,
       device: Any = None) -> torch.Tensor:
    """The location-encoding vector [1, 2, ..., n]."""
    return torch.arange(1, n + 1, dtype=dtype, device=device)


def encode_cols(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Column checksums of x: (e1^T x, e2^T x), each of shape (x.shape[1],)."""
    w = e2(x.shape[0], x.dtype, x.device)
    return x.sum(0), w @ x


def encode_rows(y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Row checksums of y: (y e1, y e2), each of shape (y.shape[0],)."""
    w = e2(y.shape[1], y.dtype, y.device)
    return y.sum(1), y @ w


def rounding_eps(input_dtype: Any = torch.float32,
                 acc_dtype: Any = torch.float32) -> float:
    """Worst-case unit roundoff of a checksummed accumulation with inputs of
    ``input_dtype`` and an ``acc_dtype`` accumulator: max of the two eps
    (integer inputs contribute none)."""
    din = _torch_dtype(input_dtype)
    eps_in = torch.finfo(din).eps if din.is_floating_point else 0.0
    return max(eps_in, torch.finfo(_torch_dtype(acc_dtype)).eps)


def threshold_factor(k: int, input_dtype: Any = torch.float32,
                     acc_dtype: Any = torch.float32) -> float:
    """Static part of the detection threshold for a length-k contraction:
    ``16 * sqrt(k) * rounding_eps``."""
    return 16.0 * (max(k, 1) ** 0.5) * rounding_eps(input_dtype, acc_dtype)


def default_threshold(k: int, dtype: Any = torch.float32, scale: float = 1.0,
                      input_dtype: Any = None) -> float:
    """Detection threshold for a length-k contraction with accumulator
    ``dtype``: ``threshold_factor(k) * scale``; pass ``input_dtype`` when the
    operands are narrower than the accumulator."""
    return threshold_factor(
        k, input_dtype if input_dtype is not None else dtype, dtype) * scale


class ChecksumState(NamedTuple):
    """Checksums carried alongside a product D = X @ Y."""

    col1: torch.Tensor  # e1^T D, shape (n,)
    col2: torch.Tensor  # e2^T D, shape (n,)
    row1: torch.Tensor  # D e1,   shape (m,)
    row2: torch.Tensor  # D e2,   shape (m,)


def expected_checksums(x: torch.Tensor, y: torch.Tensor) -> ChecksumState:
    """Checksums from the inputs (the invariant side): the encodings
    e1^T X, e2^T X, Y e1, Y e2, then four one-row products."""
    c1x, c2x = encode_cols(x)
    r1y, r2y = encode_rows(y)
    return ChecksumState(col1=c1x @ y, col2=c2x @ y, row1=x @ r1y,
                         row2=x @ r2y)


def observed_checksums(d: torch.Tensor) -> ChecksumState:
    """Checksums of the (possibly corrupted) output D."""
    c1, c2 = encode_cols(d)
    r1, r2 = encode_rows(d)
    return ChecksumState(col1=c1, col2=c2, row1=r1, row2=r2)


class Verdict(NamedTuple):
    detected: torch.Tensor   # 0-d bool
    row: torch.Tensor        # 0-d int32 (0 if not detected)
    col: torch.Tensor        # 0-d int32
    delta: torch.Tensor      # 0-d, the error to subtract (0 if not detected)


def _at(v: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``v[i]`` for a 0-d index tensor, without reading it on the host."""
    return v.index_select(0, i.view(1).long()).view(())


def _ratio_index(num: torch.Tensor, den: torch.Tensor, n: int) -> torch.Tensor:
    """``clip(int32(round(num / den) - 1), 0, n - 1)`` with a zero ``den``
    read as 1; the float -> int32 conversion saturates and maps NaN to 0,
    as the reference's does."""
    safe = torch.where(den == 0, torch.ones_like(den), den)
    r = torch.round(num / safe) - 1.0
    r = r.nan_to_num(0.0, posinf=float(n), neginf=-1.0)
    return r.clamp(-1.0, float(n)).to(torch.int32).clamp(0, n - 1)


def verify(d: torch.Tensor, expected: ChecksumState, threshold) -> Verdict:
    """Compare the output's checksums with the inputs': detect when any
    column or row residual exceeds ``threshold``, then decode the reference's
    way. The argmax column gives j and delta; the e2/e1 ratio of that
    column's residuals gives i, unless the column residual is at or below
    the threshold, where the row-residual argmax gives i and the row ratio
    gives j. ``delta`` is the larger of the column and row residuals. Every
    step stays on the device."""
    obs = observed_checksums(d)
    res_col1 = obs.col1 - expected.col1
    res_row1 = obs.row1 - expected.row1
    res_col2 = obs.col2 - expected.col2
    res_row2 = obs.row2 - expected.row2
    detected = ((res_col1.abs() > threshold).any()
                | (res_row1.abs() > threshold).any())
    j = res_col1.abs().argmax().to(torch.int32)
    delta_col = _at(res_col1, j)
    i_direct = res_row1.abs().argmax().to(torch.int32)
    use_ratio = delta_col.abs() > threshold
    i = torch.where(use_ratio,
                    _ratio_index(_at(res_col2, j), delta_col, d.shape[0]),
                    i_direct)
    delta_row = _at(res_row1, i)
    delta = torch.where(delta_col.abs() > delta_row.abs(), delta_col,
                        delta_row)
    j = torch.where(use_ratio, j,
                    _ratio_index(_at(res_row2, i), delta_row, d.shape[1]))
    zero = torch.zeros((), dtype=torch.int32, device=d.device)
    return Verdict(detected=detected,
                   row=torch.where(detected, i, zero),
                   col=torch.where(detected, j, zero),
                   delta=torch.where(detected, delta,
                                     torch.zeros((), dtype=d.dtype,
                                                 device=d.device)))


def correct(d: torch.Tensor, verdict: Verdict) -> torch.Tensor:
    """Subtract the located delta from ``d`` **in place** and return it (the
    reference returns a new array); no change when nothing was detected."""
    idx = (verdict.row.long().view(1), verdict.col.long().view(1))
    old = d[idx]
    d.index_put_(idx, torch.where(verdict.detected, old - verdict.delta, old))
    return d
