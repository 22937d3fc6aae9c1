"""Dtype-aware ABFT detection thresholds (counterpart of the plain helpers
of ``repro.core.checksum``: ``rounding_eps``, ``threshold_factor``).

A clean length-k checksummed contraction leaves a residual of about
sqrt(k) * eps * |magnitude|; the kernels flag a tile when a residual
exceeds ``threshold_factor(k) * scale``, with ``scale`` taken from the
expected (clean) checksums.
"""
from __future__ import annotations

from typing import Any

import torch


def _torch_dtype(dtype: Any) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "name", None) or str(dtype)
    return getattr(torch, name.replace("torch.", ""))


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
