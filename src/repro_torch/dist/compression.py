"""Symmetric int8 quantisation (counterpart of ``repro.dist.compression``).

Only :func:`quantize_rows` so far, the per-row scheme of the int8 distance
kernel; the blockwise error-feedback reduction comes with the distributed
slice.
"""
from __future__ import annotations

import torch


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8, the reference's arithmetic step for step:
    scale = max|row| / 127, raised to at least 1e-12, then
    q = clip(round(x / scale), -127, 127) with round half to even. Returns
    (q int8, shape of x; scale f32, last axis collapsed to 1). Rows of
    integers in [-127, 127] that hold a +-127 get scale exactly 1.0 and
    q == x: the int8 kernel's bit-exactness rests on it."""
    xf = x.float()
    scale = xf.abs().amax(-1, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale
