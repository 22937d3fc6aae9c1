"""Symmetric int8 quantisation (counterpart of ``repro.dist.compression``).

:func:`quantize_rows` is the per-row scheme of the int8 distance kernel.
:func:`quantize` / :func:`dequantize` are the blockwise scheme of the
cross-host reduce, and :func:`compressed_psum` its error-feedback
all-reduce over a process group: it quantises, dequantises and sums the
dequantised values, so its accuracy and its residual are what an int8
transport would give, while the wire still carries f32 (as in the
reference, whose psum moves f32 too). Every step is the reference's
arithmetic: ``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

from typing import Optional

import torch

BLOCK = 128


def quantize(x: torch.Tensor, block: int = BLOCK
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8 over the last axis, zero-padded to a whole
    number of blocks. Returns (q int8 (..., N/b, b), scale f32 (..., N/b,
    1))."""
    n = x.shape[-1]
    xp = torch.nn.functional.pad(x.float(), (0, (-n) % block))
    xb = xp.reshape(*xp.shape[:-1], -1, block)
    scale = xb.abs().amax(-1, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return q, scale


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


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               n: Optional[int] = None) -> torch.Tensor:
    """The blocks back as f32 over one last axis, cut to ``n`` when given."""
    x = (q.float() * scale).reshape(*q.shape[:-2], -1)
    return x if n is None else x[..., :n]


def compressed_psum(g: torch.Tensor, group) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Sum of the int8-quantised ``g`` over ``group`` and the local
    error-feedback residual ``g - dequantize(quantize(g))``, which the
    caller folds into its next value: ``red, res = compressed_psum(grad +
    carried_res, group)``. ``group`` is a process group (``None``: this
    rank alone)."""
    from repro_torch.dist.reduce import psum
    q, scale = quantize(g)
    deq = dequantize(q, scale, g.shape[-1])
    return psum(deq, group), g - deq
