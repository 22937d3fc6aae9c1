"""Plain PyTorch oracles, the counterparts of ``repro.kernels.ref``.

They define the semantics the CUDA kernels are held to, in f32 with f32
accumulation. On a CUDA device every product runs in full f32: the oracles
switch TF32 off for matrix products and convolutions wherever they run.
"""
from __future__ import annotations

import torch

from repro_torch.core import checksum


def full_f32(device: torch.device) -> None:
    """Pin full-f32 products on the card (TF32 keeps ~3 decimal digits)."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def distance_matrix(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Full squared-distance matrix ||x_i - c_j||^2, shape (M, K), f32."""
    full_f32(x.device)
    xf = x.float()
    cf = c.float()
    xn = (xf * xf).sum(1, keepdim=True)
    cn = (cf * cf).sum(1)[None, :]
    return xn + cn - 2.0 * (xf @ cf.T)


def first_min(d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Row min and the lowest column index attaining it (jnp.argmin's
    tie-break), written out so it does not rest on a library's choice. A
    row holding a NaN has min NaN and its first NaN's index, as jnp.min and
    jnp.argmin give (``d != d`` marks NaNs; a row's min is NaN exactly when
    the row holds one)."""
    mn = d.min(dim=1).values
    cols = torch.arange(d.shape[1], device=d.device, dtype=torch.int32)
    big = torch.iinfo(torch.int32).max
    hit = (d == mn[:, None]) | (d != d)
    arg = torch.where(hit, cols[None, :], big).min(dim=1).values
    return mn, arg.to(torch.int32)


def distance_argmin(x: torch.Tensor, c: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(min partial distance ||c||^2 - 2 x.c, argmin); add ||x||^2 for the
    true squared distance."""
    full_f32(x.device)
    cf = c.float()
    cn = (cf * cf).sum(1)[None, :]
    return first_min(cn - 2.0 * (x.float() @ cf.T))


def distance_argmin_ft(x: torch.Tensor, c: torch.Tensor,
                       inject_delta: float | None = None,
                       inject_pos: tuple[int, int] | None = None):
    """Oracle for the FT kernels, the reference's: plant one additive fault
    at ``inject_pos`` of X C^T, then :func:`~repro_torch.core.checksum.verify`
    with the threshold ``default_threshold(F) * max(max|X C^T|, 1)`` taken
    from the (possibly corrupted) product, correct, reduce. Returns (min
    partial distance, argmin, detected 0-d int32). The kernels and their
    plain versions scale by the expected checksums instead, so near the
    threshold this oracle and the kernels may disagree, in both packages."""
    full_f32(x.device)
    xf, cf = x.float(), c.float()
    cn = (cf * cf).sum(1)[None, :]
    cross = xf @ cf.T
    expected = checksum.expected_checksums(xf, cf.T)
    if inject_delta is not None and inject_pos is not None:
        cross[inject_pos] += inject_delta
    scale = torch.clamp_min(cross.abs().max(), 1.0)
    thr = checksum.default_threshold(x.shape[1], cross.dtype) * scale
    verdict = checksum.verify(cross, expected, thr)
    cross = checksum.correct(cross, verdict)
    mn, am = first_min(cn - 2.0 * cross)
    return mn, am, verdict.detected.to(torch.int32)


def matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Oracle for the ABFT matmul kernel: the plain f32 product."""
    full_f32(x.device)
    return torch.matmul(x.float(), y.float())


def centroid_update(x: torch.Tensor, assign: torch.Tensor, k: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster (sums (K, F) f32, counts (K,) f32)."""
    full_f32(x.device)
    onehot = one_hot(assign, k)
    return onehot.T @ x.float(), onehot.sum(0)


def one_hot(assign: torch.Tensor, k: int) -> torch.Tensor:
    """f32 one-hot rows of ``assign`` (..., k), built in place (no int64
    intermediate: at M = 2**20, K = 1000 that would be 8 GB)."""
    out = torch.zeros((*assign.shape, k), dtype=torch.float32,
                      device=assign.device)
    return out.scatter_(-1, assign.long()[..., None], 1.0)


def lloyd_step(x: torch.Tensor, c: torch.Tensor):
    """(min partial distance, argmin, sums (K, F), counts (K,))."""
    md, am = distance_argmin(x, c)
    sums, counts = centroid_update(x, am, c.shape[0])
    return md, am, sums, counts
