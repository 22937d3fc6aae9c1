"""Cluster-assignment backends of the main path (counterpart of
``repro.core.assignment``).

Each maps (x (M, F) or a DataPlan, c (K, F)) to (assign (M,) int32, true
squared distance (M,) f32, detected errors), one-pass backends adding
(sums (K, F), counts (K,)):

  naive       plain PyTorch: the paper's basic implementation, a
              per-sample loop over chunks of 1024 rows, each row's
              distances to every centroid without a GEMM, then the first
              min
  gemm        plain PyTorch: the paper's V1, the distance matrix
              materialised, then a separate first-min pass
  gemm_fused  plain PyTorch: full distance matrix, then argmin (the
              cuML-style baseline; no kernel of this package)
  fused       the fused distance/argmin kernel (paper V4/V5)
  fused_ft    the fused kernel with online dual-checksum ABFT (§IV)
  lloyd       the one-pass Lloyd kernel (assignment + update sums)
  lloyd_ft    the one-pass kernel with ABFT on the distance GEMM and a
              checksum-verified update: the ``correct`` protection path
  abft_offline
              plain PyTorch: ``ft_gemm.ft_matmul`` (the product in the
              compute dtype, then dual-checksum verify + correct on the
              materialised product), then the distances and first-min
              argmin: the ``detect`` protection path (the Wu-et-al.
              offline baseline; no kernel of this package, as the
              reference's is plain XLA). At bf16 / fp16 the product, its
              checksums, the norms and the distances are 2-byte, as the
              reference's ``jnp`` arithmetic on 2-byte operands
  lloyd_batched
              the one-pass kernel over B stacked problems in one launch
              ((B, N, F) in, every output with a leading B axis)
  lloyd_pruned
              the one-pass kernel with tile-granular triangle-inequality
              pruning: bit for bit ``lloyd``; takes and returns the carried
              ``ops.BoundsState`` (extended 7-tuple: + new bounds, pruned
              tile fraction)
  int8        the int8 distance kernel: X and C quantised per row, exact
              int32 tile products, f32 scale correction, exact norm terms;
              takes an ``ops.QuantPlan``

On the CPU every kernel backend runs its kernel's plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.api.registry import AssignmentBackend, register_backend
from repro_torch.core.ft_gemm import ft_matmul
from repro_torch.kernels import ops, ref


def _zero(device: torch.device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def _row_norms(x) -> torch.Tensor:
    """True-distance offset: the plan's precomputed norms (a QuantPlan's are
    the unquantised rows'), else computed."""
    x = ops.f32_plan(x)
    if isinstance(x, ops.DataPlan):
        return x.xn
    return (x.float() ** 2).sum(1)


def _data(x) -> torch.Tensor:
    x = ops.f32_plan(x)
    return x.x if isinstance(x, ops.DataPlan) else x


# rows a step of the naive backend (the reference's lax.map batch)
NAIVE_BATCH = 1024


def assign_naive(x, c: torch.Tensor):
    rows = _data(x)
    dt = torch.promote_types(rows.dtype, c.dtype)
    cc = c.to(dt)
    mins, args = [], []
    for xi in rows.to(dt).split(NAIVE_BATCH):
        mn, am = ref.first_min(((xi[:, None, :] - cc[None]) ** 2).sum(2))
        mins.append(mn)
        args.append(am)
    return torch.cat(args), torch.cat(mins).float(), _zero(c.device)


def assign_gemm(x, c: torch.Tensor):
    d = ref.distance_matrix(_data(x), c)
    mn, am = ref.first_min(d)
    return am, mn, _zero(d.device)


def assign_gemm_fused(x, c: torch.Tensor):
    d = ref.distance_matrix(_data(x), c)
    mn, am = ref.first_min(d)
    return am, mn, _zero(d.device)


def assign_abft_offline(x, c: torch.Tensor):
    rows = _data(x)
    cross, detected = ft_matmul(rows, c.T)
    # the reference's assembly order: (||x||^2 + ||c||^2) - 2 x.c; the
    # subtraction runs in place (2 x.c is exact, so the result is the same).
    # At f32 the row norms are the plan's; at bf16 / fp16 every term is in
    # the compute dtype, each op rounded to it, as jnp computes them
    xn = _row_norms(x) if rows.dtype == torch.float32 \
        else (rows * rows).sum(1)
    d = xn[:, None] + (c * c).sum(1)[None, :]
    d.sub_(cross, alpha=2.0)
    del cross
    mn, am = ref.first_min(d)
    # the backends' contract: f32 distances (a 2-byte value widens exactly),
    # so the fit's inertia is an f32 sum, as every other backend's
    return am, mn.float(), detected.to(torch.int32)


def assign_fused(x, c: torch.Tensor, params=None):
    am, md = ops.fused_assign(x, c, params)
    return am, md + _row_norms(x), _zero(md.device)


def assign_fused_ft(x, c: torch.Tensor, params=None,
                    inj: Optional[torch.Tensor] = None):
    am, md, det = ops.fused_assign_ft(x, c, params, inj=inj)
    return am, md + _row_norms(x), det


def assign_lloyd(x, c: torch.Tensor, params=None):
    am, md, sums, counts = ops.fused_lloyd(x, c, params)
    return am, md, _zero(md.device), sums, counts


def assign_int8(x, c: torch.Tensor, params=None):
    am, md = ops.fused_assign_int8(x, c, params)
    return am, md + _row_norms(x), _zero(md.device)


def assign_lloyd_pruned(x, c: torch.Tensor, params=None, *, bounds=None):
    am, md, sums, counts, new_bounds, frac = ops.fused_lloyd_pruned(
        x, c, params, bounds=bounds)
    return am, md, _zero(md.device), sums, counts, new_bounds, frac


def assign_lloyd_batched(x, c: torch.Tensor, params=None):
    am, md, sums, counts = ops.fused_lloyd_batched(x, c, params)
    return am, md, _zero(md.device), sums, counts


def assign_lloyd_ft(x, c: torch.Tensor, params=None,
                    inj: Optional[torch.Tensor] = None):
    am, md, sums, counts, det = ops.fused_lloyd_ft(x, c, params, inj=inj)
    return am, md, det, sums, counts


register_backend(AssignmentBackend(
    "naive", assign_naive,
    doc="paper's basic implementation: per-sample scalar loop, no GEMM"))
register_backend(AssignmentBackend(
    "gemm", assign_gemm,
    doc="paper V1: GEMM + materialized D + separate first-min pass"))
register_backend(AssignmentBackend(
    "gemm_fused", assign_gemm_fused,
    doc="plain PyTorch distance matrix + argmin (cuML-style baseline)"))
register_backend(AssignmentBackend(
    "fused", assign_fused, takes_params=True,
    doc="fused distance/argmin CUDA kernel (paper V4/V5)"))
register_backend(AssignmentBackend(
    "fused_ft", assign_fused_ft, supports_ft=True, takes_params=True,
    takes_injection=True,
    doc="fused kernel + dual-checksum online ABFT correction (paper §IV)"))
register_backend(AssignmentBackend(
    "abft_offline", assign_abft_offline, supports_ft=True,
    doc="Wu-et-al-style baseline: checksummed product in the compute "
        "dtype, offline verification and correction on the materialised "
        "product"))
register_backend(AssignmentBackend(
    "lloyd", assign_lloyd, takes_params=True, fuses_update=True,
    doc="one-pass Lloyd CUDA kernel: assignment + per-cluster sums"))
register_backend(AssignmentBackend(
    "lloyd_ft", assign_lloyd_ft, supports_ft=True, takes_params=True,
    takes_injection=True, fuses_update=True,
    doc="one-pass FT Lloyd CUDA kernel: ABFT on the distance GEMM + "
        "checksum-verified update"))
register_backend(AssignmentBackend(
    "int8", assign_int8, takes_params=True, supports_int8=True,
    doc="int8 distance CUDA kernel: per-row quantised X/C, exact int32 "
        "tile products, f32 scale-corrected epilogue with exact norm terms "
        "(bit-exact argmin on quantisation-safe data)"))
register_backend(AssignmentBackend(
    "lloyd_pruned", assign_lloyd_pruned, takes_params=True,
    fuses_update=True, supports_bounds=True, bounds_init=ops.init_bounds,
    doc="pruned one-pass Lloyd CUDA kernel: Hamerly bounds skip whole "
        "centroid tiles that provably lose (bit-identical to lloyd; "
        "extended 7-tuple with bounds state + prune fraction)"))
register_backend(AssignmentBackend(
    "lloyd_batched", assign_lloyd_batched, takes_params=True,
    fuses_update=True, supports_batch=True,
    doc="batched one-pass Lloyd CUDA kernel: B independent problems per "
        "launch, one (row tile, problem) grid"))
