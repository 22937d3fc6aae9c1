"""K-means numerics behind the estimator (counterpart of
``repro.core.kmeans``): seeding, the DMR-protected two-pass update, the
one-pass means and empty-cluster reseeding.

Randomness comes from an explicit ``torch.Generator`` on the data's device;
it cannot reproduce ``jax.random`` draws, so seeding is held to its
properties (K distinct real rows, deterministic per seed), not to samples.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def init_random(gen: torch.Generator, x: torch.Tensor, k: int) -> torch.Tensor:
    """K distinct rows drawn uniformly."""
    idx = torch.randperm(x.shape[0], generator=gen, device=x.device)[:k]
    return x[idx]


def init_kmeanspp(gen: torch.Generator, x: torch.Tensor,
                  k: int) -> torch.Tensor:
    """k-means++ seeding (D^2 sampling). Each round draws on the device, so
    seeding never synchronises with the host."""
    m = x.shape[0]
    first = torch.randint(m, (1,), generator=gen, device=x.device)
    centroids = torch.empty((k, x.shape[1]), dtype=x.dtype, device=x.device)
    centroids[0] = x[first[0]]
    d2 = ((x - centroids[0]) ** 2).sum(1)
    for i in range(1, k):
        probs = d2 / d2.sum().clamp_min(1e-30)
        idx = torch.multinomial(probs, 1, generator=gen)
        centroids[i] = x[idx[0]]
        d2 = torch.minimum(d2, ((x - centroids[i]) ** 2).sum(1))
    return centroids


def protected_sums(x, assign: torch.Tensor, k: int, *,
                   use_dmr: bool = True):
    """Per-cluster (sums, counts), optionally under DMR, in the one-pass
    kernels' order (:func:`~repro_torch.kernels.ops.tiled_update`). ``x`` is
    a padded :class:`~repro_torch.kernels.ops.DataPlan`, a
    :class:`~repro_torch.kernels.ops.QuantPlan` (its f32 DataPlan) or the
    raw (M, F) data, which is planned here at the default tiles. Under DMR
    a clean step runs two updates and the recompute runs only on a
    mismatch, gated on the device: the fit never waits on the host."""
    x = ops.f32_plan(x)
    if isinstance(x, ops.DataPlan):
        if x.params is None:
            x = x.x
        else:
            return ops.tiled_update(x, assign, k, use_dmr=use_dmr)
    params = ops.clamp_params(x.shape[0], k, x.shape[1], ops.DEFAULT_PARAMS)
    return ops.tiled_update(ops.plan_data(x, params), assign, k,
                            use_dmr=use_dmr)


def means_from_sums(sums: torch.Tensor, counts: torch.Tensor,
                    prev: torch.Tensor) -> torch.Tensor:
    """New centroids; empty clusters keep their previous centroid. Leading
    axes broadcast: (K, F) for one problem, (B, K, F) for a stack."""
    means = sums / counts.clamp_min(1.0)[..., None]
    return torch.where((counts > 0)[..., None], means, prev)


def centroid_update(x, assign: torch.Tensor, k: int,
                    prev: torch.Tensor, *, use_dmr: bool = True):
    """Means of assigned points; empty clusters keep their previous one."""
    sums, counts = protected_sums(x, assign, k, use_dmr=use_dmr)
    return means_from_sums(sums, counts, prev), counts


def reseed_empty(x: torch.Tensor, centroids: torch.Tensor,
                 counts: torch.Tensor, min_dist: torch.Tensor) -> torch.Tensor:
    """Move empty clusters onto the points farthest from their centroid,
    farthest first; a stable sort, so ties keep row order exactly as the
    reference's ``jnp.argsort`` does. Draws nothing at random. Leading axes
    are problems of a stack: x (..., N, F), centroids (..., K, F), counts
    (..., K), min_dist (..., N); each problem sorts its own rows, so it
    picks the donors it picks alone (the reference vmaps this function)."""
    n, f = x.shape[-2:]
    order = torch.argsort(-min_dist, dim=-1, stable=True)
    empty = counts == 0
    empty_rank = torch.cumsum(empty.long(), -1) - 1
    donor = order.gather(-1, empty_rank.clamp(0, n - 1))
    rows = x.gather(-2, donor[..., None].expand(*donor.shape, f))
    return torch.where(empty[..., None], rows, centroids)
