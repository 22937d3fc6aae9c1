"""Serving-plan tuning: the bucket ladder and the micro-batch window
(counterpart of ``repro.serve.tuning``).

Two knobs of the serving layer lie outside the kernel tiles: the row-count
bucket ladder (more buckets pad less but capture more cells, and launch
more of the small cells whose per-launch cost the ``serve`` model charges)
and the batching window (the latency a request pays to share a launch).
Both come from the H100 model the tile selection uses,
``core.autotune.model_score(kind="serve")`` (the assignment kernel's
roofline plus ``hw.SERVE_LAUNCH_S``, one graph replay), by minimising the
expected cost of a request over log-uniform request sizes. Plans persist as
the autotune cache's ``ladder:`` pseudo-entries beside the per-bucket tile
winners they were scored with.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Optional

import torch

from repro_torch.core import autotune
from repro_torch.kernels import ops
from repro_torch.serve.compiler import DEFAULT_BUCKETS


@dataclasses.dataclass(frozen=True)
class ServePlan:
    """A tuned serving configuration of one model shape: the row-bucket
    ladder, the micro-batch window (us) and the per-bucket tile winners the
    ladder was scored with."""

    buckets: tuple[int, ...]
    window_us: float
    winners: dict[int, tuple[str, ops.KernelParams]]


def _ladder_cost(ladder: tuple[int, ...], cost: dict[int, float],
                 sizes: tuple[int, ...]) -> float:
    """Expected cost of one request over the size distribution: each
    request runs the smallest bucket that holds it, oversize requests chunk
    through the top bucket."""
    total = 0.0
    top = ladder[-1]
    for r in sizes:
        if r > top:
            total += -(-r // top) * cost[top]
            continue
        total += cost[min(b for b in ladder if b >= r)]
    return total / len(sizes)


def plan_ladder(n_clusters: int, n_features: int, *,
                dtype: Any = torch.float32, cache: Optional[Any] = None,
                min_rows: int = 64, max_rows: int = 4096,
                max_cells: int = 4, mode: str = "model") -> ServePlan:
    """The bucket ladder and window of one model shape.

    Candidates are the powers of two in ``[min_rows, max_rows]``; every
    ladder of at most ``max_cells`` of them that holds the top one is
    scored with :func:`_ladder_cost` over request sizes 1, 2, 4, ..., 2
    ``max_rows``, and the cheapest wins (the first, fewest cells, on a
    tie). The window is the top bucket's modelled launch. With ``cache``
    the plan and its winners persist (serve kind) for
    ``KMeansService.from_estimator`` to find."""
    candidates = []
    b = 1
    while b < min_rows:
        b *= 2
    while b <= max_rows:
        candidates.append(b)
        b *= 2
    if not candidates:
        raise ValueError(f"no power-of-two buckets in "
                         f"[{min_rows}, {max_rows}]")
    winners: dict[int, tuple[str, ops.KernelParams]] = {}
    cost: dict[int, float] = {}
    for size in candidates:
        variant, p = autotune.select_params(size, n_clusters, n_features,
                                            mode=mode, dtype=dtype,
                                            kind="serve")
        winners[size] = (variant, p)
        cost[size] = autotune.model_score(size, n_clusters, n_features, p,
                                          dtype=dtype, kind="serve",
                                          variant=variant)
    sizes = []
    r = 1
    while r <= 2 * max_rows:
        sizes.append(r)
        r *= 2
    top = candidates[-1]
    best: Optional[tuple[int, ...]] = None
    best_cost = float("inf")
    for n in range(1, max_cells + 1):
        for combo in itertools.combinations(candidates, n):
            if combo[-1] != top:
                continue
            c = _ladder_cost(combo, cost, tuple(sizes))
            if c < best_cost:
                best, best_cost = combo, c
    assert best is not None
    window_us = cost[best[-1]] * 1e6
    plan = ServePlan(best, window_us, {s: winners[s] for s in best})
    if cache is not None:
        for size in best:
            variant, p = winners[size]
            cache.put(size, n_clusters, n_features, p, kind="serve",
                      dtype=dtype, variant=variant)
        cache.put_ladder(n_clusters, n_features, buckets=best,
                         window_us=window_us, dtype=dtype)
    return plan


__all__ = ["ServePlan", "plan_ladder", "DEFAULT_BUCKETS"]
