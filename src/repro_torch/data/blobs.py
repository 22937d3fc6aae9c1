"""Synthetic clustering data (isotropic Gaussian blobs), shardable.

The same generator and draw order as ``repro.data.blobs``, so both packages
see identical data for one seed. Returns numpy arrays; the estimator moves
them to its device.
"""
from __future__ import annotations

import numpy as np


def make_blobs(m: int, f: int, k: int, *, seed: int = 0, spread: float = 1.0,
               center_scale: float = 10.0, shard: int = 0,
               num_shards: int = 1, dtype=np.float32):
    """Returns (x (m_local, f), true_labels (m_local,) int32) for a shard."""
    if m % num_shards:
        raise ValueError(f"m ({m}) must divide into {num_shards} shards")
    m_local = m // num_shards
    rng_centers = np.random.default_rng(seed)           # shared across shards
    centers = rng_centers.normal(size=(k, f)) * center_scale
    rng = np.random.default_rng(seed * 1_000_003 + shard + 1)
    labels = rng.integers(0, k, size=m_local)
    x = centers[labels] + rng.normal(size=(m_local, f)) * spread
    return x.astype(dtype), labels.astype(np.int32)
