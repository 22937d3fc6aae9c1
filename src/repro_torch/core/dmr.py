"""Dual Modular Redundancy for the memory-bound centroid update (paper §I,
§IV), the counterpart of ``repro.core.dmr``.

The update streams X once and does little arithmetic, so running it twice
costs little. PyTorch runs eagerly and never merges the two runs, so no
barrier is needed between them.
"""
from __future__ import annotations

import torch


def mismatch(primary: tuple, replica: tuple,
             atol: float = 0.0) -> torch.Tensor:
    """0-d bool tensor: floating leaves differ beyond ``atol``, others on
    any difference."""
    bad = torch.zeros((), dtype=torch.bool, device=primary[0].device)
    for a, b in zip(primary, replica):
        if a.is_floating_point():
            bad = bad | ((a - b).abs() > atol).any()
        else:
            bad = bad | (a != b).any()
    return bad

