"""Fault tolerance for the LM stack: ABFT-protected dense projections."""
from repro_torch.ft.abft_dense import (FTContext, configure, detect_correct,
                                       ft_einsum, ft_enabled)

__all__ = ["FTContext", "configure", "detect_correct", "ft_einsum",
           "ft_enabled"]
