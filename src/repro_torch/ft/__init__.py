"""Fault tolerance for the LM stack: ABFT-protected dense projections and
checkpoint / restart of the train loop."""
from repro_torch.ft.abft_dense import (FTContext, configure, detect_correct,
                                       ft_einsum, ft_enabled)
from repro_torch.ft.checkpoint import Checkpointer

__all__ = ["Checkpointer", "FTContext", "configure", "detect_correct",
           "ft_einsum", "ft_enabled"]
