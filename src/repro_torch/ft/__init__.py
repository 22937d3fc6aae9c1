"""Fault tolerance beyond the kernels: ABFT-protected dense projections,
checkpoint / restart of the train loop and the elastic fit, and the elastic
decision layer (``elastic``: worker loss, the rescale plans, stragglers)."""
from repro_torch.ft import elastic
from repro_torch.ft.abft_dense import (FTContext, configure, detect_correct,
                                       ft_einsum, ft_enabled)
from repro_torch.ft.checkpoint import Checkpointer
from repro_torch.ft.elastic import (FailureSchedule, WorkerLossError,
                                    plan_rescale_rows)

__all__ = ["Checkpointer", "FTContext", "configure", "detect_correct",
           "elastic", "ft_einsum", "ft_enabled", "FailureSchedule",
           "WorkerLossError", "plan_rescale_rows"]
