"""``repro_torch.api``: the estimator surface of the port.

  * :class:`KMeans`        -- the single-problem estimator (fit / predict /
                              partial_fit / transform / score, get_state /
                              from_state), on the card by default;
  * :class:`BatchedKMeans` -- B stacked problems, one launch per Lloyd step
                              (``repro_torch.batch``, exported lazily so
                              that package can import this one first);
  * :class:`FaultPolicy`   -- off | correct, with optional SEU campaigns;
  * the backend registry   -- :func:`get_backend` / :func:`register_backend`.
"""
from typing import Any

from repro_torch.api.estimator import KMeans, NotFittedError
from repro_torch.api.policy import FaultPolicy, InjectionCampaign
from repro_torch.api.registry import (AssignmentBackend, BackendCapabilityError,
                                      get_backend, register_backend)

__all__ = [
    "KMeans", "BatchedKMeans", "NotFittedError", "FaultPolicy",
    "InjectionCampaign", "AssignmentBackend", "BackendCapabilityError",
    "get_backend", "register_backend",
]


def __getattr__(name: str) -> Any:
    if name == "BatchedKMeans":
        from repro_torch.batch.estimator import BatchedKMeans
        return BatchedKMeans
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
