"""``repro_torch.api``: the estimator surface of the port.

  * :class:`KMeans`      -- the single-problem estimator (fit / predict /
                            partial_fit / transform / score, get_state /
                            from_state), on the card by default;
  * :class:`FaultPolicy` -- off | correct, with optional SEU campaigns;
  * the backend registry -- :func:`get_backend` / :func:`register_backend`.
"""
from repro_torch.api.estimator import KMeans, NotFittedError
from repro_torch.api.policy import FaultPolicy, InjectionCampaign
from repro_torch.api.registry import (AssignmentBackend, BackendCapabilityError,
                                      get_backend, register_backend)

__all__ = [
    "KMeans", "NotFittedError", "FaultPolicy", "InjectionCampaign",
    "AssignmentBackend", "BackendCapabilityError", "get_backend",
    "register_backend",
]
