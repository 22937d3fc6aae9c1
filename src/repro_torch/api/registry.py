"""Assignment-backend registry (counterpart of ``repro.api.registry``).

Every assignment implementation is an :class:`AssignmentBackend` with
declared capabilities and one call signature

    backend(x, c, *, params=None, inj=None, bounds=None)
        -> (assign, min_dist, detected)

extended by ``(sums, counts)`` for one-pass backends and further by
``(new_bounds, prune_frac)`` for pruned ones, so the estimator
never branches on backend names. Capability mismatches are rejected here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch


class BackendCapabilityError(TypeError):
    """A backend was asked for a capability it does not declare."""


@dataclasses.dataclass(frozen=True)
class AssignmentBackend:
    """One cluster-assignment implementation plus its capability flags.

    supports_ft:     detects and corrects SDCs, counting them.
    takes_params:    accepts ``KernelParams`` and a prebuilt ``DataPlan``.
    takes_injection: accepts an in-kernel SEU injection descriptor.
    fuses_update:    one-pass backend returning ``(assign, min_dist,
                     detected, sums, counts)``.
    supports_batch:  many-problem backend: ``x`` is a (B, N, F) stack (or a
                     ``BatchPlan``), ``c`` (B, K, F), and every output
                     carries a leading B axis. Only ``BatchedKMeans`` drives
                     it; ``KMeans`` refuses it.
    supports_bounds: pruned backend: takes the carried ``bounds`` state
                     (``ops.BoundsState``) and returns the 7-tuple
                     ``(assign, min_dist, detected, sums, counts,
                     new_bounds, prune_frac)``. ``bounds=None`` (or a fresh
                     state from ``bounds_init``) computes every tile.
    supports_int8:   quantised-distance backend: ``x`` may be an
                     ``ops.QuantPlan``; bit-exact argmin against the f32
                     backends on quantisation-safe data.
    bounds_init:     for ``supports_bounds`` backends, ``(m, k, f, params,
                     *, device) -> state``, the fresh state of a fit's first
                     step.
    """

    name: str
    fn: Callable
    supports_ft: bool = False
    takes_params: bool = False
    takes_injection: bool = False
    fuses_update: bool = False
    supports_batch: bool = False
    supports_bounds: bool = False
    supports_int8: bool = False
    bounds_init: Optional[Callable] = None
    doc: str = ""

    @property
    def kernel_kind(self) -> str:
        """The kernel family whose tiles this backend uses: the int8
        kernel, the batched one-pass kernel, the pruned one-pass kernel, the
        assignment-only kernel, the one-pass kernel or the one-pass FT
        kernel."""
        if self.supports_int8:
            return "int8"
        if self.supports_batch:
            return "batched"
        if self.supports_bounds:
            return "pruned"
        if self.fuses_update:
            return "lloyd_ft" if self.supports_ft else "lloyd"
        return "assign"

    @property
    def protected_intervals(self) -> int:
        """Independently verified SEU intervals per step (§II-A: at most
        one error per interval): the distance GEMM and, for one-pass FT
        backends, the update epilogue."""
        if not self.takes_injection:
            return 0
        return 2 if self.fuses_update else 1

    def __call__(self, x: Any, c: torch.Tensor, *, params: Any = None,
                 inj: Optional[torch.Tensor] = None,
                 bounds: Any = None) -> Any:
        if inj is not None and not self.takes_injection:
            raise BackendCapabilityError(
                f"backend {self.name!r} does not take in-kernel injections "
                f"(takes_injection=False)")
        if params is not None and not self.takes_params:
            raise BackendCapabilityError(
                f"backend {self.name!r} does not take kernel parameters "
                f"(takes_params=False)")
        if bounds is not None and not self.supports_bounds:
            raise BackendCapabilityError(
                f"backend {self.name!r} does not carry pruning bounds "
                f"(supports_bounds=False); use a pruned backend or drop "
                f"the bounds state")
        if self.supports_bounds:
            return self.fn(x, c, params, bounds=bounds)
        if self.takes_injection:
            return self.fn(x, c, params, inj=inj)
        if self.takes_params:
            return self.fn(x, c, params)
        return self.fn(x, c)


# name -> backend, filled once when repro_torch.core.assignment is imported
_REGISTRY: dict[str, AssignmentBackend] = {}


def register_backend(backend: AssignmentBackend) -> AssignmentBackend:
    _REGISTRY[backend.name] = backend
    return backend


def get_backend(name: str) -> AssignmentBackend:
    _ensure_builtin_backends()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown assignment backend {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def _ensure_builtin_backends() -> None:
    from repro_torch.core import assignment  # noqa: F401  (registers)
