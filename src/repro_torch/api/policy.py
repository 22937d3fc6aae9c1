"""Typed fault-tolerance policy (counterpart of ``repro.api.policy``).

``mode`` sets the protection of the assignment step: ``"off"`` (no
checksums), ``"detect"`` (offline checksums on the materialised product,
the Wu-et-al. baseline, backend ``abft_offline``) or ``"correct"`` (the
fused online ABFT detect -> locate -> correct kernel, resolved to the
one-pass FT kernel, whose epilogue checksums also protect the update).
``update_dmr`` protects the update of two-pass backends; ``injection``
attaches an SEU campaign (§V-C); ``worker_loss`` is the answer to a
whole-worker (fail-stop) loss in a distributed fit: ``"fail"`` raises
:class:`~repro_torch.ft.elastic.WorkerLossError`, ``"shrink"`` lets
``DistributedKMeans.fit_elastic`` shrink the mesh, restore the last
snapshot and resume. Resolution is the same on every device:
``off`` -> ``fused``, ``detect`` -> ``abft_offline``, ``correct`` and any
campaign -> ``lloyd_ft`` (in-kernel injection is its surface).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.api.registry import (AssignmentBackend, BackendCapabilityError,
                                      get_backend)

MODES = ("off", "detect", "correct")
TARGETS = ("auto", "distance", "update", "both")
WORKER_LOSS = ("fail", "shrink")


@dataclasses.dataclass(frozen=True)
class InjectionCampaign:
    """SEU injection campaign (paper §II-A): ``rate`` expected injections
    per Lloyd step (Bernoulli for ``rate <= 1``), ``targets`` the intervals
    it may corrupt (``"distance"``, ``"update"``, ``"both"`` or ``"auto"``
    = every interval the backend protects), ``seed`` the schedule's seed."""

    rate: float = 1.0
    seed: int = 0
    targets: str = "auto"

    def __post_init__(self) -> None:
        if self.rate < 0:
            raise ValueError(f"InjectionCampaign.rate must be >= 0, "
                             f"got {self.rate}")
        if self.targets not in TARGETS:
            raise ValueError(f"InjectionCampaign.targets must be one of "
                             f"{TARGETS}, got {self.targets!r}")

    def enabled(self) -> bool:
        return self.rate > 0

    def resolved_targets(self, backend: AssignmentBackend) -> tuple[str, ...]:
        """The concrete interval list for a resolved backend."""
        one_pass_ft = backend.fuses_update and backend.takes_injection
        if self.targets in ("update", "both") and not one_pass_ft:
            raise BackendCapabilityError(
                f"injection targets={self.targets!r} corrupts the update "
                f"epilogue, which only a one-pass FT backend protects; "
                f"backend {backend.name!r} is not one -- use "
                f"backend='lloyd_ft' or targets='distance'")
        if self.targets == "distance":
            return ("distance",)
        if self.targets == "update":
            return ("update",)
        return ("distance", "update") if one_pass_ft else ("distance",)


@dataclasses.dataclass(frozen=True)
class FaultPolicy:
    """Protection policy for one estimator; :meth:`resolve_backend` picks
    the kernel."""

    mode: str = "off"
    update_dmr: Optional[bool] = None
    injection: Optional[InjectionCampaign] = None
    worker_loss: str = "fail"

    def __post_init__(self) -> None:
        if self.mode not in MODES:
            raise ValueError(f"FaultPolicy.mode must be one of {MODES}, "
                             f"got {self.mode!r}")
        if self.worker_loss not in WORKER_LOSS:
            raise ValueError(f"FaultPolicy.worker_loss must be one of "
                             f"{WORKER_LOSS}, got {self.worker_loss!r}")
        if self.injection is not None and self.mode == "off":
            raise ValueError(
                "an injection campaign needs a protected assignment backend; "
                "use mode='correct' (or 'detect') with injection=...")

    @classmethod
    def off(cls) -> "FaultPolicy":
        """No protection anywhere (performance baseline)."""
        return cls(mode="off", update_dmr=False)

    @classmethod
    def detect(cls, *, update_dmr: Optional[bool] = None,
               injection: Optional[InjectionCampaign] = None
               ) -> "FaultPolicy":
        """Offline ABFT on the materialised product (``abft_offline``), DMR
        on its two-pass update by default."""
        return cls(mode="detect", update_dmr=update_dmr, injection=injection)

    @classmethod
    def correct(cls, *, update_dmr: Optional[bool] = None,
                injection: Optional[InjectionCampaign] = None
                ) -> "FaultPolicy":
        return cls(mode="correct", update_dmr=update_dmr, injection=injection)

    @classmethod
    def elastic(cls, *, mode: str = "correct",
                update_dmr: Optional[bool] = None,
                injection: Optional[InjectionCampaign] = None
                ) -> "FaultPolicy":
        """The whole ladder: SEUs corrected in the kernel (``mode="correct"``
        by default), whole-worker losses survived by shrinking the mesh and
        restoring the last snapshot (``worker_loss="shrink"``)."""
        return cls(mode=mode, update_dmr=update_dmr, injection=injection,
                   worker_loss="shrink")

    @property
    def protected(self) -> bool:
        return self.mode != "off"

    def dmr_enabled(self, backend: AssignmentBackend) -> bool:
        """DMR never on one-pass backends, on by default for two-pass."""
        if backend.fuses_update:
            return False
        return True if self.update_dmr is None else self.update_dmr

    def resolve_backend(self, name: Optional[str] = None) -> AssignmentBackend:
        """Pick the assignment backend: ``name`` pins one (validated against
        the policy); otherwise a campaign -> ``lloyd_ft`` (it hosts
        ``detect``-mode campaigns too), ``off`` -> ``fused``, ``detect`` ->
        ``abft_offline``, ``correct`` -> ``lloyd_ft``."""
        if name is None:
            if self.injection is not None or self.mode == "correct":
                name = "lloyd_ft"
            elif self.mode == "detect":
                name = "abft_offline"
            else:
                name = "fused"
        backend = get_backend(name)
        if backend.supports_batch:
            raise BackendCapabilityError(
                f"backend {backend.name!r} is a batched (supports_batch) "
                f"backend with a stacked (B, N, F) contract; KMeans drives "
                f"single (M, F) problems -- use repro_torch.batch."
                f"BatchedKMeans for problem stacks")
        if self.protected and not backend.supports_ft:
            raise BackendCapabilityError(
                f"FaultPolicy(mode={self.mode!r}) needs a fault-tolerant "
                f"assignment backend, but {backend.name!r} declares "
                f"supports_ft=False")
        if self.injection is not None:
            if not backend.takes_injection:
                raise BackendCapabilityError(
                    f"injection campaign requires takes_injection=True, but "
                    f"backend {backend.name!r} cannot inject in-kernel; use "
                    f"backend='lloyd_ft' (or 'fused_ft')")
            self.injection.resolved_targets(backend)
        return backend
