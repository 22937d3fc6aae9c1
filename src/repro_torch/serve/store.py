"""Versioned centroid store, the serving side of the hot-swap protocol
(counterpart of ``repro.serve.store``).

A serving process has two loops on the centroids: the predict path reads
them at every micro-batch, and a refinement loop (``KMeans.partial_fit`` on
recent traffic) moves them. Instead of a lock around one mutable tensor the
store holds immutable versioned codebooks, and ``publish`` swaps a
reference: a batch captures one :class:`Codebook` when it flushes and
finishes on it, so it never sees a half-updated centroid set, and the next
batch takes the new version without a pause.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Codebook:
    """One published centroid set: (K, F) f32 on the serving device, a
    private copy nothing writes to, tagged with its version."""

    version: int
    centroids: torch.Tensor

    @property
    def shape(self) -> tuple[int, int]:
        return (self.centroids.shape[0], self.centroids.shape[1])


def _frozen(centroids: Any, device: torch.device) -> torch.Tensor:
    """A private f32 copy of ``centroids`` on ``device``."""
    if isinstance(centroids, torch.Tensor):
        return centroids.detach().to(device=device, dtype=torch.float32,
                                     copy=True)
    return torch.tensor(np.asarray(centroids, np.float32), device=device)


class CodebookStore:
    """Thread-safe history of published codebooks.

    ``publish`` is the only mutation: it freezes the centroids as the next
    version and makes it current. ``current()`` is a locked reference read
    that never waits on the device, so the predict path can call it at every
    flush. The last ``keep`` versions stay retrievable for batches that
    captured them mid-swap. ``device`` is where the codebooks live: the
    given tensor's device by default, else "cuda"; ``get_state`` /
    ``from_state`` round-trip every retained codebook bit for bit, as numpy
    dicts that interchange with the reference's."""

    def __init__(self, centroids: Any, *, keep: int = 8,
                 device: Any = None, _version: int = 1) -> None:
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        if device is None:
            device = centroids.device if isinstance(
                centroids, torch.Tensor) else "cuda"
        from repro_torch.api.estimator import resolve_device
        self.device = resolve_device(device)
        self._keep = keep
        self._lock = threading.Lock()
        self._current = Codebook(_version, _frozen(centroids, self.device))
        self._history: dict[int, Codebook] = {_version: self._current}

    def publish(self, centroids: Any) -> Codebook:
        """Freeze ``centroids`` as the next version and make it current.
        Batches in flight keep the codebook they captured; the next flush
        serves this one. Another (K, F) is refused: the predict cells are
        built for one model shape, and a new shape is a new service."""
        frozen = _frozen(centroids, self.device)
        with self._lock:
            cur = self._current
            if frozen.shape != cur.centroids.shape:
                raise ValueError(
                    f"published centroids have shape {tuple(frozen.shape)}, "
                    f"the store serves {tuple(cur.centroids.shape)}; the "
                    f"predict cells are built for one (K, F), so a model-"
                    f"shape change is a new service, not a hot-swap")
            cb = Codebook(cur.version + 1, frozen)
            self._history[cb.version] = cb
            self._current = cb
            while len(self._history) > self._keep:
                del self._history[min(self._history)]
            return cb

    def current(self) -> Codebook:
        """The codebook new batches capture."""
        with self._lock:
            return self._current

    def get(self, version: int) -> Codebook:
        """A retained version (KeyError once evicted)."""
        with self._lock:
            try:
                return self._history[version]
            except KeyError:
                raise KeyError(
                    f"codebook version {version} not retained (window keeps "
                    f"{self._keep}; have {sorted(self._history)})") from None

    @property
    def versions(self) -> tuple[int, ...]:
        with self._lock:
            return tuple(sorted(self._history))

    # -- serialisation -----------------------------------------------------

    def get_state(self) -> dict:
        """Host snapshot: every retained version's centroids as f32 numpy
        arrays, the current version and ``keep`` (the reference's keys)."""
        with self._lock:
            history = dict(self._history)
            cur = self._current.version
        return {"keep": self._keep, "current": cur,
                "codebooks": {str(v): cb.centroids.cpu().numpy()
                              for v, cb in history.items()}}

    @classmethod
    def from_state(cls, state: dict,
                   device: Optional[Any] = None) -> "CodebookStore":
        """Rebuild a store (this package's or the reference's state) on
        ``device`` ("cuda" by default)."""
        versions = sorted(int(v) for v in state["codebooks"])
        if not versions:
            raise ValueError("store state holds no codebooks")
        store = cls(state["codebooks"][str(versions[0])], keep=state["keep"],
                    device=device or "cuda", _version=versions[0])
        for v in versions[1:]:
            store._history[v] = Codebook(v, _frozen(
                state["codebooks"][str(v)], store.device))
        store._current = store._history[int(state["current"])]
        return store


__all__ = ["Codebook", "CodebookStore"]
