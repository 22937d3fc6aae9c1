"""The assembled k-means serving stack: compiler + batcher + store
(counterpart of ``repro.serve.service``).

:class:`KMeansService` is the estimator-to-serving handoff
(``KMeans.to_service()``): it freezes the fitted model's predict backend
into bucketed predict cells (:class:`~repro_torch.serve.compiler.
ServeCompiler`, one CUDA graph a bucket on the card), funnels requests
through the port's :class:`~repro_torch.serve.batcher.MicroBatcher` and
reads centroids from a versioned :class:`~repro_torch.serve.store.
CodebookStore`, so refinement can ``publish`` without pausing predicts.
Each micro-batch captures one codebook when it flushes: every request in it
is answered from one centroid version, recorded on its result.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.serve.batcher import MicroBatcher
from repro_torch.serve.compiler import DEFAULT_BUCKETS, ServeCompiler
from repro_torch.serve.store import CodebookStore


@dataclasses.dataclass(frozen=True)
class ServeResult:
    """One request's answer: per-row labels (int32) and true squared
    distances (f32) as host numpy arrays, the detection count of the
    micro-batch it shared, and the codebook version it was served from."""

    labels: np.ndarray
    sq_dists: np.ndarray
    detected: np.ndarray
    version: int


class KMeansService:
    """Online predict service over a fitted k-means model.

    ``predict`` enqueues a (rows, F) request and waits on its ticket; with
    the window loop running (``start``) requests from many threads share
    launches, otherwise each ``predict`` flushes at once (deterministic: the
    tests' and benchmarks' mode). ``publish`` hot-swaps centroids;
    ``refine`` runs one ``partial_fit`` of the wrapped estimator on recent
    traffic and publishes the result. ``on_dispatch(codebook)`` is called
    after a flush pins its version and before the launch."""

    def __init__(self, compiler: ServeCompiler, store: CodebookStore, *,
                 window_s: float = 0.0, estimator: Optional[Any] = None,
                 on_dispatch: Optional[Callable] = None) -> None:
        shape = store.current().shape
        if (compiler.n_clusters, compiler.n_features) != shape:
            raise ValueError(f"compiler cells are ({compiler.n_clusters}, "
                             f"{compiler.n_features}), store serves {shape}")
        if compiler.device != store.device:
            raise ValueError(f"compiler cells are on {compiler.device}, the "
                             f"store's codebooks on {store.device}")
        self.compiler = compiler
        self.store = store
        self.estimator = estimator
        self._on_dispatch = on_dispatch
        self.batcher = MicroBatcher(self._dispatch, window_s=window_s)

    @classmethod
    def from_estimator(cls, estimator: Any, *,
                       buckets: Optional[tuple[int, ...]] = None,
                       window_s: Optional[float] = None,
                       on_dispatch: Optional[Callable] = None
                       ) -> "KMeansService":
        """The serving stack of a fitted :class:`~repro_torch.api.KMeans`
        on its device, through its predict backend at its compute dtype.
        Bucket ladder and window default to the plan stored in the
        estimator's autotune cache, else ``DEFAULT_BUCKETS`` and no
        window."""
        centroids = estimator.cluster_centers_
        k, f = centroids.shape
        if buckets is None or window_s is None:
            plan = estimator.autotune.lookup_ladder(
                k, f, dtype=estimator.compute_dtype)
            if buckets is None:
                buckets = plan[0] if plan else DEFAULT_BUCKETS
            if window_s is None:
                window_s = plan[1] * 1e-6 if plan else 0.0
        compiler = ServeCompiler(
            estimator._predict_backend(), k, f, buckets=buckets,
            dtype=estimator.compute_dtype, autotune=estimator.autotune,
            params=estimator.params, device=estimator.device)
        return cls(compiler, CodebookStore(centroids), window_s=window_s,
                   estimator=estimator, on_dispatch=on_dispatch)

    # -- request path ------------------------------------------------------

    def _dispatch(self, batch: Any) -> tuple:
        cb = self.store.current()   # pin the version for the whole batch
        if self._on_dispatch is not None:
            self._on_dispatch(cb)
        am, md, det = self.compiler.dispatch(batch, cb.centroids)
        return am, md, det, cb.version

    def predict(self, x: Any) -> ServeResult:
        """Serve one (rows, F) request (rows may be zero)."""
        ticket = self.batcher.submit(x)
        if not self.batcher.running:
            self.batcher.flush()
        am, md, det, version = ticket.result()
        return ServeResult(am.numpy(), md.numpy(), det.numpy(), version)

    def start(self) -> None:
        """Run the micro-batch window loop (concurrent serving)."""
        self.batcher.start()

    def stop(self) -> None:
        self.batcher.stop()

    # -- refinement / hot-swap ---------------------------------------------

    def publish(self, centroids: Any) -> int:
        """Hot-swap: make ``centroids`` the current codebook; batches in
        flight finish on the version they captured. Returns the new
        version."""
        return self.store.publish(centroids).version

    def refine(self, x: Any) -> int:
        """One refinement step: ``partial_fit`` the wrapped estimator on
        recent traffic ``x`` and publish the moved centroids."""
        if self.estimator is None:
            raise ValueError(
                "service was built without an estimator (a plain "
                "ServeCompiler + CodebookStore); publish() refined "
                "centroids directly instead")
        self.estimator.partial_fit(x)
        return self.publish(self.estimator.cluster_centers_)

    # -- serialisation -----------------------------------------------------

    def get_state(self) -> dict:
        """Host snapshot: the codebook store (bit for bit) and the serving
        configuration under the reference's keys; the wrapped estimator
        through its own ``get_state``."""
        return {
            "store": self.store.get_state(),
            "config": {
                "backend": self.compiler.backend.name,
                "n_clusters": self.compiler.n_clusters,
                "n_features": self.compiler.n_features,
                "buckets": list(self.compiler.buckets),
                "dtype": str(self.compiler.dtype).replace("torch.", ""),
                "window_us": self.batcher.window_s * 1e6,
            },
            "estimator": (None if self.estimator is None
                          else self.estimator.get_state()),
        }

    @classmethod
    def from_state(cls, state: dict, *,
                   device: Any = None) -> "KMeansService":
        """Rebuild a service from :meth:`get_state` output (or from
        ``repro_torch.convert.from_reference_service_state``) on
        ``device``: the given one, else the estimator state's, else
        "cuda"."""
        from repro_torch.api.estimator import KMeans
        from repro_torch.api.registry import get_backend
        cfg = state["config"]
        estimator = None
        if state.get("estimator") is not None:
            estimator = KMeans.from_state(state["estimator"], device=device)
            device = estimator.device
        store = CodebookStore.from_state(state["store"], device=device)
        compiler = ServeCompiler(
            get_backend(cfg["backend"]), cfg["n_clusters"],
            cfg["n_features"], buckets=tuple(cfg["buckets"]),
            dtype=cfg["dtype"],
            autotune=None if estimator is None else estimator.autotune,
            params=None if estimator is None else estimator.params,
            device=store.device)
        return cls(compiler, store, window_s=cfg["window_us"] * 1e-6,
                   estimator=estimator)


__all__ = ["KMeansService", "ServeResult"]
