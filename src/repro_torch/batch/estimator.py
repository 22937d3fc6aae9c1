"""Batched many-problem K-means estimator (counterpart of
``repro.batch.estimator``).

One :class:`BatchedKMeans` fits B independent problems at once, on the card
by default:

    bkm = BatchedKMeans(n_clusters=256)
    bkm.fit(x)                  # x (B, N, F): B stacked problems
    labels = bkm.predict(x)     # (B, N) per-problem labels
    state = bkm.get_state()

Every Lloyd step is one launch of the batched one-pass kernel over all B
problems. The loop runs in Python in ``sync_every``-step chunks: per-problem
``done`` flags on the device freeze converged problems in place without
desynchronising the batch, and the host reads once per chunk and once at
the end, through the counted ``_host_read``. Problem b seeds from
``random_state + b``, so at ``tol=0`` it is, bit for bit, the single-problem
``KMeans(backend="lloyd", random_state=random_state + b)`` fit, at every
compute dtype.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.api.cache import AutotuneCache, default_cache
from repro_torch.api.estimator import (NotFittedError, _dtype_name,
                                       _host_read, resolve_device)
from repro_torch.api.registry import (AssignmentBackend, BackendCapabilityError,
                                      get_backend)
from repro_torch.core import kmeans as km_mod
from repro_torch.kernels import kmeanspp_init, ops

_INITS = ("kmeans++", "random", "kmeans++-fused")
_COMPUTE_DTYPES = ("float32", "bfloat16", "float16")


class BatchedKMeans:
    """K-means over B stacked independent problems, one launch per step.

    Parameters are the reference's (``n_clusters``, ``max_iter``, ``tol``,
    ``init``, ``backend``, ``params``, ``sync_every``, ``compute_dtype``,
    ``random_state``, ``autotune``) plus ``device`` ("cuda" by default,
    "cpu" for the kernels' plain versions). Tiles are explicit
    ``KernelParams`` or the ``autotune`` table's winner of the ``batched``
    kind at the compute dtype and the stack's B bucket (default table: the
    process cache), clamped to one problem's shape. ``compute_dtype`` is
    "float32", "bfloat16" or "float16", as in
    the reference: X is cast once per fit (the plan) and the centroids per
    step, at the kernel boundary; seeding runs on the uncast f32 rows, and
    centroids, distances and inertia stay f32.

    ``init``: "kmeans++" and "random" seed problem b as
    ``KMeans(random_state=random_state + b).init_centroids(x[b])`` does;
    "kmeans++-fused" runs D^2 sampling for the whole stack through the
    ``kmeanspp_round`` kernel, one launch per round (same distribution,
    another stream of draws).

    Attributes: ``cluster_centers_`` (B, K, F) f32 and ``labels_`` (B, N)
    int32 tensors on ``device``; ``inertia_`` (B,) float64 and ``n_iter_``
    (B,) int64 numpy arrays; ``detected_errors_`` (always 0: the batched
    kernel has no FT template, as in the reference) and ``_n_host_syncs``.
    """

    def __init__(self, n_clusters: int = 8, *, max_iter: int = 100,
                 tol: float = 1e-4, init: str = "kmeans++",
                 backend: Optional[str] = None,
                 params: Optional[ops.KernelParams] = None,
                 autotune: Optional[AutotuneCache] = None,
                 sync_every: int = 10, compute_dtype: Any = "float32",
                 random_state: int = 0, device: Any = "cuda") -> None:
        if n_clusters < 1:
            raise ValueError(f"n_clusters must be >= 1, got {n_clusters}")
        if init not in _INITS:
            raise ValueError(f"init must be one of {_INITS}, got {init!r}")
        if sync_every < 1:
            raise ValueError(f"sync_every must be >= 1, got {sync_every}")
        dtype = _dtype_name(compute_dtype)
        if dtype not in _COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of "
                             f"{_COMPUTE_DTYPES}, got {compute_dtype!r}")
        self.n_clusters = n_clusters
        self.max_iter = max_iter
        self.tol = tol
        self.init = init
        self.backend = backend
        self.params = params
        self.autotune = autotune if autotune is not None else default_cache()
        self.sync_every = sync_every
        self.compute_dtype = getattr(torch, dtype)
        self.random_state = random_state
        self.device = resolve_device(device)

        self._backend: AssignmentBackend = self._resolve_backend(backend)
        self._n_host_syncs: int = 0

        self.cluster_centers_: Optional[torch.Tensor] = None
        self.labels_: Optional[torch.Tensor] = None
        self.inertia_: Optional[np.ndarray] = None
        self.n_iter_: Optional[np.ndarray] = None
        self.detected_errors_: int = 0

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------

    @staticmethod
    def _resolve_backend(name: Optional[str]) -> AssignmentBackend:
        """The batched kernel unless another registered backend is named;
        it must declare ``supports_batch`` (the stacked (B, N, F) contract
        does not fit a single-problem backend) and take tiles."""
        backend = get_backend(name or "lloyd_batched")
        if not (backend.supports_batch and backend.takes_params):
            raise BackendCapabilityError(
                f"BatchedKMeans needs a supports_batch backend that takes "
                f"tiles (stacked (B, N, F) contract), but {backend.name!r} "
                f"declares supports_batch={backend.supports_batch}, "
                f"takes_params={backend.takes_params}; use 'lloyd_batched'")
        return backend

    def _check_fitted(self) -> None:
        if self.cluster_centers_ is None:
            raise NotFittedError("this BatchedKMeans instance is not fitted "
                                 "yet; call fit() first")

    def _cast(self, a: torch.Tensor) -> torch.Tensor:
        """Cast to the compute dtype at the kernel boundary (a no-op at
        f32)."""
        return a.to(self.compute_dtype)

    def _stack(self, x: Any) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x, dtype=np.float32)
            if not x.flags.writeable:       # e.g. a view of a jax array
                x = x.copy()
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        if x.dim() != 3 or x.shape[0] < 1:
            raise ValueError(f"BatchedKMeans wants stacked (B, N, F) "
                             f"problems with B >= 1, got shape "
                             f"{tuple(x.shape)}; use repro_torch.api.KMeans "
                             f"for one problem")
        return x

    def _resolve_params(self, bsz: int, n: int,
                        f: int) -> ops.KernelParams:
        if self.params is not None:
            p = self.params
        else:
            _, p = self.autotune.lookup(n, self.n_clusters, f,
                                        kind=self._backend.kernel_kind,
                                        dtype=self.compute_dtype, batch=bsz)
        return ops.clamp_params(n, self.n_clusters, f, p)

    def init_centroids(self, x: Any) -> torch.Tensor:
        """Per-problem seeding: (B, K, F) from the (B, N, F) stack, problem b
        drawing from ``random_state + b``."""
        x = self._stack(x)
        seeds = [self.random_state + b for b in range(x.shape[0])]
        if self.init == "kmeans++-fused":
            return kmeanspp_init.init_kmeanspp_fused(x, self.n_clusters,
                                                     seeds)
        fn = km_mod.init_kmeanspp if self.init == "kmeans++" \
            else km_mod.init_random
        out = []
        for xb, seed in zip(x, seeds):
            gen = torch.Generator(device=x.device)
            gen.manual_seed(seed)
            out.append(fn(gen, xb, self.n_clusters))
        return torch.stack(out)

    # ------------------------------------------------------------------
    # estimator API
    # ------------------------------------------------------------------

    def fit(self, x: Any, *, centroids: Any = None) -> "BatchedKMeans":
        """Batched Lloyd iterations to per-problem convergence (or
        ``max_iter``). ``centroids`` (B, K, F) warm-starts the run."""
        x = self._stack(x)
        if centroids is None:
            centroids = self.init_centroids(x)
        centroids = self._stack(centroids)
        bsz, n, f = x.shape
        if centroids.shape != (bsz, self.n_clusters, f):
            raise ValueError(f"centroids must be {(bsz, self.n_clusters, f)},"
                             f" got {tuple(centroids.shape)}")
        params = self._resolve_params(bsz, n, f)
        # the plan holds X in the compute dtype; reseeding donors are its
        # rows (the reference's plan.x), the seeds came from the f32 rows
        plan = ops.plan_data_batched(self._cast(x), params)
        dev = x.device

        am = torch.zeros((bsz, n), dtype=torch.int32, device=dev)
        inertia = torch.full((bsz,), float("inf"), device=dev)
        done = torch.zeros(bsz, dtype=torch.bool, device=dev)
        det = torch.zeros((), dtype=torch.int32, device=dev)
        iters = np.zeros(bsz, np.int64)
        it0 = 0
        self._n_host_syncs = 0
        while it0 < self.max_iter:
            n_steps = min(self.sync_every, self.max_iter - it0)
            live_hist = []
            for _ in range(n_steps):
                am_n, md, det_i, sums, counts = self._backend(
                    plan, self._cast(centroids), params=params)
                new_c = km_mod.means_from_sums(sums, counts, centroids)
                shift = ((new_c - centroids) ** 2).sum((1, 2)).sqrt()
                new_c = km_mod.reseed_empty(plan.x, new_c, counts, md)
                # a converged problem freezes: later steps pass its state on
                live = ~done
                centroids = torch.where(live[:, None, None], new_c, centroids)
                am = torch.where(live[:, None], am_n, am)
                inertia = torch.where(live, md.sum(1), inertia)
                done = done | (shift < self.tol)
                det = det + det_i.to(torch.int32)
                live_hist.append(live)
            # the chunk boundary: the only device->host read of the window
            done_h, live_h = _host_read((done, torch.stack(live_hist)))
            self._n_host_syncs += 1
            iters += live_h.numpy().sum(0).astype(np.int64)
            it0 += n_steps
            if bool(done_h.all()):
                break

        inertia_h, det_h = _host_read((inertia, det))
        self._n_host_syncs += 1
        self.cluster_centers_ = centroids
        self.labels_ = am
        self.inertia_ = inertia_h.numpy().astype(np.float64)
        self.n_iter_ = np.maximum(iters, 1)
        self.detected_errors_ = int(det_h)
        return self

    def fit_predict(self, x: Any) -> torch.Tensor:
        """Fit the B problems and return ``labels_`` (B, N)."""
        return self.fit(x).labels_

    def _assign(self, x: torch.Tensor) -> tuple:
        """(labels, true squared distances) through the batched kernel, its
        update outputs dropped, as the reference's ``_assign`` does."""
        c = self.cluster_centers_
        if x.shape[0] != c.shape[0] or x.shape[2] != c.shape[2]:
            raise ValueError(
                f"predict wants (B, N, F) with B={c.shape[0]} fitted "
                f"problems of F={c.shape[2]} features, got shape "
                f"{tuple(x.shape)}")
        params = self._resolve_params(*x.shape)
        return self._backend(self._cast(x), self._cast(c),
                             params=params)[:2]

    def predict(self, x: Any) -> torch.Tensor:
        """Per-problem nearest-centroid labels (B, N') int32."""
        self._check_fitted()
        return self._assign(self._stack(x))[0]

    def score(self, x: Any) -> np.ndarray:
        """Per-problem negative inertia on ``x`` (higher is better), (B,)."""
        self._check_fitted()
        _, md = self._assign(self._stack(x))
        return -_host_read(md.sum(1)).numpy().astype(np.float64)

    # ------------------------------------------------------------------
    # serializable state
    # ------------------------------------------------------------------

    def get_state(self) -> dict:
        """Fitted state as a flat dict of plain types and numpy arrays, the
        reference's layout plus ``config["device"]``."""
        self._check_fitted()
        return {
            "cluster_centers": self.cluster_centers_.cpu().numpy(),
            "n_iter": np.asarray(self.n_iter_),
            "inertia": (None if self.inertia_ is None
                        else np.asarray(self.inertia_)),
            "detected_errors": int(self.detected_errors_),
            "config": {
                "n_clusters": self.n_clusters,
                "max_iter": self.max_iter,
                "tol": self.tol,
                "init": self.init,
                "backend": self.backend,
                "sync_every": self.sync_every,
                "compute_dtype": _dtype_name(self.compute_dtype),
                "random_state": self.random_state,
                "params": (None if self.params is None else
                           [self.params.block_m, self.params.block_k,
                            self.params.block_f]),
                "device": str(self.device),
            },
        }

    @classmethod
    def from_state(cls, state: dict, *, device: Any = None,
                   autotune: Optional[AutotuneCache] = None
                   ) -> "BatchedKMeans":
        """Rebuild a fitted estimator from :meth:`get_state` output (or from
        ``repro_torch.convert.from_reference_batched_state``). ``device``
        overrides the state's; the default is "cuda". ``autotune`` is the
        new estimator's tile table."""
        cfg = state["config"]
        tiles = cfg.get("params")
        bkm = cls(cfg["n_clusters"], max_iter=cfg["max_iter"], tol=cfg["tol"],
                  init=cfg["init"], backend=cfg["backend"],
                  params=None if tiles is None else ops.KernelParams(*tiles),
                  sync_every=cfg.get("sync_every", 10),
                  compute_dtype=cfg.get("compute_dtype", "float32"),
                  random_state=cfg["random_state"], autotune=autotune,
                  device=device or cfg.get("device") or "cuda")
        bkm.cluster_centers_ = bkm._stack(state["cluster_centers"])
        bkm.n_iter_ = np.asarray(state["n_iter"])
        inertia = state.get("inertia")
        bkm.inertia_ = None if inertia is None else np.asarray(inertia)
        bkm.detected_errors_ = int(state.get("detected_errors", 0))
        return bkm
