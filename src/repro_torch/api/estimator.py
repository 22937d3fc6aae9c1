"""cuML/sklearn-shaped K-means estimator over the port's kernels
(counterpart of ``repro.api.estimator``).

    km = KMeans(n_clusters=8, fault=FaultPolicy.correct())   # on the card
    labels = km.fit_predict(x)
    km2 = KMeans.from_state(km.get_state())

Protection is a :class:`~repro_torch.api.policy.FaultPolicy`, resolved to a
registered assignment backend; tiles come from an injectable
:class:`~repro_torch.api.cache.AutotuneCache` (``autotune=``), keyed by the
backend's kernel kind and the compute dtype. The full-batch fit builds its
:class:`~repro_torch.kernels.ops.DataPlan` (a
:class:`~repro_torch.kernels.ops.QuantPlan` for ``compute_dtype="int8"``)
once, from X cast to the compute dtype (bf16 and fp16 plans hold 2-byte X;
only the (K, F) centroids are cast per step), and runs the Lloyd loop in
Python with the convergence test on the
device: a ``done`` flag freezes the remaining steps of a chunk, and the host
reads progress once per ``sync_every`` iterations, through
:func:`_host_read`. A pruned backend (``supports_bounds``) carries its
:class:`~repro_torch.kernels.ops.BoundsState` from step to step on the
device, from a fresh state at every fit; its per-step prune fractions cross
to the host in the same reads. A mini-batch fit (``batch_size=``) draws
the reference's batches from numpy and reads the host once an iteration;
``to_service()`` hands a fitted model to ``repro_torch.serve``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.api.cache import AutotuneCache, default_cache
from repro_torch.api.policy import FaultPolicy, InjectionCampaign
from repro_torch.api.registry import AssignmentBackend, get_backend
from repro_torch.core import fault as fault_mod
from repro_torch.core import kmeans as km_mod
from repro_torch.kernels import distance_argmin_ft as _daft
from repro_torch.kernels import ops, ref

_INITS = ("kmeans++", "random")
_COMPUTE_DTYPES = ("float32", "bfloat16", "float16", "int8")
_PREDICT_CHUNK_ROWS = 65_536


class NotFittedError(RuntimeError):
    pass


def _host_read(value: Any) -> Any:
    """The single device->host funnel of the fit loop: once per
    ``sync_every``-iteration chunk plus once for the final counters, so a
    test can count the reads by patching one name."""
    if isinstance(value, tuple):
        return tuple(_host_read(v) for v in value)
    return None if value is None else value.cpu()


def resolve_device(device: Any) -> torch.device:
    """The estimator's device. Asking for CUDA without a card raises: the
    port never drifts to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the kernels' plain versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev


def _dtype_name(dtype: Any) -> str:
    name = getattr(dtype, "name", None) or str(dtype)
    return name.replace("torch.", "")


class KMeans:
    """K-means estimator with composable fault tolerance.

    Parameters are the reference's (``n_clusters``, ``max_iter``, ``tol``,
    ``init``, ``fault``, ``backend``, ``params``, ``sync_every``,
    ``predict_chunk_rows``, ``random_state``) plus ``device`` ("cuda" by
    default, "cpu" for the plain versions). ``compute_dtype`` is
    "float32", "bfloat16", "float16" or "int8". bf16 and fp16 cast X (once
    per fit) and the centroids (per step) at the kernel boundary; the
    kernels multiply 2-byte tiles on the tensor cores into f32, and
    centroids, distances and inertia stay f32, but for ``detect``
    (``abft_offline``), whose product, norms and distances are in the
    compute dtype, as the reference's. int8 picks the quantised ``int8``
    backend (an unprotected, assignment-only kernel) and keeps X and the
    centroids f32 at the kernel boundary, since int8 is quantisation per
    row, not a cast. ``batch_size`` makes ``fit`` run sampled mini-batches
    of that many rows an iteration (``partial_fit`` streams the caller's
    blocks either way). ``autotune`` is the tile table (default: the
    process cache, ``default_cache()``); an explicit ``params`` wins over
    it. ``init`` is "kmeans++" or "random", as in the reference; the fused
    seeding belongs to :class:`~repro_torch.batch.BatchedKMeans`.

    Attributes: ``cluster_centers_`` (K, F) f32 and ``labels_`` (M,) int32
    tensors on ``device``; ``inertia_``, ``n_iter_``, ``detected_errors_``
    and ``_n_host_syncs`` plain numbers; ``prune_history_``, the pruned
    tile fraction of each step of the last fit on a pruned backend (empty
    otherwise).
    """

    def __init__(self, n_clusters: int = 8, *, max_iter: int = 100,
                 tol: float = 1e-4, init: str = "kmeans++",
                 fault: Optional[FaultPolicy] = None,
                 backend: Optional[str] = None,
                 batch_size: Optional[int] = None,
                 params: Optional[ops.KernelParams] = None,
                 autotune: Optional[AutotuneCache] = None,
                 sync_every: int = 10, compute_dtype: Any = "float32",
                 predict_chunk_rows: Optional[int] = None,
                 random_state: int = 0, device: Any = "cuda") -> None:
        if n_clusters < 1:
            raise ValueError(f"n_clusters must be >= 1, got {n_clusters}")
        if init not in _INITS:
            raise ValueError(f"init must be one of {_INITS}, got {init!r}")
        if sync_every < 1:
            raise ValueError(f"sync_every must be >= 1, got {sync_every}")
        dtype = _dtype_name(compute_dtype)
        if dtype not in _COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {_COMPUTE_DTYPES}"
                             f", got {compute_dtype!r}")
        if batch_size is not None and batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if predict_chunk_rows is not None and predict_chunk_rows < 1:
            raise ValueError(f"predict_chunk_rows must be >= 1, "
                             f"got {predict_chunk_rows}")
        self.n_clusters = n_clusters
        self.max_iter = max_iter
        self.tol = tol
        self.init = init
        self.fault = fault if fault is not None else FaultPolicy.off()
        self.backend = backend
        self.batch_size = batch_size
        self.params = params
        self.autotune = autotune if autotune is not None else default_cache()
        self.sync_every = sync_every
        self.compute_dtype = getattr(torch, dtype)
        self.predict_chunk_rows = predict_chunk_rows
        self.random_state = random_state
        self.device = resolve_device(device)

        is_int8 = dtype == "int8"
        if is_int8 and backend is None:
            # the quantised kernel is assignment-only; the policy still
            # validates the pick (int8 has no FT variant)
            backend = "int8"
        self._backend: AssignmentBackend = self.fault.resolve_backend(backend)
        if is_int8 != self._backend.supports_int8:
            raise ValueError(
                f"backend {self._backend.name!r} "
                + ("does not consume int8-quantized operands; pick a "
                   "supports_int8 backend or drop compute_dtype='int8'"
                   if is_int8 else
                   "is an int8 template and needs compute_dtype='int8'"))
        self._use_dmr = self.fault.dmr_enabled(self._backend)
        if self.fault.update_dmr and self._backend.fuses_update:
            warnings.warn(
                f"FaultPolicy.update_dmr is a two-pass-backend knob; backend "
                f"{self._backend.name!r} fuses the centroid update into the "
                f"kernel epilogue; the flag is ignored here",
                DeprecationWarning, stacklevel=2)
        self._n_host_syncs: int = 0
        self._counts: Optional[torch.Tensor] = None

        self.cluster_centers_: Optional[torch.Tensor] = None
        self.labels_: Optional[torch.Tensor] = None
        self.inertia_: Optional[float] = None
        self.n_iter_: int = 0
        self.detected_errors_: int = 0
        self.prune_history_: list = []

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------

    def _check_fitted(self) -> None:
        if self.cluster_centers_ is None:
            raise NotFittedError("this KMeans instance is not fitted yet; "
                                 "call fit() or partial_fit() first")

    def _cast(self, a: torch.Tensor) -> torch.Tensor:
        """Cast to the compute dtype at the kernel boundary (a no-op at f32).
        int8 is quantisation, not a cast: its boundary stays f32."""
        dt = torch.float32 if self.compute_dtype == torch.int8 \
            else self.compute_dtype
        return a.to(dt)

    def _plan(self, x: torch.Tensor, params: Optional[ops.KernelParams]):
        """The per-call data plan of X cast to the compute dtype: quantised
        for int8 backends, padded for the other tile backends. A backend
        without tiles (``gemm_fused``, ``abft_offline``) reads the plan's raw
        rows; its two-pass update reads the padded ones, at the tiles
        ``fused`` would use, so it sums as ``fused``'s update does and DMR
        recomputes only on a mismatch."""
        x = self._cast(x)
        if params is None:
            return ops.plan_data(x, self._tiles(x.shape[0], x.shape[1],
                                                "assign"))
        if self._backend.supports_int8:
            return ops.plan_data_int8(x, params)
        return ops.plan_data(x, params)

    def _tensor(self, x: Any) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x, dtype=np.float32)
            if not x.flags.writeable:       # e.g. a view of a jax array
                x = x.copy()
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _tiles(self, m: int, f: int, kind: str) -> ops.KernelParams:
        """Tiles of one kernel kind at one problem shape: the explicit
        override, else the autotune table's winner for the kind and the
        compute dtype, clamped to the shape."""
        if self.params is not None:
            p = self.params
        else:
            _, p = self.autotune.lookup(m, self.n_clusters, f, kind=kind,
                                        dtype=self.compute_dtype)
        return ops.clamp_params(m, self.n_clusters, f, p)

    def _resolve_params(self, m: int, f: int, *,
                        backend: Optional[AssignmentBackend] = None
                        ) -> Optional[ops.KernelParams]:
        """Tiles for one problem shape, by the backend's kernel kind (a
        one-pass backend never gets an assignment-only winner); None for a
        backend without tiles."""
        backend = backend if backend is not None else self._backend
        if not backend.takes_params:
            return None
        return self._tiles(m, f, backend.kernel_kind)

    def _predict_backend(self) -> AssignmentBackend:
        """Prediction is assignment-only, at the fit's protection level: a
        two-pass backend (``abft_offline`` too) predicts through itself, the
        one-pass FT backend through ``fused_ft``, the plain one-pass backend
        through ``fused``."""
        b = self._backend
        if not b.fuses_update:
            return b
        return get_backend("fused_ft" if b.supports_ft else "fused")

    def _apply_update(self, out: tuple, x: Any,
                      centroids: torch.Tensor) -> tuple:
        """One centroid update from a backend result: one-pass backends
        carry (sums, counts) (pruned ones then the bounds and the prune
        fraction); two-pass backends pay the second pass."""
        if self._backend.fuses_update:
            am, md, det, sums, counts = out[:5]
            new_c = km_mod.means_from_sums(sums, counts, centroids)
        else:
            am, md, det = out
            new_c, counts = km_mod.centroid_update(
                x, am, self.n_clusters, centroids, use_dmr=self._use_dmr)
        return am, md, det, new_c, counts

    def _campaign_rng(self, offset: int = 0) -> np.random.Generator:
        """Injection-schedule RNG, seeded exactly as the reference's."""
        camp = self.fault.injection
        camp_seed = camp.seed if camp is not None else 0
        return np.random.default_rng(
            [0x1427, camp_seed, self.random_state, offset])

    def _draw_injection(self, rng: np.random.Generator, m: int, f: int,
                        params: Optional[ops.KernelParams]) -> torch.Tensor:
        """Per-iteration campaign draw -> injection descriptor (CPU)."""
        camp = self.fault.injection
        kind = self._backend.kernel_kind
        if camp is None or not camp.enabled():
            return fault_mod.no_step_injection(kind)
        return fault_mod.draw_step_injection(
            rng, m, self.n_clusters, f, params, rate=camp.rate,
            targets=camp.resolved_targets(self._backend), kind=kind)

    def init_centroids(self, x: torch.Tensor,
                       gen: Optional[torch.Generator] = None) -> torch.Tensor:
        if gen is None:
            gen = torch.Generator(device=x.device)
            gen.manual_seed(self.random_state)
        fn = km_mod.init_kmeanspp if self.init == "kmeans++" \
            else km_mod.init_random
        return fn(gen, x, self.n_clusters)

    # ------------------------------------------------------------------
    # estimator API
    # ------------------------------------------------------------------

    def fit(self, x: Any, *, centroids: Any = None,
            on_iteration: Optional[Callable] = None) -> "KMeans":
        """Run Lloyd iterations to convergence (or ``max_iter``).

        ``centroids`` seeds the run (warm start); ``on_iteration(it,
        centroids, inertia, shift)`` is replayed from each chunk's history.
        """
        x = self._tensor(x)
        if centroids is None:
            centroids = self.init_centroids(x)
        centroids = self._tensor(centroids)
        if self.batch_size is not None:
            return self._fit_minibatch(x, centroids, on_iteration)
        return self._fit_fullbatch(x, centroids, on_iteration)

    def _fit_fullbatch(self, x: torch.Tensor, centroids: torch.Tensor,
                       on_iteration: Optional[Callable]) -> "KMeans":
        m, f = x.shape
        dev = x.device
        backend = self._backend
        params = self._resolve_params(m, f)
        takes_inj = backend.takes_injection
        inj_rng = self._campaign_rng()
        xa = self._plan(x, params)
        x_rows = ops.f32_plan(xa).x
        # a pruned fit starts from fresh bounds: a warm start or a restored
        # state never inherits bounds computed against other centroids
        bounds = backend.bounds_init(m, self.n_clusters, f, params,
                                     device=dev) \
            if backend.supports_bounds else None
        self.prune_history_ = []

        am = torch.zeros(m, dtype=torch.int32, device=dev)
        det = torch.zeros((), dtype=torch.int32, device=dev)
        inertia = torch.full((), float("inf"), device=dev)
        done = torch.zeros((), dtype=torch.bool, device=dev)
        inertia_host = float("inf")
        it0 = 0
        self._n_host_syncs = 0
        while it0 < self.max_iter:
            n_steps = min(self.sync_every, self.max_iter - it0)
            inj_stack = None
            if takes_inj:
                # the chunk's campaign schedule, drawn in the reference's
                # order and moved to the device in one copy
                inj_stack = torch.stack([
                    self._draw_injection(inj_rng, m, f, params)
                    for _ in range(n_steps)]).to(dev)
            hist, prune = [], []
            for t in range(n_steps):
                out = backend(xa, self._cast(centroids), params=params,
                              inj=None if inj_stack is None else inj_stack[t],
                              bounds=bounds)
                am_b, md, det_i, new_c, counts = self._apply_update(
                    out, xa, centroids)
                inertia_i = md.sum()
                shift_i = ((new_c - centroids) ** 2).sum().sqrt()
                # donors are rows of the plan (the cast X), as the
                # reference reseeds from plan.x
                new_c = km_mod.reseed_empty(x_rows, new_c, counts, md)
                # a converged fit freezes: later steps pass their state on
                live = ~done
                centroids = torch.where(live, new_c, centroids)
                am = torch.where(live, am_b, am)
                inertia = torch.where(live, inertia_i, inertia)
                shift = torch.where(live, shift_i, 0.0)
                det = det + torch.where(live, det_i.to(torch.int32), 0)
                if bounds is not None:
                    bounds = ops.BoundsState(*(
                        torch.where(live, getattr(out[5], fld.name),
                                    getattr(bounds, fld.name))
                        for fld in dataclasses.fields(bounds)))
                    prune.append(torch.where(live, out[6], 0.0))
                done = done | (shift < self.tol)
                hist.append((centroids, inertia, shift, live))
            # the chunk boundary: the only device->host read of the window
            in_d = torch.stack([h[1] for h in hist])
            sh_d = torch.stack([h[2] for h in hist])
            act_d = torch.stack([h[3] for h in hist])
            cs_d = torch.stack([h[0] for h in hist]) \
                if on_iteration is not None else None
            pf_d = torch.stack(prune) if prune else None
            done_h, in_h, sh_h, act_h, cs_h, pf_h = _host_read(
                (done, in_d, sh_d, act_d, cs_d, pf_d))
            self._n_host_syncs += 1
            executed = int(act_h.sum())
            if on_iteration is not None:
                for t in range(executed):
                    on_iteration(it0 + t, cs_h[t], float(in_h[t]),
                                 float(sh_h[t]))
            if pf_h is not None:
                self.prune_history_.extend(float(v) for v in pf_h[:executed])
            if executed:
                inertia_host = float(in_h[executed - 1])
            it0 += executed
            if bool(done_h):
                break

        self.cluster_centers_ = centroids
        self.n_iter_ = max(1, it0)
        self.detected_errors_ = int(_host_read(det))
        self._n_host_syncs += 1
        self._counts = None
        self.labels_ = am
        self.inertia_ = inertia_host
        return self

    def _fit_minibatch(self, x: torch.Tensor, centroids: torch.Tensor,
                       on_iteration: Optional[Callable]) -> "KMeans":
        """Sampled mini-batch Lloyd, the reference's loop: each iteration
        draws ``min(batch_size, M)`` distinct rows from
        ``np.random.default_rng(random_state + 1)`` (the reference's draws,
        index for index) and its campaign draw from the fit's campaign
        stream, gathers the rows on the device and runs one unpruned step of
        the backend on them, at the batch's own tiles and plan (an int8
        batch is quantised as a fit's X is). The host reads the step's
        inertia and shift once an iteration; the fit stops at ``shift <
        tol`` and ends with one predict over all of X (``labels_``,
        ``inertia_`` and its detections). The draws are host work (numpy's
        draw without replacement permutes M indices), so the next batch is
        drawn while the device runs this step: the same draws in the same
        order."""
        m, f = x.shape
        rows = min(self.batch_size, m)
        rng = np.random.default_rng(self.random_state + 1)
        inj_rng = self._campaign_rng()
        backend = self._backend
        self.prune_history_ = []           # mini-batch steps run unpruned
        total_det = torch.zeros((), dtype=torch.int32, device=x.device)
        self._n_host_syncs = 0
        it = 0
        idx = rng.choice(m, rows, replace=False)
        for it in range(self.max_iter):
            batch = x[torch.from_numpy(idx).to(x.device)]
            params = self._resolve_params(rows, f)
            inj = None
            if backend.takes_injection:
                inj = self._draw_injection(inj_rng, rows, f,
                                           params).to(x.device)
            xa = self._plan(batch, params)
            out = backend(xa, self._cast(centroids), params=params, inj=inj)
            _, md, det, new_c, _ = self._apply_update(out, xa, centroids)
            shift = ((new_c - centroids) ** 2).sum().sqrt()
            centroids = new_c
            total_det = total_det + det.to(torch.int32)
            if it + 1 < self.max_iter:
                idx = rng.choice(m, rows, replace=False)
            inertia_h, shift_h = _host_read((md.sum(), shift))
            self._n_host_syncs += 1
            if on_iteration is not None:
                on_iteration(it, centroids, float(inertia_h), float(shift_h))
            if float(shift_h) < self.tol:
                break

        self.cluster_centers_ = centroids
        self.n_iter_ = it + 1
        self._counts = None
        am, dist, det = self._predict_full(x)
        det_h, inertia_h = _host_read((total_det + det, dist.sum()))
        self._n_host_syncs += 1
        self.detected_errors_ = int(det_h)
        self.labels_ = am
        self.inertia_ = float(inertia_h)
        return self

    def partial_fit(self, x: Any) -> "KMeans":
        """One streaming update from a data block (the first call seeds):
        centres move by count-weighted running means. A pruned backend runs
        unpruned here: streaming blocks share no bounds."""
        x = self._tensor(x)
        if self.cluster_centers_ is None:
            self.cluster_centers_ = self.init_centroids(x)
            self.detected_errors_ = 0
            self.n_iter_ = 0
        if self._counts is None:
            self._counts = torch.zeros(self.n_clusters, device=self.device)
        backend = self._backend
        params = self._resolve_params(x.shape[0], x.shape[1])
        xa = self._plan(x, params)
        inj = None
        if backend.takes_injection:
            inj = self._draw_injection(self._campaign_rng(self.n_iter_),
                                       x.shape[0], x.shape[1],
                                       params).to(self.device)
        c = self.cluster_centers_
        out = backend(xa, self._cast(c), params=params, inj=inj)
        if backend.fuses_update:
            am, md, det, sums, bcnt = out[:5]
        else:
            am, md, det = out
            sums, bcnt = km_mod.protected_sums(xa, am, self.n_clusters,
                                               use_dmr=self._use_dmr)
        counts = self._counts + bcnt
        eta = (bcnt / counts.clamp_min(1.0))[:, None]
        bmean = sums / bcnt.clamp_min(1.0)[:, None]
        self.cluster_centers_ = torch.where(
            (bcnt > 0)[:, None], (1.0 - eta) * c + eta * bmean, c)
        self._counts = counts
        self.labels_ = am
        inertia_h, det_h = _host_read((md.sum(), det))
        self.inertia_ = float(inertia_h)
        self.n_iter_ += 1
        self.detected_errors_ += int(det_h)
        return self

    def _row_chunks(self, m: int) -> list[slice]:
        chunk = self.predict_chunk_rows or _PREDICT_CHUNK_ROWS
        return [slice(s, min(s + chunk, m)) for s in range(0, m, chunk)]

    def _predict_block(self, x: torch.Tensor) -> tuple:
        if x.shape[0] == 0:
            return (torch.zeros(0, dtype=torch.int32, device=x.device),
                    torch.zeros(0, device=x.device),
                    torch.zeros((), dtype=torch.int32, device=x.device))
        backend = self._predict_backend()
        params = self._resolve_params(x.shape[0], x.shape[1], backend=backend)
        x, c = self._cast(x), self._cast(self.cluster_centers_)
        if backend.takes_injection:
            return backend(x, c, params=params, inj=_daft.no_injection())
        return backend(x, c, params=params)

    def _predict_full(self, x: torch.Tensor) -> tuple:
        parts = [self._predict_block(x[s]) for s in self._row_chunks(
            x.shape[0])] or [self._predict_block(x)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]),
                torch.stack([p[2] for p in parts]).sum())

    def predict(self, x: Any) -> torch.Tensor:
        """Nearest-centroid labels for new data (no injection, ever)."""
        self._check_fitted()
        return self._predict_full(self._tensor(x))[0]

    def fit_predict(self, x: Any) -> torch.Tensor:
        return self.fit(x).labels_

    def transform(self, x: Any) -> torch.Tensor:
        """Distances to every centroid, (M, n_clusters), chunked over rows:
        f32 X against the f32 centroids at every compute dtype, as the
        reference's ``transform``."""
        self._check_fitted()
        x = self._tensor(x)
        blocks = [ref.distance_matrix(x[s], self.cluster_centers_)
                  .clamp_min(0.0).sqrt() for s in self._row_chunks(x.shape[0])]
        return torch.cat(blocks) if blocks else torch.zeros(
            (0, self.n_clusters), device=x.device)

    def score(self, x: Any) -> float:
        """Negative inertia on ``x`` (higher is better)."""
        self._check_fitted()
        return -float(self._predict_full(self._tensor(x))[1].sum())

    def to_service(self, *, buckets: Optional[tuple] = None,
                   window_s: Optional[float] = None) -> Any:
        """Hand the fitted model to the online serving layer: a
        :class:`repro_torch.serve.KMeansService` whose predict cells (one
        CUDA graph per row bucket on the card) run this model's predict
        backend at its compute dtype, its centroids hot-swappable through a
        versioned store and this estimator as its refinement loop
        (``service.refine`` -> :meth:`partial_fit`). Bucket ladder and
        batching window default to the plan stored in the autotune cache
        (``repro_torch.serve.tuning.plan_ladder``), else
        ``DEFAULT_BUCKETS`` and no window."""
        self._check_fitted()
        from repro_torch.serve import KMeansService  # circular-import-safe
        return KMeansService.from_estimator(self, buckets=buckets,
                                            window_s=window_s)

    # ------------------------------------------------------------------
    # serializable state
    # ------------------------------------------------------------------

    def get_state(self) -> dict:
        """Fitted state as a flat dict of plain types and numpy arrays, the
        reference's layout plus ``config["device"]``."""
        self._check_fitted()
        camp = self.fault.injection
        return {
            "cluster_centers": self.cluster_centers_.cpu().numpy(),
            "counts": (None if self._counts is None
                       else self._counts.cpu().numpy()),
            "n_iter": int(self.n_iter_),
            "inertia": (None if self.inertia_ is None
                        else float(self.inertia_)),
            "detected_errors": int(self.detected_errors_),
            "config": {
                "n_clusters": self.n_clusters,
                "max_iter": self.max_iter,
                "tol": self.tol,
                "init": self.init,
                "backend": self.backend,
                "batch_size": self.batch_size,
                "sync_every": self.sync_every,
                "compute_dtype": _dtype_name(self.compute_dtype),
                "predict_chunk_rows": self.predict_chunk_rows,
                "random_state": self.random_state,
                "params": (None if self.params is None else
                           [self.params.block_m, self.params.block_k,
                            self.params.block_f]),
                "fault": {
                    "mode": self.fault.mode,
                    "update_dmr": self.fault.update_dmr,
                    "worker_loss": self.fault.worker_loss,
                    "injection": (None if camp is None else {
                        "rate": camp.rate, "seed": camp.seed,
                        "targets": camp.targets}),
                },
                "device": str(self.device),
            },
        }

    @classmethod
    def from_state(cls, state: dict, *, device: Any = None,
                   autotune: Optional[AutotuneCache] = None) -> "KMeans":
        """Rebuild a fitted estimator from :meth:`get_state` output (or from
        ``repro_torch.convert.from_reference_state``). ``device`` overrides
        the state's device; the default is "cuda". ``autotune`` is the new
        estimator's tile table (default: the process cache)."""
        cfg = state["config"]
        fp = cfg["fault"]
        camp = fp.get("injection")
        fault = FaultPolicy(
            mode=fp["mode"], update_dmr=fp["update_dmr"],
            injection=None if camp is None else InjectionCampaign(**camp),
            worker_loss=fp.get("worker_loss", "fail"))   # pre-v3 states
        tiles = cfg.get("params")
        km = cls(cfg["n_clusters"], max_iter=cfg["max_iter"], tol=cfg["tol"],
                 init=cfg["init"], fault=fault, backend=cfg["backend"],
                 batch_size=cfg["batch_size"],
                 params=None if tiles is None else ops.KernelParams(*tiles),
                 sync_every=cfg.get("sync_every", 10),
                 compute_dtype=cfg.get("compute_dtype", "float32"),
                 predict_chunk_rows=cfg.get("predict_chunk_rows"),
                 random_state=cfg["random_state"], autotune=autotune,
                 device=device or cfg.get("device") or "cuda")
        km.cluster_centers_ = km._tensor(state["cluster_centers"])
        counts = state.get("counts")
        km._counts = None if counts is None else km._tensor(counts)
        km.n_iter_ = int(state["n_iter"])
        inertia = state.get("inertia")
        km.inertia_ = None if inertia is None else float(inertia)
        km.detected_errors_ = int(state.get("detected_errors", 0))
        return km
