"""Data-parallel FT K-means over ``torch.distributed`` ranks (counterpart of
``repro.dist.kmeans_dist``).

Each rank holds one contiguous block of the rows (:meth:`DistributedKMeans.
shard_data`) on its estimator's device and runs the single-device step on
it: the estimator's backend (the port's kernels on the card, their plain
versions on the CPU), ``protected_sums`` after a two-pass backend, then
:func:`~repro_torch.dist.reduce.reduce_update` over the mesh and
``means_from_sums``. Centroids are replicated; ``mean = sum(sums) /
sum(counts)`` keeps a fit on integer-valued data bit for bit the
single-device fit. There is no empty-cluster reseeding in the row-sharded
modes (a donor row would be one shard's), as in the reference: an empty
cluster keeps its centroid. The one-pass FT backend checks every hop of
the reduce with the update checksums.

Every rank draws each step's SEU injection from the same campaign stream
and applies it to its own shard. Every exit from a loop is decided on
values the reduce made the same on every rank (the shift of the reduced
centroids; a count of live problems summed over the mesh), so no rank
leaves while another waits in a collective. The host reads the shift once
an iteration, as the reference's loop does.

Handing ``DistributedKMeans`` a :class:`~repro_torch.batch.BatchedKMeans`
shards problems instead of rows: on a mesh without row parallelism every
rank runs ``make_batched_chunk`` (the single-device batched fit's body) on
its problems, with one collective a chunk (detections and the live count);
with row parallelism (``mesh2d(rows, problems)``, rows > 1) each problem's
rows shard too and its ``(sums, counts)`` reduce exactly over the row hops.

:meth:`DistributedKMeans.fit_elastic` survives a worker loss when the
policy says ``worker_loss="shrink"``: survivors replan
(``plan_rescale_rows``), rebind to a mesh of themselves, restore the newest
snapshot (the lowest live rank writes each one, and live ranks pass a
barrier after it) and resume; a lost rank returns ``None``.
"""
from __future__ import annotations

import json
import time
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.api.estimator import _host_read
from repro_torch.core import kmeans as km_mod
from repro_torch.dist.reduce import ReducePlan, hop_axes, psum, reduce_update
from repro_torch.dist.sharding import RankMesh, data_axes
from repro_torch.ft.elastic import (WorkerLossError, build_mesh,
                                    plan_rescale_rows)
from repro_torch.kernels import ops


def restore_estimator(checkpointer, *, device: Any = None) -> tuple:
    """``(estimator, start_iteration)`` from the newest row-mode snapshot,
    whose serialised ``get_state`` config rebuilds the whole estimator
    (policy with ``worker_loss``, backend, dtype, seeds); ``(None, 0)``
    without one. ``device`` overrides the state's."""
    st = checkpointer.restore()
    if st is None or "config_json" not in st:
        return None, 0
    from repro_torch.api import KMeans
    cfg = json.loads(bytes(bytearray(st["config_json"])).decode())
    est = KMeans.from_state({
        "cluster_centers": st["centroids"], "counts": None,
        "n_iter": int(st["iteration"]), "inertia": None,
        "detected_errors": 0, "config": cfg}, device=device)
    return est, int(st["iteration"])


class DistributedKMeans:
    """A ``KMeans`` (row mode) or ``BatchedKMeans`` (problem modes) fitted
    over a :class:`~repro_torch.dist.sharding.RankMesh`, one call per rank.

    Attributes after a fit: ``_n_host_syncs`` (device -> host reads),
    ``local_detected_`` (this rank's own detections, before the reduce)
    and ``restart_seconds_`` (each elastic restart: replan, rebind, restore
    and reshard).
    """

    def __init__(self, config: Any, mesh: RankMesh, *,
                 reduce: Optional[ReducePlan] = None) -> None:
        from repro_torch.api import KMeans
        from repro_torch.batch import BatchedKMeans
        if not isinstance(config, (KMeans, BatchedKMeans)):
            raise TypeError(f"DistributedKMeans takes a repro_torch KMeans or "
                            f"BatchedKMeans, got {type(config).__name__}")
        self.problem_axis = isinstance(config, BatchedKMeans)
        self.est = config
        self.reduce = reduce if reduce is not None else ReducePlan()
        self._n_host_syncs = 0
        self.local_detected_ = 0
        self.restart_seconds_: list = []
        self._bind_mesh(mesh)

    def _bind_mesh(self, mesh: RankMesh) -> None:
        """Adopt a mesh: the row / problem axis split and the groups of the
        reduce's hops."""
        self.mesh = mesh
        daxes = data_axes(mesh)
        if not daxes:
            raise ValueError("DistributedKMeans needs a mesh with at least "
                             "one data axis")
        has_problem = "problem" in daxes
        if self.problem_axis:
            self._paxes = ("problem",) if has_problem else daxes
            self._raxes = tuple(a for a in daxes if a != "problem") \
                if has_problem else ()
        else:
            if has_problem and mesh.shape["problem"] != 1:
                raise ValueError(
                    f"single-problem KMeans on a mesh with problem axis size "
                    f"{mesh.shape['problem']}; shard a BatchedKMeans over it, "
                    f"or build mesh2d(rows, problems=1)")
            self._paxes = ()
            self._raxes = daxes
        self._rp = mesh.size_of(self._raxes)
        self._pp = mesh.size_of(self._paxes)
        intra, cross = hop_axes(mesh, self._raxes, self.reduce)
        self._intra = mesh.group(intra)
        self._cross = None if cross is None else mesh.group((cross,))
        self._two_hops = cross is not None
        self._compress = (not self.problem_axis) and self._two_hops \
            and self.reduce.cross_host == "int8"
        self._all = mesh.group(daxes)

    # -- data placement -----------------------------------------------------

    def _block(self, n: int, parts: int, axes: tuple, what: str) -> slice:
        if n % parts:
            raise ValueError(f"{what} {n} must divide over {parts} ranks")
        i = self.mesh.index(axes) if axes else 0
        return slice(i * (n // parts), (i + 1) * (n // parts))

    def shard_data(self, x: Any) -> torch.Tensor:
        """This rank's block of ``x`` on the estimator's device: rows of an
        (M, F) matrix in row mode, the (B, N, F) stack's problems (and their
        rows, with row parallelism) in the problem modes; the blocks run in
        (host, row) order. ``x`` is the whole array (numpy, memory-mapped or
        a tensor); only the block is copied."""
        if not self.problem_axis:
            return self.est._tensor(
                x[self._block(x.shape[0], self._rp, self._raxes, "rows")])
        if x.ndim != 3:
            raise ValueError(f"problem-axis mode shards stacked (B, N, F) "
                             f"problems, got shape {tuple(x.shape)}")
        block = x[self._block(x.shape[0], self._pp, self._paxes, "problems")]
        if self._rp > 1:
            block = block[:, self._block(x.shape[1], self._rp, self._raxes,
                                         "rows")]
        return self.est._stack(block)

    def _save(self, checkpointer, centroids: torch.Tensor,
              iteration: int) -> None:
        """A snapshot by the lowest rank of the mesh, durable before every
        rank passes the barrier after it (problem stacks gathered first)."""
        if self.problem_axis and self._pp > 1:
            centroids = self._gather_problems(centroids)
        if dist.get_rank() == min(self.mesh.flat()):
            checkpointer.save(iteration,
                              self._checkpoint_state(centroids, iteration))
            checkpointer.wait()
        psum(torch.zeros(1, device=centroids.device), self._all)  # barrier

    def _gather_problems(self, c: torch.Tensor) -> torch.Tensor:
        """The whole (B, K, F) stack from each rank's problems: each rank's
        block in place in zeros, summed over the problem group."""
        bl = c.shape[0]
        full = torch.zeros((bl * self._pp,) + tuple(c.shape[1:]),
                           dtype=c.dtype, device=c.device)
        i = self.mesh.index(self._paxes)
        full[i * bl:(i + 1) * bl] = c
        return psum(full, self.mesh.group(self._paxes))

    def _checkpoint_state(self, centroids: torch.Tensor,
                          iteration: int) -> dict:
        """Snapshot payload: the arrays and, in row mode, the estimator's
        serialised config, so :func:`restore_estimator` rebuilds the whole
        estimator from the snapshot."""
        payload = {"centroids": centroids,
                   "iteration": np.asarray(iteration, np.int32)}
        if not self.problem_axis:
            # mid-fit: stamp the current centroids so get_state() (which
            # wants a fitted estimator) serialises the config
            est = self.est
            est.cluster_centers_ = centroids
            est.n_iter_ = iteration
            payload["config_json"] = np.frombuffer(
                json.dumps(est.get_state()["config"]).encode(),
                np.uint8).copy()
        return payload

    # -- row mode -------------------------------------------------------------

    def fit(self, xs: torch.Tensor, centroids: Any, *,
            max_iters: Optional[int] = None, start_iteration: int = 0,
            checkpointer=None, checkpoint_interval: int = 5,
            on_iteration: Optional[Callable] = None) -> tuple:
        """Lloyd iterations on this rank's block ``xs`` (from
        :meth:`shard_data`), every rank calling at once.

        Row mode returns ``(centroids, labels, inertia, iterations,
        detected)``: the replicated (K, F) centroids, this rank's labels,
        the total inertia and detections (every rank's, plus one a failed
        hop check), and the completed iterations counted from zero (a
        restart with ``start_iteration`` continues the trajectory).
        ``on_iteration(it)`` runs at the start of each iteration (each
        chunk, in problem mode): a drill's ``FailureSchedule`` raises from
        it. A snapshot goes to ``checkpointer`` every
        ``checkpoint_interval`` iterations and at the end.

        Problem modes take ``centroids`` as the whole (B, K, F) stack and
        return this rank's problems: ``(centroids (Bl, K, F), labels,
        inertia (Bl,), iterations (Bl,), detected)``.
        """
        est = self.est
        max_iters = max_iters if max_iters is not None else est.max_iter
        self._n_host_syncs = 0
        args = (xs, centroids, max_iters, start_iteration, checkpointer,
                checkpoint_interval, on_iteration)
        if self.problem_axis:
            if self._rp > 1:
                return self._fit_combined(*args)
            return self._fit_problems(*args)
        return self._fit_rows(*args)

    def _fit_rows(self, xs, centroids, max_iters, start_iteration,
                  checkpointer, checkpoint_interval, on_iteration) -> tuple:
        est = self.est
        backend = est._backend
        m, f = xs.shape
        k = est.n_clusters
        dev = xs.device
        params = est._resolve_params(m, f)        # the shard's shape
        xa = est._plan(xs, params)
        rng = est._campaign_rng() if backend.takes_injection else None
        checked = backend.fuses_update and backend.supports_ft
        m_total = m * self._rp                    # the checks' threshold
        c = est._tensor(centroids)
        am = torch.zeros(m, dtype=torch.int32, device=dev)
        inertia = torch.full((), float("inf"), device=dev)
        total_det = torch.zeros((), dtype=torch.int32, device=dev)
        local_det = torch.zeros((), dtype=torch.int32, device=dev)
        # one error-feedback residual a host group (the intra hop makes it
        # the same on every member), zero at every fit and restart
        res = torch.zeros((k, f), device=dev) if self._compress else None
        completed = start_iteration
        saved = False
        for it in range(start_iteration, max_iters):
            if on_iteration is not None:
                on_iteration(it)
            inj = None
            if rng is not None:
                inj = est._draw_injection(rng, m, f, params).to(dev)
            out = backend(xa, est._cast(c), params=params, inj=inj)
            if backend.fuses_update:
                am, md, det, sums, cnt = out[:5]
            else:
                am, md, det = out
                sums, cnt = km_mod.protected_sums(xa, am, k,
                                                  use_dmr=est._use_dmr)
            det = det.to(torch.int32)
            sums, cnt, bad, res, extra = reduce_update(
                sums, cnt, intra=self._intra, cross=self._cross,
                compress=self._compress, residual=res, checked=checked,
                m_total=m_total,
                extra=torch.stack([md.sum(), det.float()]))
            inertia = extra[0]
            total_det = total_det + extra[1].to(torch.int32) + bad
            local_det = local_det + det
            new_c = km_mod.means_from_sums(sums, cnt, c)
            shift = ((new_c - c) ** 2).sum().sqrt()
            c = new_c
            completed = it + 1
            saved = completed % checkpoint_interval == 0
            if checkpointer is not None and saved:
                self._save(checkpointer, c, completed)
            self._n_host_syncs += 1
            if float(_host_read(shift)) < est.tol:
                break
        if checkpointer is not None and not saved and \
                completed > start_iteration:
            # the final snapshot: a fit that ends between intervals must
            # still be restartable
            self._save(checkpointer, c, completed)
        inertia_h, det_h, local_h = _host_read((inertia, total_det,
                                                local_det))
        self._n_host_syncs += 1
        self.local_detected_ = int(local_h)
        return c, am, float(inertia_h), completed, int(det_h)

    # -- problem-axis mode: each rank its own problems ------------------------

    def _problem_block(self, centroids: Any, bl: int) -> torch.Tensor:
        c = self.est._stack(centroids)
        if c.shape[0] != bl * self._pp:
            raise ValueError(f"centroids must be the whole stack of "
                             f"{bl * self._pp} problems, got {c.shape[0]}")
        return c[self._block(c.shape[0], self._pp, self._paxes, "problems")]

    def _fit_problems(self, xs, centroids, max_iters, start_iteration,
                      checkpointer, checkpoint_interval,
                      on_iteration) -> tuple:
        from repro_torch.batch.estimator import make_batched_chunk
        est = self.est
        bl, n, f = xs.shape
        dev = xs.device
        params = est._resolve_params(bl, n, f)
        plan = ops.plan_data_batched(est._cast(xs), params)
        c = self._problem_block(centroids, bl)
        am = torch.zeros((bl, n), dtype=torch.int32, device=dev)
        inertia = torch.full((bl,), float("inf"), device=dev)
        done = torch.zeros(bl, dtype=torch.bool, device=dev)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        iters = np.zeros(bl, np.int64)
        total_det = 0
        it0 = start_iteration
        saved = False
        while it0 < max_iters:
            if on_iteration is not None:
                on_iteration(it0)
            n_steps = min(est.sync_every, max_iters - it0)
            chunk = make_batched_chunk(est._backend, params, est._cast,
                                       est.tol, n_steps)
            (c, am, inertia, done, det), live = chunk(plan, c, am, inertia,
                                                      done, zero)
            # the chunk's one collective: detections and the problems still
            # live on every rank, so all ranks stop together
            red = psum(torch.stack([det.float(), (~done).sum().float()]),
                       self._all)
            red_h, live_h = _host_read((red, live))
            self._n_host_syncs += 1
            iters += live_h.numpy().sum(0).astype(np.int64)
            total_det += int(red_h[0])
            it0 += n_steps
            saved = it0 % checkpoint_interval == 0
            if checkpointer is not None and saved:
                self._save(checkpointer, c, it0)
            if float(red_h[1]) == 0:
                break
        if checkpointer is not None and not saved and it0 > start_iteration:
            self._save(checkpointer, c, it0)
        inertia_h = _host_read(inertia)
        self._n_host_syncs += 1
        return (c, am, inertia_h.numpy().astype(np.float64),
                np.maximum(iters, 1), total_det)

    # -- combined mode: problems x rows, an exact reduce a problem ------------

    def _fit_combined(self, xs, centroids, max_iters, start_iteration,
                      checkpointer, checkpoint_interval,
                      on_iteration) -> tuple:
        """The batched chunk's arithmetic a step, each problem's ``(sums,
        counts)`` reduced over the row hops; no reseeding (donor rows are a
        shard's), so it is bit for bit the single-device batched fit
        exactly when no cluster empties."""
        if self._two_hops and self.reduce.cross_host == "int8":
            raise NotImplementedError(
                "the int8 cross-host hop carries one residual per host group "
                "and is row-mode (single-problem) only; use ReducePlan."
                "compressed(exact=True) or the exact default for "
                "row-sharded problem stacks")
        est = self.est
        backend = est._backend
        bl, n, f = xs.shape
        dev = xs.device
        params = est._resolve_params(bl, n, f)
        plan = ops.plan_data_batched(est._cast(xs), params)
        c = self._problem_block(centroids, bl)
        am = torch.zeros((bl, n), dtype=torch.int32, device=dev)
        inertia = torch.full((bl,), float("inf"), device=dev)
        done = torch.zeros(bl, dtype=torch.bool, device=dev)
        iters = np.zeros(bl, np.int64)
        total_det = 0
        completed = start_iteration
        saved = False
        for it in range(start_iteration, max_iters):
            if on_iteration is not None:
                on_iteration(it)
            am_n, md, det_i, sums, cnt = backend(plan, est._cast(c),
                                                 params=params)
            sums, cnt, _, _, inertia_n = reduce_update(
                sums, cnt, intra=self._intra, cross=self._cross,
                extra=md.sum(1))
            new_c = km_mod.means_from_sums(sums, cnt, c)
            shift = ((new_c - c) ** 2).sum((1, 2)).sqrt()
            live = ~done
            c = torch.where(live[:, None, None], new_c, c)
            am = torch.where(live[:, None], am_n, am)
            inertia = torch.where(live, inertia_n, inertia)
            done = done | (shift < est.tol)
            red = psum(torch.stack([det_i.sum().float(),
                                    (~done).sum().float()]), self._all)
            red_h, live_h = _host_read((red, live))
            self._n_host_syncs += 1
            iters += live_h.numpy().astype(np.int64)
            total_det += int(red_h[0])
            completed = it + 1
            saved = completed % checkpoint_interval == 0
            if checkpointer is not None and saved:
                self._save(checkpointer, c, completed)
            if float(red_h[1]) == 0:
                break
        if checkpointer is not None and not saved and \
                completed > start_iteration:
            self._save(checkpointer, c, completed)
        inertia_h = _host_read(inertia)
        self._n_host_syncs += 1
        return (c, am, inertia_h.numpy().astype(np.float64),
                np.maximum(iters, 1), total_det)

    # -- elastic driver: survive a fail-stop worker loss ----------------------

    def fit_elastic(self, x: Any, centroids: Any, *, checkpointer,
                    checkpoint_interval: int = 5,
                    max_iters: Optional[int] = None,
                    on_iteration: Optional[Callable] = None,
                    max_restarts: int = 8) -> Optional[tuple]:
        """Row-mode fit that survives whole-worker loss when the policy
        says ``worker_loss="shrink"`` (with "fail" the error propagates).

        On :class:`~repro_torch.ft.elastic.WorkerLossError` (in a drill,
        raised by a ``FailureSchedule`` as ``on_iteration`` on every rank at
        once) the lost ranks return ``None``; the survivors replan with
        ``plan_rescale_rows``, rebind to a mesh of themselves, reshard ``x``
        (the whole matrix), restore the newest snapshot (or the initial
        ``centroids`` when there is none) and resume from its iteration.
        Returns ``fit``'s tuple plus the number of restarts.
        """
        if self.problem_axis:
            raise ValueError("fit_elastic drives the row-sharded mode; "
                             "problem stacks restart whole")
        shrink = self.est.fault.worker_loss == "shrink"
        c = centroids
        it0 = 0
        restarts = 0
        xs = self.shard_data(x)
        while True:
            try:
                out = self.fit(xs, c, max_iters=max_iters,
                               start_iteration=it0, checkpointer=checkpointer,
                               checkpoint_interval=checkpoint_interval,
                               on_iteration=on_iteration)
                return out + (restarts,)
            except WorkerLossError as e:
                if not shrink or restarts >= max_restarts:
                    raise
                t0 = time.perf_counter()
                restarts += 1
                lost = set(e.lost)
                live = [r for i, r in enumerate(self.mesh.flat())
                        if i not in lost]
                plan = plan_rescale_rows(
                    live, problems=self.mesh.shape.get("problem", 1),
                    hosts=self.mesh.shape.get("host", 1))
                if dist.get_rank() not in live[:int(np.prod(
                        plan.mesh_shape))]:
                    return None
                del xs
                self._bind_mesh(build_mesh(plan, live))
                st = checkpointer.restore()
                if st is None:      # lost before the first snapshot
                    c, it0 = centroids, 0
                else:
                    c, it0 = st["centroids"], int(st["iteration"])
                xs = self.shard_data(x)
                if xs.is_cuda:
                    torch.cuda.synchronize(xs.device)
                self.restart_seconds_.append(time.perf_counter() - t0)
