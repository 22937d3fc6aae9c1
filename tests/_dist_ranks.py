"""Rank bodies of the distributed tests (``test_torch_dist.py``,
``test_torch_elastic.py``).

``repro_torch.dist.sharding.run_ranks`` spawns each rank from a fresh
interpreter that imports the rank's function by module, so the bodies live
here, in a module that imports torch and the port only (not JAX: a rank
never needs it). Every body returns numpy arrays and plain numbers.

The groups of a mesh are made once per set of ranks, and a member must
hold as many groups as the others when one is made
(``repro_torch.dist.sharding``): each body builds its 4-rank meshes before
any mesh of fewer ranks.
"""
import time

import numpy as np
import torch

from repro_torch.api import FaultPolicy, InjectionCampaign, KMeans
from repro_torch.batch import BatchedKMeans
from repro_torch.dist.compression import compressed_psum
from repro_torch.dist.kmeans_dist import DistributedKMeans
from repro_torch.dist.reduce import ReducePlan
from repro_torch.dist.sharding import mesh2d
from repro_torch.ft import Checkpointer, FailureSchedule, WorkerLossError
from repro_torch.kernels import ops

K = 8
CAMPAIGN = dict(rate=1.0, targets="both", seed=3)
PLANS = {"two_hops": ReducePlan(), "flat": ReducePlan.flat(),
         "int8": ReducePlan.compressed(),
         "int8_exact": ReducePlan.compressed(exact=True)}
POLICIES = {"off": FaultPolicy.off(), "correct": FaultPolicy.correct(),
            "campaign": FaultPolicy.correct(
                injection=InjectionCampaign(**CAMPAIGN)),
            "elastic": FaultPolicy.elastic(), "fail": FaultPolicy.correct()}
BATCH_TILES = ops.KernelParams(128, 128, 32)


def int_blobs(seed: int, m: int = 1680, f: int = 16, k: int = K):
    """The reference tests' data: integers in [-20, 20), so every partial
    sum is exact, and K rows of it as the seeds."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-20, 20, size=(m, f)).astype(np.float32)
    c0 = x[rng.choice(m, size=k, replace=False)].copy()
    return x, c0


def estimator(backend: str, policy: str, **kw) -> KMeans:
    kw.setdefault("max_iter", 15)
    kw.setdefault("tol", 1e-4)
    return KMeans(K, backend=backend, fault=POLICIES[policy],
                  random_state=0, device="cpu", **kw)


def _row_fit(x, c0, backend, policy, plan, mesh, **kw) -> dict:
    d = DistributedKMeans(estimator(backend, policy, **kw), mesh,
                          reduce=PLANS[plan])
    c, am, inertia, iters, det = d.fit(d.shard_data(x), c0)
    return {"centroids": c.numpy(), "labels": am.numpy(),
            "inertia": inertia, "iters": iters, "det": det,
            "local_det": d.local_detected_, "host_syncs": d._n_host_syncs}


def row_fits(rank, world, device, datasets, specs, gs) -> dict:
    """Each ``(key, backend, policy, plan, data)`` of ``specs`` fitted on
    ``mesh2d(4, hosts=2)`` (``datasets[data]`` is ``(x, c0)``; the "real"
    data for 6 steps at tol 0), and ``compressed_psum`` of ``gs[rank]`` over
    the four ranks."""
    mesh = mesh2d(4, hosts=2)
    out = {}
    for key, backend, policy, plan, data in specs:
        kw = dict(tol=0.0, max_iter=6) if data == "real" else {}
        out[key] = _row_fit(*datasets[data], backend, policy, plan, mesh,
                            **kw)
    red, res = compressed_psum(torch.from_numpy(gs[rank]),
                               mesh.group(("host", "row", "problem")))
    out["compressed_psum"] = (red.numpy(), res.numpy())
    return out


def problem_fits(rank, world, device, xs, cs) -> dict:
    """``BatchedKMeans`` over problems alone (``mesh2d(1, 4)``), problems x
    rows (``mesh2d(2, 2)``), and the combined mode's refusal of the int8
    hop (``mesh2d(2, 2, hosts=2)``)."""
    out = {}
    for key, mesh in (("problems", mesh2d(1, 4)),
                      ("combined", mesh2d(2, 2))):
        bkm = BatchedKMeans(K, max_iter=12, tol=1e-4, params=BATCH_TILES,
                            sync_every=5, device="cpu")
        d = DistributedKMeans(bkm, mesh)
        c, am, inertia, iters, det = d.fit(d.shard_data(xs), cs)
        out[key] = {"centroids": c.numpy(), "labels": am.numpy(),
                    "inertia": inertia, "iters": iters, "det": det}
    d = DistributedKMeans(BatchedKMeans(K, params=BATCH_TILES, device="cpu"),
                          mesh2d(2, 2, hosts=2),
                          reduce=ReducePlan.compressed())
    try:
        d.fit(d.shard_data(xs), cs)
        out["combined_int8"] = "no error"
    except NotImplementedError as e:
        out["combined_int8"] = str(e)
    return out


def _drill(x, c0, policy, schedule, directory, mesh):
    ck = Checkpointer(directory, async_write=False)
    d = DistributedKMeans(estimator("lloyd_ft", policy, tol=0.0), mesh)
    out = d.fit_elastic(x, c0, checkpointer=ck, checkpoint_interval=5,
                        on_iteration=FailureSchedule(dict(schedule)))
    if out is None:
        return None
    c, am, inertia, iters, det, restarts = out
    return {"centroids": c.numpy(), "labels": am.numpy(), "iters": iters,
            "det": det, "restarts": restarts, "mesh": d.mesh.flat(),
            "mesh_shape": d.mesh.ranks.shape,
            "restart_s": list(d.restart_seconds_)}


def drills(rank, world, device, x, c0, losses, directory) -> dict:
    """One elastic drill a loss iteration of ``losses`` (rank 3 lost on
    ``mesh2d(4, hosts=2)``, snapshots every 5), the ``worker_loss="fail"``
    drill, then the uninterrupted fit of ranks 0-2."""
    out = {}
    for it in losses:
        out[f"loss_{it}"] = _drill(x, c0, "elastic", {it: (3,)},
                                   f"{directory}/loss_{it}",
                                   mesh2d(4, hosts=2))
    try:
        _drill(x, c0, "fail", {5: (3,)}, f"{directory}/fail",
               mesh2d(4, hosts=2))
        out["fail"] = "no error"
    except WorkerLossError as e:
        out["fail"] = e.lost
    if rank < 3:
        mesh = mesh2d(3, ranks=[0, 1, 2])
        d = DistributedKMeans(estimator("lloyd_ft", "elastic", tol=0.0),
                              mesh)
        c, am, inertia, iters, det = d.fit(d.shard_data(x), c0)
        out["three"] = {"centroids": c.numpy(), "labels": am.numpy(),
                        "iters": iters, "det": det}
    return out


def several(rank, world, device, calls) -> list:
    """Each ``(body, args)`` of ``calls`` in turn, in one group of ranks."""
    return [body(rank, world, device, *args) for body, args in calls]


def hang(rank, world, device) -> None:
    """Rank 1 never ends."""
    if rank == 1:
        time.sleep(600)


def fail(rank, world, device) -> None:
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
