"""The port's elastic layer (``repro_torch.ft.elastic``,
``DistributedKMeans.fit_elastic``, ``FaultPolicy.elastic()``) against the
reference, on the CPU.

The decision layer (``plan_rescale``, ``plan_rescale_rows``,
``StragglerPolicy``) gives the reference's results on the same inputs. The
drills run in one group of four gloo ranks (``run_ranks``: a ``FileStore``
in a temporary directory, a time limit): on ``mesh2d(4, hosts=2)`` rank 3
is lost at iteration 0 (before any snapshot), 5 or 11, with snapshots every
5; each drill restarts once on a mesh of ranks 0-2 and ends bit for bit the
uninterrupted 3-rank fit (integer data: every sum exact), which is itself
bit for bit the reference's single-device fit. With
``worker_loss="fail"`` every rank raises ``WorkerLossError((3,))``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _dist_ranks as R  # noqa: E402
from repro.api import FaultPolicy as JFaultPolicy  # noqa: E402
from repro.api import KMeans as JKMeans  # noqa: E402
from repro.ft import elastic as jelastic  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.api import FaultPolicy, KMeans  # noqa: E402
from repro_torch.dist.kmeans_dist import restore_estimator  # noqa: E402
from repro_torch.dist.sharding import run_ranks  # noqa: E402
from repro_torch.ft import (Checkpointer, FailureSchedule,  # noqa: E402
                            WorkerLossError, elastic)

SPAWN_S = 180
LOSSES = (0, 5, 11)


@pytest.mark.parametrize("n,mp,pods", [(8, 1, 1), (7, 2, 1), (16, 4, 2),
                                       (5, 4, 1), (12, 3, 2)])
def test_plan_rescale_matches_reference(n, mp, pods):
    got = elastic.plan_rescale(list(range(n)), model_parallel=mp, pods=pods)
    want = jelastic.plan_rescale(list(range(n)), model_parallel=mp,
                                 pods=pods)
    assert got.__dict__ == want.__dict__


@pytest.mark.parametrize("n,problems,hosts", [(3, 1, 2), (4, 1, 2),
                                              (6, 2, 2), (7, 2, 3),
                                              (8, 1, 4), (5, 1, 1)])
def test_plan_rescale_rows_matches_reference(n, problems, hosts):
    got = elastic.plan_rescale_rows(list(range(n)), problems=problems,
                                    hosts=hosts)
    want = jelastic.plan_rescale_rows(list(range(n)), problems=problems,
                                      hosts=hosts)
    assert got.__dict__ == want.__dict__


def test_largest_mesh_keeps_model_groups_whole():
    assert elastic.largest_mesh(7, model_parallel=2) == \
        jelastic.largest_mesh(7, model_parallel=2)
    with pytest.raises(ValueError, match="cannot keep model=4"):
        elastic.largest_mesh(3, model_parallel=4)


def test_build_mesh_over_live_ranks():
    live = [0, 2, 5, 7, 9]          # 5 rows do not divide over 2 hosts
    plan = elastic.plan_rescale_rows(live, hosts=2)
    assert elastic.build_mesh(plan, live).shape == {
        "host": 1, "row": 5, "problem": 1}
    plan = elastic.plan_rescale_rows(live, problems=2, hosts=2)
    mesh = elastic.build_mesh(plan, live)
    assert mesh.shape == {"host": 2, "row": 1, "problem": 2}
    assert mesh.flat() == [0, 2, 5, 7]
    assert mesh.members(("host",), 5) == (0, 5)


def test_straggler_policy_matches_reference():
    times = [(0, 1.0), (1, 5.0), (1, 4.0), (2, 9.0), (1, 0.5), (2, 7.0)]
    port, ref = elastic.StragglerPolicy(), jelastic.StragglerPolicy()
    for shard, t in times:
        assert port.observe(shard, t, 1.0) == ref.observe(shard, t, 1.0)
    rng = np.random.default_rng(0)
    sums = rng.integers(-9, 9, (4, 5, 3)).astype(np.float32)
    counts = rng.integers(0, 9, (4, 5)).astype(np.float32)
    live = np.array([True, False, True, True])
    got = elastic.StragglerPolicy.aggregate(sums, counts, live)
    want = jelastic.StragglerPolicy.aggregate(sums, counts, live)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_failure_schedule_fires_once():
    sched = FailureSchedule({2: (3,)})
    sched(0)
    with pytest.raises(WorkerLossError) as err:
        sched(2)
    assert err.value.lost == (3,)
    sched(2)        # a resumed fit passes iteration 2 again


@pytest.fixture(scope="module")
def drilled(tmp_path_factory):
    x, c0 = R.int_blobs(5)
    directory = str(tmp_path_factory.mktemp("drills"))
    outs = run_ranks(R.drills, 4, device="cpu", backend="gloo",
                     timeout=SPAWN_S, args=(x, c0, LOSSES, directory))
    return outs, directory


@pytest.mark.parametrize("loss", LOSSES)
def test_drill_ends_bitwise_the_three_rank_fit(drilled, loss):
    outs, _ = drilled
    key = f"loss_{loss}"
    assert outs[3][key] is None         # the lost rank stepped out
    three = outs[0]["three"]
    for r in range(3):
        got = outs[r][key]
        assert got["restarts"] == 1
        assert got["mesh"] == [0, 1, 2] and got["mesh_shape"] == (1, 3, 1)
        np.testing.assert_array_equal(got["centroids"], three["centroids"])
        np.testing.assert_array_equal(got["labels"],
                                      outs[r]["three"]["labels"])
        assert got["iters"] == three["iters"] == 15
        assert got["det"] == three["det"] == 0
        assert len(got["restart_s"]) == 1


def test_three_rank_fit_bitwise_single_device_reference(drilled):
    """The uninterrupted 3-rank fit the drills are held to is itself the
    reference's single-device fit (``lloyd_ft_xla``, the analogue of
    ``lloyd_ft`` off the TPU): centroids and gathered labels bit for bit,
    the same iterations."""
    outs, _ = drilled
    x, c0 = R.int_blobs(5)
    jk = JKMeans(R.K, max_iter=15, tol=0.0, fault=JFaultPolicy.correct(),
                 backend="lloyd_ft_xla").fit(x, centroids=c0)
    three = outs[0]["three"]
    np.testing.assert_array_equal(three["centroids"],
                                  np.asarray(jk.cluster_centers_))
    np.testing.assert_array_equal(
        np.concatenate([outs[r]["three"]["labels"] for r in range(3)]),
        np.asarray(jk.labels_))
    assert three["iters"] == jk.n_iter_ == 15


def test_worker_loss_fail_raises_on_every_rank(drilled):
    outs, _ = drilled
    assert [o["fail"] for o in outs] == [(3,)] * 4


def test_restore_estimator_keeps_the_elastic_policy(drilled):
    outs, directory = drilled
    est, it = restore_estimator(Checkpointer(f"{directory}/loss_5",
                                             async_write=False),
                                device="cpu")
    assert it == 15
    assert est.fault == FaultPolicy.elastic()
    assert est._backend.name == "lloyd_ft"
    np.testing.assert_array_equal(est.cluster_centers_.numpy(),
                                  outs[0]["three"]["centroids"])
    empty = Checkpointer(f"{directory}/none", async_write=False)
    assert restore_estimator(empty) == (None, 0)


def test_reference_elastic_state_loads_and_round_trips():
    x, c0 = R.int_blobs(5)
    jk = JKMeans(R.K, fault=JFaultPolicy.elastic(), max_iter=3,
                 backend="lloyd_ft_xla").fit(x, centroids=c0)
    state = convert.from_reference_state(jk.get_state())
    km = KMeans.from_state(state, device="cpu")
    assert km.fault == FaultPolicy.elastic()
    np.testing.assert_array_equal(km.predict(x).numpy(),
                                  np.asarray(jk.predict(x)))
    back = JKMeans.from_state(convert.to_reference_state(km.get_state()))
    assert back.fault == jk.fault
    assert back.fault.worker_loss == "shrink"
