"""The port's distributed fit (``repro_torch.dist``) against the reference, on
the CPU, in groups of four gloo ranks.

Each group is spawned by ``run_ranks`` (a ``FileStore`` in a temporary
directory, no port; every spawn under its own time limit, after which its
ranks are killed and the test fails with their logs): one group runs every
fit of the module; the rank bodies are ``tests/_dist_ranks.py``.

Integer-valued data (the reference tests': integers in [-20, 20), 1680 x
16, K 8) keeps every partial sum exact, so the order of the all-reduce
cannot move a bit: exact row-mode fits on ``mesh2d(4, hosts=2)`` (two hops)
and on the flat plan are held bit for bit to the reference's single-device
``repro.api.KMeans`` fit with each backend's XLA analogue (what the
reference's own sharded step runs off the TPU): centroids, the gathered
labels and the iterations; the inertia is a sum of f32 squares in another
order, held to rtol 1e-6. A real-valued fit is held to the port's
single-device fit within rtol 1e-5 (sums in another order). The
problem-axis and combined modes are held bit for bit to the port's
single-device ``BatchedKMeans`` and to the reference's, with the same tiles.
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _dist_ranks as R  # noqa: E402
from _mesh import run_with_devices  # noqa: E402
from repro.api import BatchedKMeans as JBatchedKMeans  # noqa: E402
from repro.api import FaultPolicy as JFaultPolicy  # noqa: E402
from repro.api import KMeans as JKMeans  # noqa: E402
from repro.dist import compression as jcomp  # noqa: E402
from repro.dist import reduce as jreduce  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.api import FaultPolicy, KMeans  # noqa: E402
from repro_torch.batch import BatchedKMeans  # noqa: E402
from repro_torch.dist import compression, reduce, sharding  # noqa: E402
from repro_torch.dist import ReducePlan, mesh2d  # noqa: E402

SPAWN_S = 180               # each group's time limit
INERTIA_RTOL = 1e-6         # f32 squares summed in another order
REAL_RTOL = 1e-5
# the reference tests' bars for the int8 hop against the exact fit
INT8_CENTROID_BAR, INT8_INERTIA_BAR = 0.15, 0.02
# the port's int8 fit against the reference's: the same quantisation and
# the same sums of two dequantised hosts, so equal to f32 rounding
INT8_REF_RTOL = 1e-6

# backend -> (its policy, the reference's analogue and policy)
BACKENDS = {"lloyd": ("off", "lloyd_xla", JFaultPolicy.off()),
            "fused": ("off", "gemm_fused", JFaultPolicy.off()),
            "lloyd_ft": ("correct", "lloyd_ft_xla", JFaultPolicy.correct()),
            "fused_ft": ("correct", "abft_offline", JFaultPolicy.correct())}
# (key, backend, policy, plan, data): the int8 hop on the reference's own
# test data for it (``int_blobs(11)``, tests/test_mesh2d.py)
ROW_SPECS = [(f"{b}/{plan}", b, pol, plan, "int") for b, (pol, _, _) in
             BACKENDS.items() for plan in ("two_hops", "flat")] + [
    ("campaign", "lloyd_ft", "campaign", "two_hops", "int"),
    ("exact11", "lloyd", "off", "two_hops", "int11"),
    ("int8", "lloyd", "off", "int8", "int11"),
    ("int8_exact", "lloyd", "off", "int8_exact", "int11"),
    ("int8_ft", "lloyd_ft", "correct", "int8", "int11"),
    ("real", "lloyd", "off", "two_hops", "real")]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(1)
    xr = rng.normal(size=(1680, 16)).astype(np.float32) + np.repeat(
        8.0 * rng.normal(size=(8, 16)), 210, 0).astype(np.float32)
    cr = xr[rng.choice(1680, 8, replace=False)].copy()
    return {"int": R.int_blobs(3), "int11": R.int_blobs(11),
            "real": (xr, cr),
            "gs": rng.normal(size=(4, 3, 300)).astype(np.float32)}


@pytest.fixture(scope="module")
def stack_data():
    rng = np.random.default_rng(2)
    xs = rng.integers(-20, 20, size=(8, 400, 16)).astype(np.float32)
    cs = np.stack([xb[rng.choice(400, R.K, replace=False)] for xb in xs])
    return xs, cs


@pytest.fixture(scope="module")
def ranks(data, stack_data):
    """Every row-mode fit, then the problem-axis and combined fits, in one
    group of four ranks (the 4-rank row mesh first: its groups serve the
    problem meshes too)."""
    sets = {k: v for k, v in data.items() if k != "gs"}
    outs = sharding.run_ranks(R.several, 4, device="cpu", backend="gloo",
                              timeout=SPAWN_S, args=([
                                  (R.row_fits, (sets, ROW_SPECS, data["gs"])),
                                  (R.problem_fits, stack_data)],))
    return [o[0] for o in outs], [o[1] for o in outs]


@pytest.fixture(scope="module")
def rows(ranks):
    return ranks[0]


@pytest.fixture(scope="module")
def reference(data):
    """The reference's single-device fit with each backend's analogue."""
    x, c0 = data["int"]
    out = {}
    for name, (_, jbackend, jpol) in BACKENDS.items():
        jk = JKMeans(R.K, max_iter=15, tol=1e-4, fault=jpol,
                     backend=jbackend).fit(x, centroids=c0)
        out[name] = (np.asarray(jk.cluster_centers_),
                     np.asarray(jk.labels_), jk.n_iter_, float(jk.inertia_))
    return out


def gathered(outs, key):
    return np.concatenate([o[key]["labels"] for o in outs])


# ---------------------------------------------------------------------------
# the int8 transport and the checks, against the reference's functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(5,), (3, 128), (2, 3, 300), (8, 129)])
def test_quantize_bitwise_reference(shape):
    rng = np.random.default_rng(len(shape))
    x = (rng.normal(size=shape) * 10.0 ** rng.integers(-3, 4)).astype(
        np.float32)
    x.reshape(-1)[0] = 0.5      # a half step of some block's scale
    q, s = compression.quantize(torch.from_numpy(x))
    jq, js = jcomp.quantize(x)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        compression.dequantize(q, s, shape[-1]).numpy(),
        np.asarray(jcomp.dequantize(jq, js, shape[-1])))


def test_error_feedback_time_average_converges():
    """Reducing a fixed value again and again with the residual carried,
    the time average approaches the value (error feedback telescopes)."""
    g = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 512)).astype(np.float32))
    res = torch.zeros_like(g)
    total = torch.zeros_like(g)
    errs = {}
    for t in range(1, 33):
        red, res = compression.compressed_psum(g + res, None)
        total += red
        errs[t] = float((total / t - g).abs().max() / g.abs().max())
    assert errs[32] < errs[1] / 8 + 1e-7


def test_compressed_psum_over_four_ranks(data, rows):
    gs = data["gs"]
    want = sum(jcomp.dequantize(*jcomp.quantize(g), 300) for g in gs)
    for r, out in enumerate(rows):
        red, res = out["compressed_psum"]
        np.testing.assert_allclose(red, np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
        deq = compression.dequantize(*compression.quantize(
            torch.from_numpy(gs[r])), 300)
        np.testing.assert_array_equal(res, gs[r] - deq.numpy())


def _triples():
    rng = np.random.default_rng(4)
    sums = rng.integers(-50, 50, (8, 16)).astype(np.float32)
    cnt = rng.integers(0, 60, 8).astype(np.float32)
    exp, cexp = (np.array(a) for a in jreduce.update_checksums(sums, cnt))
    bad_s = sums.copy()
    bad_s[3, 5] += 64.0
    bad_c = cnt.copy()
    bad_c[6] += 1.0
    small = sums.copy()
    small[2, 2] += 1e-5
    return {"clean": (sums, cnt, exp, cexp), "sum_fault": (bad_s, cnt, exp,
                                                          cexp),
            "count_fault": (sums, bad_c, exp, cexp),
            "under_threshold": (small, cnt, exp, cexp)}


@pytest.mark.parametrize("case", sorted(_triples()))
def test_checksums_match_reference(case):
    sums, cnt, exp, cexp = _triples()[case]
    got = reduce.update_checksums(torch.from_numpy(sums),
                                  torch.from_numpy(cnt))
    want = jreduce.update_checksums(sums, cnt)
    # integer sums are exact in any order; the under-threshold case's are
    # not, and the two packages' weighted sums run in other orders
    rtol = 0 if (sums == np.round(sums)).all() else 1e-6
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol)
    verdict = bool(reduce.checksums_mismatch(
        torch.from_numpy(sums), torch.from_numpy(cnt),
        torch.from_numpy(exp), torch.from_numpy(cexp), 1680))
    want = bool(jreduce.checksums_mismatch(sums, cnt, exp, cexp, 1680))
    assert verdict == want == (case in ("sum_fault", "count_fault"))


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("corrupt", [(), ("intra",), ("cross",),
                                     ("intra", "cross")])
def test_each_corrupted_hop_adds_one_detection(monkeypatch, corrupt,
                                               compress):
    """A value corrupted on a hop's wire (one sum element) fails that hop's
    re-check, one detection a hop; quantisation alone never does."""
    def wire(t, group):
        out = t.clone()
        if group in corrupt:
            out[3] += 64.0
        return out
    monkeypatch.setattr(reduce, "psum", wire)
    rng = np.random.default_rng(5)
    sums = torch.from_numpy(rng.integers(-50, 50, (8, 16)).astype(
        np.float32))
    cnt = torch.from_numpy(rng.integers(1, 60, 8).astype(np.float32))
    bad = reduce.reduce_update(sums, cnt, intra="intra", cross="cross",
                               compress=compress, checked=True,
                               m_total=1680)[2]
    assert int(bad) == len(corrupt)


def test_reduce_plans_and_hops_match_reference():
    assert ReducePlan.flat() == ReducePlan(hierarchical=False)
    assert ReducePlan.compressed().cross_host == "int8"
    assert ReducePlan.compressed(exact=True) == ReducePlan()
    with pytest.raises(ValueError, match="cross_host must be one of"):
        ReducePlan(cross_host="fp8")
    mesh = mesh2d(4, hosts=2)
    axes = ("host", "row", "problem")
    assert reduce.hop_axes(mesh, axes, ReducePlan()) == (
        ("row", "problem"), "host")
    assert reduce.hop_axes(mesh, axes, ReducePlan.flat()) == (axes, None)
    assert reduce.hop_axes(mesh2d(4), axes, ReducePlan()) == (axes, None)


def test_mesh_layout():
    """Ranks fill the (host, row, problem) grid in order; a member's groups
    are the ranks off the other axes."""
    mesh = mesh2d(4, 2, hosts=2)
    assert mesh.shape == {"host": 2, "row": 2, "problem": 2}
    assert mesh.flat() == list(range(8))
    assert mesh.coords(5) == {"host": 1, "row": 0, "problem": 1}
    assert mesh.members(("row",), 5) == (5, 7)
    assert mesh.members(("host", "row"), 5) == (1, 3, 5, 7)
    assert mesh.index(("host", "row"), 5) == 2
    assert sharding.data_axes(mesh) == ("host", "row", "problem")
    with pytest.raises(ValueError, match="must divide over hosts"):
        mesh2d(3, hosts=2)
    with pytest.raises(ValueError, match="needs 8 ranks"):
        mesh2d(4, 2, ranks=range(6))


def test_no_fallback_without_a_card():
    """The distributed path asks for the card and raises without one."""
    with pytest.raises(RuntimeError, match="is_available"):
        KMeans(8, device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        sharding.rank_device("cuda", 0)


def test_worker_loss_policy_is_checked_as_the_reference():
    from repro.api import FaultPolicy as JF
    with pytest.raises(ValueError) as port:
        FaultPolicy(worker_loss="bogus")
    with pytest.raises(ValueError) as ref:
        JF(worker_loss="bogus")
    assert str(port.value) == str(ref.value)
    assert FaultPolicy.elastic().worker_loss == "shrink"
    assert FaultPolicy.elastic(mode="detect").mode == "detect"


# ---------------------------------------------------------------------------
# row mode on four ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plan", ["two_hops", "flat"])
@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_exact_fit_bitwise_single_device_reference(rows, reference, backend,
                                                   plan):
    c, labels, n_iter, inertia = reference[backend]
    got = rows[0][f"{backend}/{plan}"]
    for out in rows:     # the reduce made every rank's centroids the same
        np.testing.assert_array_equal(out[f"{backend}/{plan}"]["centroids"],
                                      got["centroids"])
    np.testing.assert_array_equal(got["centroids"], c)
    np.testing.assert_array_equal(gathered(rows, f"{backend}/{plan}"),
                                  labels)
    assert got["iters"] == n_iter
    assert got["inertia"] == pytest.approx(inertia, rel=INERTIA_RTOL)
    assert got["det"] == 0       # a clean FT fit: 0 after both hops
    assert got["host_syncs"] == n_iter + 1


def test_campaign_bitwise_clean_detections_summed(rows):
    clean, camp = rows[0]["lloyd_ft/two_hops"], rows[0]["campaign"]
    np.testing.assert_array_equal(camp["centroids"], clean["centroids"])
    np.testing.assert_array_equal(gathered(rows, "campaign"),
                                  gathered(rows, "lloyd_ft/two_hops"))
    local = [out["campaign"]["local_det"] for out in rows]
    assert min(local) > 0
    assert camp["det"] == sum(local)


def test_int8_hop_within_reference_bars(rows):
    exact, int8 = rows[0]["exact11"], rows[0]["int8"]
    scale = float(np.abs(exact["centroids"]).max())
    assert float(np.abs(int8["centroids"] - exact["centroids"]).max()) \
        / scale < INT8_CENTROID_BAR
    assert abs(int8["inertia"] - exact["inertia"]) / exact["inertia"] \
        < INT8_INERTIA_BAR
    assert int8["det"] == 0
    # the checked hops never take quantisation for corruption
    assert rows[0]["int8_ft"]["det"] == 0
    np.testing.assert_array_equal(rows[0]["int8_exact"]["centroids"],
                                  exact["centroids"])
    np.testing.assert_array_equal(gathered(rows, "int8_exact"),
                                  gathered(rows, "exact11"))


def test_int8_hop_matches_reference_compressed_fit(data, rows, tmp_path):
    """The reference's own compressed fit on four virtual devices: the same
    labels and iterations, 0 detected, centroids within INT8_REF_RTOL."""
    x, c0 = data["int11"]
    np.save(tmp_path / "x.npy", x)
    np.save(tmp_path / "c0.npy", c0)
    out = run_with_devices(f"""
    import numpy as np
    from repro.api import KMeans
    from repro.dist.kmeans_dist import DistributedKMeans
    from repro.dist.reduce import ReducePlan
    from repro.dist.sharding import mesh2d
    tmp = {str(tmp_path)!r}
    x, c0 = np.load(tmp + "/x.npy"), np.load(tmp + "/c0.npy")
    d = DistributedKMeans(KMeans(8, max_iter=15, tol=1e-4, random_state=0,
                                 backend="lloyd_xla"), mesh2d(4, hosts=2),
                          reduce=ReducePlan.compressed())
    c, am, inertia, iters, det = d.fit(d.shard_data(x), c0)
    np.save(tmp + "/c.npy", np.asarray(c))
    np.save(tmp + "/am.npy", np.asarray(am))
    print("ITERS", int(iters), "DET", int(det))
    """, n=4, timeout=SPAWN_S)
    got = rows[0]["int8"]
    np.testing.assert_array_equal(gathered(rows, "int8"),
                                  np.load(tmp_path / "am.npy"))
    np.testing.assert_allclose(got["centroids"], np.load(tmp_path / "c.npy"),
                               rtol=INT8_REF_RTOL, atol=0)
    assert f"ITERS {got['iters']} DET 0" in out


def test_real_valued_fit_within_tolerance(data, rows):
    xr, cr = data["real"]
    km = KMeans(R.K, max_iter=6, tol=0.0, backend="lloyd",
                device="cpu").fit(xr, centroids=cr)
    got = rows[0]["real"]
    np.testing.assert_allclose(got["centroids"], km.cluster_centers_.numpy(),
                               rtol=REAL_RTOL, atol=REAL_RTOL)
    np.testing.assert_array_equal(gathered(rows, "real"), km.labels_.numpy())
    assert got["inertia"] == pytest.approx(km.inertia_, rel=REAL_RTOL)


# ---------------------------------------------------------------------------
# problem-axis and combined modes on four ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stacks(ranks, stack_data):
    """The ranks' problem-axis and combined fits, the port's single-device
    ``BatchedKMeans`` and the reference's (its default backend here,
    ``lloyd_batched_xla``), both with the ranks' pinned tiles."""
    xs, cs = stack_data
    kw = dict(max_iter=12, tol=1e-4, sync_every=5)
    bkm = BatchedKMeans(R.K, params=R.BATCH_TILES, device="cpu",
                        **kw).fit(xs, centroids=cs)
    t = R.BATCH_TILES
    jbkm = JBatchedKMeans(R.K, params=jops.KernelParams(
        t.block_m, t.block_k, t.block_f), **kw).fit(xs, centroids=cs)
    return ranks[1], {"port": (bkm.cluster_centers_.numpy(),
                               bkm.labels_.numpy(), bkm.n_iter_,
                               bkm.inertia_),
                      "reference": (np.asarray(jbkm.cluster_centers_),
                                    np.asarray(jbkm.labels_),
                                    np.asarray(jbkm.n_iter_),
                                    np.asarray(jbkm.inertia_))}


def _combined(outs):
    """mesh2d(2, 2): ranks [[0, 1], [2, 3]] on (row, problem); rank r holds
    rows r // 2 of problems 4 (r % 2) .. 4 (r % 2) + 3."""
    c = np.concatenate([outs[p]["combined"]["centroids"] for p in (0, 1)])
    labels = np.concatenate([np.concatenate(
        [outs[p]["combined"]["labels"], outs[p + 2]["combined"]["labels"]],
        axis=1) for p in (0, 1)])
    iters = np.concatenate([outs[p]["combined"]["iters"] for p in (0, 1)])
    inertia = np.concatenate([outs[p]["combined"]["inertia"]
                              for p in (0, 1)])
    return c, labels, iters, inertia


@pytest.mark.parametrize("single", ["port", "reference"])
def test_problem_axis_bitwise_batched(stacks, single):
    outs, fits = stacks     # mesh2d(1, 4): rank r holds problems 2r, 2r + 1
    c, labels, iters, inertia = fits[single]
    got = {k: np.concatenate([o["problems"][k] for o in outs])
           for k in ("centroids", "labels", "iters", "inertia")}
    np.testing.assert_array_equal(got["centroids"], c)
    np.testing.assert_array_equal(got["labels"], labels)
    np.testing.assert_array_equal(got["iters"], iters)
    if single == "port":
        np.testing.assert_array_equal(got["inertia"], inertia)
    else:       # the reference sums the f32 squares in another order
        np.testing.assert_allclose(got["inertia"], inertia,
                                   rtol=INERTIA_RTOL)
    assert len(set(got["iters"])) > 1       # problems froze apart


@pytest.mark.parametrize("single", ["port", "reference"])
def test_combined_bitwise_batched(stacks, single):
    outs, fits = stacks
    c, labels, iters, inertia = fits[single]
    got = _combined(outs)
    np.testing.assert_array_equal(got[0], c)
    np.testing.assert_array_equal(got[1], labels)
    np.testing.assert_array_equal(got[2], iters)
    np.testing.assert_allclose(got[3], inertia, rtol=INERTIA_RTOL)


def test_combined_refuses_int8_hop(stacks):
    outs = stacks[0]
    assert all("row-mode (single-problem) only" in o["combined_int8"]
               for o in outs)


# ---------------------------------------------------------------------------
# the rig itself: a hang or a failure ends in time, with the ranks' logs
# ---------------------------------------------------------------------------

def test_run_ranks_kills_a_hang():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="not done within 10 s"):
        sharding.run_ranks(R.hang, 2, device="cpu", backend="gloo",
                           timeout=10)
    assert time.monotonic() - t0 < 60


def test_run_ranks_reports_a_failure():
    with pytest.raises(RuntimeError) as err:
        sharding.run_ranks(R.fail, 2, device="cpu", backend="gloo",
                           timeout=SPAWN_S)
    assert "ValueError: rank 1 fails on purpose" in str(err.value), \
        str(err.value)
