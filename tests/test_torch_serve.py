"""The port's k-means serving layer (``repro_torch.serve``,
``KMeans.to_service``) against the reference's, on the CPU.

A reference ``KMeansService`` and the port's, built from the same centroids
at buckets (16, 64), answer requests of 0, 1, 15, 16, 17, 64 and 150 rows
(below, at and past a bucket, past the top one) with the same labels and
squared distances within rtol 1e-5; a reference service's state serves
from the port with the reference's labels. The port's own service answers
bit for bit as its estimator's ``predict`` (``fused``, the FT ``fused_ft``
cells of a ``lloyd_ft`` model, bf16, int8), pins one codebook version per
micro-batch under the ``on_dispatch`` hook, bumps it on ``refine``, and its
store round-trips and refuses another model shape. On the CPU the cells
are eager calls at the bucket's shapes (no graph, ``captures`` 0); the
graphs run on the card (``chip_smoke.py`` phase 15). The reference's
Pallas backends run in interpret mode. Inputs are made from a seed with
numpy.
"""
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import FaultPolicy as JFaultPolicy  # noqa: E402
from repro.api import KMeans as JKMeans  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.serve import CodebookStore as JCodebookStore  # noqa: E402
from repro.serve import KMeansService as JKMeansService  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.api import (AutotuneCache, FaultPolicy,  # noqa: E402
                             InjectionCampaign, KMeans, get_backend)
from repro_torch.data.blobs import make_blobs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serve import (DEFAULT_BUCKETS, Codebook,  # noqa: E402
                               CodebookStore, KMeansService, ServeCompiler,
                               ServeResult, plan_ladder)
from repro_torch.serve import __all__ as serve_all  # noqa: E402
from repro.serve import __all__ as j_serve_all  # noqa: E402

M, F, K = 400, 40, 24
BUCKETS = (16, 64)
SIZES = (0, 1, 15, 16, 17, 64, 150)
TILES = (128, 128, 128)
RTOL = 1e-5


@pytest.fixture(scope="module")
def data():
    x, _ = make_blobs(M, F, 8, seed=21)
    c0 = x[np.random.default_rng(21).choice(M, K, replace=False)]
    return x, c0


def _requests(x):
    rng = np.random.default_rng(5)
    return [x[rng.choice(M, m, replace=True)] for m in SIZES]


def _pair(data, jbackend, jfault):
    """A reference model fitted two steps from c0 and the port's model
    loaded from its state: the same centroids, bit for bit."""
    x, c0 = data
    jk = JKMeans(K, fault=jfault, backend=jbackend, max_iter=2, tol=0.0,
                 params=jops.KernelParams(*TILES)).fit(x, centroids=c0)
    km = KMeans.from_state(convert.from_reference_state(jk.get_state()),
                           device="cpu")
    assert np.array_equal(km.cluster_centers_.numpy(),
                          np.asarray(jk.cluster_centers_))
    return jk, km


# reference backend and policy -> the port's predict backend
PAIRS = {"fused": ("fused", JFaultPolicy.off(), "fused"),
         "lloyd_ft": ("lloyd_ft", JFaultPolicy.correct(), "fused_ft"),
         "lloyd_xla": ("lloyd_xla", JFaultPolicy.off(), "fused")}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_service_matches_reference(data, name):
    jbackend, jfault, port_backend = PAIRS[name]
    jk, km = _pair(data, jbackend, jfault)
    jsvc = jk.to_service(buckets=BUCKETS)
    svc = km.to_service(buckets=BUCKETS)
    assert svc.compiler.backend.name == port_backend
    assert svc.compiler.buckets == BUCKETS and svc.compiler.captures == 0
    for q in _requests(data[0]):
        got, want = svc.predict(q), jsvc.predict(q)
        assert isinstance(got, ServeResult)
        assert got.labels.dtype == np.int32 and got.labels.shape == (len(q),)
        np.testing.assert_array_equal(got.labels, np.asarray(want.labels))
        np.testing.assert_allclose(got.sq_dists, np.asarray(want.sq_dists),
                                   rtol=RTOL, atol=RTOL * float(
                                       (q * q).sum(1).max(initial=1.0)))
        assert int(got.detected) == int(want.detected) == 0
        assert got.version == want.version == 1


def test_reference_state_serves_from_the_port(data):
    """A reference service's state (its store, config and estimator) loads
    into the port through ``convert`` and answers with its labels; the
    port's state goes back the other way."""
    jk, _ = _pair(data, "lloyd_xla", JFaultPolicy.off())
    jsvc = jk.to_service(buckets=BUCKETS)
    jsvc.publish(np.asarray(jk.cluster_centers_) + 0.25)
    state = convert.from_reference_service_state(jsvc.get_state())
    assert state["config"]["backend"] == "gemm_fused"
    svc = KMeansService.from_state(state, device="cpu")
    assert svc.store.versions == (1, 2) and svc.compiler.buckets == BUCKETS
    assert svc.estimator.backend == "lloyd"
    for q in _requests(data[0]):
        got, want = svc.predict(q), jsvc.predict(q)
        np.testing.assert_array_equal(got.labels, np.asarray(want.labels))
        assert got.version == want.version == 2
    back = JKMeansService.from_state(
        convert.to_reference_service_state(svc.get_state()))
    q = _requests(data[0])[-1]
    np.testing.assert_array_equal(np.asarray(back.predict(q).labels),
                                  svc.predict(q).labels)


MODELS = {
    "fused": dict(),
    "lloyd_ft": dict(fault=FaultPolicy.correct()),
    "campaign": dict(fault=FaultPolicy.correct(
        injection=InjectionCampaign(rate=1.0, targets="both"))),
    "bf16": dict(compute_dtype="bfloat16"),
    "fp16_lloyd": dict(compute_dtype="float16", backend="lloyd"),
    "int8": dict(compute_dtype="int8"),
    "detect": dict(fault=FaultPolicy.detect()),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_service_is_bitwise_predict(data, name):
    x, c0 = data
    km = KMeans(K, max_iter=3, tol=0.0, device="cpu",
                **MODELS[name]).fit(x, centroids=c0)
    svc = km.to_service(buckets=BUCKETS)
    for q in _requests(x) + [x]:
        got = svc.predict(q)
        am, md, det = km._predict_full(torch.as_tensor(q))
        np.testing.assert_array_equal(got.labels, am.numpy())
        np.testing.assert_array_equal(got.sq_dists.view(np.int32),
                                      md.numpy().view(np.int32))
        if name != "detect":
            assert int(got.detected) == int(det) == 0
    # ``detect``'s offline check counts clean-product noise over the whole
    # product it verifies, so its count follows the bucket a request ran
    # in; the labels and distances do not


def test_oversize_chunks_keep_each_chunks_rows(data):
    """A request of 5 top buckets and 3 rows runs 6 chunks through the top
    cell; every chunk's rows come back, not the last chunk's."""
    x, c0 = data
    km = KMeans(K, max_iter=1, tol=0.0, device="cpu").fit(x, centroids=c0)
    comp = km.to_service(buckets=BUCKETS).compiler
    q = x[np.random.default_rng(1).choice(M, 5 * 64 + 3)]
    am, md, det = comp.dispatch(q, km.cluster_centers_)
    assert am.shape == (5 * 64 + 3,)
    np.testing.assert_array_equal(am.numpy(), km.predict(q).numpy())
    assert tuple(comp._cells) == BUCKETS
    assert comp.bucket_for(1) == 16 and comp.bucket_for(17) == 64
    assert comp.bucket_for(10_000) == 64


def test_zero_rows_never_touch_a_cell(data):
    x, c0 = data
    km = KMeans(K, max_iter=1, tol=0.0, device="cpu").fit(x, centroids=c0)
    comp = km.to_service(buckets=BUCKETS).compiler
    calls = []
    for b in BUCKETS:
        cell = comp.cell(b)
        cell.run = (lambda run: lambda: calls.append(1) or run())(cell.run)
    am, md, det = comp.dispatch(np.zeros((0, F), np.float32),
                                km.cluster_centers_)
    assert am.shape == (0,) and am.dtype == torch.int32
    assert md.shape == (0,) and md.dtype == torch.float32
    assert int(det) == 0 and calls == []
    comp.dispatch(x[:3], km.cluster_centers_)
    assert calls == [1]
    with pytest.raises(ValueError, match="features"):
        comp.dispatch(np.zeros((2, F + 1), np.float32), km.cluster_centers_)


def test_version_pinned_per_batch(data):
    """A publish from the ``on_dispatch`` hook (mid-flight) does not reach
    the batch that already pinned its codebook; the next batch serves
    it."""
    x, c0 = data
    km = KMeans(K, max_iter=1, tol=0.0, device="cpu").fit(x, centroids=c0)
    moved = km.cluster_centers_ + 100.0
    svc = None

    def hook(cb):
        if cb.version == 1:
            svc.publish(moved)
    svc = KMeansService.from_estimator(km, buckets=BUCKETS,
                                       on_dispatch=hook)
    first = svc.predict(x[:20])
    assert first.version == 1
    np.testing.assert_array_equal(first.labels, km.predict(x[:20]).numpy())
    second = svc.predict(x[:20])
    assert second.version == 2
    am, _ = ops.fused_assign(torch.as_tensor(x[:20]), moved)
    np.testing.assert_array_equal(second.labels, am.numpy())


def test_refine_bumps_the_version(data):
    x, c0 = data
    km = KMeans(K, max_iter=1, tol=0.0, device="cpu").fit(x, centroids=c0)
    svc = km.to_service(buckets=BUCKETS)
    before = svc.store.current().centroids.clone()
    assert svc.refine(x[:100]) == 2
    assert km.n_iter_ == 2
    assert svc.store.current().version == 2
    assert torch.equal(svc.store.current().centroids, km.cluster_centers_)
    assert not torch.equal(svc.store.current().centroids, before)
    assert torch.equal(svc.store.get(1).centroids, before)
    plain = KMeansService(svc.compiler, CodebookStore(before))
    with pytest.raises(ValueError, match="estimator"):
        plain.refine(x[:10])


def test_store_round_trip_and_shape_refusal():
    rng = np.random.default_rng(3)
    cents = [rng.normal(size=(K, F)).astype(np.float32) for _ in range(5)]
    store = CodebookStore(cents[0], keep=3, device="cpu")
    for c in cents[1:]:
        store.publish(torch.as_tensor(c))
    assert store.versions == (3, 4, 5) and store.current().version == 5
    with pytest.raises(KeyError, match="not retained"):
        store.get(1)
    state = store.get_state()
    assert sorted(state) == ["codebooks", "current", "keep"]
    again = CodebookStore.from_state(state, device="cpu")
    for v in (3, 4, 5):
        assert again.get(v).centroids.numpy().tobytes() == \
            cents[v - 1].tobytes()
    # interchange with the reference's store, both ways, bit for bit
    jstore = JCodebookStore.from_state(state)
    assert np.asarray(jstore.current().centroids).tobytes() == \
        cents[4].tobytes()
    back = CodebookStore.from_state(jstore.get_state(), device="cpu")
    assert back.versions == (3, 4, 5)
    assert back.current().centroids.numpy().tobytes() == cents[4].tobytes()
    with pytest.raises(ValueError, match="shape"):
        store.publish(np.zeros((K + 1, F), np.float32))
    with pytest.raises(ValueError, match="keep"):
        CodebookStore(cents[0], keep=0, device="cpu")
    src = torch.as_tensor(cents[0]).clone()
    cb = CodebookStore(src, device="cpu").current()
    src += 1.0                                     # the store kept a copy
    assert isinstance(cb, Codebook) and cb.shape == (K, F)
    assert cb.centroids.numpy().tobytes() == cents[0].tobytes()


def test_state_round_trip_serves_the_same(data):
    x, c0 = data
    km = KMeans(K, fault=FaultPolicy.correct(), max_iter=2, tol=0.0,
                device="cpu").fit(x, centroids=c0)
    svc = km.to_service(buckets=BUCKETS, window_s=0.002)
    svc.publish(km.cluster_centers_ * 1.01)
    again = KMeansService.from_state(svc.get_state(), device="cpu")
    assert again.batcher.window_s == pytest.approx(0.002)
    assert again.compiler.backend.name == "fused_ft"
    assert again.store.versions == (1, 2)
    for q in _requests(x):
        a, b = svc.predict(q), again.predict(q)
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_array_equal(a.sq_dists, b.sq_dists)
        assert a.version == b.version == 2


@pytest.mark.parametrize("started", [True, False])
def test_threads_share_the_batcher(data, started):
    """24 threads (more than the cores) with a short switch interval: with
    the window loop running their requests coalesce, without it each
    thread flushes itself and the compiler's lock keeps the cells' static
    buffers to one request at a time; each answer is its own rows'."""
    x, c0 = data
    km = KMeans(K, max_iter=1, tol=0.0, device="cpu").fit(x, centroids=c0)
    svc = km.to_service(buckets=BUCKETS, window_s=0.01)
    rng = np.random.default_rng(9)
    reqs = [x[rng.choice(M, int(n))] for n in rng.integers(0, 90, 24)]
    out = [None] * len(reqs)

    def worker(i):
        out[i] = svc.predict(reqs[i])
    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(reqs))]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        if started:
            svc.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        svc.stop()
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for q, r in zip(reqs, out):
        np.testing.assert_array_equal(r.labels, km.predict(q).numpy())


def test_ladder_plan_reaches_to_service(data):
    """``plan_ladder`` with a cache persists the ladder and its window;
    ``to_service()`` of an estimator on that cache serves at them."""
    x, c0 = data
    cache = AutotuneCache()
    plan = plan_ladder(K, F, cache=cache, min_rows=16, max_rows=256)
    assert plan.buckets[-1] == 256 and len(plan.buckets) <= 4
    assert plan.window_us > 0
    km = KMeans(K, max_iter=1, tol=0.0, device="cpu", autotune=cache).fit(
        x, centroids=c0)
    svc = km.to_service()
    assert svc.compiler.buckets == plan.buckets
    assert svc.batcher.window_s == pytest.approx(plan.window_us * 1e-6)
    for size, (_, p) in plan.winners.items():
        assert svc.compiler.bucket_params(size) == ops.clamp_params(
            size, K, F, p)
    bare = KMeans(K, max_iter=1, tol=0.0, device="cpu",
                  autotune=AutotuneCache()).fit(x, centroids=c0)
    assert bare.to_service().compiler.buckets == DEFAULT_BUCKETS
    assert bare.to_service().batcher.window_s == 0.0


def test_compiler_checks(data):
    with pytest.raises(ValueError, match="bucket"):
        ServeCompiler(get_backend("fused"), K, F, buckets=(), device="cpu")
    with pytest.raises(ValueError, match="positive"):
        ServeCompiler(get_backend("fused"), K, F, buckets=(0, 8),
                      device="cpu")
    comp = ServeCompiler(get_backend("fused"), K, F, buckets=(64, 16, 16),
                         device="cpu",
                         params=ops.KernelParams(128, 128, 32))
    assert comp.buckets == (16, 64)
    assert comp.bucket_params(16) == ops.KernelParams(64, 128, 32)
    assert comp.bucket_params is not None
    with pytest.raises(ValueError, match="compiler cells"):
        KMeansService(comp, CodebookStore(np.zeros((K + 1, F), np.float32),
                                          device="cpu"))
    with pytest.raises(RuntimeError, match="cuda"):
        ServeCompiler(get_backend("fused"), K, F, device="cuda")


def test_unfitted_to_service_raises():
    with pytest.raises(Exception, match="not fitted"):
        KMeans(K, device="cpu").to_service()


def test_package_exports_the_reference_names():
    assert sorted(serve_all) == sorted(j_serve_all)


@pytest.mark.parametrize("f", [16, 100, 128, 300])
def test_row_norms_do_not_move_with_the_row_count(f):
    """A request's row norms are the bits those rows have in any larger X,
    so a request served in a padded bucket gets ``predict``'s distances
    (on the card under 512 rows through a zero-padded copy; on the CPU the
    plain sum, the same bits)."""
    x = torch.as_tensor(np.random.default_rng(f).normal(
        size=(700, f)).astype(np.float32))
    full = ops.row_norms(x)
    assert torch.equal(full, (x ** 2).sum(1))
    for m in (1, 2, 7, 15, 16, 17, 100, 511, 512, 700):
        assert torch.equal(ops.row_norms(x[:m]), full[:m]), m
    assert ops.row_norms(x[:0]).shape == (0,)
