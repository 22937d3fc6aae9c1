"""Port vs reference for the estimator, on the CPU.

Both packages fit the same numpy data from the same explicit centroids
(``torch.Generator`` cannot reproduce ``jax.random`` draws, so seeding is
held to its properties instead). The reference pins its Pallas backends,
which run in interpret mode here: ``fused`` for ``FaultPolicy.off()``,
``lloyd_ft`` for ``FaultPolicy.correct()``. Labels and iteration counts
must be equal; centroids and inertia agree to rtol 1e-5 (f32 sums in a
different order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import FaultPolicy as JFaultPolicy  # noqa: E402
from repro.api import InjectionCampaign as JCampaign  # noqa: E402
from repro.api import KMeans as JKMeans  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.api import FaultPolicy, InjectionCampaign, KMeans  # noqa: E402
from repro_torch.data.blobs import make_blobs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

M, F, K = 433, 150, 140          # 4 x 2 x 2 tiles at (128, 128, 128)
TILES = (128, 128, 128)
RTOL = 1e-5


@pytest.fixture(scope="module")
def data():
    x, _ = make_blobs(M, F, 11, seed=7)
    c0 = x[np.random.default_rng(7).choice(M, K, replace=False)]
    return x, c0


def _port(policy, backend=None, **kw):
    kw.setdefault("max_iter", 5)
    kw.setdefault("tol", 0.0)
    return KMeans(K, fault=policy, backend=backend,
                  params=ops.KernelParams(*TILES), device="cpu", **kw)


def _ref(policy, backend, **kw):
    kw.setdefault("max_iter", 5)
    kw.setdefault("tol", 0.0)
    return JKMeans(K, fault=policy, backend=backend,
                   params=jops.KernelParams(*TILES), **kw)


def _scale(a):
    return RTOL * max(float(np.abs(a).max()), 1.0)


# (port policy, port backend, reference policy, reference backend)
FITS = {
    "off": (FaultPolicy.off(), None, JFaultPolicy.off(), "fused"),
    "correct": (FaultPolicy.correct(), None, JFaultPolicy.correct(),
                "lloyd_ft"),
    "lloyd": (FaultPolicy.off(), "lloyd", JFaultPolicy.off(), "lloyd"),
}


@pytest.mark.parametrize("name", sorted(FITS))
def test_fit_matches_reference(data, name):
    x, c0 = data
    pol, backend, jpol, jbackend = FITS[name]
    km = _port(pol, backend).fit(x, centroids=c0)
    jk = _ref(jpol, jbackend).fit(x, centroids=c0)
    assert km._backend.name == (backend or {"off": "fused"}.get(
        pol.mode, "lloyd_ft"))
    np.testing.assert_array_equal(km.labels_.numpy(), np.asarray(jk.labels_))
    assert km.n_iter_ == jk.n_iter_ == 5
    ref_c = np.asarray(jk.cluster_centers_)
    np.testing.assert_allclose(km.cluster_centers_.numpy(), ref_c, rtol=0,
                               atol=_scale(ref_c))
    assert km.inertia_ == pytest.approx(jk.inertia_, rel=RTOL)
    assert km.detected_errors_ == jk.detected_errors_ == 0
    assert km._n_host_syncs == jk._n_host_syncs


def test_fused_and_lloyd_fits_are_bitwise_equal(data):
    """The two-pass update sums in the one-pass kernels' order, so the
    ``fused`` and ``lloyd`` fits agree bit for bit, and the clean
    protected fit equals both."""
    x, c0 = data
    fits = [_port(FaultPolicy.off(), b).fit(x, centroids=c0)
            for b in (None, "lloyd")]
    fits.append(_port(FaultPolicy.correct()).fit(x, centroids=c0))
    for km in fits[1:]:
        assert torch.equal(km.cluster_centers_, fits[0].cluster_centers_)
        assert torch.equal(km.labels_, fits[0].labels_)


@pytest.mark.parametrize("sync_every", [1, 3])
def test_convergence_freezes_mid_chunk(data, sync_every):
    """With tol > 0 the device-side ``done`` flag stops the fit at the same
    iteration as the reference, whatever the chunk size, and the host is
    read once per chunk plus once at the end."""
    x, c0 = data
    kw = dict(max_iter=30, tol=1e-3, sync_every=sync_every)
    km = _port(FaultPolicy.off(), **kw).fit(x, centroids=c0)
    jk = _ref(JFaultPolicy.off(), "fused", **kw).fit(x, centroids=c0)
    assert km.n_iter_ == jk.n_iter_ < 30
    np.testing.assert_array_equal(km.labels_.numpy(), np.asarray(jk.labels_))
    assert km._n_host_syncs == -(-km.n_iter_ // sync_every) + 1
    assert km._n_host_syncs == jk._n_host_syncs


def test_on_iteration_replay(data):
    x, c0 = data
    seen = []
    km = _port(FaultPolicy.off(), sync_every=2).fit(
        x, centroids=c0, on_iteration=lambda it, c, inertia, shift:
        seen.append((it, inertia)))
    assert [s[0] for s in seen] == list(range(5))
    assert seen[-1][1] == pytest.approx(km.inertia_)


def test_campaign_detects_like_reference_and_recovers_bitwise(data):
    """A seeded campaign on both FT intervals: the same descriptors are
    drawn in both packages, both count the same detections, and the port's
    centroids are bit for bit its clean protected fit's."""
    x, c0 = data
    camp = dict(rate=1.0, targets="both", seed=3)
    km = _port(FaultPolicy.correct(injection=InjectionCampaign(**camp))
               ).fit(x, centroids=c0)
    jk = _ref(JFaultPolicy.correct(injection=JCampaign(**camp)),
              None).fit(x, centroids=c0)
    clean = _port(FaultPolicy.correct()).fit(x, centroids=c0)
    assert km.detected_errors_ == jk.detected_errors_ > 0
    assert torch.equal(km.cluster_centers_, clean.cluster_centers_)
    assert torch.equal(km.labels_, clean.labels_)


def test_campaign_draws_match_reference(data):
    """The estimator's per-chunk schedule equals the reference's."""
    x, _ = data
    camp = dict(rate=1.5, targets="both", seed=9)
    km = _port(FaultPolicy.correct(injection=InjectionCampaign(**camp)))
    jk = _ref(JFaultPolicy.correct(injection=JCampaign(**camp)), None)
    p = km._resolve_params(M, F)
    jp = jk._resolve_params(M, F)
    rng, jrng = km._campaign_rng(), jk._campaign_rng()
    for _ in range(6):
        np.testing.assert_array_equal(
            km._draw_injection(rng, M, F, p).numpy(),
            np.asarray(jk._draw_injection(jrng, M, F, jp)))


@pytest.mark.parametrize("mode", ["off", "correct"])
def test_state_from_reference(data, mode):
    x, c0 = data
    jpol = JFaultPolicy.off() if mode == "off" else JFaultPolicy.correct()
    jk = _ref(jpol, None).fit(x, centroids=c0)
    km = KMeans.from_state(convert.from_reference_state(jk.get_state()),
                           device="cpu")
    assert km.fault.mode == mode and km.n_iter_ == jk.n_iter_
    np.testing.assert_array_equal(km.predict(x).numpy(),
                                  np.asarray(jk.predict(x)))
    assert km.score(x) == pytest.approx(jk.score(x), rel=RTOL)


@pytest.mark.parametrize("mode", ["off", "correct"])
def test_state_to_reference(data, mode):
    x, c0 = data
    pol = FaultPolicy.off() if mode == "off" else FaultPolicy.correct()
    km = _port(pol).fit(x, centroids=c0)
    state = km.get_state()
    assert state["config"]["device"] == "cpu"
    jk = JKMeans.from_state(convert.to_reference_state(state))
    assert jk.fault.mode == mode and jk.params == jops.KernelParams(*TILES)
    np.testing.assert_array_equal(np.asarray(jk.predict(x)),
                                  km.predict(x).numpy())


def test_state_fields_the_port_lacks():
    """The reference's bit-range keys: filled with the reference's defaults
    on the way out, dropped on the way in; the worker-loss policy passes
    through both ways, the elastic one included."""
    camp = dict(rate=1.0, seed=3, targets="both")
    jk = _ref(JFaultPolicy.correct(injection=JCampaign(**camp)), None)
    jk.cluster_centers_ = np.eye(K, F, dtype=np.float32)
    state = convert.from_reference_state(jk.get_state())
    assert state["config"]["fault"]["worker_loss"] == "fail"
    km = KMeans.from_state(state, device="cpu")
    assert km.fault.injection == InjectionCampaign(**camp)
    back = convert.to_reference_state(km.get_state())
    assert back["config"]["fault"]["worker_loss"] == "fail"
    assert back["config"]["fault"]["injection"] == dict(
        camp, bit_low=20, bit_high=30)
    assert JKMeans.from_state(back).fault == jk.fault
    elastic = _ref(JFaultPolicy.elastic(), None)
    elastic.cluster_centers_ = jk.cluster_centers_
    km = KMeans.from_state(convert.from_reference_state(elastic.get_state()),
                           device="cpu")
    assert km.fault == FaultPolicy.elastic()
    back = convert.to_reference_state(km.get_state())
    assert JKMeans.from_state(back).fault == elastic.fault


def test_state_round_trip_in_port(data):
    x, c0 = data
    km = _port(FaultPolicy.correct()).fit(x, centroids=c0)
    km2 = KMeans.from_state(km.get_state())
    assert km2.device == km.device
    assert torch.equal(km2.cluster_centers_, km.cluster_centers_)
    assert torch.equal(km2.predict(x), km.predict(x))


@pytest.mark.parametrize("init", ["kmeans++", "random"])
def test_seeding_properties(data, init):
    """K distinct real rows, the same for one seed, different across
    seeds."""
    x, _ = data
    xt = torch.from_numpy(x)
    a = KMeans(K, init=init, random_state=1, device="cpu").init_centroids(xt)
    b = KMeans(K, init=init, random_state=1, device="cpu").init_centroids(xt)
    c = KMeans(K, init=init, random_state=2, device="cpu").init_centroids(xt)
    assert a.shape == (K, F) and torch.equal(a, b) and not torch.equal(a, c)
    rows = {tuple(r) for r in x.tolist()}
    assert all(tuple(r) in rows for r in a.tolist())
    assert len({tuple(r) for r in a.tolist()}) == K


def test_fit_without_centroids_seeds_itself(data):
    x, _ = data
    km = KMeans(K, max_iter=3, random_state=4, device="cpu").fit(x)
    seeded = km.init_centroids(torch.from_numpy(x))
    again = KMeans(K, max_iter=3, random_state=4, device="cpu").fit(
        x, centroids=seeded)
    assert torch.equal(km.cluster_centers_, again.cluster_centers_)


def test_partial_fit_streams(data):
    x, c0 = data
    km = _port(FaultPolicy.correct())
    km.partial_fit(x[:200])
    km.partial_fit(x[200:])
    assert km.n_iter_ == 2 and km.detected_errors_ == 0
    assert km._counts.sum().item() == M
    assert torch.isfinite(km.cluster_centers_).all()


def test_transform_and_predict_chunks(data):
    x, c0 = data
    km = _port(FaultPolicy.off(), predict_chunk_rows=100).fit(
        x, centroids=c0)
    whole = _port(FaultPolicy.off()).fit(x, centroids=c0)
    assert torch.equal(km.predict(x), whole.predict(x))
    d = km.transform(x)
    assert d.shape == (M, K)
    assert torch.equal(d.argmin(1).to(torch.int32), km.predict(x))
