"""Mini-batch fits (``KMeans(batch_size=...)``) of the port against the
reference's, on the CPU.

Both packages draw each batch from ``np.random.default_rng(random_state +
1)`` and each campaign descriptor from the fit's campaign stream, so from
the same explicit centroids and tiles they fit the same batches: labels
and ``n_iter_`` equal, centres and inertia within f32 rounding (rtol 1e-5
of the largest centre: sums in another order), detections equal for the
same campaign. The reference's Pallas backends run in interpret mode, its
int8 template through ``int8_xla``, which assembles each distance from
its f32 carrier's terms in another order than the port's int8 plain
version: there each row's distance is held to 1e-6 of the largest squared
row norm (``test_torch_int8.py``'s bar), so the int8 inertia to M times
that. Inputs are made from a seed with numpy.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import FaultPolicy as JFaultPolicy  # noqa: E402
from repro.api import InjectionCampaign as JCampaign  # noqa: E402
from repro.api import KMeans as JKMeans  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.api import FaultPolicy, InjectionCampaign, KMeans  # noqa: E402
from repro_torch.data.blobs import make_blobs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

M, F, K = 600, 40, 24
BATCH = 200                      # 2 x 1 x 1 tiles at (128, 128, 128)
TILES = (128, 128, 128)
RTOL = 1e-5
CAMP = dict(rate=1.0, targets="both", seed=5)


@pytest.fixture(scope="module")
def data():
    x, _ = make_blobs(M, F, 8, seed=11)
    c0 = x[np.random.default_rng(11).choice(M, K, replace=False)]
    return x, c0


# name -> (port kwargs, reference kwargs)
CASES = {
    "off": (dict(fault=FaultPolicy.off()),
            dict(fault=JFaultPolicy.off(), backend="fused")),
    "off_lloyd": (dict(fault=FaultPolicy.off(), backend="lloyd"),
                  dict(fault=JFaultPolicy.off(), backend="lloyd")),
    "correct": (dict(fault=FaultPolicy.correct()),
                dict(fault=JFaultPolicy.correct(), backend="lloyd_ft")),
    "campaign": (
        dict(fault=FaultPolicy.correct(injection=InjectionCampaign(**CAMP))),
        dict(fault=JFaultPolicy.correct(injection=JCampaign(**CAMP)))),
    "detect": (dict(fault=FaultPolicy.detect()),
               dict(fault=JFaultPolicy.detect())),
    "int8": (dict(compute_dtype="int8"), dict(compute_dtype="int8")),
}


def _fit_pair(data, name, **kw):
    x, c0 = data
    pkw, jkw = CASES[name]
    kw = dict(dict(max_iter=4, tol=0.0, batch_size=BATCH), **kw)
    km = KMeans(K, params=ops.KernelParams(*TILES), device="cpu", **pkw,
                **kw).fit(x, centroids=c0)
    jk = JKMeans(K, params=jops.KernelParams(*TILES), **jkw,
                 **kw).fit(x, centroids=c0)
    return km, jk


@pytest.mark.parametrize("name", sorted(CASES))
def test_minibatch_matches_reference(data, name):
    km, jk = _fit_pair(data, name)
    np.testing.assert_array_equal(km.labels_.numpy(), np.asarray(jk.labels_))
    assert km.n_iter_ == jk.n_iter_ == 4
    ref_c = np.asarray(jk.cluster_centers_)
    np.testing.assert_allclose(km.cluster_centers_.numpy(), ref_c, rtol=0,
                               atol=RTOL * max(float(np.abs(ref_c).max()),
                                               1.0))
    x = data[0]
    slack = 1e-6 * M * float((x * x).sum(1).max()) if name == "int8" else 0.0
    assert km.inertia_ == pytest.approx(jk.inertia_, rel=RTOL, abs=slack)
    assert km.detected_errors_ == jk.detected_errors_
    if name == "campaign":
        assert km.detected_errors_ > 0
    assert km.prune_history_ == [] and km._counts is None


def test_campaign_centres_bitwise_the_clean_fit(data):
    """Every planted fault is corrected: the campaign's mini-batch fit is
    bit for bit the clean protected one."""
    camp, _ = _fit_pair(data, "campaign")
    clean = KMeans(K, fault=FaultPolicy.correct(), max_iter=4, tol=0.0,
                   batch_size=BATCH, params=ops.KernelParams(*TILES),
                   device="cpu").fit(data[0], centroids=data[1])
    assert camp.detected_errors_ > 0 == clean.detected_errors_
    assert torch.equal(camp.cluster_centers_, clean.cluster_centers_)
    assert torch.equal(camp.labels_, clean.labels_)


def test_tol_stops_like_reference(data):
    """Batches of all M rows (each a new permutation) converge; both stop
    at the same iteration once the shift is under tol."""
    km, jk = _fit_pair(data, "off", max_iter=30, tol=1e-3, batch_size=M)
    assert km.n_iter_ == jk.n_iter_ < 30
    np.testing.assert_array_equal(km.labels_.numpy(), np.asarray(jk.labels_))


def test_batches_are_numpys_draws(data):
    """Each step runs the backend on the rows numpy draws, in order: a loop
    driving ``fused`` by hand over those batches gives the same centres,
    bit for bit, and ``on_iteration`` sees each step."""
    x, c0 = data
    seen = []
    km = KMeans(K, max_iter=3, tol=0.0, batch_size=BATCH, random_state=4,
                device="cpu").fit(x, centroids=c0,
                                  on_iteration=lambda *a: seen.append(a))
    rng = np.random.default_rng(4 + 1)
    c = torch.as_tensor(c0)
    xt = torch.as_tensor(x)
    for it in range(3):
        batch = xt[torch.from_numpy(rng.choice(M, BATCH, replace=False))]
        p = ops.clamp_params(BATCH, K, F, km.autotune.lookup(
            BATCH, K, F, kind="assign")[1])
        am, _ = ops.fused_assign(batch, c, p)
        sums, counts = ops.tiled_update(ops.plan_data(batch, p), am, K)
        c = torch.where(counts[:, None] > 0,
                        sums / counts.clamp_min(1.0)[:, None], c)
        assert torch.equal(seen[it][1], c)
    assert [s[0] for s in seen] == [0, 1, 2]
    assert torch.equal(km.cluster_centers_, c)
    assert km._n_host_syncs == 4          # one a step, one at the end
    np.testing.assert_array_equal(km.labels_.numpy(),
                                  km.predict(x).numpy())


def test_batch_at_least_m_takes_every_row(data):
    """A batch of M rows or more is a permutation of X: the step's sums are
    the full-batch step's up to order."""
    x, c0 = data
    full = KMeans(K, max_iter=1, tol=0.0, device="cpu").fit(
        x, centroids=c0)
    mb = KMeans(K, max_iter=1, tol=0.0, batch_size=5 * M,
                device="cpu").fit(x, centroids=c0)
    np.testing.assert_allclose(mb.cluster_centers_.numpy(),
                               full.cluster_centers_.numpy(), rtol=0,
                               atol=RTOL * float(np.abs(x).max()))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_two_byte_minibatch_matches_reference(data, dtype):
    """bf16 / fp16 mini-batch ``lloyd`` fits: the same batches, labels and
    centres as the reference's 2-byte template in interpret mode."""
    x, c0 = data
    kw = dict(max_iter=3, tol=0.0, batch_size=BATCH, compute_dtype=dtype,
              backend="lloyd")
    km = KMeans(K, params=ops.KernelParams(*TILES), device="cpu",
                **kw).fit(x, centroids=c0)
    jk = JKMeans(K, params=jops.KernelParams(*TILES), **kw).fit(
        x, centroids=c0)
    np.testing.assert_array_equal(km.labels_.numpy(), np.asarray(jk.labels_))
    ref_c = np.asarray(jk.cluster_centers_)
    np.testing.assert_allclose(km.cluster_centers_.numpy(), ref_c, rtol=0,
                               atol=RTOL * max(float(np.abs(ref_c).max()),
                                               1.0))


def test_pruned_backend_runs_unpruned(data):
    x, c0 = data
    km = KMeans(K, backend="lloyd_pruned", max_iter=3, tol=0.0,
                batch_size=BATCH, device="cpu").fit(x, centroids=c0)
    ll = KMeans(K, backend="lloyd", max_iter=3, tol=0.0, batch_size=BATCH,
                device="cpu").fit(x, centroids=c0)
    assert km.prune_history_ == []
    assert torch.equal(km.cluster_centers_, ll.cluster_centers_)


def test_bad_batch_size_refused():
    with pytest.raises(ValueError, match="batch_size"):
        KMeans(4, batch_size=0, device="cpu")
