"""State interchange for the reference's host-only and baseline backends,
on the CPU.

The reference fits with ``lloyd_xla``, ``lloyd_ft_xla``, ``naive`` and
``gemm`` (plain XLA, not Pallas); ``convert.from_reference_state`` maps the
first two onto the port's ``lloyd`` and ``lloyd_ft`` and passes the last
two through to the port's plain-PyTorch ``naive`` and ``gemm`` backends.
Each loaded state must predict the reference's labels. The port's
``naive`` and ``gemm`` must give ``gemm_fused``'s labels, first-min ties
included.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import FaultPolicy as JFaultPolicy  # noqa: E402
from repro.api import KMeans as JKMeans  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.api import FaultPolicy, KMeans  # noqa: E402
from repro_torch.api.registry import get_backend  # noqa: E402
from repro_torch.data.blobs import make_blobs  # noqa: E402

M, F, K = 433, 20, 9


@pytest.fixture(scope="module")
def data():
    x, _ = make_blobs(M, F, K, seed=11)
    c0 = x[np.random.default_rng(11).choice(M, K, replace=False)]
    return x, c0


# reference backend -> (its policy, the port's backend after loading)
REF_BACKENDS = {
    "lloyd_xla": (JFaultPolicy.off(), "lloyd"),
    "lloyd_ft_xla": (JFaultPolicy.correct(), "lloyd_ft"),
    "naive": (JFaultPolicy.off(), "naive"),
    "gemm": (JFaultPolicy.off(), "gemm"),
}


@pytest.mark.parametrize("name", sorted(REF_BACKENDS))
def test_reference_state_loads_and_predicts(data, name):
    x, c0 = data
    jpol, port_name = REF_BACKENDS[name]
    jk = JKMeans(K, fault=jpol, backend=name, max_iter=4,
                 tol=0.0).fit(x, centroids=c0)
    state = convert.from_reference_state(jk.get_state())
    assert state["config"]["backend"] == port_name
    km = KMeans.from_state(state, device="cpu")
    assert km._backend.name == port_name
    assert km.fault.mode == jpol.mode
    np.testing.assert_array_equal(km.predict(x).numpy(),
                                  np.asarray(jk.predict(x)))


@pytest.mark.parametrize("name", ["naive", "gemm"])
def test_baseline_fit_matches_reference(data, name):
    """A port fit on the plain baseline backend follows the reference's
    fit on the same backend from the same centroids."""
    x, c0 = data
    km = KMeans(K, backend=name, max_iter=4, tol=0.0,
                device="cpu").fit(x, centroids=c0)
    jk = JKMeans(K, backend=name, max_iter=4, tol=0.0).fit(x, centroids=c0)
    np.testing.assert_array_equal(km.labels_.numpy(), np.asarray(jk.labels_))
    np.testing.assert_allclose(km.cluster_centers_.numpy(),
                               np.asarray(jk.cluster_centers_), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", ["naive", "gemm"])
@pytest.mark.parametrize("m", [7, 1024, 2500])
def test_baselines_take_gemm_fused_labels_on_ties(name, m):
    """Integer rows against duplicated centroids: every row ties between
    two equal centroids (exact distances), and the first wins, as
    ``gemm_fused``'s first-min. m = 2500 spans three naive batches."""
    rng = np.random.default_rng(m)
    x = torch.from_numpy(rng.integers(-4, 5, (m, 6)).astype(np.float32))
    half = torch.from_numpy(rng.integers(-4, 5, (5, 6)).astype(np.float32))
    c = torch.cat([half, half])               # centroid j == centroid j + 5
    am, md, det = get_backend(name)(x, c)
    want_am, want_md, _ = get_backend("gemm_fused")(x, c)
    assert am.dtype == torch.int32 and int(det) == 0
    assert torch.equal(am, want_am) and bool((am < 5).all())
    torch.testing.assert_close(md, want_md, rtol=0, atol=0)


def test_naive_on_no_rows():
    am, md, det = get_backend("naive")(torch.zeros(0, 4), torch.ones(3, 4))
    assert am.shape == (0,) and md.shape == (0,) and int(det) == 0


def test_port_state_with_baseline_backend_round_trips(data):
    x, c0 = data
    km = KMeans(K, backend="gemm", fault=FaultPolicy.off(), max_iter=3,
                tol=0.0, device="cpu").fit(x, centroids=c0)
    jk = JKMeans.from_state(convert.to_reference_state(km.get_state()))
    np.testing.assert_array_equal(np.asarray(jk.predict(x)),
                                  km.predict(x).numpy())
