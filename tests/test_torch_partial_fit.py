"""``KMeans.partial_fit`` of the port against the reference's, on the CPU.

Both packages fit one step from the same explicit centroids (seeding cannot
match across packages) and then stream two blocks through
``partial_fit``: the count-weighted running means of a fitted estimator
restarting its stream. Under ``FaultPolicy.off()`` (backend ``fused``) and
``FaultPolicy.correct()`` (``lloyd_ft``) the labels of every call, the
counts and ``n_iter_`` must be equal, and the centres agree to f32
rounding (rtol 1e-5 of the largest centre, as ``test_torch_estimator.py``:
sums in another order). The reference's Pallas backends run in interpret
mode. Inputs are made from a seed with numpy.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import FaultPolicy as JFaultPolicy  # noqa: E402
from repro.api import KMeans as JKMeans  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.api import FaultPolicy, KMeans  # noqa: E402
from repro_torch.data.blobs import make_blobs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

M, F, K = 433, 150, 140          # 4 x 2 x 2 tiles at (128, 128, 128)
TILES = (128, 128, 128)
RTOL = 1e-5

POLICIES = {"off": (FaultPolicy.off, JFaultPolicy.off, "fused"),
            "correct": (FaultPolicy.correct, JFaultPolicy.correct,
                        "lloyd_ft")}


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_partial_fit_matches_reference(name):
    x, _ = make_blobs(M, F, 11, seed=7)
    c0 = x[np.random.default_rng(7).choice(M, K, replace=False)]
    blocks = (x[:200], x[200:])
    pol, jpol, backend = POLICIES[name]
    km = KMeans(K, fault=pol(), max_iter=1, tol=0.0,
                params=ops.KernelParams(*TILES), device="cpu")
    jk = JKMeans(K, fault=jpol(), backend=backend, max_iter=1, tol=0.0,
                 params=jops.KernelParams(*TILES))
    km.fit(x, centroids=c0)
    jk.fit(x, centroids=c0)
    assert km._backend.name == backend
    for blk in blocks:
        km.partial_fit(blk)
        jk.partial_fit(blk)
        np.testing.assert_array_equal(km.labels_.numpy(),
                                      np.asarray(jk.labels_))
    np.testing.assert_array_equal(km._counts.numpy(), np.asarray(jk._counts))
    assert km._counts.sum().item() == M
    assert km.n_iter_ == jk.n_iter_ == 3
    assert km.detected_errors_ == jk.detected_errors_ == 0
    ref_c = np.asarray(jk.cluster_centers_)
    np.testing.assert_allclose(km.cluster_centers_.numpy(), ref_c, rtol=0,
                               atol=RTOL * max(float(np.abs(ref_c).max()),
                                               1.0))
