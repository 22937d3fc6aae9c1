"""The port's pruned one-pass Lloyd path against the reference, on the CPU.

The port's pruned wrapper runs its plain version on CPU tensors; the
reference runs its Pallas ``fused_lloyd_pruned`` in interpret mode (never
``lloyd_pruned_xla``, which drifts under newer jax). Inputs are made with
numpy from a seed: well-separated blobs, rows cluster-contiguous and
centres in cluster order, the regime tile pruning is built for. Labels,
skip masks and prune fractions must be equal across packages; sums and
``tmin`` agree to rtol 1e-5 (f32 sums in another order). Inside the port
the pruned step must be bit for bit the unpruned one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import KMeans as JKMeans  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.api import (BackendCapabilityError, KMeans,  # noqa: E402
                             get_backend)
from repro_torch.core.kmeans import means_from_sums  # noqa: E402
from repro_torch.kernels import lloyd_step_pruned as llp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TILES = (128, 128, 128)
RTOL = 1e-5


def _clustered(m, k, f, seed=0, sep=8.0):
    """Blobs with rows cluster-contiguous (cluster j owns rows j*m/k ..
    (j+1)*m/k) and centres in cluster order."""
    rng = np.random.default_rng(seed)
    centers = (rng.normal(size=(k, f)) * sep).astype(np.float32)
    labels = (np.arange(m) * k) // m
    x = centers[labels] + rng.normal(size=(m, f)).astype(np.float32)
    return x.astype(np.float32), centers


def _close(a, b, scale=None):
    """|a - b| <= rtol * scale, scale defaulting to max |b|. True squared
    distances cancel terms of size ||x||^2, so they pass that scale."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max() if scale is None else scale
    np.testing.assert_allclose(a, b, rtol=0, atol=RTOL * max(scale, 1.0))


def _recording(monkeypatch, module, store, pos):
    """Record the skip mask (positional argument ``pos``) each pruned kernel
    call receives."""
    inner = module.lloyd_step_pruned

    def record(*args, **kwargs):
        store.append(np.asarray(args[pos]))
        return inner(*args, **kwargs)
    monkeypatch.setattr(module, "lloyd_step_pruned", record)


def test_fused_lloyd_pruned_matches_reference(monkeypatch):
    m, k, f = 512, 512, 32
    x, c = _clustered(m, k, f, seed=3)
    p, jp = ops.KernelParams(*TILES), jops.KernelParams(*TILES)
    masks, jmasks = [], []
    _recording(monkeypatch, ops._llp, masks, 4)
    _recording(monkeypatch, jops._llp, jmasks, 5)
    xt = torch.from_numpy(x)
    bounds = jbounds = None
    fracs = []
    for it in range(3):
        am, md, sums, counts, bounds, frac = ops.fused_lloyd_pruned(
            xt, torch.from_numpy(c), p, bounds=bounds)
        jam, jmd, jsums, jcounts, jbounds, jfrac = jops.fused_lloyd_pruned(
            x, c, jp, bounds=jbounds, interpret=True)
        np.testing.assert_array_equal(am.numpy(), np.asarray(jam),
                                      err_msg=f"iter {it}")
        np.testing.assert_array_equal(masks[-1], jmasks[-1],
                                      err_msg=f"iter {it}")
        assert float(frac) == float(jfrac)
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
        _close(sums.numpy(), jsums)
        _close(bounds.tmin.numpy(), jbounds.tmin)
        _close(md.numpy(), jmd, scale=float((x.astype(np.float64) ** 2)
                                             .sum(1).max()))
        fracs.append(float(frac))
        # both packages continue from the same centroids
        c = np.asarray(means_from_sums(torch.from_numpy(np.array(jsums)),
                                       torch.from_numpy(np.array(jcounts)),
                                       torch.from_numpy(c)))
    assert fracs[0] == 0.0 and fracs[-1] > 0.0


@pytest.mark.parametrize("m,k,f", [
    (512, 256, 32),      # two centroid tiles: pruning engages
    (517, 260, 40),      # ragged rows, centroids and features
    (512, 16, 32),       # one centroid tile: never prunes
])
def test_pruned_is_bitwise_unpruned_over_iterations(m, k, f):
    x, c = _clustered(m, k, f)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    p = ops.clamp_params(m, k, f, ops.KernelParams(*TILES))
    plan = ops.plan_data(xt, p)
    bounds, pruned_any = None, False
    for it in range(4):
        am_u, md_u, sums_u, cnt_u = ops.fused_lloyd(plan, ct, p)
        am_p, md_p, sums_p, cnt_p, bounds, frac = ops.fused_lloyd_pruned(
            plan, ct, p, bounds=bounds)
        for a, b, what in ((am_u, am_p, "labels"), (md_u, md_p, "distances"),
                           (sums_u, sums_p, "sums"),
                           (cnt_u, cnt_p, "counts")):
            assert torch.equal(a, b), f"iter {it}: {what}"
        pruned_any |= float(frac) > 0.0
        ct = means_from_sums(sums_u, cnt_u, ct)
    nkt = ops._round_up(k, p.block_k) // p.block_k
    assert pruned_any == (nkt > 1)


def test_pruning_engages_on_aligned_clusters():
    """nkt = 4, one centroid tile per row tile: the seed pass computes every
    tile, steady state skips 3/4 (reference ``tests/test_pruned.py``)."""
    m, k, f = 512, 512, 32
    x, c = _clustered(m, k, f, seed=3)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    p = ops.KernelParams(*TILES)
    bounds = ops.init_bounds(m, k, f, p, device="cpu")
    assert bool(bounds.fresh)
    fracs = []
    for _ in range(3):
        _, _, sums, cnt, bounds, frac = ops.fused_lloyd_pruned(
            xt, ct, p, bounds=bounds)
        fracs.append(float(frac))
        ct = means_from_sums(sums, cnt, ct)
    assert not bool(bounds.fresh)
    assert fracs[0] == 0.0
    assert fracs[-1] >= 0.5, fracs


def test_plain_kernel_skips_and_bounds():
    """The raw entry: a skipped cell holds the MIN_INIT placeholder and is
    never folded; a row tile with every cell skipped keeps the kernels'
    start (MIN_INIT, index 0); tmin is the min over valid rows of
    sqrt(max(local min + ||x||^2, 0))."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(256, 32)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(256, 32)).astype(np.float32))
    cn = (c * c).sum(1)
    xn = (x * x).sum(1)
    xn[200:] = 0.0
    skip = torch.tensor([[0, 1], [1, 1]], dtype=torch.int32)
    mind, am, _, ecnt, _, tmin = llp.lloyd_step_pruned(
        x, c, cn, xn, skip, 200, block_m=128, block_k=128, block_f=32)
    d = cn[None, :] - 2.0 * (x @ c.T)
    assert torch.equal(am[:128], d[:128, :128].argmin(1).to(torch.int32))
    assert torch.equal(mind[:128], d[:128, :128].amin(1))
    assert bool((mind[128:] == llp.MIN_INIT).all())
    assert bool((am[128:] == 0).all())
    e = (d[:128, :128].amin(1) + xn[:128]).clamp_min(0.0).sqrt()
    assert float(tmin[0, 0]) == float(e.min())
    assert bool((tmin[0, 1:] == llp.MIN_INIT).all())
    assert bool((tmin[1] == llp.MIN_INIT).all())
    assert float(ecnt.sum()) == 200.0


def test_wrapper_counts_no_launch_on_cpu_and_refuses_other_devices():
    before = llp.lloyd_step_pruned.launches
    x, c = _clustered(300, 200, 40)
    ops.fused_lloyd_pruned(torch.from_numpy(x), torch.from_numpy(c),
                           ops.KernelParams(128, 128, 32))
    assert llp.lloyd_step_pruned.launches == before == 0
    meta = dict(device="meta")
    with pytest.raises(RuntimeError, match="CPU or on one CUDA"):
        llp.lloyd_step_pruned(
            torch.empty((128, 32), **meta), torch.empty((128, 32), **meta),
            torch.empty(128, **meta), torch.empty(128, **meta),
            torch.empty((1, 1), dtype=torch.int32, **meta), 128,
            block_m=128, block_k=128, block_f=32)
    with pytest.raises(ValueError, match="skip"):
        llp.lloyd_step_pruned(
            torch.zeros(128, 32), torch.zeros(128, 32), torch.zeros(128),
            torch.zeros(128), torch.zeros((2, 1), dtype=torch.int32), 128,
            block_m=128, block_k=128, block_f=32)


def test_registry_flags_match_reference():
    from repro.api import get_backend as j_get_backend
    b, jb = get_backend("lloyd_pruned"), j_get_backend("lloyd_pruned")
    assert b.kernel_kind == jb.kernel_kind == "pruned"
    for flag in ("supports_ft", "takes_params", "takes_injection",
                 "fuses_update", "supports_batch", "supports_bounds",
                 "supports_int8"):
        assert getattr(b, flag) == getattr(jb, flag), flag
    assert b.bounds_init is ops.init_bounds


def test_bounds_refused_by_a_backend_without_them():
    x = torch.zeros(64, 8)
    bounds = ops.init_bounds(64, 4, 8, device="cpu")
    with pytest.raises(BackendCapabilityError, match="pruning bounds"):
        get_backend("lloyd")(x, x[:4], bounds=bounds)
    with pytest.raises(BackendCapabilityError, match="pruning bounds"):
        get_backend("fused")(x, x[:4], bounds=bounds)
    with pytest.raises(TypeError, match="device"):
        ops.init_bounds(64, 4, 8)


# --- the estimator ---------------------------------------------------------

M, K, F = 1024, 256, 32


@pytest.fixture(scope="module")
def data():
    return _clustered(M, K, F, seed=2)


def _fit(x, c, backend, **kw):
    kw.setdefault("max_iter", 6)
    kw.setdefault("tol", 0.0)
    return KMeans(K, backend=backend, params=ops.KernelParams(*TILES),
                  device="cpu", **kw).fit(x, centroids=c)


def test_fit_is_bitwise_lloyd(data):
    x, c = data
    a, b = _fit(x, c, "lloyd_pruned"), _fit(x, c, "lloyd")
    assert a.n_iter_ == b.n_iter_
    assert torch.equal(a.labels_, b.labels_)
    assert torch.equal(a.cluster_centers_, b.cluster_centers_)
    assert a.inertia_ == b.inertia_
    assert len(a.prune_history_) == a.n_iter_ and a.prune_history_[0] == 0.0
    assert max(a.prune_history_) > 0.0
    assert b.prune_history_ == []
    assert a._n_host_syncs == b._n_host_syncs
    assert torch.equal(a.predict(x), b.predict(x))


def test_converged_fit_freezes_bounds_and_history(data):
    """tol > 0: the fit stops early; frozen steps report no pruning and the
    history covers the executed steps only."""
    x, c = data
    a = _fit(x, c, "lloyd_pruned", max_iter=30, tol=1e-3, sync_every=4)
    b = _fit(x, c, "lloyd", max_iter=30, tol=1e-3, sync_every=4)
    assert a.n_iter_ == b.n_iter_ < 30
    assert torch.equal(a.cluster_centers_, b.cluster_centers_)
    assert len(a.prune_history_) == a.n_iter_
    assert a._n_host_syncs == b._n_host_syncs


def test_fit_matches_reference(data):
    x, c = data
    a = _fit(x, c, "lloyd_pruned", max_iter=4)
    j = JKMeans(K, backend="lloyd_pruned", params=jops.KernelParams(*TILES),
                max_iter=4, tol=0.0).fit(x, centroids=c)
    np.testing.assert_array_equal(a.labels_.numpy(), np.asarray(j.labels_))
    assert a.prune_history_ == j.prune_history_
    _close(a.cluster_centers_.numpy(), np.asarray(j.cluster_centers_))


def test_warm_refit_after_from_state_equals_cold_fit(data):
    x, c = data
    km = _fit(x, c, "lloyd_pruned", max_iter=3)
    state = km.get_state()
    seed_c = state["cluster_centers"]
    warm = KMeans.from_state(state, device="cpu").fit(x, centroids=seed_c)
    cold = _fit(x, seed_c, "lloyd_pruned", max_iter=3)
    assert warm.n_iter_ == cold.n_iter_
    assert torch.equal(warm.labels_, cold.labels_)
    assert torch.equal(warm.cluster_centers_, cold.cluster_centers_)
    assert warm.prune_history_ == cold.prune_history_


def test_partial_fit_runs_unpruned_and_matches_lloyd(data):
    x, c = data
    results = []
    for name in ("lloyd_pruned", "lloyd"):
        km = KMeans(K, backend=name, params=ops.KernelParams(*TILES),
                    device="cpu")
        km.cluster_centers_ = torch.from_numpy(c)
        km.partial_fit(x[:512]).partial_fit(x[512:])
        results.append(km)
    a, b = results
    assert torch.equal(a.labels_, b.labels_)
    assert torch.equal(a.cluster_centers_, b.cluster_centers_)
    assert a.prune_history_ == []


def test_state_interchange(data):
    """A reference state fitted by its host-only ``lloyd_pruned_xla`` loads
    into the port as ``lloyd_pruned`` and predicts the reference's labels;
    the port's state loads into the reference likewise."""
    x, c = data
    j = JKMeans(K, backend="lloyd_pruned_xla", max_iter=3,
                tol=0.0).fit(x, centroids=c)
    state = convert.from_reference_state(j.get_state())
    assert state["config"]["backend"] == "lloyd_pruned"
    km = KMeans.from_state(state, device="cpu")
    assert km._backend.name == "lloyd_pruned"
    np.testing.assert_array_equal(km.predict(x).numpy(),
                                  np.asarray(j.predict(x)))
    port = _fit(x, c, "lloyd_pruned", max_iter=3)
    back = JKMeans.from_state(convert.to_reference_state(port.get_state()))
    assert back._backend.name == "lloyd_pruned"
    np.testing.assert_array_equal(np.asarray(back.predict(x)),
                                  port.predict(x).numpy())
