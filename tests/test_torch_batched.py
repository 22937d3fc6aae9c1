"""Port vs reference for the batched path, on the CPU.

The same numpy inputs go through the reference's batched kernel (Pallas in
interpret mode), its batched op and its ``BatchedKMeans`` (backend
``lloyd_batched``), and through the port's counterparts, which run the
kernels' plain versions here. Labels, counts and iteration counts must be
equal; distances, sums and centroids agree to rtol 1e-5 (f32 sums in
another order). Within the port, a batched problem must be bit for bit the
single-problem path on that problem alone.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.api import BatchedKMeans as JBatchedKMeans  # noqa: E402
from repro.kernels import lloyd_step as j_ll  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.api import (BackendCapabilityError, KMeans,  # noqa: E402
                             get_backend)
from repro_torch.batch import BatchedKMeans  # noqa: E402
from repro_torch.batch import estimator as b_est  # noqa: E402
from repro_torch.data.blobs import make_blobs  # noqa: E402
from repro_torch.kernels import lloyd_step as ll  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
RTOL = 1e-5
# the reference's tests/test_batched.py BATCH_SHAPES: (b, n, k, f)
BATCH_SHAPES = [(3, 200, 7, 33), (2, 256, 8, 128), (4, 70, 3, 16)]


def _stack(b, n, f, k, seed=0):
    x = np.stack([make_blobs(n, f, k, seed=seed + i)[0] for i in range(b)])
    c = np.random.default_rng(seed + 99).normal(size=(b, k, f))
    return x, c.astype(np.float32)


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=RTOL * max(float(np.abs(b).max()), 1.0))


@pytest.mark.parametrize("block_m", [64, 128])
def test_kernel_matches_reference_kernel(block_m):
    """The raw batched step on shared padded inputs (Fp = 128 and one
    centroid tile, the reference kernel's grid) against the Pallas kernel
    in interpret mode."""
    b, n, f, k = 3, 300, 50, 37
    x, c = _stack(b, n, f, k, seed=4)
    np_, kp, fp = -(-n // block_m) * block_m, 128, 128
    xp = np.zeros((b, np_, fp), np.float32)
    xp[:, :n, :f] = x
    cp = np.zeros((b, kp, fp), np.float32)
    cp[:, :k, :f] = c
    cn = np.where(np.arange(kp) < k, (cp ** 2).sum(2), np.inf)
    cn = cn.astype(np.float32)
    got = ll.lloyd_step_batched(torch.from_numpy(xp), torch.from_numpy(cp),
                                torch.from_numpy(cn), n, block_m=block_m,
                                block_k=128, block_f=32)
    want = j_ll.lloyd_step_batched(
        jnp.asarray(xp), jnp.asarray(cp), jnp.asarray(cn[:, None, :]),
        jnp.array([n], jnp.int32), block_m=block_m, block_f=128,
        interpret=True)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1])[..., 0])
    _close(got[0].numpy(), np.asarray(want[0])[..., 0])
    _close(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


@pytest.mark.parametrize("b,n,k,f", BATCH_SHAPES)
def test_fused_lloyd_batched_matches_reference(b, n, k, f):
    x, c = _stack(b, n, f, k)
    am, md, sums, counts = ops.fused_lloyd_batched(torch.from_numpy(x),
                                                   torch.from_numpy(c))
    jam, jmd, jsums, jcounts = jops.fused_lloyd_batched(
        jnp.asarray(x), jnp.asarray(c),
        jops.clamp_params(n, k, f, jops.KernelParams(256, 128, 128)),
        interpret=True)
    assert am.shape == (b, n) and sums.shape == (b, k, f)
    np.testing.assert_array_equal(am.numpy(), np.asarray(jam))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    _close(md.numpy(), np.asarray(jmd))
    _close(sums.numpy(), np.asarray(jsums))


@pytest.mark.parametrize("b,n,k,f", BATCH_SHAPES)
def test_batched_problem_is_single_problem_bitwise(b, n, k, f):
    """The tentpole invariant on the CPU: problem i of one batched step is
    bit for bit ``fused_lloyd`` on problem i alone, at the same tiles."""
    x, c = _stack(b, n, f, k, seed=3)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    p = ops.KernelParams(64, 128, 32)
    got = ops.fused_lloyd_batched(xt, ct, p)
    for i in range(b):
        one = ops.fused_lloyd(xt[i], ct[i], p)
        for g, o in zip(got, one):
            assert torch.equal(g[i], o)


def test_batch_plan_reused_and_plan_without_params_rejected():
    x, c = _stack(2, 100, 20, 5)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    p = ops.clamp_params(100, 5, 20, ops.DEFAULT_PARAMS)
    plan = ops.plan_data_batched(xt, p)
    assert plan.xp.shape == (2, 128, 32)
    for g, w in zip(ops.fused_lloyd_batched(plan, ct),
                    ops.fused_lloyd_batched(xt, ct, p)):
        assert torch.equal(g, w)
    # the tiles are part of the plan: no plan is built without them
    with pytest.raises(TypeError, match="params"):
        ops.plan_data_batched(xt)


# --- the estimator ----------------------------------------------------------

B, N, F, K = 3, 256, 8, 4


@pytest.fixture(scope="module")
def data():
    x, _ = _stack(B, N, F, K, seed=10)
    rng = np.random.default_rng(10)
    c0 = np.stack([x[i][rng.choice(N, K, replace=False)] for i in range(B)])
    return x, c0


def _port(**kw):
    kw.setdefault("max_iter", 25)
    return BatchedKMeans(K, device="cpu", **kw)


def test_fit_matches_reference(data):
    x, c0 = data
    bkm = _port(tol=1e-3).fit(x, centroids=c0)
    jb = JBatchedKMeans(K, max_iter=25, tol=1e-3,
                        backend="lloyd_batched").fit(jnp.asarray(x),
                                                     centroids=jnp.asarray(c0))
    np.testing.assert_array_equal(bkm.labels_.numpy(), np.asarray(jb.labels_))
    np.testing.assert_array_equal(bkm.n_iter_, jb.n_iter_)
    assert (bkm.n_iter_ < 25).all()
    _close(bkm.cluster_centers_.numpy(), np.asarray(jb.cluster_centers_))
    np.testing.assert_allclose(bkm.inertia_, jb.inertia_, rtol=RTOL)
    assert bkm.detected_errors_ == jb.detected_errors_ == 0
    assert bkm.labels_.shape == (B, N) and bkm.labels_.dtype == torch.int32


@pytest.mark.parametrize("init", ["kmeans++", "random"])
def test_problem_is_single_fit_bitwise(data, init):
    """At tol = 0 problem b of a batched fit is, bit for bit, the
    single-problem ``lloyd`` fit seeded ``random_state + b``."""
    x, _ = data
    bkm = _port(tol=0.0, init=init, random_state=3).fit(x)
    for i in range(B):
        one = KMeans(K, backend="lloyd", max_iter=25, tol=0.0, init=init,
                     random_state=3 + i, device="cpu").fit(x[i])
        assert torch.equal(one.cluster_centers_, bkm.cluster_centers_[i])
        assert torch.equal(one.labels_, bkm.labels_[i])
        assert one.n_iter_ == bkm.n_iter_[i] == 25
        assert one.inertia_ == pytest.approx(bkm.inertia_[i], rel=1e-6)
        assert torch.equal(one.predict(x[i]), bkm.predict(x)[i])


def test_convergence_mask_isolation(data):
    """A problem that freezes at once leaves the others' trajectories
    exactly as if it were absent (after the reference's
    tests/test_batched.py:120)."""
    x, c0 = data
    base = _port(max_iter=30, tol=1e-4).fit(x, centroids=c0)
    mixed_c0 = c0.copy()
    mixed_c0[0] = base.cluster_centers_[0].numpy()
    mixed = _port(max_iter=30, tol=1e-4).fit(x, centroids=mixed_c0)
    assert mixed.n_iter_[0] <= 2
    solo = _port(max_iter=30, tol=1e-4).fit(x[1:], centroids=c0[1:])
    assert torch.equal(mixed.cluster_centers_[1:], solo.cluster_centers_)
    assert torch.equal(mixed.labels_[1:], solo.labels_)
    np.testing.assert_array_equal(mixed.n_iter_[1:], solo.n_iter_)


def test_frozen_problem_stops_updating(data):
    """A converged problem keeps its state while the batch steps on
    (after the reference's tests/test_batched.py:150)."""
    x, c0 = data
    short = _port(max_iter=60, tol=1e-3, sync_every=60).fit(x, centroids=c0)
    longer = _port(max_iter=90, tol=1e-3, sync_every=90).fit(x, centroids=c0)
    np.testing.assert_array_equal(short.n_iter_, longer.n_iter_)
    assert torch.equal(short.cluster_centers_, longer.cluster_centers_)


@pytest.mark.parametrize("sync_every,max_iter", [(1, 5), (3, 7), (10, 25)])
def test_host_reads_are_chunks_plus_one(data, monkeypatch, sync_every,
                                        max_iter):
    x, c0 = data
    reads = []
    real = b_est._host_read
    monkeypatch.setattr(b_est, "_host_read",
                        lambda v: reads.append(1) or real(v))
    bkm = _port(max_iter=max_iter, tol=0.0, sync_every=sync_every)
    bkm.fit(x, centroids=c0)
    chunks = -(-max_iter // sync_every)
    assert len(reads) == bkm._n_host_syncs == chunks + 1


def test_predict_score_and_state_round_trip(data):
    x, c0 = data
    bkm = _port(max_iter=5).fit(x, centroids=c0)
    labels = bkm.predict(x)
    for i in range(B):
        d = ref.distance_matrix(torch.from_numpy(x[i]),
                                bkm.cluster_centers_[i])
        assert torch.equal(labels[i], ref.first_min(d)[1])
    score = bkm.score(x)
    assert score.shape == (B,) and (score < 0).all()
    c = bkm.cluster_centers_
    want = ((torch.from_numpy(x) - c.gather(
        1, labels.long()[..., None].expand(B, N, F))) ** 2).sum((1, 2))
    np.testing.assert_allclose(-score, want.numpy(), rtol=RTOL)
    back = BatchedKMeans.from_state(bkm.get_state(), device="cpu")
    assert torch.equal(back.predict(x), labels)
    np.testing.assert_array_equal(back.n_iter_, bkm.n_iter_)
    assert back.get_state()["config"] == bkm.get_state()["config"]


@pytest.mark.parametrize("backend", [None, "lloyd_batched_xla"])
def test_state_from_reference(data, backend):
    x, c0 = data
    jb = JBatchedKMeans(K, max_iter=5, backend=backend).fit(
        jnp.asarray(x), centroids=jnp.asarray(c0))
    state = convert.from_reference_batched_state(jb.get_state())
    assert state["config"]["backend"] == (
        None if backend is None else "lloyd_batched")
    bkm = BatchedKMeans.from_state(state, device="cpu")
    np.testing.assert_array_equal(bkm.predict(x).numpy(),
                                  np.asarray(jb.predict(jnp.asarray(x))))
    np.testing.assert_array_equal(bkm.n_iter_, jb.n_iter_)


def test_state_to_reference(data):
    x, c0 = data
    bkm = _port(max_iter=5).fit(x, centroids=c0)
    state = convert.to_reference_batched_state(bkm.get_state())
    assert "device" not in state["config"]
    jb = JBatchedKMeans.from_state(state)
    np.testing.assert_array_equal(np.asarray(jb.predict(jnp.asarray(x))),
                                  bkm.predict(x).numpy())
    np.testing.assert_array_equal(jb.n_iter_, bkm.n_iter_)


def test_input_validation_and_capabilities():
    with pytest.raises(ValueError, match="stacked"):
        BatchedKMeans(2, device="cpu").fit(np.zeros((16, 4), np.float32))
    with pytest.raises(BackendCapabilityError, match="supports_batch"):
        BatchedKMeans(2, backend="lloyd", device="cpu")
    with pytest.raises(BackendCapabilityError, match="BatchedKMeans"):
        KMeans(4, backend="lloyd_batched", device="cpu")
    with pytest.raises(ValueError, match="compute_dtype"):
        BatchedKMeans(2, compute_dtype="int8", device="cpu")
    with pytest.raises(ValueError, match="compute_dtype"):
        JBatchedKMeans(2, compute_dtype="int8")
    with pytest.raises(ValueError):
        BatchedKMeans(2, init="nope", device="cpu")
    bkm = BatchedKMeans(2, max_iter=3, device="cpu").fit(
        np.random.default_rng(0).normal(size=(2, 64, 4)).astype(np.float32))
    with pytest.raises(ValueError, match="B=2"):
        bkm.predict(np.zeros((3, 64, 4), np.float32))
    be = get_backend("lloyd_batched")
    assert be.supports_batch and be.fuses_update and be.takes_params
    assert be.kernel_kind == "batched"


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        assert BatchedKMeans(4).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            BatchedKMeans(4)


def test_fresh_interpreter_imports_batch_first():
    """repro_torch.batch imports on its own: the repro_torch.api export is
    lazy, so importing the batch package first cannot re-enter a partly
    initialised repro_torch.api."""
    code = ("import repro_torch.batch; from repro_torch.api import "
            "BatchedKMeans; assert BatchedKMeans is "
            "repro_torch.batch.BatchedKMeans")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ,
                                  PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr[-2000:]
