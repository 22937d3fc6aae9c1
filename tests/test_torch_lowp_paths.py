"""The last 2-byte kernel variants and their paths: the port against the
reference at bf16 / fp16, on the CPU.

The port's wrappers run their kernels' plain versions on CPU tensors (f32
products of the widened 2-byte values); the reference runs its Pallas
kernels at bf16 / fp16 in interpret mode (2-byte tiles, f32 accumulation).
Inputs are made with numpy from a seed, cast to the compute dtype, and fed
to both packages with the same explicit KernelParams and initial
centroids. The CUDA kernels themselves run on the card (``chip_smoke.py``
phase 14). Tolerances:

* ``lloyd_step_batched``, ``lloyd_step_pruned`` and ``matmul_abft``
  accumulate in f32, and a product of two 2-byte values is exact in f32, so
  the two packages differ only in the order of their f32 sums: assignments,
  counts, skip masks, prune fractions and detection counts are exact;
  distances, sums, ``tmin``, centroids and D hold to rtol 1e-5 of the
  largest magnitude, true squared distances and inertia to rtol 1e-5 of the
  row norms they cancel (PR 16's bar for the other 2-byte kernels). An
  ABFT GEMM element corrected after a planted fault holds, in both
  packages, to f32 rounding at the fault's magnitude (each subtracts its
  own checksum residual): ``FIX_RTOL`` |delta| from the clean product.
* The ``detect`` path (``abft_offline``) computes in the compute dtype in
  both packages: a 2-byte product rounded to 2 bytes, 2-byte norms and a
  2-byte assembly. XLA and PyTorch sum a product in other orders, so a
  product, and a distance built from it, may differ by one ulp of the
  compute dtype: distances hold to two ulps of the compute dtype at the
  magnitude of their largest term (row norm plus centroid norm). On blob
  data whose label gaps are far above that, labels and detection counts are
  exact and centroids (f32 means of the same rows) hold to rtol 1e-5.
* fp16 flash attention holds to the reference test's bf16 bar
  (``tests/test_torch_flash.py``: rtol 1e-3, atol 2e-2) scaled by fp16's
  eps (2^-10 against bf16's 2^-7): rtol 1e-3, atol 2.5e-3. The reference's
  own tests set no fp16 bar.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.api import BatchedKMeans as JBatchedKMeans  # noqa: E402
from repro.api import FaultPolicy as JFaultPolicy  # noqa: E402
from repro.api import KMeans as JKMeans  # noqa: E402
from repro.core import assignment as j_assignment  # noqa: E402
from repro.core import kmeans as j_kmeans  # noqa: E402
from repro.kernels import lloyd_step as j_ll  # noqa: E402
from repro.kernels import lloyd_step_pruned as j_llp  # noqa: E402
from repro.kernels import matmul_abft as j_mma  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as j_flash  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.api import FaultPolicy, KMeans  # noqa: E402
from repro_torch.batch import BatchedKMeans  # noqa: E402
from repro_torch.core.assignment import assign_abft_offline  # noqa: E402
from repro_torch.core.kmeans import means_from_sums  # noqa: E402
from repro_torch.data.blobs import make_blobs  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import lloyd_step as ll  # noqa: E402
from repro_torch.kernels import lloyd_step_pruned as llp  # noqa: E402
from repro_torch.kernels import matmul_abft as mma  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import update as up  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402

DTYPES = ["bfloat16", "float16"]
NP_DTYPES = {"bfloat16": ml_dtypes.bfloat16, "float16": np.float16}
RTOL = 1e-5
FIX_RTOL = 2.0 ** -16
FP16_RTOL, FP16_ATOL = 1e-3, 2.5e-3
TILES = [(128, 128, 128), (64, 128, 128)]


def _lo(a: np.ndarray, dtype: str) -> np.ndarray:
    """``a`` rounded to the compute dtype, as f32 values."""
    return np.asarray(a, np.float32).astype(NP_DTYPES[dtype]).astype(
        np.float32)


def _t(a: np.ndarray, dtype: str = "float32") -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch,
                                                                   dtype))


def _j(a: np.ndarray, dtype: str = "float32"):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


def _close(a, b, rtol=RTOL, scale=None):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b[np.isfinite(b)]).max() if scale is None else scale
    np.testing.assert_allclose(a, b, rtol=0, atol=rtol * max(scale, 1.0))


def _wide_blobs(m, f, k, seed, spread=1.0):
    """Blob rows and their blob centres (``make_blobs``'s own): every row's
    nearest centre is its own by a gap far above 2-byte rounding."""
    x, labels = make_blobs(m, f, k, seed=seed, spread=spread)
    c = (np.random.default_rng(seed).normal(size=(k, f)) * 10.0)
    return x, c.astype(np.float32), labels


def _ints(shape, seed):
    """Small integers: exact in every dtype, every product and every sum."""
    return np.random.default_rng(seed).integers(-3, 4, size=shape).astype(
        np.float32)


# --- lloyd_step_batched ------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block_m", [64, 128])
def test_batched_kernel_matches_reference_kernel(block_m, dtype):
    """The raw batched step on shared padded 2-byte inputs (one centroid
    tile, the reference kernel's grid) against the Pallas kernel."""
    b, n, f, k = 3, 300, 50, 37
    x = np.stack([make_blobs(n, f, k, seed=4 + i)[0] for i in range(b)])
    c = np.random.default_rng(9).normal(size=(b, k, f)) * 10.0
    np_, kp, fp = -(-n // block_m) * block_m, 128, 128
    xp = np.zeros((b, np_, fp), np.float32)
    xp[:, :n, :f] = _lo(x, dtype)
    cp = np.zeros((b, kp, fp), np.float32)
    cp[:, :k, :f] = _lo(c, dtype)
    cn = np.where(np.arange(kp) < k, (cp.astype(np.float64) ** 2).sum(2),
                  np.inf).astype(np.float32)
    got = ll.lloyd_step_batched(_t(xp, dtype), _t(cp, dtype), _t(cn), n,
                                block_m=block_m, block_k=128, block_f=32)
    want = j_ll.lloyd_step_batched(
        _j(xp, dtype), _j(cp, dtype), jnp.asarray(cn[:, None, :]),
        jnp.array([n], jnp.int32), block_m=block_m, block_f=128,
        interpret=True)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1])[..., 0])
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    _close(got[0].numpy(), np.asarray(want[0])[..., 0])
    _close(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,n,k,f", [(3, 200, 7, 33), (4, 70, 3, 16)])
def test_fused_lloyd_batched_matches_reference(b, n, k, f, dtype):
    x = np.stack([make_blobs(n, f, k, seed=i)[0] for i in range(b)])
    c = (np.random.default_rng(99).normal(size=(b, k, f)) * 10.0).astype(
        np.float32)
    p = ops.KernelParams(128, 128, 128)
    jp = jops.KernelParams(128, 128, 128)
    am, md, sums, counts = ops.fused_lloyd_batched(_t(x, dtype), _t(c), p)
    jam, jmd, jsums, jcounts = jops.fused_lloyd_batched(
        _j(x, dtype), jnp.asarray(c), jp, interpret=True)
    np.testing.assert_array_equal(am.numpy(), np.asarray(jam))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert md.dtype == sums.dtype == torch.float32
    norm = float((_lo(x, dtype).astype(np.float64) ** 2).sum(2).max())
    _close(md.numpy(), jmd, scale=norm)
    _close(sums.numpy(), jsums)


@pytest.fixture(scope="module")
def pq():
    """Three small PQ-like problems with blob structure, and their
    centroids drawn from each problem's rows."""
    b, n, f, k = 3, 240, 12, 6
    x = np.stack([make_blobs(n, f, k, seed=20 + i, spread=0.5)[0]
                  for i in range(b)])
    rng = np.random.default_rng(21)
    c = np.stack([x[i][rng.choice(n, k, replace=False)] for i in range(b)])
    return x, c


@pytest.mark.parametrize("dtype", DTYPES)
def test_batched_fit_matches_reference(pq, dtype):
    """BatchedKMeans fit, predict and score against the reference's at the
    same dtype, tiles and initial centroids."""
    x, c = pq
    kw = dict(max_iter=12, tol=0.0, compute_dtype=dtype)
    bkm = BatchedKMeans(6, params=ops.KernelParams(128, 128, 128),
                        device="cpu", **kw).fit(x, centroids=c)
    jb = JBatchedKMeans(6, params=jops.KernelParams(128, 128, 128),
                        **kw).fit(jnp.asarray(x), centroids=jnp.asarray(c))
    assert bkm.compute_dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(bkm.labels_.numpy(), np.asarray(jb.labels_))
    np.testing.assert_array_equal(bkm.n_iter_, np.asarray(jb.n_iter_))
    assert bkm.cluster_centers_.dtype == torch.float32
    _close(bkm.cluster_centers_.numpy(), np.asarray(jb.cluster_centers_))
    # inertia sums true distances, which cancel the row norms: it holds
    # to rtol 1e-5 of the norms it cancels
    norms = (_lo(x, dtype).astype(np.float64) ** 2).sum((1, 2))
    np.testing.assert_allclose(bkm.inertia_, np.asarray(jb.inertia_),
                               rtol=0, atol=RTOL * norms.max())
    np.testing.assert_array_equal(bkm.predict(x).numpy(),
                                  np.asarray(jb.predict(jnp.asarray(x))))
    np.testing.assert_allclose(bkm.score(x), jb.score(jnp.asarray(x)),
                               rtol=0, atol=RTOL * norms.max())


@pytest.mark.parametrize("dtype", DTYPES)
def test_batched_problems_are_bitwise_single_lloyd_fits(pq, dtype):
    """Problem b of a 2-byte batched fit is, bit for bit, the 2-byte
    single-problem lloyd fit from its centroids (the path chip_smoke.py
    phase 14 holds on the card)."""
    x, c = pq
    kw = dict(max_iter=9, tol=0.0, compute_dtype=dtype, device="cpu")
    bkm = BatchedKMeans(6, **kw).fit(x, centroids=c)
    for i in range(x.shape[0]):
        one = KMeans(6, backend="lloyd", random_state=i, **kw).fit(
            x[i], centroids=c[i])
        assert torch.equal(one.cluster_centers_, bkm.cluster_centers_[i])
        assert torch.equal(one.labels_, bkm.labels_[i])
        assert torch.equal(one.predict(x[i]), bkm.predict(x)[i])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("direction", ["to_reference", "from_reference"])
def test_batched_state_interchange(pq, dtype, direction):
    x, c = pq
    kw = dict(max_iter=4, tol=0.0, compute_dtype=dtype)
    if direction == "to_reference":
        bkm = BatchedKMeans(6, device="cpu", **kw).fit(x, centroids=c)
        st = convert.to_reference_batched_state(bkm.get_state())
        assert st["config"]["compute_dtype"] == dtype
        jb = JBatchedKMeans.from_state(st)
        assert jb.compute_dtype == jnp.dtype(dtype)
    else:
        jb = JBatchedKMeans(6, **kw).fit(jnp.asarray(x),
                                         centroids=jnp.asarray(c))
        bkm = BatchedKMeans.from_state(
            convert.from_reference_batched_state(jb.get_state()),
            device="cpu")
        assert bkm.compute_dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(bkm.predict(x).numpy(),
                                  np.asarray(jb.predict(jnp.asarray(x))))


# --- lloyd_step_pruned -------------------------------------------------------

M, K, F = 517, 260, 200      # 5 x 3 x 2 tiles at (128, 128, 128)


def _padded(a, rows, cols):
    out = np.zeros((rows, cols), np.float32)
    out[:a.shape[0], :a.shape[1]] = a
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tiles", TILES)
def test_pruned_kernel_matches_reference_kernel(tiles, dtype):
    """The raw pruned step under the same random skip mask: integer data,
    so every product and sum is exact and labels, sums, counts and min
    distances agree bit for bit; ``tmin`` to rtol 1e-5 (a sqrt each)."""
    bm, bk, bf = tiles
    x, c = _ints((M, F), 1), _ints((K, F), 2)
    mp, kp, fp = -(-M // bm) * bm, -(-K // bk) * bk, -(-F // bf) * bf
    xp, cp = _padded(x, mp, fp), _padded(c, kp, fp)
    cn = np.where(np.arange(kp) < K, (cp ** 2).sum(1), np.inf).astype(
        np.float32)
    xn = (xp ** 2).sum(1).astype(np.float32)
    nt, nkt = mp // bm, kp // bk
    skip = (np.random.default_rng(3).random((nt, nkt)) < 0.4).astype(np.int32)
    got = llp.lloyd_step_pruned(_t(xp, dtype), _t(cp, dtype), _t(cn), _t(xn),
                                torch.from_numpy(skip), M, block_m=bm,
                                block_k=bk, block_f=bf)
    want = j_llp.lloyd_step_pruned(
        _j(xp, dtype), _j(cp, dtype), jnp.asarray(cn[None, :]),
        jnp.asarray(xn[:, None]), jnp.array([M], jnp.int32),
        jnp.asarray(skip), block_m=bm, block_k=bk, block_f=bf,
        interpret=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0])[:, 0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1])[:, 0])
    # the update as entries: the reference's dense per-tile partials in the
    # entries' layout, every (tile, cluster) entry
    want_entries = up.dense_to_entries(torch.from_numpy(np.array(want[2])),
                                       torch.from_numpy(np.array(want[3])),
                                       bm)
    for g, w in zip(got[2:5], want_entries):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    computed = skip == 0
    _close(got[5].numpy()[computed], np.asarray(want[4])[computed])


def _clustered(m, k, f, seed=0, sep=8.0):
    """Blobs with rows cluster-contiguous and centres in cluster order:
    the regime tile pruning is built for."""
    rng = np.random.default_rng(seed)
    centers = (rng.normal(size=(k, f)) * sep).astype(np.float32)
    labels = (np.arange(m) * k) // m
    x = centers[labels] + rng.normal(size=(m, f)).astype(np.float32)
    return x.astype(np.float32), centers


def _recording(monkeypatch, module, store, pos):
    inner = module.lloyd_step_pruned

    def record(*args, **kwargs):
        store.append(np.asarray(args[pos]))
        return inner(*args, **kwargs)
    monkeypatch.setattr(module, "lloyd_step_pruned", record)


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_lloyd_pruned_matches_reference(monkeypatch, dtype):
    """Three pruned steps at 2-byte X: the same skip masks and prune
    fractions, labels and counts exact, sums and ``tmin`` to rtol 1e-5."""
    m, k, f = 512, 512, 32
    x, c = _clustered(m, k, f, seed=3)
    p, jp = ops.KernelParams(128, 128, 128), jops.KernelParams(128, 128, 128)
    masks, jmasks = [], []
    _recording(monkeypatch, ops._llp, masks, 4)
    _recording(monkeypatch, jops._llp, jmasks, 5)
    bounds = jbounds = None
    fracs = []
    for it in range(3):
        am, md, sums, counts, bounds, frac = ops.fused_lloyd_pruned(
            _t(x, dtype), torch.from_numpy(c), p, bounds=bounds)
        jam, jmd, jsums, jcounts, jbounds, jfrac = jops.fused_lloyd_pruned(
            _j(x, dtype), jnp.asarray(c), jp, bounds=jbounds, interpret=True)
        np.testing.assert_array_equal(am.numpy(), np.asarray(jam),
                                      err_msg=f"iter {it}")
        np.testing.assert_array_equal(masks[-1], jmasks[-1],
                                      err_msg=f"iter {it}")
        assert float(frac) == float(jfrac)
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
        _close(sums.numpy(), jsums)
        _close(bounds.tmin.numpy(), jbounds.tmin)
        assert bounds.c_prev.dtype == torch.float32
        fracs.append(float(frac))
        # both packages continue from the same centroids
        c = np.asarray(means_from_sums(torch.from_numpy(np.array(jsums)),
                                       torch.from_numpy(np.array(jcounts)),
                                       torch.from_numpy(c)))
    assert fracs[0] == 0.0 and fracs[-1] > 0.0


@pytest.fixture(scope="module")
def sorted_blobs():
    x, c = _clustered(1024, 256, 24, seed=5)
    return x, c + np.random.default_rng(6).normal(size=c.shape).astype(
        np.float32) * 0.5


@pytest.mark.parametrize("dtype", DTYPES)
def test_pruned_fit_matches_reference_and_is_bitwise_lloyd(sorted_blobs,
                                                           dtype):
    """KMeans(backend="lloyd_pruned") at 2 bytes: the reference's labels
    and prune history, its centroids to rtol 1e-5; and bit for bit the
    port's own 2-byte lloyd fit, with pruning engaged."""
    x, c = sorted_blobs
    kw = dict(max_iter=6, tol=0.0, compute_dtype=dtype)
    km = KMeans(256, backend="lloyd_pruned", device="cpu",
                params=ops.KernelParams(128, 128, 128), **kw).fit(
        x, centroids=c)
    jk = JKMeans(256, backend="lloyd_pruned",
                 params=jops.KernelParams(128, 128, 128), **kw).fit(
        x, centroids=c)
    lloyd = KMeans(256, backend="lloyd", device="cpu",
                   params=ops.KernelParams(128, 128, 128), **kw).fit(
        x, centroids=c)
    np.testing.assert_array_equal(km.labels_.numpy(), np.asarray(jk.labels_))
    assert km.prune_history_ == jk.prune_history_
    assert max(km.prune_history_) > 0.0
    _close(km.cluster_centers_.numpy(), np.asarray(jk.cluster_centers_))
    assert torch.equal(km.cluster_centers_, lloyd.cluster_centers_)
    assert torch.equal(km.labels_, lloyd.labels_)
    np.testing.assert_array_equal(km.predict(x).numpy(),
                                  np.asarray(jk.predict(x)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("direction", ["to_reference", "from_reference"])
def test_pruned_state_interchange(sorted_blobs, dtype, direction):
    x, c = sorted_blobs
    kw = dict(max_iter=3, tol=0.0, compute_dtype=dtype,
              backend="lloyd_pruned")
    if direction == "to_reference":
        km = KMeans(256, device="cpu", **kw).fit(x, centroids=c)
        st = convert.to_reference_state(km.get_state())
        assert st["config"]["compute_dtype"] == dtype
        jk = JKMeans.from_state(st)
    else:
        jk = JKMeans(256, **kw).fit(x, centroids=c)
        km = KMeans.from_state(convert.from_reference_state(jk.get_state()),
                               device="cpu")
    assert km.compute_dtype == getattr(torch, dtype)
    assert km._backend.name == "lloyd_pruned"
    np.testing.assert_array_equal(km.predict(x).numpy(),
                                  np.asarray(jk.predict(x)))


# --- matmul_abft (ops.abft_matmul) -------------------------------------------

ABFT_CASES = {"clean": None, "detected": 2.0 ** 20, "under": 1.0}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tiles", [(128, 128, 128), (64, 256, 128)])
@pytest.mark.parametrize("case", sorted(ABFT_CASES))
def test_abft_matmul_matches_reference(case, tiles, dtype):
    """2-byte X and Y, D in f32: clean; a fault both packages detect and
    correct; one under the bf16/fp16 threshold that both let through."""
    rng = np.random.default_rng(31)
    x = rng.normal(size=(256, 512)).astype(np.float32)
    y = rng.normal(size=(512, 384)).astype(np.float32)
    bm, bn, bk = tiles
    kw = dict(block_m=bm, block_n=bn, block_k=bk)
    delta = ABFT_CASES[case]
    # tile (1, 0), after k-step 1, row 5, col 9
    desc = (1, 0, 1, 5, 9)
    i, j = bm + 5, 9
    inj = None if delta is None else mma.make_injection(*desc, delta)
    jinj = None if delta is None else j_mma.make_injection(*desc, delta)
    d, det = ops.abft_matmul(_t(x, dtype), _t(y, dtype), inj=inj, **kw)
    jd, jdet = jops.abft_matmul(_j(x, dtype), _j(y, dtype), inj=jinj,
                                interpret=True, **kw)
    assert d.dtype == torch.float32
    assert int(det) == int(jdet) == (1 if case == "detected" else 0)
    jd = np.array(jd, np.float32)
    clean = _lo(x, dtype).astype(np.float64) @ _lo(y, dtype).astype(
        np.float64)
    got = d.numpy().copy()
    if case == "detected":
        for a in (got, jd):
            assert abs(float(a[i, j]) - clean[i, j]) <= FIX_RTOL * delta
            a[i, j] = clean[i, j]
    elif case == "under":
        assert abs(float(got[i, j]) - clean[i, j] - delta) < 1e-3
    _close(got, jd)


# --- detect (abft_offline) at 2 bytes ----------------------------------------

@pytest.fixture(scope="module")
def wide():
    """Blob rows whose centroids are their blob centres plus noise: label
    gaps far above two 2-byte ulps of the distances."""
    x, c, _ = _wide_blobs(600, 24, 7, seed=2)
    c = c + np.random.default_rng(3).normal(size=c.shape).astype(
        np.float32) * 0.3
    return x, c


def _two_ulps(x, c, dtype):
    """Two ulps of the compute dtype at the largest term of a distance."""
    xl, cl = _lo(x, dtype).astype(np.float64), _lo(c, dtype).astype(
        np.float64)
    top = (xl ** 2).sum(1).max() + (cl ** 2).sum(1).max()
    return 2.0 * torch.finfo(getattr(torch, dtype)).eps * top


@pytest.mark.parametrize("dtype", DTYPES)
def test_abft_offline_step_matches_reference(wide, dtype):
    """One detect step on 2-byte X and C: the reference's labels and
    detection, distances within two ulps of the compute dtype; the port's
    distances are f32 tensors holding 2-byte values."""
    x, c = wide
    am, md, det = assign_abft_offline(_t(x, dtype), _t(c, dtype))
    jam, jmd, jdet = j_assignment.assign_abft_offline(_j(x, dtype),
                                                      _j(c, dtype))
    assert jmd.dtype == jnp.dtype(dtype) and md.dtype == torch.float32
    np.testing.assert_array_equal(md.numpy(), _lo(md.numpy(), dtype))
    np.testing.assert_array_equal(am.numpy(), np.asarray(jam))
    assert int(det) == int(jdet)
    np.testing.assert_allclose(md.numpy(), np.asarray(jmd, np.float32),
                               rtol=0, atol=_two_ulps(x, c, dtype))
    plan = ops.plan_data(_t(x, dtype), ops.DEFAULT_PARAMS)
    am2, md2, _ = assign_abft_offline(plan, _t(c, dtype))
    assert torch.equal(am2, am) and torch.equal(md2, md)


def _reference_detect_fit(x, c0, dtype, n_iter):
    """The reference's detect fit, step by step from its own functions:
    ``assign_abft_offline`` on the cast rows and centroids, the DMR-protected
    two-pass ``centroid_update`` on the cast rows, ``reseed_empty`` from
    them (the live branch of its estimator's chunk, which cannot run at 2
    bytes: see test_reference_detect_fit_fails_at_2_bytes)."""
    xc = _j(x, dtype)
    c = jnp.asarray(c0, jnp.float32)
    key = jax.random.PRNGKey(0)
    dets, md = 0, None
    for _ in range(n_iter):
        am, md, det = j_assignment.assign_abft_offline(xc, c.astype(dtype))
        new_c, counts = j_kmeans.centroid_update(xc, am, c.shape[0], c,
                                                 use_dmr=True)
        c = j_kmeans.reseed_empty(key, xc, new_c, counts, md)
        dets += int(det)
    return np.asarray(am), np.asarray(md, np.float32), np.asarray(c), dets


@pytest.mark.parametrize("dtype", DTYPES)
def test_detect_fit_matches_reference(wide, dtype):
    """KMeans(fault=FaultPolicy.detect()) at 2 bytes against the
    reference's detect steps: labels and detected errors exact, centroids
    to rtol 1e-5, inertia within two 2-byte ulps per row; predict and
    score through the same backend."""
    x, c = wide
    n_iter = 4
    km = KMeans(7, fault=FaultPolicy.detect(), max_iter=n_iter, tol=0.0,
                compute_dtype=dtype, device="cpu").fit(x, centroids=c)
    assert km._backend.name == "abft_offline" and km._use_dmr
    am, md, cj, dets = _reference_detect_fit(x, c, dtype, n_iter)
    np.testing.assert_array_equal(km.labels_.numpy(), am)
    assert km.detected_errors_ == dets
    assert km.n_iter_ == n_iter
    _close(km.cluster_centers_.numpy(), cj)
    tol = x.shape[0] * _two_ulps(x, c, dtype)
    assert abs(km.inertia_ - float(md.astype(np.float64).sum())) <= tol
    pred = km.predict(x).numpy()
    jam, jmd, _ = j_assignment.assign_abft_offline(
        _j(x, dtype), jnp.asarray(cj).astype(dtype))
    np.testing.assert_array_equal(pred, np.asarray(jam))
    assert abs(km.score(x) + float(np.asarray(jmd, np.float64).sum())) <= tol


@pytest.mark.parametrize("dtype", DTYPES)
def test_reference_detect_fit_fails_at_2_bytes(wide, dtype):
    """The reference's own detect fit does not run at bf16 / fp16: its
    chunk's ``lax.cond`` gets a 2-byte inertia from the live branch (the
    sum of 2-byte distances) and an f32 one from the frozen branch
    (ROADMAP Queue 3). The port's backend returns f32 distances, so its fit
    runs; test_detect_fit_matches_reference holds it to the reference's
    steps instead."""
    x, c = wide
    with pytest.raises(TypeError, match="cond branches"):
        JKMeans(7, fault=JFaultPolicy.detect(), max_iter=2, tol=0.0,
                compute_dtype=dtype).fit(x, centroids=c)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("direction", ["to_reference", "from_reference"])
def test_detect_state_interchange(wide, dtype, direction):
    """A 2-byte detect state crosses both ways (the reference's state goes
    through its from_state/get_state, since its fit cannot run) and
    predicts the reference's labels."""
    x, c = wide
    km = KMeans(7, fault=FaultPolicy.detect(), max_iter=3, tol=0.0,
                compute_dtype=dtype, device="cpu").fit(x, centroids=c)
    jk = JKMeans.from_state(convert.to_reference_state(km.get_state()))
    assert jk.compute_dtype == jnp.dtype(dtype)
    if direction == "from_reference":
        km = KMeans.from_state(convert.from_reference_state(jk.get_state()),
                               device="cpu")
    assert km.compute_dtype == getattr(torch, dtype)
    assert km._backend.name == "abft_offline"
    np.testing.assert_array_equal(km.predict(x).numpy(),
                                  np.asarray(jk.predict(x)))


def test_first_min_takes_a_nan_as_jnp_argmin_does():
    """At fp16 the detect path's checksums overflow past a few thousand
    rows in both packages (the e2 weights alone pass 65504), and one
    "corrected" product turns NaN: the row's min is then NaN and its label
    the first NaN's index, as jnp.min / jnp.argmin give, never out of
    range."""
    from repro_torch.kernels import ref
    nan = float("nan")
    d = np.array([[3.0, 1.0, 1.0, 5.0], [2.0, nan, 0.0, nan],
                  [nan, 1.0, 2.0, 3.0]], np.float32)
    mn, am = ref.first_min(torch.from_numpy(d))
    np.testing.assert_array_equal(mn.numpy(), np.asarray(jnp.min(d, axis=1)))
    np.testing.assert_array_equal(am.numpy(),
                                  np.asarray(jnp.argmin(d, axis=1)))


# --- flash attention at fp16 -------------------------------------------------

def _qkv(seed, b, h, kv, s, hd):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(b, h, s, hd)) * 0.3).astype(np.float32)
    k = (rng.normal(size=(b, kv, s, hd)) * 0.3).astype(np.float32)
    v = rng.normal(size=(b, kv, s, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 128),
                                           (False, 0)])
def test_flash_fp16_matches_reference_kernel(causal, window):
    B, H, KV, S, HD = 1, 4, 2, 512, 64
    q, k, v = _qkv(0, B, H, KV, S, HD)
    pos = np.arange(S, dtype=np.int32)
    want = j_flash(_j(q, "float16"), _j(k, "float16"), _j(v, "float16"),
                   jnp.asarray(pos), jnp.asarray(pos), causal=causal,
                   window=window, block_q=128, block_k=128, interpret=True)
    got = fa.flash_attention(_t(q, "float16"), _t(k, "float16"),
                             _t(v, "float16"), torch.from_numpy(pos),
                             torch.from_numpy(pos), causal=causal,
                             window=window)
    assert got.dtype == torch.float16 and got.shape == (B, H, S, HD)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=FP16_RTOL, atol=FP16_ATOL)


def test_attend_fp16_matches_reference():
    """``attend`` at fp16 ((B, S, H, hd) layout, positions with cold
    slots), the chunked route and the kernel route (its plain version
    here), against the reference's ``attend``."""
    rng = np.random.default_rng(12)
    b, s, h, kvh, hd = 2, 300, 4, 2, 64
    q = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, s, kvh, hd)).astype(np.float32)
    v = rng.normal(size=(b, s, kvh, hd)).astype(np.float32)
    qpos = np.arange(s, dtype=np.int32)
    kpos = qpos.copy()
    kpos[-20:] = t_attn.NEG_POS
    want = j_attn.attend(_j(q, "float16"), _j(k, "float16"),
                         _j(v, "float16"), q_positions=jnp.asarray(qpos),
                         kv_positions=jnp.asarray(kpos), causal=True)
    args = (_t(q, "float16"), _t(k, "float16"), _t(v, "float16"))
    kw = dict(q_positions=torch.from_numpy(qpos),
              kv_positions=torch.from_numpy(kpos), causal=True, window=0)
    want = np.asarray(want.astype(jnp.float32))
    for got in (t_attn.attend(*args, **kw),
                t_attn._attend_kernel(*args, **kw)):
        assert got.dtype == torch.float16
        np.testing.assert_allclose(got.float().numpy(), want, rtol=FP16_RTOL,
                                   atol=FP16_ATOL)


# --- the wrappers on the CPU -------------------------------------------------

def test_wrappers_count_no_launch_on_cpu_at_2_bytes():
    """On CPU tensors the new 2-byte entries run their plain versions and
    count no launch; a dtype the kernels do not take raises."""
    counters = (ll.lloyd_step_batched, llp.lloyd_step_pruned,
                mma.matmul_abft, fa.flash_attention)
    before = [w.launches for w in counters]
    for dtype in DTYPES:
        x = _t(_ints((3, 64, 32), 4), dtype)
        c = _t(_ints((3, 128, 32), 5), dtype)
        cn = (c.float() ** 2).sum(2)
        ll.lloyd_step_batched(x, c, cn, 64, block_m=64, block_k=128,
                              block_f=32)
        skip = torch.zeros((1, 1), dtype=torch.int32)
        llp.lloyd_step_pruned(x[0], c[0], cn[0], (x[0].float() ** 2).sum(1),
                              skip, 64, block_m=64, block_k=128, block_f=32)
        ops.abft_matmul(x[0], c[0].T.contiguous())
    q = torch.zeros((1, 2, 8, 16), dtype=torch.float16)
    pos = torch.arange(8)
    fa.flash_attention(q, q, q, pos, pos)
    assert [w.launches for w in counters] == before
    with pytest.raises(ValueError, match="one dtype"):
        ll.lloyd_step_batched(x, c.float(), cn, 64, block_m=64, block_k=128,
                              block_f=32)
