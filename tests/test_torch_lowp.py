"""bf16 / fp16 compute dtypes: the port against the reference, on the CPU.

The port's wrappers run their kernels' plain versions on CPU tensors (f32
products of the widened 2-byte values); the reference runs its Pallas
templates at bf16 / fp16 in interpret mode (2-byte tiles, f32 accumulation).
Inputs are made with numpy from a seed, cast to the compute dtype, and fed
to both with the same explicit KernelParams. Tolerances: assignments,
counts, detection counts and iteration counts exact; min distances, sums,
centroids and inertia to rtol 1e-5 (of the largest magnitude for arrays):
products of 2-byte values are exact in f32, so the two packages differ only
in the order of their f32 sums. The CUDA kernels themselves run on the card
(``chip_smoke.py`` phase 13).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.api import FaultPolicy as JFaultPolicy  # noqa: E402
from repro.api import InjectionCampaign as JCampaign  # noqa: E402
from repro.api import KMeans as JKMeans  # noqa: E402
from repro.kernels import lloyd_step_ft as j_llft  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import matmul_abft as j_mma  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.api import FaultPolicy, InjectionCampaign, KMeans  # noqa: E402
from repro_torch.data.blobs import make_blobs  # noqa: E402
from repro_torch.kernels import distance_argmin as t_da  # noqa: E402
from repro_torch.kernels import lloyd_step_ft as t_llft  # noqa: E402
from repro_torch.kernels import matmul_abft as t_mma  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

DTYPES = ["bfloat16", "float16"]
M, K, F = 517, 260, 200          # 5 x 3 x 2 tiles at (128, 128, 128)
TILES = [(128, 128, 128), (64, 128, 128)]
RTOL = 1e-5
NP_DTYPES = {"bfloat16": ml_dtypes.bfloat16, "float16": np.float16}


def _cast(a: np.ndarray, dtype: str):
    """(numpy array of the 2-byte dtype for the reference, torch tensor of
    the same values for the port)."""
    lo = a.astype(NP_DTYPES[dtype])
    return lo, torch.from_numpy(lo.astype(np.float32)).to(getattr(torch,
                                                                  dtype))


def _blob_inputs(seed=3):
    x, _ = make_blobs(M, F, 9, seed=seed)
    rng = np.random.default_rng(seed)
    c = x[rng.choice(M, K, replace=False)] + rng.normal(
        size=(K, F)).astype(np.float32)
    return x, c.astype(np.float32)


def _tie_inputs(seed=5):
    """Small integers, exact in every dtype and every sum: centroid
    duplicates across a tile boundary and inside a tile, and rows sitting
    on them, so the argmin tie-break decides."""
    rng = np.random.default_rng(seed)
    c = rng.integers(-3, 4, size=(K, F)).astype(np.float32)
    for dup, orig in ((200, 10), (128, 127), (31, 30), (259, 5)):
        c[dup] = c[orig]
    x = rng.integers(-3, 4, size=(M, F)).astype(np.float32)
    for i, orig in enumerate((10, 127, 30, 5) * 18):
        x[7 * i] = c[orig]
    return x, c


INPUTS = {"blobs": _blob_inputs, "ties": _tie_inputs}


def _both(x, c, tiles, dtype):
    """Reference and port operands: X in the compute dtype, C in f32 (each
    package casts it to X's dtype), explicit tiles."""
    jx, tx = _cast(x, dtype)
    return (tx, torch.from_numpy(c), ops.KernelParams(*tiles), jx, c,
            jops.KernelParams(*tiles))


def _close(a, b, rtol=RTOL, scale=None):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max() if scale is None else scale
    np.testing.assert_allclose(a, b, rtol=0, atol=rtol * max(scale, 1.0))


def _norm_scale(x, dtype):
    xl = x.astype(NP_DTYPES[dtype]).astype(np.float64)
    return float((xl ** 2).sum(1).max())


# --- (a) each kernel entry against the reference's interpret-mode call ----

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tiles", TILES)
@pytest.mark.parametrize("data", sorted(INPUTS))
class TestKernelParity:
    def test_fused_assign(self, data, tiles, dtype):
        x, c = INPUTS[data]()
        tx, tc, p, jx, jc, jp = _both(x, c, tiles, dtype)
        am, md = ops.fused_assign(tx, tc, p)
        jam, jmd = jops.fused_assign(jx, jc, jp, interpret=True)
        np.testing.assert_array_equal(am.numpy(), np.asarray(jam))
        assert md.dtype == torch.float32
        _close(md.numpy(), jmd)

    def test_fused_lloyd(self, data, tiles, dtype):
        x, c = INPUTS[data]()
        tx, tc, p, jx, jc, jp = _both(x, c, tiles, dtype)
        am, md, sums, counts = ops.fused_lloyd(tx, tc, p)
        jam, jmd, jsums, jcounts = jops.fused_lloyd(jx, jc, jp,
                                                    interpret=True)
        np.testing.assert_array_equal(am.numpy(), np.asarray(jam))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
        assert sums.dtype == torch.float32
        _close(md.numpy(), jmd, scale=_norm_scale(x, dtype))
        _close(sums.numpy(), jsums)

    def test_fused_assign_ft(self, data, tiles, dtype):
        x, c = INPUTS[data]()
        tx, tc, p, jx, jc, jp = _both(x, c, tiles, dtype)
        am, md, det = ops.fused_assign_ft(tx, tc, p)
        jam, jmd, jdet = jops.fused_assign_ft(jx, jc, jp, interpret=True)
        np.testing.assert_array_equal(am.numpy(), np.asarray(jam))
        assert int(det) == int(jdet) == 0
        _close(md.numpy(), jmd)

    def test_fused_lloyd_ft(self, data, tiles, dtype):
        x, c = INPUTS[data]()
        tx, tc, p, jx, jc, jp = _both(x, c, tiles, dtype)
        am, md, sums, counts, det = ops.fused_lloyd_ft(tx, tc, p)
        jam, jmd, jsums, jcounts, jdet = jops.fused_lloyd_ft(
            jx, jc, jp, interpret=True)
        np.testing.assert_array_equal(am.numpy(), np.asarray(jam))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
        assert int(det) == int(jdet) == 0
        _close(md.numpy(), jmd, scale=_norm_scale(x, dtype))
        _close(sums.numpy(), jsums)


def test_plan_keeps_the_compute_dtype():
    """The plan pads X in its dtype and sums the norms of the cast rows in
    f32; padded centroids are cast, their norms f32 norms of the cast
    values (the reference's order)."""
    x, c = _blob_inputs()
    for dtype in DTYPES:
        jx, tx = _cast(x, dtype)
        p = ops.KernelParams(128, 128, 128)
        plan = ops.plan_data(tx, p)
        jplan = jops.plan_data(jnp.asarray(jx), jops.KernelParams(128, 128,
                                                                  128))
        assert plan.xp.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(plan.xp.float().numpy(),
                                      np.asarray(jplan.xp, np.float32))
        _close(plan.xn.numpy(), jplan.xn)
        _, cp, cn, _ = ops._resolve_padded(plan, torch.from_numpy(c), None)
        assert cp.dtype == plan.xp.dtype and cn.dtype == torch.float32
        want = (c.astype(NP_DTYPES[dtype]).astype(np.float32) ** 2).sum(1)
        _close(cn[:K].numpy(), want)


# --- (b) the same injection descriptors -----------------------------------

# (row, col, f_step, delta): first/last row, the ragged last centroid tile,
# both feature tiles, both signs
FAULTS = [(0, 0, 0, 2.0 ** 21), (516, 259, 1, -2.0 ** 23),
          (300, 130, 1, 2.0 ** 22), (129, 127, 0, -2.0 ** 21)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fault", FAULTS)
def test_assign_ft_same_descriptor(fault, dtype):
    x, c = _blob_inputs()
    tx, tc, p, jx, jc, jp = _both(x, c, TILES[0], dtype)
    row, col, f_step, delta = fault
    inj = ops.plan_injection_tile(M, K, F, p, row, col, f_step, delta)
    jinj = jops.plan_injection_tile(M, K, F, jp, row, col, f_step, delta)
    np.testing.assert_array_equal(inj.numpy(), np.asarray(jinj))
    clean_am, clean_md, _ = ops.fused_assign_ft(tx, tc, p)
    am, md, det = ops.fused_assign_ft(tx, tc, p, inj=inj)
    jam, jmd, jdet = jops.fused_assign_ft(jx, jc, jp, inj=jinj,
                                          interpret=True)
    assert int(det) == int(jdet) == 1
    np.testing.assert_array_equal(am.numpy(), clean_am.numpy())
    np.testing.assert_array_equal(am.numpy(), np.asarray(jam))
    _close(md.numpy(), clean_md.numpy())
    _close(md.numpy(), jmd)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("slots", [
    {"distance": (2, 1, 0, 17, 100, 2.0 ** 21)},
    {"update": (3, 8, 150, -2.0 ** 20)},
    {"distance": (4, 2, 1, 4, 3, -2.0 ** 22), "update": (0, 0, 0, 2.0 ** 22)},
])
def test_lloyd_ft_same_descriptor(slots, dtype):
    """Equal detection counts in both packages; the port's corrected step
    is bit for bit its clean step (assignment, sums, counts)."""
    x, c = _blob_inputs()
    tx, tc, p, jx, jc, jp = _both(x, c, TILES[0], dtype)
    inj = t_llft.make_injection(**slots)
    jinj = j_llft.make_injection(**slots)
    np.testing.assert_array_equal(inj.numpy(), np.asarray(jinj))
    clean = ops.fused_lloyd_ft(tx, tc, p)
    hit = ops.fused_lloyd_ft(tx, tc, p, inj=inj)
    jhit = jops.fused_lloyd_ft(jx, jc, jp, inj=jinj, interpret=True)
    assert int(hit[4]) == int(jhit[4]) == len(slots)
    for a, b in zip(hit[:4:2], clean[:4:2]):
        assert torch.equal(a, b)
    assert torch.equal(hit[3], clean[3])
    np.testing.assert_array_equal(hit[0].numpy(), np.asarray(jhit[0]))
    _close(hit[2].numpy(), jhit[2])


# --- (c) KMeans fits from the same explicit centroids ----------------------

@pytest.fixture(scope="module")
def blobs():
    x, _ = make_blobs(1500, 12, 6, seed=3, spread=0.5)
    c0 = x[np.random.default_rng(3).choice(1500, 6, replace=False)]
    return x, c0


BACKENDS = ["fused", "lloyd", "fused_ft", "lloyd_ft"]


def _fits(x, c0, dtype, backend, **kw):
    kw = dict(dict(max_iter=20, tol=0.0), **kw)
    km = KMeans(6, backend=backend, compute_dtype=dtype, device="cpu",
                **kw).fit(x, centroids=c0)
    jk = JKMeans(6, backend=backend, compute_dtype=dtype, **kw).fit(
        x, centroids=c0)
    return km, jk


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_fit_matches_reference(blobs, backend, dtype):
    x, c0 = blobs
    km, jk = _fits(x, c0, dtype, backend)
    labels = km.labels_.numpy()
    np.testing.assert_array_equal(labels, np.asarray(jk.labels_))
    assert km.n_iter_ == jk.n_iter_
    assert km.cluster_centers_.dtype == torch.float32
    ref_c = np.asarray(jk.cluster_centers_)
    _close(km.cluster_centers_.numpy(), ref_c)
    assert km.inertia_ == pytest.approx(jk.inertia_, rel=RTOL)
    assert km.detected_errors_ == jk.detected_errors_ == 0
    # predict runs through the compute dtype, consistently with the fit
    pred = km.predict(x).numpy()
    np.testing.assert_array_equal(pred, labels)
    np.testing.assert_array_equal(pred, np.asarray(jk.predict(x)))
    assert km.score(x) == pytest.approx(jk.score(x), rel=RTOL)
    want = np.asarray(jk.transform(x))
    _close(km.transform(x).numpy(), want)


# --- (d) the port's own contracts at 2-byte dtypes --------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_lloyd_and_clean_ft_fits_are_bitwise_equal(blobs, dtype):
    x, c0 = blobs
    kw = dict(compute_dtype=dtype, device="cpu", max_iter=8, tol=0.0)
    fits = [KMeans(6, backend=b, **kw).fit(x, centroids=c0)
            for b in ("fused", "lloyd", "lloyd_ft")]
    for km in fits[1:]:
        assert torch.equal(km.cluster_centers_, fits[0].cluster_centers_)
        assert torch.equal(km.labels_, fits[0].labels_)


@pytest.mark.parametrize("dtype", DTYPES)
def test_campaign_detects_like_reference_and_recovers_bitwise(blobs, dtype):
    """Every step plants a distance and an update fault; both packages draw
    the same schedule and detect it all, and the port's protected fit ends
    bit for bit on its clean fit."""
    x, c0 = blobs
    kw = dict(max_iter=6, tol=0.0, compute_dtype=dtype)
    clean = KMeans(6, fault=FaultPolicy.correct(), device="cpu", **kw).fit(
        x, centroids=c0)
    camp = KMeans(6, fault=FaultPolicy.correct(injection=InjectionCampaign(
        rate=2.0, targets="both")), device="cpu", **kw).fit(x, centroids=c0)
    jcamp = JKMeans(6, fault=JFaultPolicy.correct(injection=JCampaign(
        rate=2.0, targets="both")), **kw).fit(x, centroids=c0)
    assert camp.detected_errors_ == jcamp.detected_errors_ == 12
    assert torch.equal(camp.cluster_centers_, clean.cluster_centers_)
    assert torch.equal(camp.labels_, clean.labels_)
    np.testing.assert_array_equal(camp.labels_.numpy(),
                                  np.asarray(jcamp.labels_))


@pytest.mark.parametrize("dtype", DTYPES)
def test_partial_fit_matches_reference(blobs, dtype):
    x, c0 = blobs
    km = KMeans(6, compute_dtype=dtype, device="cpu")
    jk = JKMeans(6, compute_dtype=dtype)
    for est in (km, jk):
        est.fit(x[:500], centroids=c0)
        est.partial_fit(x[500:1000])
        est.partial_fit(x[1000:])
    _close(km.cluster_centers_.numpy(), np.asarray(jk.cluster_centers_))
    np.testing.assert_array_equal(km.labels_.numpy(),
                                  np.asarray(jk.labels_))


# --- (e) state interchange ---------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_state_from_reference(blobs, dtype):
    x, c0 = blobs
    jk = JKMeans(6, compute_dtype=dtype, max_iter=5, tol=0.0).fit(
        x, centroids=c0)
    km = KMeans.from_state(convert.from_reference_state(jk.get_state()),
                           device="cpu")
    assert km.compute_dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(km.predict(x).numpy(),
                                  np.asarray(jk.predict(x)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_state_to_reference(blobs, dtype):
    x, c0 = blobs
    km = KMeans(6, compute_dtype=dtype, max_iter=5, tol=0.0,
                device="cpu").fit(x, centroids=c0)
    st = convert.to_reference_state(km.get_state())
    assert st["config"]["compute_dtype"] == dtype
    jk = JKMeans.from_state(st)
    assert jk.compute_dtype == jnp.dtype(dtype)
    np.testing.assert_array_equal(np.asarray(jk.predict(x)),
                                  km.predict(x).numpy())
    back = KMeans.from_state(km.get_state(), device="cpu")
    assert torch.equal(back.predict(x), km.predict(x))


# --- (f) the plain product's trap ------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_product_is_f32_on_the_widened_values(dtype):
    """A 2-byte torch product rounds its output to 2 bytes on the CPU; the
    plain versions multiply the widened values in f32 instead, which is the
    kernels' (and the reference's) function: within f32 rounding of the
    float64 product."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(256, 128)).astype(np.float32)
    c = rng.normal(size=(64, 128)).astype(np.float32)
    _, tx = _cast(x, dtype)
    _, tc = _cast(c, dtype)
    xd, cd = tx.double(), tc.double()
    cn = (tc.float() ** 2).sum(1)
    exact = cn.double()[None, :] - 2.0 * (xd @ cd.T)
    md, am = t_da.distance_argmin_plain(tx, tc, cn)
    assert md.dtype == torch.float32
    scale = float(exact.abs().max())
    assert float((md.double() - exact.min(1).values).abs().max()) \
        <= 1e-6 * scale
    np.testing.assert_array_equal(am.numpy(), exact.argmin(1).numpy())
    # the trap: the native 2-byte product misses that bar
    native = (tx @ tc.T).double()
    assert float((native - xd @ cd.T).abs().max()) > 1e-6 * scale


# --- (h) ops.abft_matmul takes its threshold from the inputs' dtype -------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("delta", [1.0, 100.0])
def test_abft_matmul_threshold_follows_input_dtype(dtype, delta):
    """256 x 512 . 512 x 256 at 128^3 tiles, a fault at tile (0, 0), row 3,
    col 5: the reference's bf16/fp16 threshold lets a delta of 1 or 100
    through (0 detected, D off by delta), and so must the port's."""
    rng = np.random.default_rng(17)
    x = rng.normal(size=(256, 512)).astype(np.float32)
    y = rng.normal(size=(512, 256)).astype(np.float32)
    jx, tx = _cast(x, dtype)
    jy, ty = _cast(y, dtype)
    tiles = dict(block_m=128, block_n=128, block_k=128)
    inj = t_mma.make_injection(0, 0, 0, 3, 5, delta)
    jinj = j_mma.make_injection(0, 0, 0, 3, 5, delta)
    d, det = ops.abft_matmul(tx, ty, inj=inj, **tiles)
    jd, jdet = jops.abft_matmul(jnp.asarray(jx), jnp.asarray(jy), inj=jinj,
                                interpret=True, **tiles)
    assert int(det) == int(jdet)
    clean = tx.double() @ ty.double()
    assert abs(float(d[3, 5]) - float(clean[3, 5]) - delta) < 1e-2
    _close(d.numpy(), np.asarray(jd, np.float32))
