"""The port's int8 path against the reference, on the CPU.

* ``quantize_rows`` is bit for bit the reference's, exact halves (round
  half to even) and all-zero rows included;
* the int8 kernel's plain version (exact int64 products) equals the
  reference's Pallas entry in interpret mode bit for bit on the same
  quantised inputs, and on quantisation-safe data (integers in
  [-127, 127] with a +-127 in every row, so every scale is 1.0) the port's
  f32 ``distance_argmin``;
* the estimator picks the int8 backend itself, fits within the reference's
  5 % of f32, leaves an f32 fit's path on blob data exactly where the
  reference's int8 fit does, refuses the reference's mismatched configurations with its
  messages, and its states load into either package.

Inputs are made with numpy from a seed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.api import FaultPolicy as JFaultPolicy  # noqa: E402
from repro.api import KMeans as JKMeans  # noqa: E402
from repro.dist import compression as j_comp  # noqa: E402
from repro.kernels import distance_argmin_int8 as j_dai  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.api import (BackendCapabilityError, FaultPolicy,  # noqa: E402
                             KMeans, get_backend)
from repro_torch.data.blobs import make_blobs  # noqa: E402
from repro_torch.dist.compression import quantize_rows  # noqa: E402
from repro_torch.kernels import distance_argmin_int8 as dai  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TILES = (128, 128, 128)


def _safe(m, f, seed):
    """Quantisation-safe rows (the reference's ``tests/test_int8.py``)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-127, 128, size=(m, f)).astype(np.float32)
    a[np.arange(m), rng.integers(0, f, m)] = 127.0
    return a


def _normal(m, f, seed):
    return np.random.default_rng(seed).normal(size=(m, f)).astype(np.float32)


# --- quantisation -----------------------------------------------------------

def test_quantize_rows_matches_reference_bitwise():
    x = _normal(300, 77, 0) * 3.0
    x[5] = 0.0                                    # all-zero row
    # exact halves: max 127 gives scale 1.0, so x / scale is x itself
    x[7, :6] = [127.0, 2.5, -3.5, 0.5, -0.5, 126.5]
    x[8, :4] = [-127.0, 1.5, -2.5, 4.5]
    q, s = quantize_rows(torch.from_numpy(x))
    jq, js = j_comp.quantize_rows(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.shape == (300, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q[7, :6].tolist() == [127, 2, -4, 0, 0, 126]
    assert q[8, :4].tolist() == [-127, 2, -2, 4]
    assert bool((q[5] == 0).all()) and float(s[5, 0]) == np.float32(1e-12)


def test_quantize_rows_is_identity_on_safe_rows():
    x = _safe(64, 40, 1)
    q, s = quantize_rows(torch.from_numpy(x))
    assert bool((s == 1.0).all())
    np.testing.assert_array_equal(q.numpy().astype(np.float32), x)


# --- the kernel ---------------------------------------------------------------

SHAPES = [(517, 260, 200), (300, 77, 130), (256, 16, 64)]   # last: one tile


def _quantised(x, c, kp, fp):
    """The raw kernel's inputs, in numpy: padded int8 tiles, scales with 1.0
    in padded slots, norms of the unquantised centroids with +inf."""
    m, f = x.shape
    k = c.shape[0]
    qx, sx = (np.asarray(a) for a in j_comp.quantize_rows(jnp.asarray(x)))
    qc, sc = (np.asarray(a) for a in j_comp.quantize_rows(jnp.asarray(c)))
    mp = -(-m // 128) * 128
    xq = np.zeros((mp, fp), np.int8)
    xq[:m, :f] = qx
    cq = np.zeros((kp, fp), np.int8)
    cq[:k, :f] = qc
    sxp = np.ones(mp, np.float32)
    sxp[:m] = sx[:, 0]
    scp = np.ones(kp, np.float32)
    scp[:k] = sc[:, 0]
    cn = np.full(kp, np.inf, np.float32)
    cn[:k] = (c.astype(np.float32) ** 2).sum(1)
    return xq, cq, sxp, scp, cn


@pytest.mark.parametrize("m,k,f", SHAPES)
def test_plain_kernel_matches_reference_pallas_bitwise(m, k, f):
    x, c = _normal(m, f, 2) * 4.0, _normal(k, f, 3) * 4.0
    kp, fp = -(-k // 128) * 128, -(-f // 128) * 128
    xq, cq, sx, sc, cn = _quantised(x, c, kp, fp)
    mind, am = dai.distance_argmin_int8(
        *(torch.from_numpy(a) for a in (xq, cq, sx, sc, cn)),
        block_m=128, block_k=128, block_f=128)
    variant = "smallk" if kp == 128 else "generic"
    jmind, jam = j_dai.distance_argmin_int8(
        xq, cq, sx[:, None], sc[None, :], cn[None, :], block_m=128,
        block_k=128, block_f=128, variant=variant, interpret=True)
    np.testing.assert_array_equal(am.numpy(), np.asarray(jam)[:, 0])
    np.testing.assert_array_equal(mind.numpy(), np.asarray(jmind)[:, 0])


def test_plain_products_are_exact_beyond_the_f32_carrier():
    """F = 2048 > 1040: int8 products no longer fit the f32 carrier, the
    plain version's int64 accumulation stays exact."""
    rng = np.random.default_rng(4)
    a = rng.integers(-127, 128, size=(40, 2048)).astype(np.int8)
    b = rng.integers(-127, 128, size=(24, 2048)).astype(np.int8)
    got = dai.int8_products(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(
        got.numpy(), a.astype(np.int64) @ b.astype(np.int64).T)


@pytest.mark.parametrize("m,k,f", SHAPES)
def test_fused_assign_int8_matches_reference(m, k, f):
    x, c = _normal(m, f, 5) * 4.0, _normal(k, f, 6) * 4.0
    am, md = ops.fused_assign_int8(torch.from_numpy(x), torch.from_numpy(c),
                                   ops.KernelParams(*TILES))
    jam, jmd = jops.fused_assign_int8(jnp.asarray(x), jnp.asarray(c),
                                      jops.KernelParams(*TILES),
                                      interpret=True)
    np.testing.assert_array_equal(am.numpy(), np.asarray(jam))
    np.testing.assert_allclose(md.numpy(), np.asarray(jmd), rtol=1e-6,
                               atol=1e-6 * float(np.abs(jmd).max()))


@pytest.mark.parametrize("m,k,f", SHAPES)
@pytest.mark.parametrize("bm", [64, 128])
def test_safe_data_is_bitwise_distance_argmin(m, k, f, bm):
    x, c = torch.from_numpy(_safe(m, f, 7)), torch.from_numpy(_safe(k, f, 8))
    p = ops.KernelParams(bm, 128, 32)
    am8, md8 = ops.fused_assign_int8(x, c, p)
    am, md = ops.fused_assign(x, c, p)
    assert torch.equal(am8, am) and torch.equal(md8, md)
    plan = ops.plan_data_int8(x, ops.clamp_params(m, k, f, p))
    assert torch.equal(ops.fused_assign_int8(plan, c)[0], am)


def test_quant_plan_and_row_norms():
    from repro_torch.core import assignment
    x = torch.from_numpy(_normal(200, 24, 9))
    p = ops.clamp_params(200, 8, 24, ops.KernelParams(*TILES))
    plan = ops.plan_data_int8(x, p)
    assert plan.xq.shape == (256, 32) and plan.xq.dtype == torch.int8
    assert bool((plan.sx[200:] == 1.0).all()) and plan.sx.shape == (256,)
    assert torch.equal(assignment._row_norms(plan), (x * x).sum(1))
    assert plan.data.x is x and plan.data.xp.shape == (256, 32)


def test_wrapper_checks_and_counts_no_launch_on_cpu():
    before = dai.distance_argmin_int8.launches
    ops.fused_assign_int8(torch.from_numpy(_normal(300, 40, 1)),
                          torch.from_numpy(_normal(9, 40, 2)))
    assert dai.distance_argmin_int8.launches == before == 0
    z8 = torch.zeros((128, 32), dtype=torch.int8)
    ones = torch.ones(128)
    with pytest.raises(ValueError, match="int8 tiles"):
        dai.distance_argmin_int8(z8.float(), z8, ones, ones, ones,
                                 block_m=128, block_k=128, block_f=32)
    meta = dict(device="meta")
    with pytest.raises(RuntimeError, match="CPU or on one CUDA"):
        dai.distance_argmin_int8(
            torch.empty((128, 32), dtype=torch.int8, **meta),
            torch.empty((128, 32), dtype=torch.int8, **meta),
            torch.empty(128, **meta), torch.empty(128, **meta),
            torch.empty(128, **meta), block_m=128, block_k=128, block_f=32)


def test_registry_flags_match_reference():
    from repro.api import get_backend as j_get_backend
    b, jb = get_backend("int8"), j_get_backend("int8")
    assert b.kernel_kind == jb.kernel_kind == "int8"
    for flag in ("supports_ft", "takes_params", "takes_injection",
                 "fuses_update", "supports_batch", "supports_bounds",
                 "supports_int8"):
        assert getattr(b, flag) == getattr(jb, flag), flag


# --- the estimator -------------------------------------------------------------

def test_auto_backend_and_fit_close_to_f32():
    x = _normal(600, 48, 0)
    km8 = KMeans(7, compute_dtype="int8", max_iter=15, random_state=3,
                 device="cpu")
    assert km8._backend.name == "int8"
    km8.fit(x)
    kmf = KMeans(7, max_iter=15, random_state=3, device="cpu").fit(x)
    assert abs(km8.inertia_ - kmf.inertia_) / kmf.inertia_ < 0.05
    assert km8.cluster_centers_.dtype == torch.float32
    assert km8.get_state()["config"]["compute_dtype"] == "int8"


def test_one_step_on_safe_data_is_one_fused_step():
    x, c = _safe(700, 40, 11), _safe(30, 40, 12)
    kw = dict(max_iter=1, tol=0.0, params=ops.KernelParams(*TILES),
              device="cpu")
    k8 = KMeans(30, compute_dtype="int8", **kw).fit(x, centroids=c)
    kf = KMeans(30, backend="fused", **kw).fit(x, centroids=c)
    assert torch.equal(k8.labels_, kf.labels_)
    assert torch.equal(k8.cluster_centers_, kf.cluster_centers_)
    assert k8.inertia_ == kf.inertia_


def test_fit_matches_reference():
    """Same data and centroids: the port's int8 fit and the reference's
    (``int8_xla``, f32 carrier: the same integers) assign alike."""
    x = _normal(500, 32, 13)
    c = x[np.random.default_rng(13).choice(500, 6, replace=False)]
    km = KMeans(6, compute_dtype="int8", max_iter=5, tol=0.0,
                device="cpu").fit(x, centroids=c)
    jk = JKMeans(6, compute_dtype="int8", max_iter=5,
                 tol=0.0).fit(x, centroids=c)
    np.testing.assert_array_equal(km.labels_.numpy(), np.asarray(jk.labels_))
    np.testing.assert_allclose(km.cluster_centers_.numpy(),
                               np.asarray(jk.cluster_centers_), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("seed,diverges", [(0, False), (1, False),
                                           (2, False), (3, True)])
def test_int8_leaves_f32_alike_in_both_packages(seed, diverges):
    """Blob data from k-means++ seeds: both packages' int8 fits take the
    same path, and where quantisation moves that path off the f32 fit's
    (seed 3 ends 36 % below f32) the reference's fit moves alike. The 5 %
    bar of ``test_auto_backend_and_fit_close_to_f32`` holds only where the
    two fits share an optimum, in either package."""
    x, _ = make_blobs(8192, 128, 64, seed=0)
    c0 = np.asarray(JKMeans(64, random_state=seed).init_centroids(x))
    kw = dict(max_iter=10, tol=0.0)
    p8 = KMeans(64, compute_dtype="int8", device="cpu",
                **kw).fit(x, centroids=c0)
    pf = KMeans(64, device="cpu", **kw).fit(x, centroids=c0)
    j8 = JKMeans(64, compute_dtype="int8", **kw).fit(x, centroids=c0)
    jf = JKMeans(64, **kw).fit(x, centroids=c0)
    np.testing.assert_array_equal(p8.labels_.numpy(), np.asarray(j8.labels_))
    np.testing.assert_array_equal(pf.labels_.numpy(), np.asarray(jf.labels_))
    rel_port = p8.inertia_ / pf.inertia_ - 1.0
    rel_ref = j8.inertia_ / jf.inertia_ - 1.0
    np.testing.assert_allclose(rel_port, rel_ref, rtol=0, atol=1e-5)
    assert (abs(rel_ref) > 0.05) == diverges, rel_ref


def test_predict_score_partial_fit():
    x = _normal(512, 32, 2)
    km = KMeans(5, compute_dtype="int8", max_iter=8, device="cpu").fit(x)
    assert km.predict(x).shape == (512,)
    assert km.score(x) <= 0.0
    assert torch.equal(km.predict(x[:0]), torch.zeros(0, dtype=torch.int32))
    st = KMeans(5, compute_dtype="int8", device="cpu")
    st.partial_fit(x[:256]).partial_fit(x[256:])
    assert st.n_iter_ == 2 and np.isfinite(st.inertia_)


@pytest.mark.parametrize("kw,match", [
    (dict(compute_dtype="int8", backend="fused"), "int8-quantized"),
    (dict(backend="int8"), "compute_dtype='int8'"),
])
def test_mismatched_configs_rejected_like_reference(kw, match):
    with pytest.raises(ValueError, match=match):
        KMeans(4, device="cpu", **kw)
    with pytest.raises(ValueError, match=match):
        JKMeans(4, **kw)


def test_protected_int8_refused_like_reference():
    with pytest.raises(BackendCapabilityError, match="fault-tolerant"):
        KMeans(4, compute_dtype="int8", fault=FaultPolicy.correct(),
               device="cpu")
    with pytest.raises(Exception, match="fault-tolerant"):
        JKMeans(4, compute_dtype="int8", fault=JFaultPolicy.correct())


@pytest.mark.parametrize("kw", [dict(compute_dtype="int8", batch_size=64)])
def test_later_slices_still_raise(kw):
    with pytest.raises(NotImplementedError):
        KMeans(4, device="cpu", **kw)


def test_state_interchange():
    """A reference int8 state (host backend ``int8_xla``) loads into the
    port as ``int8`` and predicts the reference's labels; the port's state
    loads into the reference likewise."""
    x = _normal(400, 24, 21) + np.repeat(np.eye(4, 24, dtype=np.float32)
                                         * 12.0, 100, axis=0)
    c = x[[0, 100, 200, 300]]
    jk = JKMeans(4, compute_dtype="int8", backend="int8_xla", max_iter=4,
                 tol=0.0).fit(x, centroids=c)
    state = convert.from_reference_state(jk.get_state())
    assert state["config"]["backend"] == "int8"
    assert state["config"]["compute_dtype"] == "int8"
    km = KMeans.from_state(state, device="cpu")
    assert km._backend.name == "int8"
    np.testing.assert_array_equal(km.predict(x).numpy(),
                                  np.asarray(jk.predict(x)))
    port = KMeans(4, compute_dtype="int8", max_iter=4, tol=0.0,
                  device="cpu").fit(x, centroids=c)
    back = JKMeans.from_state(convert.to_reference_state(port.get_state()))
    assert back.compute_dtype == jnp.int8 and back._backend.supports_int8
    np.testing.assert_array_equal(np.asarray(back.predict(x)),
                                  port.predict(x).numpy())
