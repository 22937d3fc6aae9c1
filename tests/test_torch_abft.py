"""The offline-ABFT slice of the port against the reference, on the CPU:
dual-checksum encodings and decode (``core.checksum``), bit flips and
injection (``core.fault``), the protected products (``core.ft_gemm``), the
ABFT GEMM (``ops.abft_matmul`` on ``kernels.matmul_abft``'s plain version,
against the reference's Pallas kernel in interpret mode), the
``abft_offline`` backend and ``FaultPolicy.detect()`` fits, policy
resolution and state interchange.

Tolerances: sums taken in different orders by XLA and PyTorch agree to
f32 rounding of the magnitudes involved; where a decode must be bitwise
the inputs are small integers, so every sum is exact in any order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
except ImportError:       # deterministic fallback (see _hypothesis_stub)
    from _hypothesis_stub import given, settings, st

from repro.api import FaultPolicy as JFaultPolicy  # noqa: E402
from repro.api import InjectionCampaign as JInjectionCampaign  # noqa: E402
from repro.api import KMeans as JKMeans  # noqa: E402
from repro.core import assignment as j_assignment  # noqa: E402
from repro.core import checksum as j_checksum  # noqa: E402
from repro.core import fault as j_fault  # noqa: E402
from repro.core import ft_gemm as j_ft_gemm  # noqa: E402
from repro.kernels import matmul_abft as j_mma  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.api import (BackendCapabilityError, FaultPolicy,  # noqa: E402
                             InjectionCampaign, KMeans, get_backend)
from repro_torch.core import abft_dot, checksum, fault, ft_gemm  # noqa: E402
from repro_torch.core.assignment import assign_abft_offline  # noqa: E402
from repro_torch.data.blobs import make_blobs  # noqa: E402
from repro_torch.kernels import centroid_update_dmr as cud  # noqa: E402
from repro_torch.kernels import matmul_abft as mma  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _ints(shape, seed):
    return np.random.default_rng(seed).integers(-4, 5, size=shape).astype(
        np.float32)


# --- core.checksum ----------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(8, 16, 8), (32, 64, 16), (128, 256, 64)])
def test_checksums_match_reference(m, k, n):
    x, y = _normal((m, k), 1), _normal((k, n), 2)
    exp = checksum.expected_checksums(torch.from_numpy(x), torch.from_numpy(y))
    jexp = j_checksum.expected_checksums(jnp.asarray(x), jnp.asarray(y))
    obs = checksum.observed_checksums(torch.from_numpy(x @ y))
    # sums in other orders: within f32 rounding of the largest magnitude
    for a, b, c in zip(exp, jexp, obs):
        atol = 1e-5 * float(np.abs(np.asarray(b)).max())
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=atol)
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-4,
                                   atol=atol)
    assert checksum.default_threshold(k) == j_checksum.default_threshold(k)
    np.testing.assert_array_equal(checksum.e2(n).numpy(),
                                  np.asarray(j_checksum.e2(n)))


@pytest.mark.parametrize("i,j,delta", [
    (0, 0, 37.0), (17, 3, 37.0), (63, 31, -512.0), (5, 0, 3.0),
    (40, 22, 1e4), (63, 0, -2.0)])
def test_verify_correct_decode_bitwise(i, j, delta):
    """Integer inputs: every checksum is exact in either package, so the
    verdict, the delta and the corrected product agree bit for bit."""
    x, y = _ints((64, 128), 5), _ints((128, 32), 6)
    d = x @ y
    bad = d.copy()
    bad[i, j] += delta
    thr = 0.5
    exp = checksum.expected_checksums(torch.from_numpy(x), torch.from_numpy(y))
    v = checksum.verify(torch.from_numpy(bad), exp, thr)
    jexp = j_checksum.expected_checksums(jnp.asarray(x), jnp.asarray(y))
    jv = j_checksum.verify(jnp.asarray(bad), jexp, thr)
    assert bool(v.detected) and bool(jv.detected)
    assert (int(v.row), int(v.col)) == (int(jv.row), int(jv.col)) == (i, j)
    assert float(v.delta) == float(jv.delta) == delta
    fixed = checksum.correct(torch.from_numpy(bad.copy()), v)
    np.testing.assert_array_equal(fixed.numpy(),
                                  np.asarray(j_checksum.correct(
                                      jnp.asarray(bad), jv)))
    np.testing.assert_array_equal(fixed.numpy(), d)


def test_verify_row_fallback_matches_reference():
    """A column residual at or below the threshold with a row residual above
    it: the row argmax gives i and the row ratio j, in both packages."""
    x, y = _ints((16, 8), 7), _ints((8, 12), 8)
    d = torch.from_numpy(x @ y)
    exp = checksum.expected_checksums(torch.from_numpy(x), torch.from_numpy(y))
    jexp = j_checksum.expected_checksums(jnp.asarray(x), jnp.asarray(y))
    # the row residual exceeds the threshold, the column's does not
    exp.row1[6] -= 9.0
    exp.row2[6] -= 9.0 * 4
    jexp = jexp._replace(row1=jexp.row1.at[6].add(-9.0),
                         row2=jexp.row2.at[6].add(-36.0))
    v = checksum.verify(d, exp, 5.0)
    jv = j_checksum.verify(jnp.asarray(d.numpy()), jexp, 5.0)
    assert bool(v.detected) == bool(jv.detected)
    assert (int(v.row), int(v.col), float(v.delta)) == \
        (int(jv.row), int(jv.col), float(jv.delta)) == (6, 3, 9.0)


def test_clean_product_not_flagged_and_correct_is_identity():
    x, y = _normal((64, 128), 3), _normal((128, 32), 4)
    d = torch.from_numpy(x) @ torch.from_numpy(y)
    exp = checksum.expected_checksums(torch.from_numpy(x), torch.from_numpy(y))
    thr = checksum.default_threshold(128) * float(d.abs().max())
    v = checksum.verify(d, exp, thr)
    assert not bool(v.detected) and int(v.row) == int(v.col) == 0
    before = d.clone()
    assert checksum.correct(d, v) is d      # in place
    assert torch.equal(d, before)


# --- core.fault ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("idx,bit", [(0, 0), (5, 20), (17, 30), (31, 31),
                                     (12, 7)])
def test_flip_bit_bitwise_reference(dtype, idx, bit):
    if dtype == "bfloat16" and bit > 15:
        bit = bit % 16
    x = _normal((4, 8), 9)
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    j = jnp.asarray(x).astype(getattr(jnp, dtype))
    got = fault.flip_bit(t, idx, bit)
    want = j_fault.flip_bit(j, idx, bit)
    bits = {"float32": (torch.int32, np.int32),
            "bfloat16": (torch.int16, np.int16)}[dtype]
    got_bits = got.view(bits[0]).numpy().copy()
    want_bits = np.asarray(want).view(bits[1]).copy()
    assert int((got.view(bits[0]) != t.view(bits[0])).sum()) == 1
    if np.isnan(np.asarray(want, np.float32).flat[idx]):
        # the reference's bf16 update goes through f32 on the CPU and
        # returns the canonical quiet NaN; the port keeps the flipped bits
        assert bool(torch.isnan(got.flatten()[idx].float()))
        got_bits.flat[idx] = want_bits.flat[idx]
    np.testing.assert_array_equal(got_bits, want_bits)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_inject_properties(seed):
    """Draws cannot match jax.random's; held to their properties: exactly
    one element changes, by one bit in [bit_low, bit_high]; rate 0 is the
    identity; inject_delta adds back to the corrupted tensor."""
    x = torch.from_numpy(_normal((16, 9), seed))
    cfg = fault.FaultConfig(rate=1.0, bit_low=21, bit_high=25)
    gen = torch.Generator().manual_seed(seed)
    bad = fault.inject(gen, x, cfg)
    diff = (bad.view(torch.int32) ^ x.view(torch.int32))
    changed = diff.flatten().nonzero()
    assert changed.numel() == 1
    flipped = int(diff.flatten()[changed[0, 0]])
    bit = flipped.bit_length() - 1
    assert flipped == 1 << bit and 21 <= bit <= 25
    zero = fault.FaultConfig(rate=0.0)
    assert fault.inject(gen, x, zero) is x
    gen = torch.Generator().manual_seed(seed)
    delta = fault.inject_delta(gen, x, cfg)
    assert int((delta != 0).sum()) == 1
    # x + (bad - x) rounds back to bad only up to one rounding of the sum
    torch.testing.assert_close(x + delta, bad, rtol=1e-6, atol=0.0)


# --- core.ft_gemm -----------------------------------------------------------

@pytest.mark.parametrize("fn", ["ft_matmul", "ft_matmul_col"])
def test_ft_matmul_clean_matches_reference(fn):
    x, y = _normal((64, 128), 9), _normal((128, 48), 10)
    d, det = getattr(ft_gemm, fn)(torch.from_numpy(x), torch.from_numpy(y))
    jd, jdet = getattr(j_ft_gemm, fn)(jnp.asarray(x), jnp.asarray(y))
    assert not bool(det) and not bool(jdet)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("bit", [22, 24, 26])
def test_ft_matmul_corrects_one_flip(bit):
    x, y = torch.from_numpy(_normal((32, 64), 11)), \
        torch.from_numpy(_normal((64, 16), 12))
    clean = x @ y
    cfg = fault.FaultConfig(rate=1.0, bit_low=bit, bit_high=bit)
    before = (fault.inject(torch.Generator().manual_seed(4), clean, cfg)
              - clean).abs().max()
    d, det = ft_gemm.ft_matmul(x, y, inject_gen=torch.Generator()
                               .manual_seed(4), fault=cfg)
    assert bool(det) and float(before) > 1.0
    assert float((d - clean).abs().max()) <= max(1e-2, float(before) * 1e-4)


@pytest.mark.parametrize("i,j,delta", [(3, 5, 300.0), (31, 0, -2e4)])
def test_ft_matmul_col_corrects_planted_delta(monkeypatch, i, j, delta):
    """ft_matmul_col takes no injection (in either package): a delta is
    planted in its product, and the corrected product matches the
    reference's clean one."""
    x, y = _normal((32, 64), 13), _normal((64, 16), 14)
    real = torch.matmul

    def planted(a, b):
        out = real(a, b)
        out[i, j] += delta
        return out
    monkeypatch.setattr(ft_gemm.torch, "matmul", planted)
    d, det = ft_gemm.ft_matmul_col(torch.from_numpy(x), torch.from_numpy(y))
    monkeypatch.undo()
    jd, jdet = j_ft_gemm.ft_matmul_col(jnp.asarray(x), jnp.asarray(y))
    assert bool(det) and not bool(jdet)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-4,
                               atol=1e-2)


# The reference's property test (tests/test_checksum.py:79-97) fails under
# its own ft_matmul for high exponent flips: the flipped element turns
# non-finite or overflows the e2-weighted checksum, the residuals hold
# inf/NaN, and detection or location fails. The port behaves the same way;
# the test below names that outcome and asserts it, so a change either way
# shows.
def _flip_outcome(d_clean, fixed, exp, corrupted, before):
    obs = checksum.observed_checksums(corrupted)
    res = torch.cat([obs.col1 - exp.col1, obs.col2 - exp.col2,
                     obs.row1 - exp.row1, obs.row2 - exp.row2])
    after = float((fixed - d_clean).abs().max())
    if after <= max(1e-2, before * 1e-4):
        return "corrected"
    if not bool(torch.isfinite(res).all()):
        return "non-finite residuals"
    return "missed"


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(20, 30))
def test_property_bitflip_corrected_or_nonfinite_residuals(seed, bit):
    x, y = torch.from_numpy(_normal((32, 64), 11)), \
        torch.from_numpy(_normal((64, 16), 12))
    clean = x @ y
    cfg = fault.FaultConfig(rate=1.0, bit_low=bit, bit_high=bit)
    corrupted = fault.inject(torch.Generator().manual_seed(seed), clean, cfg)
    before = float((corrupted - clean).abs().max())
    d, _ = ft_gemm.ft_matmul(x, y, inject_gen=torch.Generator()
                             .manual_seed(seed), fault=cfg)
    exp = checksum.expected_checksums(x, y)
    outcome = _flip_outcome(clean, d, exp, corrupted, before)
    assert outcome in ("corrected", "non-finite residuals"), outcome
    if outcome == "non-finite residuals":
        assert bit >= 29     # only the top exponent bits overflow


def _same_flip_outcomes(idx, bit):
    """One deterministic flip (flip_bit at the same flat index and bit) in
    each package's product, then ft_matmul's verify + correct: the outcome
    in the port and in the reference."""
    x, y = _normal((32, 64), 11), _normal((64, 16), 12)
    outcomes = []
    for pkg in ("torch", "jax"):
        if pkg == "torch":
            xt, yt = torch.from_numpy(x), torch.from_numpy(y)
            clean = xt @ yt
            exp = checksum.expected_checksums(xt, yt)
            bad = fault.flip_bit(clean, idx, bit)
            thr = checksum.default_threshold(64) * max(
                float(bad.abs().max()), 1.0)
            fixed = checksum.correct(bad.clone(),
                                     checksum.verify(bad, exp, thr))
        else:
            xj, yj = jnp.asarray(x), jnp.asarray(y)
            cj = jnp.matmul(xj, yj)
            badj = j_fault.flip_bit(cj, idx, bit)
            thr = j_checksum.default_threshold(64) * max(
                float(jnp.max(jnp.abs(badj))), 1.0)
            vj = j_checksum.verify(badj, j_checksum.expected_checksums(
                xj, yj), thr)
            clean = torch.from_numpy(np.array(cj))
            bad = torch.from_numpy(np.array(badj))
            fixed = torch.from_numpy(np.array(j_checksum.correct(badj, vj)))
            exp = checksum.expected_checksums(torch.from_numpy(x),
                                              torch.from_numpy(y))
        before = float((bad - clean).abs().max())
        outcomes.append(_flip_outcome(clean, fixed, exp, bad, before))
    return outcomes


@pytest.mark.parametrize("bit", list(range(20, 31)))
@pytest.mark.parametrize("idx", [0, 6, 77, 300, 511])
def test_same_flip_same_outcome_as_reference(idx, bit):
    port, reference = _same_flip_outcomes(idx, bit)
    assert port == reference == "corrected"


@pytest.mark.parametrize("idx", [7, 8, 13])
def test_top_exponent_flip_leaves_nonfinite_residuals_in_both(idx):
    """|D[idx]| in [1, 2): flipping bit 30 makes it inf/NaN, the residuals
    turn non-finite and the element is not corrected, in the port as in the
    reference (whose tests/test_checksum.py property test fails on it)."""
    port, reference = _same_flip_outcomes(idx, 30)
    assert port == reference == "non-finite residuals"


@pytest.mark.parametrize("mode", ["col", "full"])
def test_abft_dot_gradients_match_matmul(mode):
    x0, y0 = _normal((24, 40), 15), _normal((40, 12), 16)
    g = torch.from_numpy(_normal((24, 12), 17))
    xa = torch.from_numpy(x0).requires_grad_()
    ya = torch.from_numpy(y0).requires_grad_()
    (abft_dot(xa, ya, mode=mode) * g).sum().backward()
    xb = torch.from_numpy(x0).requires_grad_()
    yb = torch.from_numpy(y0).requires_grad_()
    (torch.matmul(xb, yb) * g).sum().backward()
    torch.testing.assert_close(xa.grad, xb.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ya.grad, yb.grad, rtol=1e-5, atol=1e-5)
    assert torch.equal(abft_dot(xb, yb, enabled=False), xb @ yb)
    with pytest.raises(ValueError):
        abft_dot(xb, yb, mode="rows")


# --- kernels.matmul_abft / ops.abft_matmul ------------------------------------

# the reference's test shapes (tests/test_kernels.py:105-127) and tiles
# (256, 256, 512) as the reference clamps them
@pytest.mark.parametrize("m,k,n,seed", [(256, 512, 256, 8), (512, 512, 512, 8),
                                        (100, 300, 50, 12)])
@pytest.mark.parametrize("tiles", ["reference", "port"])
def test_abft_matmul_clean_matches_reference(m, k, n, seed, tiles):
    x, y = _normal((m, k), seed), _normal((k, n), seed + 1)
    jd, jdet = jops.abft_matmul(jnp.asarray(x), jnp.asarray(y),
                                interpret=True)
    kw = dict(block_m=256, block_n=256, block_k=512) if tiles == "reference" \
        else {}
    d, det = ops.abft_matmul(torch.from_numpy(x), torch.from_numpy(y), **kw)
    assert int(det) == int(jdet) == 0
    assert d.shape == (m, n)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=2e-4,
                               atol=2e-3)
    np.testing.assert_allclose(d.numpy(), x @ y, rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("desc", [(0, 0, 0, 7, 31), (1, 0, 0, 100, 5),
                                  (0, 1, 0, 255, 255)])
def test_abft_matmul_injected_matches_reference(desc):
    """The same descriptor means the same fault at the reference's tiles:
    one detection in both packages, the product corrected to the reference
    test's tolerance."""
    x, y = _normal((512, 512), 10), _normal((512, 512), 11)
    jinj = j_mma.make_injection(*desc, 5e4)
    jd, jdet = jops.abft_matmul(jnp.asarray(x), jnp.asarray(y), inj=jinj,
                                interpret=True)
    d, det = ops.abft_matmul(torch.from_numpy(x), torch.from_numpy(y),
                             inj=mma.make_injection(*desc, 5e4),
                             block_m=256, block_n=256, block_k=512)
    assert int(det) == int(jdet) == 1
    np.testing.assert_allclose(d.numpy(), x @ y, rtol=2e-4, atol=2e-2)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=2e-4,
                               atol=2e-2)


@pytest.mark.parametrize("desc", [(0, 0, 1, 7, 31), (3, 1, 3, 127, 0)])
def test_abft_matmul_port_tiles_fault_at_later_k_step(desc):
    """At the port's tiles (128, 128, 128) a K of 512 has four k-steps; a
    fault after a later one is found and corrected by the plain version's
    rules."""
    x, y = _normal((512, 512), 20), _normal((512, 256), 21)
    d, det = ops.abft_matmul(torch.from_numpy(x), torch.from_numpy(y),
                             inj=mma.make_injection(*desc, 5e4))
    assert ops.abft_tiles(512, 256, 512) == (128, 128, 128)
    assert int(det) == 1
    np.testing.assert_allclose(d.numpy(), x @ y, rtol=2e-4, atol=2e-2)


def test_abft_tiles_keep_reference_clamp():
    for m, n, k in [(100, 50, 300), (16, 8, 40), (1000, 700, 2048),
                    (256, 256, 512)]:
        p = jops.clamp_params(m, n, k, jops.KernelParams(256, 256, 512))
        assert ops.abft_tiles(m, n, k, 256, 256, 512) == \
            (p.block_m, p.block_k, p.block_f)
    with pytest.raises(ValueError, match="not a tile"):
        mma.check_cuda_tiles(256, 192, 512)
    mma.check_cuda_tiles(*ops.abft_tiles(100, 50, 300, 256, 256, 512))


def test_new_wrappers_count_no_launch_on_cpu():
    before = (mma.matmul_abft.launches, cud.centroid_update_dmr.launches)
    x = torch.from_numpy(_normal((64, 32), 1))
    ops.abft_matmul(x, x.T.contiguous())
    cud.centroid_update_dmr(x, torch.zeros(64, dtype=torch.int32), 3)
    assert (mma.matmul_abft.launches,
            cud.centroid_update_dmr.launches) == before


# --- the oracle (ref.distance_argmin_ft) --------------------------------------

@pytest.mark.parametrize("delta", [1e-4, 3e-4, 2.0 ** 20])
def test_ft_oracle_near_threshold_matches_reference(delta):
    """The reference's oracle scales its threshold by max |X C^T| after the
    fault; the port's does the same, so a fault between that threshold and
    the expected-checksum one (1e-4 here: the expected-checksum scale would
    miss it) is detected in both."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(40, 9)).astype(np.float32)
    c = rng.normal(size=(5, 9)).astype(np.float32)
    pos = (17, 3)
    md, am, det = ref.distance_argmin_ft(torch.from_numpy(x),
                                         torch.from_numpy(c), delta, pos)
    jmd, jam, jdet = j_ref.distance_argmin_ft(jnp.asarray(x), jnp.asarray(c),
                                              jnp.float32(delta), pos)
    assert int(det) == int(jdet) == 1
    np.testing.assert_array_equal(am.numpy(), np.asarray(jam))
    np.testing.assert_allclose(md.numpy(), np.asarray(jmd), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(ref.matmul(torch.from_numpy(x),
                                          torch.from_numpy(c).T).numpy(),
                               np.asarray(j_ref.matmul(jnp.asarray(x),
                                                       jnp.asarray(c).T)),
                               rtol=1e-5, atol=1e-5)


# --- abft_offline, detect() fits, policy, state -------------------------------

@pytest.fixture(scope="module")
def blobs():
    x, _ = make_blobs(3000, 16, 6, seed=1)
    return x, x[np.random.default_rng(5).choice(3000, 6, replace=False)]


def test_abft_offline_backend_matches_reference(blobs):
    x, c = blobs
    am, md, det = assign_abft_offline(torch.from_numpy(x), torch.from_numpy(c))
    jam, jmd, jdet = j_assignment.assign_abft_offline(jnp.asarray(x),
                                                      jnp.asarray(c))
    np.testing.assert_array_equal(am.numpy(), np.asarray(jam))
    # a clean product of 3000 rows already flags in both packages (the
    # column checksums sum 3000 rows against a max|D| scale): each then
    # "corrects" one element by rounding noise, each its own, so one row's
    # distance may differ by that noise
    assert int(det) == int(jdet)
    off = ~np.isclose(md.numpy(), np.asarray(jmd), rtol=1e-5, atol=1e-3)
    assert off.sum() <= 2 * int(det)
    assert det.dtype == torch.int32 and det.shape == ()
    plan = ops.plan_data(torch.from_numpy(x), ops.DEFAULT_PARAMS)
    am2, md2, _ = assign_abft_offline(plan, torch.from_numpy(c))
    assert torch.equal(am2, am) and torch.equal(md2, md)


@pytest.mark.parametrize("max_iter", [1, 4, 30])
def test_detect_fit_matches_reference(blobs, max_iter):
    x, c = blobs
    km = KMeans(6, fault=FaultPolicy.detect(), max_iter=max_iter,
                device="cpu").fit(x, centroids=c)
    jk = JKMeans(6, fault=JFaultPolicy.detect(), max_iter=max_iter).fit(
        jnp.asarray(x), centroids=jnp.asarray(c))
    assert km._backend.name == jk._backend.name == "abft_offline"
    assert km._use_dmr and jk._use_dmr
    np.testing.assert_array_equal(km.labels_.numpy(), np.asarray(jk.labels_))
    assert km.n_iter_ == jk.n_iter_
    assert abs(km.inertia_ - jk.inertia_) <= 1e-5 * abs(jk.inertia_)
    np.testing.assert_allclose(km.cluster_centers_.numpy(),
                               np.asarray(jk.cluster_centers_), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(km.predict(x).numpy(),
                                  np.asarray(jk.predict(jnp.asarray(x))))
    assert abs(km.score(x) - jk.score(jnp.asarray(x))) \
        <= 1e-5 * abs(jk.score(jnp.asarray(x)))
    assert km.detected_errors_ >= 0 and jk.detected_errors_ >= 0


def test_detect_campaign_resolves_to_lloyd_ft_and_recovers(blobs):
    x, c = blobs
    camp = FaultPolicy.detect(injection=InjectionCampaign(rate=1.0))
    noisy = KMeans(6, fault=camp, max_iter=10, device="cpu").fit(
        x, centroids=c)
    clean = KMeans(6, fault=FaultPolicy.correct(), max_iter=10,
                   device="cpu").fit(x, centroids=c)
    assert noisy._backend.name == "lloyd_ft"
    assert noisy.detected_errors_ > 0
    assert torch.equal(noisy.cluster_centers_, clean.cluster_centers_)


def test_policy_resolution_and_capabilities_match_reference():
    """tests/test_api.py:120-170, on the port."""
    assert FaultPolicy.detect().resolve_backend().name == "abft_offline"
    assert JFaultPolicy.detect().resolve_backend(on_tpu=False).name \
        == "abft_offline"
    camp = FaultPolicy.detect(injection=InjectionCampaign(rate=1.0))
    assert camp.resolve_backend().name == "lloyd_ft"
    b = get_backend("abft_offline")
    assert b.supports_ft and not b.takes_injection and not b.takes_params
    assert not b.fuses_update and b.kernel_kind == "assign"
    errors = []
    for make in (lambda: JKMeans(4, fault=JFaultPolicy.correct(
                     injection=JInjectionCampaign(rate=1.0)),
                     backend="abft_offline"),
                 lambda: KMeans(4, fault=FaultPolicy.correct(
                     injection=InjectionCampaign(rate=1.0)),
                     backend="abft_offline", device="cpu")):
        with pytest.raises(Exception) as info:
            make()
        errors.append(str(info.value).replace("—", "--"))
    assert errors[0] == errors[1]
    with pytest.raises(BackendCapabilityError):
        KMeans(4, fault=FaultPolicy.detect(), backend="gemm_fused",
               device="cpu")
    with pytest.raises(ValueError, match="or 'detect'"):
        FaultPolicy(mode="off", injection=InjectionCampaign())
    km_two = KMeans(4, fault=FaultPolicy.detect(), backend="abft_offline",
                    device="cpu")
    assert km_two._use_dmr
    assert not KMeans(4, fault=FaultPolicy.detect(update_dmr=False),
                      device="cpu")._use_dmr


@pytest.mark.parametrize("direction", ["to_port", "to_reference"])
def test_detect_state_interchange(blobs, direction):
    x, c = blobs
    if direction == "to_port":
        src = JKMeans(6, fault=JFaultPolicy.detect(), max_iter=5).fit(
            jnp.asarray(x), centroids=jnp.asarray(c))
        state = convert.from_reference_state(src.get_state())
        dst = KMeans.from_state(state, device="cpu")
        got = dst.predict(x).numpy()
        want = np.asarray(src.predict(jnp.asarray(x)))
    else:
        src = KMeans(6, fault=FaultPolicy.detect(), max_iter=5,
                     device="cpu").fit(x, centroids=c)
        state = convert.to_reference_state(src.get_state())
        dst = JKMeans.from_state(state)
        got = np.asarray(dst.predict(jnp.asarray(x)))
        want = src.predict(x).numpy()
    assert state["config"]["fault"]["mode"] == "detect"
    assert dst.fault.mode == "detect"
    assert dst._backend.name == "abft_offline"
    np.testing.assert_array_equal(got, want)
    assert dst.detected_errors_ == src.detected_errors_


@pytest.mark.parametrize("m,flags", [(4096, False), (65_536, True)])
def test_clean_product_flags_at_scale_in_both_packages(m, flags):
    """ft_matmul's threshold scales with max|D| while its column checksums
    sum all M rows, so a clean product of the detect path (blobs at the
    chip run's widths, F = 128, K = 1000) flags once M is large: in the
    reference as in the port. A reference behaviour, not a port fault."""
    x, _ = make_blobs(m, 128, 1000, seed=0)
    c = x[np.random.default_rng(0).choice(m, 1000, replace=False)]
    _, det = ft_gemm.ft_matmul(torch.from_numpy(x), torch.from_numpy(c).T)
    _, jdet = j_ft_gemm.ft_matmul(jnp.asarray(x), jnp.asarray(c).T)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    d = xt @ ct.T
    res = checksum.observed_checksums(d).col1 - \
        checksum.expected_checksums(xt, ct.T).col1
    ratio = float(res.abs().max()) / (checksum.default_threshold(128)
                                      * float(d.abs().max()))
    assert bool(det) == bool(jdet) == flags, ratio
