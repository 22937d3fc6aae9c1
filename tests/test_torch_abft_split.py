"""The f32 ABFT GEMM's operand split against the reference, on the CPU.

The f32 ``matmul_abft`` of the port runs on the bf16 tensor cores: each
f32 value is split into three bf16 parts (``matmul_abft.split3_plain``),
the pre-pass writes Y's three planes (``y_planes_plain``), the kernel
splits X's fragments in registers and D accumulates the six products with
i + j <= 2 (``matmul_split_plain`` emulates them). Here:

* the split is exact: hi + mid + lo == x for every finite f32 of magnitude
  2^-110 or more (a hypothesis property over f32 bit patterns, and f32's
  largest value, 2^-126, values whose mid is zero, negatives, +-0); below
  2^-110 the parts fall under bf16's subnormal spacing and the sum is off
  by at most 2^-134; +-inf splits as (+-max, +-inf, NaN) and NaN as (-max,
  NaN, NaN), so a non-finite input makes its products NaN;
* the six-product arithmetic: ``matmul_split_plain`` (the kernel's order
  of adds) within 2^-22 (|X||Y|) of a float64 product on normal and on
  positive data at fixed draws, and within the rounding bound
  ``_six_product_bound(k)``, which grows with k, on every draw of a
  hypothesis property (the three dropped
  products alone are at most 2^-23 |X||Y|, also for values spread over
  2^+-40, where f32's own accumulation can exceed 2^-22), and its ABFT
  decode (the kernel's rules,
  ``abft_correct_plain``) against the reference kernel
  ``repro.kernels.matmul_abft.matmul_abft`` in interpret mode with the
  same descriptor: the same detections and the same located element,
  clean and with a fault after a later k-step, at tiles (128, 128, 128),
  (8, 128, 32) and chip_smoke's (256, 256, 512) case cut small;
* the pre-pass: Y's planes add back to Y, their tile sums give the f32
  encodings E_Y, and ``abft_operands_plain`` at f32 is (E_X, E_Y, planes,
  the expected column and row checksums) with the reference's encodings
  and checksums;
* the kernel's A-fragment and column-checksum reads of the 128-byte
  swizzled stage (a model of TMA's layout) pick the values they name.

Tolerances: D against the float64 product within RTOL = 1e-5 of max |D|
(f32 sums in other orders); a corrected element within the tile's
threshold of the clean product (each package subtracts its own f32
residual); the encodings within 1e-6 of the largest |encoding| (f32 sums
against float64).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

try:
    from hypothesis import example, given, settings, strategies as st
except ImportError:       # deterministic fallback (see _hypothesis_stub)
    from _hypothesis_stub import given, settings, st

    def example(**_kw):
        return lambda fn: fn

from repro.kernels import matmul_abft as j_mma  # noqa: E402
from repro_torch.kernels import matmul_abft as mma  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

RTOL = 1e-5
ENC_RTOL = 1e-6
F32_MAX = float(np.finfo(np.float32).max)
EXACT_FROM = 2.0 ** -110      # |x| from here on splits exactly
TINY_ERR = 2.0 ** -134        # the most a smaller x's split is off by


def _f32(values) -> torch.Tensor:
    return torch.tensor(np.asarray(values, np.float32))


def _sum64(parts) -> np.ndarray:
    return sum(p.double().numpy() for p in parts)


def _check_split(x: torch.Tensor) -> None:
    """Every finite value of x splits exactly from EXACT_FROM on (also the
    f32 sum hi + (mid + lo) is x bit for bit, zeros aside; (hi + mid)
    overflows past bf16's largest value), within TINY_ERR below; the parts
    shrink as the split says."""
    parts = mma.split3_plain(x)
    assert all(p.dtype == torch.bfloat16 for p in parts)
    hi, mid, lo = (p.double().numpy() for p in parts)
    xv = x.double().numpy()
    big = np.abs(xv) >= EXACT_FROM
    back = _sum64(parts)
    assert np.array_equal(back[big], xv[big])
    assert np.all(np.abs(back[~big] - xv[~big]) <= TINY_ERR)
    f32 = parts[0].float() + (parts[1].float() + parts[2].float())
    nz = big & (xv != 0)
    assert np.array_equal(f32.numpy().view(np.uint32)[nz],
                          x.numpy().view(np.uint32)[nz])
    # |mid| <= 2^-8 |x| and |lo| <= 2^-16 |x| (past bf16's largest value,
    # where hi saturates, mid is up to 2^-8 (1 + 2^-23) |x|)
    assert np.all(np.abs(mid[big]) <= 2.0 ** -8 * (1.0 + 2.0 ** -22)
                  * np.abs(xv[big]))
    assert np.all(np.abs(lo[big]) <= 2.0 ** -16 * np.abs(xv[big]))
    assert np.all(np.abs(hi) <= mma.BF16_MAX)


# --- the split ---------------------------------------------------------------

@settings(max_examples=200, deadline=None)
@given(st.integers(0, 2 ** 32 - 1))
def test_split_is_exact_over_f32_bits(bits):
    """Any f32 bit pattern: exact when finite (from 2^-110 on), its
    negation too; inf and NaN as stated."""
    x = np.array([bits], np.uint32).view(np.float32)
    if not np.isfinite(x[0]):
        _check_nonfinite(float(x[0]))
        return
    _check_split(torch.from_numpy(np.concatenate([x, -x])))


@settings(max_examples=50, deadline=None)
@given(st.integers(-126, 127), st.integers(0, 2 ** 23 - 1),
       st.integers(0, 1))
def test_split_is_exact_over_exponents(exp, mant, neg):
    """Each exponent of a normal f32, with a random significand."""
    x = (-1.0) ** neg * (1.0 + mant * 2.0 ** -23) * 2.0 ** exp
    _check_split(_f32([x]))


def test_split_edge_values():
    """f32's largest value (its hi saturates at bf16's), 2^-126, values
    whose mid is zero (a bf16 value) or whose lo is zero (16 significant
    bits), negatives, +-0 (hi keeps the sign, mid and lo are +0), values
    past bf16's largest (hi saturates) and tiny ones."""
    bf16_max = mma.BF16_MAX
    vals = [F32_MAX, -F32_MAX, 2.0 ** -126, -(2.0 ** -126), 1.0, -3.0,
            0.15625, 1.0 + 2.0 ** -7, 1.0 + 2.0 ** -8 + 2.0 ** -15,
            -(1.0 + 2.0 ** -9), 1.0 + 2.0 ** -23, bf16_max,
            np.nextafter(np.float32(bf16_max), np.float32(np.inf)),
            2.0 ** -110, 2.0 ** -149, -(2.0 ** -140), 0.0, -0.0]
    x = _f32(vals)
    _check_split(x)
    hi, mid, lo = mma.split3_plain(x)
    # f32's largest: hi = bf16's largest, the rest exact
    assert float(hi[0]) == bf16_max and float(hi[1]) == -bf16_max
    assert float(mid[0]) == 2.0 ** 120 and float(lo[0]) == -(2.0 ** 104)
    # a bf16 value has a zero mid and lo; 16 significant bits a zero lo
    for i in (2, 3, 4, 5, 6, 7, 11):
        assert float(mid[i]) == 0.0 and float(lo[i]) == 0.0
    assert float(mid[8]) != 0.0 and float(lo[8]) == 0.0
    # +-0: hi carries the sign, mid and lo are +0
    z = hi[-2:].float().numpy().view(np.uint32)
    assert z[0] == 0 and z[1] == 0x80000000
    assert float(mid[-1]) == 0.0 and float(lo[-1]) == 0.0


def _check_nonfinite(v: float) -> None:
    hi, mid, lo = (float(p[0]) for p in mma.split3_plain(_f32([v])))
    if math.isnan(v):
        assert hi == -mma.BF16_MAX and math.isnan(mid) and math.isnan(lo)
    else:
        sign = math.copysign(1.0, v)
        assert hi == sign * mma.BF16_MAX and mid == sign * math.inf
        assert math.isnan(lo)


@pytest.mark.parametrize("v", [math.inf, -math.inf, math.nan])
def test_split_nonfinite_values_give_nan_products(v):
    """inf splits as (max, inf, NaN), NaN as (-max, NaN, NaN): the row of X
    (and column of Y) that holds one is NaN in the emulated product, where
    the f32 product has +-inf or NaN."""
    _check_nonfinite(v)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 16)).astype(np.float32)
    y = rng.normal(size=(16, 5)).astype(np.float32)
    x[2, 7] = v
    y[3, 4] = v
    d = mma.matmul_split_plain(torch.from_numpy(x), torch.from_numpy(y))
    d = d.numpy()
    assert np.all(np.isnan(d[2])) and np.all(np.isnan(d[:, 4]))
    rest = np.ones_like(d, bool)
    rest[2] = False
    rest[:, 4] = False
    assert np.all(np.isfinite(d[rest]))
    with np.errstate(invalid="ignore"):
        assert not np.any(np.isfinite((x @ y)[2]))


# --- the six products ---------------------------------------------------------

def _six_product_error(x: np.ndarray, y: np.ndarray) -> float:
    """The emulated product's largest error over 2^-22 (|X||Y|)."""
    d = mma.matmul_split_plain(torch.from_numpy(x), torch.from_numpy(y))
    want = x.astype(np.float64) @ y.astype(np.float64)
    scale = np.abs(x).astype(np.float64) @ np.abs(y).astype(np.float64)
    return float(np.max(np.abs(d.double().numpy() - want)
                        / (2.0 ** -22 * np.maximum(scale, 1e-300))))


@pytest.mark.parametrize("m,k,n,kind", [
    (64, 128, 200, "normal"), (100, 1000, 128, "normal"),
    (8, 2048, 256, "normal"), (128, 96, 128, "blobs")])
def test_six_products_within_f32_rounding(m, k, n, kind):
    """Normal data, and positive, correlated data (the detect fit's X C^T:
    every partial sum grows)."""
    rng = np.random.default_rng(m + k + n)
    if kind == "normal":
        x, y = rng.normal(size=(m, k)), rng.normal(size=(k, n))
    else:
        x = 10.0 + rng.normal(size=(m, k))
        y = 10.0 + rng.normal(size=(k, n))
    assert _six_product_error(x.astype(np.float32),
                              y.astype(np.float32)) <= 1.0


@pytest.mark.parametrize("spread", [0, 8, 40])
def test_dropped_products_under_f32_rounding(spread):
    """The split's own error, without f32's accumulation: the six products
    summed exactly (float64) are within 2^-23 (|X||Y|) of the product, for
    values spread over 2^+-spread (where f32's own accumulation of such
    sums can exceed 2^-22 (|X||Y|), the plain f32 product's as much)."""
    rng = np.random.default_rng(spread)
    x = rng.normal(size=(40, 300)) * 2.0 ** rng.integers(-spread, spread + 1,
                                                         (40, 300))
    y = rng.normal(size=(300, 130)) * 2.0 ** rng.integers(-spread,
                                                          spread + 1,
                                                          (300, 130))
    x, y = x.astype(np.float32), y.astype(np.float32)
    xs = [p.double().numpy() for p in mma.split3_plain(torch.from_numpy(x))]
    ys = [p.double().numpy() for p in mma.split3_plain(torch.from_numpy(y))]
    six = sum(xs[i] @ ys[j] for i, j in ((0, 0), (0, 1), (1, 0), (0, 2),
                                         (1, 1), (2, 0)))
    want = x.astype(np.float64) @ y.astype(np.float64)
    scale = np.abs(x).astype(np.float64) @ np.abs(y).astype(np.float64)
    assert np.all(np.abs(six - want) <= 2.0 ** -23 * scale)


def _six_product_bound(k: int) -> float:
    """The rounding bound of ``matmul_split_plain`` in units of 2^-22
    (|X||Y|), for K = k.

    Every term of the six products is exact in f32 (a bf16 x bf16 product
    has 16 significant bits). A term then goes through at most
    min(k, 16) - 1 adds within its 16-deep product, 5 adds joining the six
    products into the k-step's partial, and ceil(k / 16) - 1 adds of the
    partials into D (the first partial lands on zero, exactly): depth
    n = min(k, 16) + ceil(k / 16) + 3. Recursive summation errs by at most
    gamma_n = n u / (1 - n u), u = 2^-24, times the sum of the terms'
    magnitudes, which is at most (1 + 2^-7 + 2^-15)^2 < 1.02 times (|X||Y|)
    (the parts of x sum in magnitude to at most that much over |x|: |hi| <=
    (1 + 2^-8)|x|, |mid| and |lo| under 2^-8 |x| and 2^-16 |x|). The three
    dropped products add at most 2^-23 (|X||Y|)
    (``test_dropped_products_under_f32_rounding``). So

        |D - X Y| <= (1.02 gamma_n + 2^-23) (|X||Y|).

    At k = 4 that is 2.54 x 2^-22: the claim that six products summed in
    f32 stay within 2^-22 (|X||Y|) for every k does not hold (the pinned
    example below errs by 1.0020 x 2^-22, where the plain f32 ``x @ y``
    errs by 0.51 x)."""
    n = min(k, mma.SPLIT_K_STEP) + -(-k // mma.SPLIT_K_STEP) + 3
    u = 2.0 ** -24
    return (1.02 * n * u / (1.0 - n * u) + 2.0 ** -23) / 2.0 ** -22


@settings(max_examples=12, deadline=None)
@given(st.integers(1, 96), st.integers(1, 600), st.integers(1, 96),
       st.integers(0, 2 ** 31 - 1))
@example(m=43, k=4, n=53, seed=1659251524)
def test_six_products_within_f32_rounding_property(m, k, n, seed):
    """Within ``_six_product_bound(k)`` on every draw; the pinned example
    is the draw that broke the former 2^-22 bar."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    y = rng.normal(size=(k, n)).astype(np.float32)
    assert _six_product_error(x, y) <= _six_product_bound(k)


def _tile_threshold(x, y, tiles, tile_ix) -> float:
    bm, bn, _ = tiles
    i, j = tile_ix
    xt = x[i * bm:(i + 1) * bm].astype(np.float64)
    yt = y[:, j * bn:(j + 1) * bn].astype(np.float64)
    scale = max(np.abs(xt.sum(0) @ yt).max(), np.abs(xt @ yt.sum(1)).max(),
                1.0)
    return ops.threshold_factor(x.shape[1], torch.float32) * scale


def _up(v: int, b: int) -> int:
    return -(-v // b) * b


# (bm, bn, bk) and an (m, k, n) of two or more tiles a side, ragged: the
# port's default tiles, one warpgroup a tile with a 32-deep k-step, and
# chip_smoke.ABFT_TILE_CASES' several-sub-tile tile at (1500, 1100, 700)
# cut small
DECODE_CASES = [((128, 128, 128), (200, 384, 300)),
                ((8, 128, 32), (44, 96, 200)),
                ((256, 256, 512), (300, 700, 300))]


@pytest.mark.parametrize("tiles,shape", DECODE_CASES)
@pytest.mark.parametrize("case", ["clean", "later_k_step"])
def test_split_decode_matches_reference_kernel(tiles, shape, case):
    """The split product through the kernel's decode rules against the
    reference kernel in interpret mode, the same descriptor planted in
    both: the same detections, the port's decode locates the planted
    element, and the reference corrects that one (its D is the clean
    product there and elsewhere)."""
    bm, bn, bk = tiles
    m, k, n = shape
    rng = np.random.default_rng(m * 7 + n)
    mp, kp, np_ = _up(m, bm), _up(k, bk), _up(n, bn)
    x = np.zeros((mp, kp), np.float32)
    y = np.zeros((kp, np_), np.float32)
    x[:m, :k] = rng.normal(size=(m, k))
    y[:k, :n] = rng.normal(size=(k, n))
    nmt, nnt, nk = mp // bm, np_ // bn, kp // bk
    factor = ops.threshold_factor(kp, torch.float32)
    desc, delta = None, 0.0
    if case == "later_k_step":
        desc = (nmt - 1, nnt // 2, nk - 1 if nk > 1 else 0,
                min(m - 1 - (nmt - 1) * bm, bm - 1), 31)
        thr = _tile_threshold(x, y, tiles, desc[:2])
        delta = 2.0 ** math.ceil(math.log2(8.0 * thr))
    inj = mma.no_injection() if desc is None else mma.make_injection(
        *desc, delta)
    jinj = j_mma.no_injection() if desc is None else j_mma.make_injection(
        *desc, delta)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    d_split = mma.matmul_split_plain(tx, ty)
    d_fix, det = mma.abft_correct_plain(d_split, tx, ty.T.contiguous(), inj,
                                        bm, bn, bk, factor)
    jd, jdet = j_mma.matmul_abft(jnp.asarray(x), jnp.asarray(y), jinj,
                                 block_m=bm, block_n=bn, block_k=bk,
                                 interpret=True)
    jd = np.array(jd, np.float64)
    clean = x.astype(np.float64) @ y.astype(np.float64)
    scale = max(np.abs(clean).max(), 1.0)
    assert int(det.sum()) == int(np.sum(np.asarray(jdet))) == (
        0 if desc is None else 1)
    got = d_fix.double().numpy()
    if desc is not None:
        i, j = desc[0] * bm + desc[3], desc[1] * bn + desc[4]
        faulty = d_split.clone()
        faulty[i, j] += delta
        changed = np.argwhere(got != faulty.double().numpy())
        assert changed.tolist() == [[i, j]]      # the element located
        thr = _tile_threshold(x, y, tiles, desc[:2])
        assert abs(got[i, j] - clean[i, j]) <= thr
        assert abs(jd[i, j] - clean[i, j]) <= thr
        got[i, j] = jd[i, j] = clean[i, j]
    np.testing.assert_allclose(got, clean, rtol=0, atol=RTOL * scale)
    np.testing.assert_allclose(jd, clean, rtol=0, atol=RTOL * scale)
    np.testing.assert_allclose(got, jd, rtol=0, atol=RTOL * scale)


# --- the pre-pass ------------------------------------------------------------

@pytest.mark.parametrize("bm,bn,m,k,n", [(8, 128, 44, 96, 200),
                                         (128, 128, 200, 256, 256),
                                         (256, 384, 300, 64, 400)])
def test_prepass_planes_and_encodings(bm, bn, m, k, n):
    """Y's planes (3, Kp, Np) bf16 add back to Y exactly; each n-tile's
    weighted sums of hi + mid + lo are the f32 encodings E_Y; E_X and E_Y
    are the reference kernel's definitions (``e1x = sum(x, 0)``, ``ye1 =
    sum(y, 1)``, weights iota + 1 in the tile) to ENC_RTOL, and the
    expected checksums its ``col1 = e1x @ y``, ``col2 = e2x @ y`` of every
    m-tile over all of Y's columns and ``row1 = x @ ye1``, ``row2 = x @
    ye2`` of every n-tile over all of X's rows."""
    rng = np.random.default_rng(bm + n)
    kp = _up(k, 32)
    x = np.zeros((_up(m, bm), kp), np.float32)
    y = np.zeros((kp, _up(n, bn)), np.float32)
    x[:m, :k] = rng.normal(size=(m, k)) * 3.0
    y[:k, :n] = rng.normal(size=(k, n)) * 3.0
    ex, ey, planes, ecol, erow = mma.abft_operands_plain(
        torch.from_numpy(x), torch.from_numpy(y), bm, bn)
    assert ecol.shape == (x.shape[0] // bm, y.shape[1], 2)
    assert erow.shape == (y.shape[1] // bn, x.shape[0], 2)
    assert planes.shape == (3, kp, y.shape[1])
    assert planes.dtype == torch.bfloat16 and planes.is_contiguous()
    assert torch.equal(planes, mma.y_planes_plain(torch.from_numpy(y)))
    back = _sum64(planes.unbind(0))
    assert np.array_equal(back, y.astype(np.float64))
    kpe = _up(kp, mma.ENC_K_ALIGN)
    assert ex.shape == (x.shape[0] // bm, kpe, 2)
    assert ey.shape == (y.shape[1] // bn, kpe, 2)
    w_m = np.arange(1, bm + 1, dtype=np.float64)[:, None]
    w_n = np.arange(1, bn + 1, dtype=np.float64)[None, :]
    for nt in range(y.shape[1] // bn):
        tile = back[:, nt * bn:(nt + 1) * bn]
        want = np.stack((tile.sum(1), (tile * w_n).sum(1)), -1)
        got = ey[nt, :kp].double().numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=ENC_RTOL * np.abs(want).max())
        assert np.all(ey[nt, kp:].numpy() == 0.0)
        rows = x.astype(np.float64) @ want                   # (Mp, 2)
        np.testing.assert_allclose(erow[nt].double().numpy(), rows, rtol=0,
                                   atol=ENC_RTOL * np.abs(rows).max())
    for mt in range(x.shape[0] // bm):
        tile = x[mt * bm:(mt + 1) * bm].astype(np.float64)
        want = np.stack((tile.sum(0), (w_m * tile).sum(0)), -1)
        np.testing.assert_allclose(ex[mt, :kp].double().numpy(), want,
                                   rtol=0,
                                   atol=ENC_RTOL * np.abs(want).max())
        cols = want.T @ y.astype(np.float64)                 # (2, Np)
        np.testing.assert_allclose(ecol[mt].double().numpy(), cols.T,
                                   rtol=0,
                                   atol=ENC_RTOL * np.abs(cols).max())


def test_prepass_at_2_bytes_is_unchanged():
    """At bf16 the pre-pass's plain outputs stay (E_X, E_Y, split E_Y)."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(80, 96)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(96, 256)).astype(np.float32))
    xb, yb = x.to(torch.bfloat16), y.to(torch.bfloat16)
    got = mma.abft_operands_plain(xb, yb, 40, 128)
    want = mma.abft_encodings_plain(xb, yb, 40, 128)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[2].shape == (2, 8, 128)
    on_cpu = mma.abft_encodings(x, y, block_m=40, block_n=128)
    assert torch.equal(on_cpu[2], mma.y_planes_plain(y))


# --- the kernel's reads of the swizzled stage ---------------------------------

def _sw128(row: int, byte: int) -> int:
    """TMA's 128-byte swizzle of a box of 128-byte rows at a 1024-aligned
    base: the 16-byte chunk index XOR the row mod 8."""
    return row * 128 + (((byte >> 4) ^ (row & 7)) << 4) + (byte & 15)


def test_fragment_reads_pick_the_named_values():
    """X f32 in a 64-row x 32-k box: the address the kernel reads for
    thread (warp wi, lane 4 g + t), k-block kk, half q and row half h is
    the one TMA put X[16 wi + g + 8 h, 16 kk + 2 t + 8 q] (and + 1 in the
    next 4 bytes) at: wgmma's A fragment order. Y's planes in 32-k x 64-
    column panels: the column checksums' read for thread ct (cc = ct & 15,
    cq = ct >> 4), row q is Y[4 cq + q, 8 cc .. 8 cc + 7] of panel cc >> 3."""
    for wi in range(4):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for kk in range(2):
                for q in range(2):
                    for h in range(2):
                        r = 16 * wi + g + 8 * h
                        chunk = (4 * kk + (t >> 1) + 2 * q) ^ (r & 7)
                        got = r * 128 + (chunk << 4) + 8 * (t & 1)
                        k = 16 * kk + 2 * t + 8 * q
                        assert got == _sw128(r, 4 * k)
                        assert got + 4 == _sw128(r, 4 * (k + 1))
    for ct in range(128):
        cc, cq = ct & 15, ct >> 4
        for q in range(4):
            kr = 4 * cq + q
            got = kr * 128 + (((cc & 7) ^ (kr & 7)) << 4)
            assert got == _sw128(kr, 2 * (8 * cc % 64))
