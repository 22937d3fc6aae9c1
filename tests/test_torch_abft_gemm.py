"""The 2-byte ABFT GEMM of the port against the reference, on the CPU.

* ``matmul_abft.abft_encodings_plain``, the plain version of the CUDA
  kernel's encodings pre-pass (E_X per m-tile, E_Y per n-tile), against the
  reference kernel's definitions (``src/repro/kernels/matmul_abft.py``
  ``_kernel``: ``e1x = sum(x, 0)``, ``e2x = sum(w_m x, 0)``, ``ye1 =
  sum(y, 1)``, ``ye2 = sum(y w_n, 1)``, ``w = iota + 1`` within the tile)
  computed in numpy from the same seeded values, at f32, bf16 and fp16:
  tiles under 64 rows, a last tile padded with zero rows and a Kp that is
  not a multiple of the kernel's 64-deep stages.
* ``ops.abft_matmul`` (or, for a k-step of 32, which ``ops.abft_tiles``
  rounds up to the reference's 128, the raw entry ``matmul_abft`` on the
  padded inputs) against the reference's Pallas kernel
  ``repro.kernels.matmul_abft.matmul_abft`` in interpret mode, at bf16 and
  fp16, at the tiles the CUDA kernel treats apart (8 and 40 rows: one
  warpgroup a tile, rows past the tile masked; 64; 128; 256 x 256 with a
  512-deep k-step: several sub-tiles a tile), clean and with a fault after
  the first and after the last k-step at a tile's last row and column; a
  hypothesis property draws the rest.

Tolerances: the same f32 sums in other orders, so D within rtol 1e-5 of
max |D| (``RTOL``); the port's corrected element within 2^-16 |delta| of the
clean product (``FIX_RTOL``: it subtracts an f32 residual), the reference's
within its tile's threshold (its expected checksums are sums in the input
dtype, so its residual carries 2-byte rounding); the
encodings within 1e-6 of the largest |encoding| (f32 sums of at most 1024
exactly widened 2-byte values against float64).
"""
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
except ImportError:       # deterministic fallback (see _hypothesis_stub)
    from _hypothesis_stub import given, settings, st

from repro.kernels import matmul_abft as j_mma  # noqa: E402
from repro_torch.kernels import matmul_abft as mma  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

DTYPES = ["bfloat16", "float16"]
NP_DTYPES = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16,
             "float16": np.float16}
RTOL = 1e-5
FIX_RTOL = 2.0 ** -16
ENC_RTOL = 1e-6
# (bm, bn, bk): one warpgroup a tile (8, 40 rows; 24, an odd number of
# 8-row D bands in its second warp), one (64), two (128), several sub-tiles
# a tile (256 x 256)
TILES = [(8, 128, 32), (24, 128, 32), (40, 128, 32), (64, 128, 128),
         (128, 128, 128), (256, 256, 512)]
# (m, k, n) of each tile's case: two or more m-tiles and n-tiles, ragged
SHAPES = {(8, 128, 32): (44, 96, 200), (24, 128, 32): (100, 64, 300),
          (40, 128, 32): (100, 160, 250),
          (64, 128, 128): (150, 200, 300), (128, 128, 128): (200, 256, 256),
          (256, 256, 512): (400, 700, 500)}


def _lo(a: np.ndarray, dtype: str) -> np.ndarray:
    """``a`` rounded to ``dtype``, as f32 values."""
    return np.asarray(a, np.float32).astype(NP_DTYPES[dtype]).astype(
        np.float32)


def _t(a: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch,
                                                                   dtype))


def _pad(a: np.ndarray, rows: int, cols: int) -> np.ndarray:
    return np.pad(a, ((0, rows - a.shape[0]), (0, cols - a.shape[1])))


def _up(v: int, b: int) -> int:
    return -(-v // b) * b


# --- the encodings -----------------------------------------------------------

def _reference_encodings(x: np.ndarray, y: np.ndarray, bm: int, bn: int):
    """The reference kernel's e1x / e2x per m-tile and ye1 / ye2 per n-tile
    over the whole k range, in float64: (nmt, Kp, 2) and (nnt, Kp, 2)."""
    x, y = x.astype(np.float64), y.astype(np.float64)
    mp, kp = x.shape
    np_ = y.shape[1]
    w_m = np.arange(bm, dtype=np.float64)[:, None] + 1.0     # iota + 1
    w_n = np.arange(bn, dtype=np.float64)[None, :] + 1.0
    ex = np.zeros((mp // bm, kp, 2))
    ey = np.zeros((np_ // bn, kp, 2))
    for mt in range(mp // bm):
        xt = x[mt * bm:(mt + 1) * bm]
        ex[mt, :, 0] = np.sum(xt, axis=0)
        ex[mt, :, 1] = np.sum(w_m * xt, axis=0)
    for nt in range(np_ // bn):
        yt = y[:, nt * bn:(nt + 1) * bn]
        ey[nt, :, 0] = np.sum(yt, axis=1)
        ey[nt, :, 1] = np.sum(yt * w_n, axis=1)
    return ex, ey


@pytest.mark.parametrize("dtype", ["float32"] + DTYPES)
@pytest.mark.parametrize("bm,bn,m,k,n", [
    (8, 128, 44, 96, 200),       # tiles under 64 rows, Kp 96 (stage 128)
    (40, 128, 100, 160, 250),
    (64, 256, 150, 200, 300),    # a last tile mostly zero rows
    (128, 128, 200, 256, 256),
    (256, 384, 300, 64, 400)])
def test_encodings_plain_match_reference_definitions(bm, bn, m, k, n, dtype):
    rng = np.random.default_rng(5)
    x = _lo(rng.normal(size=(m, k)), dtype)
    y = _lo(rng.normal(size=(k, n)), dtype)
    kp = _up(k, 32)
    xp, yp = _pad(x, _up(m, bm), kp), _pad(y, kp, _up(n, bn))
    ex, ey, esy = mma.abft_encodings_plain(_t(xp, dtype), _t(yp, dtype), bm,
                                           bn)
    kpe = _up(kp, mma.ENC_K_ALIGN)
    assert ex.shape == (xp.shape[0] // bm, kpe, 2)
    assert ey.shape == (yp.shape[1] // bn, kpe, 2)
    assert ex.dtype == ey.dtype == torch.float32
    want_x, want_y = _reference_encodings(xp, yp, bm, bn)
    for got, want in ((ex, want_x), (ey, want_y)):
        got = got.numpy().astype(np.float64)
        assert np.all(got[:, kp:] == 0.0)            # zeros past Kp
        np.testing.assert_allclose(got[:, :kp], want, rtol=0,
                                   atol=ENC_RTOL * np.abs(want).max())
    # the split E_Y: three parts a sum, scaled down by a power of two, that
    # add back to E_Y; two zero rows
    assert esy.shape == (yp.shape[1] // bn, 8, kpe)
    assert esy.dtype == getattr(torch, dtype)
    s1, s2 = mma.encoding_scales(bn)
    parts = esy.double().numpy()
    assert np.all(parts[:, 6:] == 0.0)
    e = ey.double().numpy()
    for rows, scale, col in ((slice(0, 3), s1, 0), (slice(3, 6), s2, 1)):
        back = parts[:, rows].sum(1) * 2.0 ** scale
        np.testing.assert_allclose(back, e[..., col], rtol=0,
                                   atol=ENC_RTOL * np.abs(e[..., col]).max())
        # a scaled part never exceeds max |y|: fp16 holds it
        assert np.abs(parts[:, rows]).max() <= np.abs(yp).max()


def test_encodings_wrapper_on_cpu_is_the_plain_version():
    """On CPU tensors ``abft_encodings`` is its plain version and counts no
    launch."""
    rng = np.random.default_rng(6)
    x = _t(rng.normal(size=(80, 96)), "bfloat16")
    y = _t(rng.normal(size=(96, 256)), "bfloat16")
    before = mma.abft_encodings.launches
    got = mma.abft_encodings(x, y, block_m=40, block_n=128)
    want = mma.abft_encodings_plain(x, y, 40, 128)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert mma.abft_encodings.launches == before


# --- the GEMM ---------------------------------------------------------------

def _tile_threshold(x, y, tiles, tile_ix, dtype) -> float:
    """The kernel's threshold of one output tile: factor(Kp, dtype) x
    max(max |col1|, max |row1|, 1) from its inputs' expected checksums."""
    bm, bn, _ = tiles
    i, j = tile_ix
    xt = x[i * bm:(i + 1) * bm].astype(np.float64)
    yt = y[:, j * bn:(j + 1) * bn].astype(np.float64)
    scale = max(np.abs(xt.sum(0) @ yt).max(), np.abs(xt @ yt.sum(1)).max(),
                1.0)
    return ops.threshold_factor(x.shape[1], getattr(torch, dtype)) * scale


def _both(x, y, tiles, dtype, desc=None, delta=0.0):
    """(D, det) of the port and of the reference kernel in interpret mode on
    padded x (Mp, Kp), y (Kp, Np), the fault ``desc`` (m-tile, n-tile,
    k-step, row, col) of ``delta`` planted in both. The port goes through
    ``ops.abft_matmul`` where its tiles keep these, else the raw entry."""
    bm, bn, bk = tiles
    inj = None if desc is None else mma.make_injection(*desc, delta)
    jinj = (j_mma.no_injection() if desc is None
            else j_mma.make_injection(*desc, delta))
    jd, jdet = j_mma.matmul_abft(
        jnp.asarray(x).astype(dtype), jnp.asarray(y).astype(dtype), jinj,
        block_m=bm, block_n=bn, block_k=bk, interpret=True)
    tx, ty = _t(x, dtype), _t(y, dtype)
    if ops.abft_tiles(*x.shape[:1], y.shape[1], x.shape[1], *tiles) == tiles:
        d, det = ops.abft_matmul(tx, ty, inj=inj, block_m=bm, block_n=bn,
                                 block_k=bk)
    else:
        factor = ops.threshold_factor(x.shape[1], getattr(torch, dtype))
        d, det = mma.matmul_abft(
            tx, ty, mma.no_injection() if inj is None else inj, block_m=bm,
            block_n=bn, block_k=bk, factor=factor)
        det = det.sum()
    assert d.dtype == torch.float32
    return d.numpy().copy(), int(det), np.array(jd, np.float32), int(
        np.sum(np.asarray(jdet)))


def _check(x, y, tiles, dtype, desc=None, over=8.0):
    """Clean (desc None), or a fault ``over`` x its tile's threshold (rounded
    up to a power of two): both packages detect it and correct the element
    to FIX_RTOL |delta|, and agree elsewhere within RTOL."""
    bm, bn, _ = tiles
    delta = thr = 0.0
    if desc is not None:
        thr = _tile_threshold(x, y, tiles, desc[:2], dtype)
        delta = 2.0 ** np.ceil(np.log2(over * thr))
    d, det, jd, jdet = _both(x, y, tiles, dtype, desc, delta)
    clean = x.astype(np.float64) @ y.astype(np.float64)
    want = 0 if desc is None else 1
    assert det == jdet == want
    if desc is not None:
        # the port's correction holds to f32 rounding at the fault's size;
        # the reference's to its tile's threshold: its expected checksums
        # are sums in the input dtype (jnp.sum of 2-byte x and y), so its
        # residual, and the element it corrects, carry 2-byte rounding
        i, j = desc[0] * bm + desc[3], desc[1] * bn + desc[4]
        assert abs(float(d[i, j]) - clean[i, j]) <= FIX_RTOL * delta
        assert abs(float(jd[i, j]) - clean[i, j]) <= thr
        d[i, j] = jd[i, j] = clean[i, j]
    scale = max(np.abs(clean).max(), 1.0)
    np.testing.assert_allclose(d, jd, rtol=0, atol=RTOL * scale)
    np.testing.assert_allclose(d, clean, rtol=0, atol=RTOL * scale)


def _padded_inputs(tiles, dtype, seed=11):
    bm, bn, bk = tiles
    m, k, n = SHAPES[tiles]
    rng = np.random.default_rng(seed)
    x = _lo(rng.normal(size=(m, k)), dtype)
    y = _lo(rng.normal(size=(k, n)), dtype)
    return _pad(x, _up(m, bm), _up(k, bk)), _pad(y, _up(k, bk), _up(n, bn))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tiles", TILES)
@pytest.mark.parametrize("case", ["clean", "first_k_step", "last_k_step"])
def test_abft_gemm_matches_reference_kernel(case, tiles, dtype):
    """Clean: no detection. Faulted: one tile's last row and last column,
    planted after the first or the last k-step of the last tile (the one
    with padded rows and columns), found and corrected by both."""
    x, y = _padded_inputs(tiles, dtype)
    bm, bn, bk = tiles
    nmt, nnt, nk = x.shape[0] // bm, y.shape[1] // bn, x.shape[1] // bk
    desc = {"clean": None,
            "first_k_step": (nmt - 1, nnt - 1, 0, bm - 1, bn - 1),
            "last_k_step": (nmt - 1, nnt - 1, nk - 1, bm - 1, bn - 1)}[case]
    _check(x, y, tiles, dtype, desc)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tiles", [(8, 128, 32), (256, 256, 512)])
def test_abft_gemm_fault_under_threshold_goes_through(tiles, dtype):
    """A fault of a 64th of its tile's threshold: neither package detects
    it, and D is off by it there."""
    x, y = _padded_inputs(tiles, dtype, seed=12)
    bm, bn, _ = tiles
    desc = (0, 1, 0, bm // 2, 5)
    delta = _tile_threshold(x, y, tiles, desc[:2], dtype) / 64.0
    d, det, jd, jdet = _both(x, y, tiles, dtype, desc, delta)
    assert det == jdet == 0
    clean = x.astype(np.float64) @ y.astype(np.float64)
    i, j = desc[3], bn + desc[4]
    scale = max(np.abs(clean).max(), 1.0)
    assert abs(float(d[i, j]) - clean[i, j] - delta) <= RTOL * scale
    np.testing.assert_allclose(d, jd, rtol=0, atol=RTOL * scale)


@settings(max_examples=8, deadline=None)
@given(st.sampled_from(DTYPES), st.sampled_from([8, 24, 64, 72, 128, 256]),
       st.sampled_from([128, 256]), st.sampled_from([32, 64, 128]),
       st.integers(1, 3), st.integers(1, 2), st.integers(1, 3),
       st.integers(0, 2 ** 31 - 1), st.booleans())
def test_abft_gemm_matches_reference_kernel_property(
        dtype, bm, bn, bk, mt, nt, kt, seed, faulted):
    """Random tiles of the CUDA kernel's set, shapes of 1-3 tiles a side,
    clean or with a fault at a random place and k-step."""
    rng = np.random.default_rng(seed)
    x = _lo(rng.normal(size=(mt * bm, kt * bk)), dtype)
    y = _lo(rng.normal(size=(kt * bk, nt * bn)), dtype)
    desc = None
    if faulted:
        desc = (int(rng.integers(mt)), int(rng.integers(nt)),
                int(rng.integers(kt)), int(rng.integers(bm)),
                int(rng.integers(bn)))
    _check(x, y, (bm, bn, bk), dtype, desc)
