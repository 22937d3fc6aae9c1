"""The f32 tile kernel's design, checked on the CPU.

``lloyd_tile_kernel`` (``csrc/fk_kernels.cu``) runs only on the card, so
these tests hold numpy mirrors of the parts of its design that could move
a bit against mirrors of the serial code they replaced:

* ``tile_fold``: each thread's scan of its 8 columns of a row (columns
  4 tx .. 4 tx + 3 and 64 + the same, ``frag_col``), the shuffle reduction
  over the row's 16 lanes that halves the rows a lane holds, and the fold
  by the lane that owns the row (``frag_row``),
  against ``tile_min_argmin`` (one thread scans the row's 128 columns with
  a strict '<') and ``fold_min``, tile by tile and across tiles, on ties,
  signed zeros, infinities and NaNs wherever they may stand;
* the step after which the distance-slot SEU lands (``inj_step``) against
  the (centroid tile, chunk) condition it replaced;
* ``chunk_encodings``' lanes against the 8 strided partials a feature of
  the first f32 design's staged loop.

Then the Python side: the pre-pass ``prep_centroids`` (C feature-major
and C's encodings) and its exact single-rounding ``fma_f32``, held to
exact rational arithmetic and to a float32 loop in the kernel's order;
``_build.ptr``'s 16-byte rule for the f32 tile kernels' X, C and norms
(``vec16``), and the plain versions of the four
single-problem entries against the reference at F = 300 (Fp = 320, ten
feature chunks), the shape ``chip_smoke.py`` phase 2 adds on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build, ops, ref  # noqa: E402

KBK, KTN, FLT_MAX = 128, 8, np.float32(np.finfo(np.float32).max)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def frag_row(ty, i):
    """Row slot i of thread row ty (the kernel's frag_row)."""
    return 4 * ty + i if i < 4 else 64 + 4 * ty + i - 4


def frag_col(tx, j):
    """Column slot j of thread column tx (the kernel's frag_col)."""
    return 4 * tx + j if j < 4 else 64 + 4 * tx + j - 4


# --- mirrors of the serial scan and of tile_fold ---------------------------

def serial_tile(t):
    """tile_min_argmin on one row of a tile: (min, column)."""
    best, arg = t[0], 0
    for c in range(1, KBK):
        if t[c] < best:
            best, arg = t[c], c
    return best, arg


def lane_scans(tile, bm):
    """Each lane's (value, column) per row of its fragment: tile (bm, 128);
    returns v, c of shape (16 ty, 16 tx, bm / 16), in the kernel's names
    (rg, cg) = (ty, tx)."""
    ktm = bm // 16
    v = np.empty((16, 16, ktm), np.float32)
    c = np.empty((16, 16, ktm), np.int64)
    for rg in range(16):
        for cg in range(16):
            for i in range(ktm):
                row = tile[frag_row(rg, i)]
                d0 = row[frag_col(cg, 0)]
                if np.isnan(d0):
                    vv, cc = (np.float32(-np.inf), -1) if cg == 0 else (
                        np.float32(np.inf), frag_col(cg, 0))
                else:
                    vv, cc = d0, frag_col(cg, 0)
                for j in range(1, KTN):
                    d = row[frag_col(cg, j)]
                    if d < vv:
                        vv, cc = d, frag_col(cg, j)
                v[rg, cg, i], c[rg, cg, i] = vv, cc
    return v, c


def _min_pair(v, c, ov, oc):
    return (ov, oc) if (ov < v or (ov == v and oc < c)) else (v, c)


def row_reduce(v, c):
    """The shuffles of row_reduce over the 16 lanes of one thread row: v, c
    (16, N); returns each lane's final (value, column)."""
    lanes = len(v)
    v = [list(r) for r in v]
    c = [list(r) for r in c]
    n, off = len(v[0]), lanes // 2
    while n > 1:
        nv = [[None] * (n // 2) for _ in range(lanes)]
        nc = [[None] * (n // 2) for _ in range(lanes)]
        for cg in range(lanes):
            p, upper = cg ^ off, bool(cg & off)
            for h in range(n // 2):
                sh = h if (p & off) else h + n // 2      # the partner's send
                kh = h + n // 2 if upper else h          # the half kept
                nv[cg][h], nc[cg][h] = _min_pair(v[cg][kh], c[cg][kh],
                                                 v[p][sh], c[p][sh])
        v, c, n, off = nv, nc, n // 2, off // 2
    while off > 0:
        pairs = [_min_pair(v[cg][0], c[cg][0], v[cg ^ off][0],
                           c[cg ^ off][0]) for cg in range(lanes)]
        v = [[a] for a, _ in pairs]
        c = [[b] for _, b in pairs]
        off //= 2
    return [r[0] for r in v], [r[0] for r in c]


def tile_contributions(tile, bm):
    """What tile_fold folds for each row of one tile: (value, column) or
    None (the pair of a NaN at column 0). Also checks that the lanes that
    share a row agree and that each row has exactly one owner."""
    ktm = bm // 16
    shift = {8: 1, 4: 2}[ktm]
    v, c = lane_scans(tile, bm)
    out = {}
    for rg in range(16):
        fv, fc = row_reduce(v[rg], c[rg])
        for cg in range(16):
            row = frag_row(rg, cg >> shift)
            got = None if fc[cg] < 0 else (fv[cg], fc[cg])
            if cg % (16 // ktm) == 0:
                assert row not in out, "two owners of one row"
                out[row] = got
            else:       # a lane that shares the row's result
                own = out[frag_row(rg, cg >> shift)]
                assert (own is None) == (got is None)
                if got is not None:
                    assert own[1] == got[1]
                    assert _bits(own[0]) == _bits(got[0])
    assert sorted(out) == list(range(bm))
    return [out[r] for r in range(bm)]


def serial_contributions(tile):
    """The serial scan's (min, column) of each row, None where the min is
    NaN (fold_min's strict '<' never takes it)."""
    out = []
    for row in tile:
        m, a = serial_tile(row)
        out.append(None if np.isnan(m) else (m, a))
    return out


def fold(contribs_by_tile, rows):
    """fold_min over tiles: running (min, argmin) from (FLT_MAX, 0)."""
    best = np.full(rows, FLT_MAX, np.float32)
    arg = np.zeros(rows, np.int64)
    for kt, contribs in enumerate(contribs_by_tile):
        for r, got in enumerate(contribs):
            if got is not None and got[0] < best[r]:
                best[r], arg[r] = got[0], got[1] + kt * KBK
    return best, arg


def _tiles(name, bm, seed):
    """(bm, 3 x 128) distance rows of one kind."""
    rng = np.random.default_rng(seed)
    shape = (bm, 3 * KBK)
    nan, inf = np.float32(np.nan), np.float32(np.inf)
    if name == "normal":
        return rng.standard_normal(shape).astype(np.float32)
    if name == "ties":
        return rng.integers(-2, 3, shape).astype(np.float32)
    if name == "signed_zero":
        return rng.choice(np.array([-0.0, 0.0, 1.0], np.float32), shape)
    d = rng.integers(-3, 4, shape).astype(np.float32)
    if name == "nan_col0":
        d[::3, 0] = nan
        d[1::3, KBK] = nan
        d[2::5, 2 * KBK] = nan
        d[::7, 5] = -9.0
    elif name == "nan_scatter":
        d[rng.random(shape) < 0.2] = nan
    elif name == "nan_rows":
        d[::4] = nan
        d[1::4] = nan
        d[1::4, 77] = 1.0
        d[2::4, :] = inf
        d[2::4, 200] = nan
    elif name == "infinities":
        d = np.where(rng.random(shape) < 0.5, inf, d).astype(np.float32)
        d[::6] = inf
        d[1::6, 3] = -inf
        d[2::6, 130] = -inf
        d[2::6, 129] = -inf
    elif name == "lane_first_nan":
        # every lane's first column NaN but column 0's: +inf, a finite
        # value or a NaN at column 0, the rest +inf or equal values
        d[:] = inf
        d[:, 1:16] = nan
        d[:, KBK + 1:KBK + 16] = nan
        d[::3, 0] = inf
        d[1::3, 0] = 5.0
        d[1::3, 40] = 5.0
        d[2::3, KBK] = nan
        d[2::3, KBK + 100] = 7.0
    return d


CASES = ["normal", "ties", "signed_zero", "nan_col0", "nan_scatter",
         "nan_rows", "infinities", "lane_first_nan"]


@pytest.mark.parametrize("bm", [64, 128])
@pytest.mark.parametrize("case", CASES)
def test_tile_fold_is_the_serial_scan(case, bm):
    """Tile by tile the folded (value, column) -- or no fold -- and across
    the three tiles the row's (min, argmin), bit for bit the serial scan
    and fold_min."""
    d = _tiles(case, bm, seed=CASES.index(case) + bm)
    par, ser = [], []
    for kt in range(d.shape[1] // KBK):
        t = d[:, kt * KBK:(kt + 1) * KBK]
        p, s = tile_contributions(t, bm), serial_contributions(t)
        for r, (a, b) in enumerate(zip(p, s)):
            assert (a is None) == (b is None), (case, kt, r)
            if a is not None:
                assert a[1] == b[1] and _bits(a[0]) == _bits(b[0]), \
                    (case, kt, r, a, b)
        par.append(p)
        ser.append(s)
    pb, pa = fold(par, bm)
    sb, sa = fold(ser, bm)
    np.testing.assert_array_equal(_bits(pb), _bits(sb))
    np.testing.assert_array_equal(pa, sa)
    if np.isfinite(d).all():
        # finite rows: the plain version's first_min
        mn, am = ref.first_min(torch.from_numpy(d))
        np.testing.assert_array_equal(_bits(pb), _bits(mn.numpy()))
        np.testing.assert_array_equal(pa, am.numpy())


def test_tile_fold_halving_levels():
    """At BM = 128 a lane holds 8 rows and halves them at lane bits 8, 4
    and 2; at BM = 64, 4 rows at bits 8 and 4: the owned row of lane tx is
    row slot tx >> 1, resp. tx >> 2, of its thread row ty."""
    for bm, shift in ((128, 1), (64, 2)):
        ktm = bm // 16
        # row r holds its index at column r % 128 and a larger value
        # elsewhere, so each row's result names the row
        t = np.full((bm, KBK), 1e3, np.float32)
        t[np.arange(bm), np.arange(bm) % KBK] = -np.arange(bm)
        v, c = lane_scans(t, bm)
        for rg in range(16):
            fv, fc = row_reduce(v[rg], c[rg])
            for cg in range(0, 16, 16 // ktm):
                row = frag_row(rg, cg >> shift)
                assert fc[cg] == row % KBK and fv[cg] == -row


@pytest.mark.parametrize("bm", [64, 128])
def test_fragments_cover_the_tile_once(bm):
    """frag_row / frag_col of the 256 threads cover the BM x 128 tile, each
    element once, each thread's rows and columns in increasing order."""
    ktm = bm // 16
    seen = np.zeros((bm, KBK), np.int64)
    for rg in range(16):
        rows = [frag_row(rg, i) for i in range(ktm)]
        assert rows == sorted(rows)
        for cg in range(16):
            cols = [frag_col(cg, j) for j in range(KTN)]
            assert cols == sorted(cols) and cols[0] == 4 * cg
            for r in rows:
                for c in cols:
                    seen[r, c] += 1
    assert (seen == 1).all()


# --- the injection step ----------------------------------------------------

def _tile_chunk_fires(kt, ch, d, cpt):
    enabled, m_tile, c_tile, f_tile = d
    return bool(enabled) and m_tile == 0 and kt == c_tile and \
        ch == (f_tile + 1) * cpt - 1


def _inj_step(d, cpt, nkt, nch):
    enabled, m_tile, c_tile, f_tile = d
    ch = (f_tile + 1) * cpt - 1
    if enabled and m_tile == 0 and 0 <= c_tile < nkt and 0 <= ch < nch:
        return c_tile * nch + ch
    return -1


@pytest.mark.parametrize("nkt,nch,cpt", [(1, 1, 1), (3, 4, 1), (3, 4, 2),
                                         (8, 4, 4), (2, 10, 1), (2, 10, 5)])
def test_injection_step_is_the_tile_chunk_rule(nkt, nch, cpt):
    """The step s = kt * nch + ch after whose FMAs the SEU lands: the one
    where (kt == c_tile, ch == (f_tile + 1) cpt - 1) holds, or
    none, for descriptors in and out of range."""
    for enabled in (0, 1):
        for c_tile in (-1, 0, 1, nkt - 1, nkt, nkt + 3):
            for f_tile in (-2, -1, 0, 1, nch // cpt - 1, nch // cpt, 99):
                d = (enabled, 0, c_tile, f_tile)
                fires = [kt * nch + ch for kt in range(nkt)
                         for ch in range(nch)
                         if _tile_chunk_fires(kt, ch, d, cpt)]
                step = _inj_step(d, cpt, nkt, nch)
                assert fires == ([step] if step >= 0 else []), d


# --- chunk_encodings' lanes --------------------------------------------------

@pytest.mark.parametrize("n", [64, 128])
def test_chunk_encodings_lanes_are_the_strided_partials(n):
    """Lane 4 p + q of warp w sums rows p, p + 8, .. of feature 4 w + q:
    partial p of that feature, as thread (f, s = p) of the first design; the
    eight partials then add in p order. The lanes cover each (feature,
    partial) once."""
    seen = set()
    for warp in range(8):
        for lane in range(32):
            p, q = lane // 4, lane % 4
            f = 4 * warp + q
            assert list(range(p, n, 8)) == [r for r in range(n) if r % 8 == p]
            seen.add((f, p))
        # the ordered sum reads lanes 4 k + q, k = 0..7: partials 0..7 of q
        for q in range(4):
            assert [(4 * k + q) // 4 for k in range(8)] == list(range(8))
    assert seen == {(f, p) for f in range(32) for p in range(8)}


# --- the pre-pass: C feature-major and C's encodings ----------------------

def _round_f32(q):
    """The f32 nearest to the Fraction q (ties to the even mantissa)."""
    from fractions import Fraction
    r = np.float32(float(q))
    for cand in (np.nextafter(r, np.float32(np.inf)),
                 np.nextafter(r, np.float32(-np.inf))):
        dr, dc = abs(Fraction(float(r)) - q), abs(Fraction(float(cand)) - q)
        if dc < dr or (dc == dr and int(cand.view(np.int32)) % 2 == 0
                       and int(r.view(np.int32)) % 2 == 1):
            r = cand
    return np.float32(r)


def _fma_exact(a, b, c):
    from fractions import Fraction
    return _round_f32(Fraction(float(a)) * Fraction(float(b))
                      + Fraction(float(c)))


def test_fma_f32_rounds_once():
    """``fma_f32`` against exact rational arithmetic: random triples, exact
    ties, and sums whose f64 rounding lands on an f32 midpoint (where
    rounding the f64 sum again would round twice)."""
    from repro_torch.kernels.distance_argmin import fma_f32
    rng = np.random.default_rng(0)
    a = rng.standard_normal(300).astype(np.float32)
    b = (rng.standard_normal(300) * 1e3).astype(np.float32)
    c = (rng.standard_normal(300) * 10.0 ** rng.integers(-8, 8, 300)
         ).astype(np.float32)
    one12 = np.float32(1 + 2.0 ** -12)
    one23 = np.float32(1 + 2.0 ** -23)
    extra = [(one12, one12, np.float32(2.0 ** -60)),     # lifted off a tie
             (one12, one12, np.float32(-2.0 ** -60)),
             (one12, one12, np.float32(0.0)),            # an exact tie
             (one23, one23, np.float32(2.0 ** -24 - 2.0 ** -46)),
             (np.float32(3.0), np.float32(1 + 2.0 ** -23),
              np.float32(-3.0))]
    a = np.concatenate([a, [t[0] for t in extra]]).astype(np.float32)
    b = np.concatenate([b, [t[1] for t in extra]]).astype(np.float32)
    c = np.concatenate([c, [t[2] for t in extra]]).astype(np.float32)
    got = fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                  torch.from_numpy(c)).numpy()
    want = np.array([_fma_exact(*t) for t in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # the lifted tie rounds up, where a second rounding would go to even
    assert got[-5] == np.float32(1 + 2.0 ** -11 + 2.0 ** -23)


def _encodings_loop(c):
    """C's e1 / e2 encodings by a plain float32 loop in the kernel's order:
    per centroid tile of 128 rows and feature f, partial p sums rows p, p +
    8, .. (e1 by float32 adds, e2 by an exact single-rounding fma), then e
    = 0 + part_0 + .. + part_7."""
    kp, fp = c.shape
    out = np.zeros((kp // KBK, 2, fp), np.float32)
    for kt in range(kp // KBK):
        for f in range(fp):
            parts1, parts2 = [], []
            for p in range(8):
                a1 = a2 = np.float32(0.0)
                for r in range(p, KBK, 8):
                    v = c[kt * KBK + r, f]
                    a1 = np.float32(a1 + v)
                    a2 = _fma_exact(np.float32(r + 1), v, a2)
                parts1.append(a1)
                parts2.append(a2)
            e1 = e2 = np.float32(0.0)
            for p in range(8):
                e1 = np.float32(e1 + parts1[p])
                e2 = np.float32(e2 + parts2[p])
            out[kt, 0, f], out[kt, 1, f] = e1, e2
    return out


@pytest.mark.parametrize("scale", [1.0, 3.0e4])
def test_prep_centroids_plain_is_the_kernels_order(scale):
    """``prep_centroids`` on the CPU (its plain version): C transposed, and
    the encodings bit for bit the float32 loop in the kernel's order;
    a stack of problems equals each problem alone."""
    from repro_torch.kernels import distance_argmin as da
    rng = np.random.default_rng(int(scale))
    c = (rng.standard_normal((256, 32)) * scale).astype(np.float32)
    ct, cenc = da.prep_centroids(torch.from_numpy(c), encodings=True)
    np.testing.assert_array_equal(ct.numpy(), c.T)
    np.testing.assert_array_equal(cenc.numpy().view(np.int32),
                                  _encodings_loop(c).view(np.int32))
    stack = torch.from_numpy(np.stack([c, c[::-1].copy()]))
    sct, senc = da.prep_centroids(stack, encodings=True)
    assert torch.equal(sct[0], ct) and torch.equal(senc[0], cenc)
    assert torch.equal(senc[1], da.prep_centroids(stack[1], True)[1])
    assert da.prep_centroids(torch.from_numpy(c))[1] is None


def test_prep_centroids_rejects():
    from repro_torch.kernels import distance_argmin as da
    for bad in (torch.zeros(256, 32, dtype=torch.bfloat16),
                torch.zeros(200, 32), torch.zeros(256, 40),
                torch.zeros(256)):
        with pytest.raises(ValueError, match="prep_centroids takes f32"):
            da.prep_centroids(bad)


# --- the Python side ---------------------------------------------------------

def test_ptr_vec16_rejects_unaligned():
    base = torch.zeros(64, dtype=torch.float32)
    assert base.data_ptr() % 16 == 0
    assert _build.ptr(base, torch.float32, "x", vec16=True) == \
        base.data_ptr()
    view = base[1:]
    assert view.data_ptr() % 16 == 4
    assert _build.ptr(view, torch.float32, "x") == view.data_ptr()
    with pytest.raises(ValueError, match="16-byte boundary"):
        _build.ptr(view, torch.float32, "x", vec16=True)
    with pytest.raises(ValueError, match="contiguous"):
        _build.ptr(base.view(8, 8).T, torch.float32, "x", vec16=True)


def test_tile_wrappers_ask_for_16_bytes():
    """X, C and the norms of the five f32 tile entries go through the
    16-byte rule (the kernel stages them with 16-byte cp.async)."""
    import inspect

    from repro_torch.kernels import distance_argmin as da
    from repro_torch.kernels import distance_argmin_ft as daft
    from repro_torch.kernels import lloyd_step as ll
    from repro_torch.kernels import lloyd_step_ft as llft
    for fn, n in ((da.distance_argmin, 3), (daft.distance_argmin_ft, 3),
                  (ll.lloyd_step, 3), (ll.lloyd_step_batched, 3),
                  (llft.lloyd_step_ft, 3)):
        assert inspect.getsource(fn).count("vec16=True") == n, fn.__name__


# --- the plain versions at F = 300 against the reference ------------------

M3, K3, F3 = 517, 300, 300          # 5 x 3 x 10 tiles at (128, 128, 32)


@pytest.fixture(scope="module")
def f300():
    import jax.numpy as jnp  # noqa: F401
    from repro.kernels import ops as jops
    from repro_torch.data.blobs import make_blobs
    x, _ = make_blobs(M3, F3, 7, seed=11)
    rng = np.random.default_rng(11)
    c = (x[rng.choice(M3, K3, replace=False)]
         + rng.normal(size=(K3, F3)).astype(np.float32)).astype(np.float32)
    return x, c, jops


def _close(a, b, scale):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=0,
                               atol=1e-5 * max(scale, 1.0))


@pytest.mark.parametrize("entry", ["fused_assign", "fused_lloyd",
                                   "fused_assign_ft", "fused_lloyd_ft"])
def test_plain_at_f300_matches_reference(f300, entry):
    """Labels, counts and detections exact; distances and sums to 1e-5 of
    the largest magnitude (the packages sum in other orders)."""
    x, c, jops = f300
    p = ops.KernelParams(128, 128, 32)
    jp = jops.KernelParams(128, 128, 32)
    got = getattr(ops, entry)(torch.from_numpy(x), torch.from_numpy(c), p)
    want = getattr(jops, entry)(x, c, jp, interpret=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    norms = float((x.astype(np.float64) ** 2).sum(1).max())
    _close(got[1].numpy(), want[1], norms)
    if entry.startswith("fused_lloyd"):
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
        _close(got[2].numpy(), want[2], float(np.abs(want[2]).max()))
    if entry.endswith("_ft"):
        assert int(got[-1]) == int(want[-1]) == 0
