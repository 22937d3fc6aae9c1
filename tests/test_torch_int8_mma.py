"""The int8 tile kernel's tensor-core design, checked on the CPU.

``int8_tile_kernel`` (``csrc/fk_kernels.cu``) runs only on the card, so
these tests hold torch models of the parts of its design that could move
a bit:

* the fragments: each lane's ``ldmatrix.x4`` addresses (the kernel's
  formulas) over X's stash and C's staged chunk, the 32-bit words they
  give, read as the PTX ISA's m16n8k32 s8 A and B fragments, and the s32
  C fragment each ``mma.sync`` adds to, over the warps' 2 x 4 tiling:
  assembled, every output of the BM x 128 block is covered once and equals
  ``xq.long() @ cq.long().T``;
* the epilogue: each lane's scan of its 8 columns of a row, the quad's
  shuffle combine, the 4 warps of a row band, the owner's ``fold_min``,
  against the serial ``tile_min_argmin`` + ``fold_min`` it replaced, on
  ties within and across tiles, signed zeros, infinities (the padded
  centroids' +inf norms), NaNs and extreme scales, at one and two centroid
  tiles;

then ``distance_argmin_int8_plain`` against the reference kernel (Pallas,
interpret mode) at a ragged shape, and ``check_int8``'s limit on Fp (int32
sums exact while Fp * 128**2 < 2**31).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import distance_argmin_int8 as j_dai  # noqa: E402
from repro_torch.dist.compression import quantize_rows  # noqa: E402
from repro_torch.kernels import distance_argmin_int8 as dai  # noqa: E402

WARPS, LANES, TILE_K, CHUNK = 8, 32, 128, 128
FLT_MAX = torch.finfo(torch.float32).max


# --- the fragments ----------------------------------------------------------

def ldmatrix_x4(tile: torch.Tensor, rows, cols) -> torch.Tensor:
    """``ldmatrix.sync.m8n8.x4.b16`` over a staged int8 tile (rows, bytes):
    lane 8 i + r gives row ``rows[lane]`` / byte ``cols[lane]`` of matrix
    i's row r (16 bytes); lane 4 g + t receives word t of row g of each
    matrix. Returns (32 lanes, 4 registers, 4 bytes) int8."""
    out = torch.empty(LANES, 4, 4, dtype=torch.int8)
    for lane in range(LANES):
        g, t = divmod(lane, 4)
        for i in range(4):
            src = 8 * i + g
            out[lane, i] = tile[rows[src], cols[src] + 4 * t:
                                cols[src] + 4 * t + 4]
    return out


def a_fragment_matrix(regs: torch.Tensor) -> torch.Tensor:
    """The 16 x 32 A operand that a warp's registers hold under the PTX
    m16n8k32 s8 layout: a[0] row g, k 4t..; a[1] row g + 8; a[2] row g,
    k 4t + 16..; a[3] row g + 8, k 4t + 16.."""
    a = torch.empty(16, 32, dtype=torch.int64)
    for lane in range(LANES):
        g, t = divmod(lane, 4)
        for q, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 16), (8, 16))):
            a[g + dr, 4 * t + dk:4 * t + dk + 4] = regs[lane, q].long()
    return a


def b_fragment_matrix(b0: torch.Tensor, b1: torch.Tensor) -> torch.Tensor:
    """The 32 x 8 B operand (column-major) of registers b0, b1 (32 lanes,
    4 bytes): b0 column g, k 4t..; b1 column g, k 4t + 16.."""
    b = torch.empty(32, 8, dtype=torch.int64)
    for lane in range(LANES):
        g, t = divmod(lane, 4)
        b[4 * t:4 * t + 4, g] = b0[lane].long()
        b[4 * t + 16:4 * t + 20, g] = b1[lane].long()
    return b


def c_fragment_positions():
    """(lane, e) -> (row, col) of the m16n8 s32 C fragment."""
    return {(lane, e): (lane // 4 + 8 * (e // 2), 2 * (lane % 4) + e % 2)
            for lane in range(LANES) for e in range(4)}


def kernel_products(xq: torch.Tensor, cq: torch.Tensor, bm: int):
    """One (row tile, centroid tile) of the kernel: X's BM rows stashed at
    a pitch of Fp + 16 bytes, C's 128 rows staged a chunk at a time at a
    pitch of 144, each warp's ldmatrix + mma walk over the chunks' 32-deep
    k-steps. Returns the BM x 128 block assembled from every lane's
    accumulators and how many accumulators each output got."""
    fp = xq.shape[1]
    xs = torch.zeros(bm, fp + 16, dtype=torch.int8)
    xs[:, :fp] = xq
    block = torch.zeros(bm, TILE_K, dtype=torch.int64)
    hits = torch.zeros(bm, TILE_K, dtype=torch.int64)
    pos = c_fragment_positions()
    kmf, kwm = bm // 32, bm // 2
    lanes = torch.arange(LANES)
    for w in range(WARPS):
        r0, n0 = (w // 4) * kwm, (w % 4) * 32
        acc = torch.zeros(kmf, 4, LANES, 4, dtype=torch.int64)
        for ch in range(0, fp, CHUNK):
            cs = torch.zeros(TILE_K, CHUNK + 16, dtype=torch.int8)
            cw = min(CHUNK, fp - ch)
            cs[:, :cw] = cq[:, ch:ch + cw]
            for kk in range(cw // 32):
                b = {}
                for jj in range(2):
                    regs = ldmatrix_x4(
                        cs, n0 + 16 * jj + (lanes & 7) + 8 * (lanes >> 4),
                        32 * kk + 16 * ((lanes >> 3) & 1))
                    b[2 * jj] = b_fragment_matrix(regs[:, 0], regs[:, 1])
                    b[2 * jj + 1] = b_fragment_matrix(regs[:, 2], regs[:, 3])
                for i in range(kmf):
                    regs = ldmatrix_x4(
                        xs, r0 + 16 * i + (lanes & 7)
                        + 8 * ((lanes >> 3) & 1),
                        ch + 32 * kk + 16 * (lanes >> 4))
                    a = a_fragment_matrix(regs)
                    for j in range(4):
                        d = a @ b[j]
                        for (lane, e), (r, c) in pos.items():
                            acc[i, j, lane, e] += d[r, c]
        for i in range(kmf):
            for j in range(4):
                for (lane, e), (r, c) in pos.items():
                    row, col = r0 + 16 * i + r, n0 + 8 * j + c
                    block[row, col] += acc[i, j, lane, e]
                    hits[row, col] += 1
    return block, hits


@pytest.mark.parametrize("bm,fp", [(64, 96), (128, 160)])
def test_fragments_assemble_the_exact_product(bm, fp):
    """Fp 96: one chunk of three k-steps; Fp 160: a full chunk and a tail
    of one k-step. Extreme int8 values, -128 included."""
    rng = np.random.default_rng(bm + fp)
    xq = torch.from_numpy(rng.integers(-128, 128, (bm, fp)).astype(np.int8))
    cq = torch.from_numpy(rng.integers(-128, 128, (TILE_K, fp))
                          .astype(np.int8))
    xq[0] = -128
    cq[0] = -128
    block, hits = kernel_products(xq, cq, bm)
    assert bool((hits == 1).all())
    assert torch.equal(block, xq.long() @ cq.long().T)


def test_ldmatrix_rows_fall_on_distinct_banks():
    """Each 8 x 16-byte matrix the kernel loads: 8 rows at the pitch of C's
    chunk (144 bytes) or of X's stash (Fp + 16, Fp a multiple of 32) start
    on 8 distinct groups of 4 banks."""
    for pitch in [144] + [fp + 16 for fp in range(32, 1024, 32)]:
        banks = {(r * pitch // 4) % 32 for r in range(8)}
        assert len(banks) == 8 and all(b % 4 == 0 for b in banks), pitch


# --- the epilogue ----------------------------------------------------------

def _min_pair(v, c, ov, oc):
    return (ov, oc) if (ov < v or (ov == v and oc < c)) else (v, c)


def lane_pairs(d: np.ndarray, bm: int) -> tuple:
    """The kernel's scans and combines on one tile's distances d (BM, 128)
    f32: each lane's scan of its columns n0 + 8 j + 2 t + e of each of its
    rows (strict '<'; a NaN first column becomes (-inf, -1) at the tile's
    column 0, else (+inf, that column)), the quad's shuffle combine (xor 1,
    then 2), then the 4 warps of the row band in warp order. Returns per
    row (value, column), column -1 where the tile does not fold."""
    kmf, kwm = bm // 32, bm // 2
    v = np.empty((WARPS, LANES, kmf, 2), np.float32)
    c = np.empty((WARPS, LANES, kmf, 2), np.int64)
    for w in range(WARPS):
        r0, n0 = (w // 4) * kwm, (w % 4) * 32
        for lane in range(LANES):
            g, t = divmod(lane, 4)
            cols = [n0 + 8 * j + 2 * t + e for j in range(4) for e in range(2)]
            for i in range(kmf):
                for h in range(2):
                    row = d[r0 + 16 * i + g + 8 * h]
                    if np.isnan(row[cols[0]]):
                        first = n0 == 0 and t == 0
                        vv = np.float32(-np.inf if first else np.inf)
                        cc = -1 if first else cols[0]
                    else:
                        vv, cc = row[cols[0]], cols[0]
                    for col in cols[1:]:
                        if row[col] < vv:
                            vv, cc = row[col], col
                    v[w, lane, i, h], c[w, lane, i, h] = vv, cc
    for off in (1, 2):
        pv, pc = v.copy(), c.copy()
        for w in range(WARPS):
            for lane in range(LANES):
                for i in range(kmf):
                    for h in range(2):
                        v[w, lane, i, h], c[w, lane, i, h] = _min_pair(
                            pv[w, lane, i, h], pc[w, lane, i, h],
                            pv[w, lane ^ off, i, h], pc[w, lane ^ off, i, h])
    out = []
    for r in range(bm):
        band, rr = divmod(r, kwm)
        i, rest = divmod(rr, 16)
        h, g = divmod(rest, 8)
        pairs = [(v[4 * band + q, 4 * g + t, i, h],
                  c[4 * band + q, 4 * g + t, i, h])
                 for q in range(4) for t in range(4)]
        # the quad agrees after its combine; the owner reads lane 4 g
        for q in range(4):
            quad = {(float(v[4 * band + q, 4 * g + t, i, h]).hex(),
                     int(c[4 * band + q, 4 * g + t, i, h])) for t in range(4)}
            assert len(quad) == 1, "a quad's lanes disagree"
        vv, cc = pairs[0]
        for q in range(1, 4):
            vv, cc = _min_pair(vv, cc, *pairs[4 * q])
        out.append((vv, cc))
    return out


def serial_tile(row: np.ndarray) -> tuple:
    """tile_min_argmin on one row of a tile (strict '<')."""
    best, arg = row[0], 0
    for c in range(1, TILE_K):
        if row[c] < best:
            best, arg = row[c], c
    return best, arg


def fold(tiles: list, bm: int, mirror: bool) -> tuple:
    """The row state after folding each tile's (BM, 128) distances with
    fold_min from (FLT_MAX, 0): through the kernel's mirror or the serial
    scan."""
    best = [np.float32(FLT_MAX)] * bm
    arg = [0] * bm
    for kt, d in enumerate(tiles):
        got = lane_pairs(d, bm) if mirror else [serial_tile(r) for r in d]
        for r, (v, c) in enumerate(got):
            if c >= 0 and v < best[r]:
                best[r], arg[r] = v, c + kt * TILE_K
    return np.array(best, np.float32), np.array(arg)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _tiles(kind: str, n_tiles: int, bm: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for kt in range(n_tiles):
        d = rng.integers(-4, 5, size=(bm, TILE_K)).astype(np.float32)
        if kind == "ties":       # equal minima within and across tiles
            d[:, ::17] = -9.0
        elif kind == "zeros":    # +0 and -0 as the minima
            d = np.abs(d) + 1.0
            d[:, rng.integers(0, TILE_K, 6)] = 0.0
            d[:, rng.integers(0, TILE_K, 6)] = -0.0
        elif kind == "infs":     # padded centroids' +inf, some -inf
            d[:, TILE_K - 40:] = np.inf if kt == n_tiles - 1 else d[:, :40]
            d[::5] = np.inf
            d[3, 77] = -np.inf
            d[9, 0] = -np.inf
        elif kind == "nans":     # NaN at column 0, elsewhere, everywhere
            d[::3, 0] = np.nan
            d[1::3, rng.integers(1, TILE_K, 9)] = np.nan
            d[2::7] = np.nan
            d[4::7, :] = np.inf
            d[4::7, 50] = np.nan
        out.append(d)
    return out


@pytest.mark.parametrize("bm", [64, 128])
@pytest.mark.parametrize("n_tiles", [1, 2])
@pytest.mark.parametrize("kind", ["ties", "zeros", "infs", "nans"])
def test_epilogue_mirror_is_the_serial_scan(kind, n_tiles, bm):
    tiles = _tiles(kind, n_tiles, bm, seed=bm + 7 * n_tiles)
    got_v, got_c = fold(tiles, bm, mirror=True)
    want_v, want_c = fold(tiles, bm, mirror=False)
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_array_equal(_bits(got_v), _bits(want_v))


# (sx exponent, sc exponent, cn exponent): products near f32's top, past
# it (2 v overflows to +-inf), in its subnormals, and far apart
SCALES = {"extreme": (50, 50, 120), "overflow": (60, 60, 100),
          "tiny": (-70, -70, -120), "mixed": (-100, 100, 20)}


@pytest.mark.parametrize("scale", sorted(SCALES))
def test_epilogue_from_int32_products_matches_plain(scale):
    """The kernel's arithmetic from int32 products at extreme scales
    (sx (float(acc) sc), rounded at each step, then cn - 2 v) through the
    mirror, against ``distance_argmin_int8_plain`` on the same inputs (no
    NaN arises: the plain version's first_min and the scan agree)."""
    bm, kp, fp = 64, 256, 64
    rng = np.random.default_rng(11)
    xq = torch.from_numpy(rng.integers(-127, 128, (bm, fp)).astype(np.int8))
    cq = torch.from_numpy(rng.integers(-127, 128, (kp, fp)).astype(np.int8))
    ex, ec, en = SCALES[scale]
    sx = torch.from_numpy((2.0 ** ex * rng.random(bm) + 2.0 ** ex)
                          .astype(np.float32))
    sc = torch.from_numpy((2.0 ** ec * rng.random(kp) + 2.0 ** ec)
                          .astype(np.float32))
    cn = torch.from_numpy((rng.random(kp) * 2.0 ** en).astype(np.float32))
    cn[200:] = torch.inf                   # padded centroids
    sc[200:] = 1.0
    cq[200:] = 0
    acc = (xq.long() @ cq.long().T).to(torch.int32)
    w = sx[:, None] * (acc.float() * sc[None, :])
    d = (cn[None, :] - 2.0 * w).numpy()
    assert not np.isnan(d).any()
    tiles = [d[:, kt * TILE_K:(kt + 1) * TILE_K] for kt in range(2)]
    got_v, got_c = fold(tiles, bm, mirror=True)
    want_v, want_c = dai.distance_argmin_int8_plain(xq, cq, sx, sc, cn)
    np.testing.assert_array_equal(got_c, want_c.numpy())
    np.testing.assert_array_equal(_bits(got_v), _bits(want_v.numpy()))


# --- the plain version against the reference, and the Fp limit -------------

def test_plain_matches_reference_kernel_at_a_ragged_shape():
    """M 333, F 45, K 150 padded to (384, 256, 128): the plain version
    against the reference kernel in interpret mode, bit for bit."""
    m, f, k = 333, 45, 150
    rng = np.random.default_rng(21)
    x = (rng.normal(size=(m, f)) * 4.0).astype(np.float32)
    c = (rng.normal(size=(k, f)) * 4.0).astype(np.float32)
    mp, kp, fp = 384, 256, 128
    qx, sx = quantize_rows(torch.from_numpy(x))
    qc, sc = quantize_rows(torch.from_numpy(c))
    xq = np.zeros((mp, fp), np.int8)
    xq[:m, :f] = qx.numpy()
    cq = np.zeros((kp, fp), np.int8)
    cq[:k, :f] = qc.numpy()
    sxp = np.ones(mp, np.float32)
    sxp[:m] = sx[:, 0].numpy()
    scp = np.ones(kp, np.float32)
    scp[:k] = sc[:, 0].numpy()
    cn = np.full(kp, np.inf, np.float32)
    cn[:k] = (c ** 2).sum(1)
    mind, am = dai.distance_argmin_int8_plain(
        *(torch.from_numpy(a) for a in (xq, cq, sxp, scp, cn)))
    jmind, jam = j_dai.distance_argmin_int8(
        xq, cq, sxp[:, None], scp[None, :], cn[None, :], block_m=128,
        block_k=128, block_f=128, variant="generic", interpret=True)
    np.testing.assert_array_equal(am.numpy(), np.asarray(jam)[:, 0])
    np.testing.assert_array_equal(_bits(mind.numpy()),
                                  _bits(np.asarray(jmind)[:, 0]))


def test_check_int8_refuses_fp_past_exact_int32():
    assert dai.MAX_FEATURES * 128 ** 2 < 2 ** 31
    assert (dai.MAX_FEATURES + 1) * 128 ** 2 >= 2 ** 31

    def args(fp):
        return (torch.zeros(64, fp, dtype=torch.int8),
                torch.zeros(128, fp, dtype=torch.int8), torch.ones(64),
                torch.ones(128), torch.zeros(128), 64, 128, 32)
    wide = -(-(dai.MAX_FEATURES + 1) // 32) * 32
    with pytest.raises(ValueError, match="exact up to"):
        dai.check_int8(*args(wide))
    dai.check_int8(*args(dai.MAX_FEATURES // 32 * 32))
