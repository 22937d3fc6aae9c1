"""The 2-byte tile kernel's loop, checked on the CPU.

``lloyd_tile_mma_kernel`` (``csrc/fk_kernels.cu``) runs only on the card,
so these tests hold torch / numpy models of the parts of its design that
could move a bit or a byte:

* the layout (``MmaLayout``): where X's row tile is kept and where it
  streams, the features a ring step takes, and that every instantiation's
  shared memory leaves two blocks an SM; ``ldmatrix`` rows of every pitch
  on distinct banks;
* the fragments: each lane's ``ldmatrix.x4`` addresses (the kernel's
  formulas) over X's stash or its streamed chunk and C's ring slot, the
  32-bit words they give, read as the PTX ISA's m16n8k16 A and B
  fragments, over the warps' 2 x 4 tiling and the ring's steps: every
  output of the BM x 128 block is covered once, each accumulator takes the
  k16 steps 0 .. Fp/16 - 1 in order (the first design's order, so the same
  bits), and on integer-valued bf16 / fp16 data the assembled block equals
  ``x.float() @ c.float().T``;
* the epilogue in registers: each lane's scan of its 8 columns of a row (d
  = cn - 2 acc), the quad's shuffle combine, the 4 warps of a row band,
  the owner's ``fold_min``, against the serial ``tile_min_argmin`` +
  ``fold_min`` it replaced, on ties within and across tiles, signed zeros,
  +inf norms (padded centroids) and NaNs, at one and two centroid tiles.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

WARPS, LANES, TILE_K, CHUNK, WIDE, PAD = 8, 32, 128, 32, 64, 8
STAGES, STASH_MAX, TWO_BLOCKS = 3, 48 * 1024, 113 * 1024
FLT_MAX = np.float32(torch.finfo(torch.float32).max)


# --- the layout --------------------------------------------------------------

def mma_layout(bm: int, fp: int, ft: bool, ntiles: int = 0) -> dict:
    """``MmaLayout``'s decisions and bytes (the kernel's formulas)."""
    def place(stash: bool) -> dict:
        ck = WIDE if stash and not ft and fp >= WIDE else CHUNK
        cpitch = ck + PAD
        xpitch = fp + PAD if stash else cpitch
        un = bm * xpitch * 2 if stash else 0
        slot = (TILE_K + (8 if ft else 0) + (0 if stash else bm)) * cpitch * 2
        body = STAGES * slot
        if ft:
            body = max(body, bm * (TILE_K + 1) * 4)
        cn = un + -(-body // 16) * 16
        xch = cn + STAGES * TILE_K * 4
        chk = xch + (0 if ft else 4 * bm * 8)
        part = chk + (4 * (TILE_K + bm) * 4 if ft else 0)
        xenc = part + (2 * (TILE_K + 8 * CHUNK) * 4 + 16 if ft else 0)
        prune = xenc + (2 * fp * 4 if ft else 0)
        return dict(stash=stash, ck=ck, cpitch=cpitch, xpitch=xpitch,
                    slot=slot, un=un, body=body,
                    bytes=prune + ((16 + bm + ntiles + 1) * 4 if ntiles
                                   else 0))
    lay = place(bm * (fp + PAD) * 2 <= STASH_MAX)
    if lay["stash"] and lay["bytes"] > TWO_BLOCKS:
        lay = place(False)
    return lay


@pytest.mark.parametrize("ft", [False, True])
@pytest.mark.parametrize("bm", [64, 128])
def test_layout_keeps_two_blocks_an_sm(bm, ft):
    """Every Fp a 2-byte instantiation takes up to 2048 fits two blocks an
    SM (113 KB each); X is kept up to its 48 KB where that fits beside the
    ring (and, at kFT, Ds), else it streams; a step is 64 features only
    with X kept and no checksums."""
    for fp in range(32, 2048 + 1, 32):
        lay = mma_layout(bm, fp, ft, 0 if ft else 8)
        assert lay["bytes"] <= TWO_BLOCKS, (fp, lay)
        assert lay["bytes"] % 4 == 0 and lay["un"] % 16 == 0
        assert lay["stash"] == (bm * (fp + PAD) * 2 <= STASH_MAX
                                and not (ft and fp > 128 and bm == 128))
        assert lay["ck"] == (WIDE if lay["stash"] and not ft and fp >= WIDE
                             else CHUNK)
        if ft:   # Ds lies over the ring; the writer's partials and ints too
            assert lay["body"] >= bm * (TILE_K + 1) * 4
            assert lay["body"] >= 8 * 1024 + 4 * bm * 4
        else:
            assert lay["body"] >= 4 * bm * 4
    # the main path's shapes keep X: Fp 128 (M = 2^20, F = 128) and Fp 32
    # (the PQ codebooks), with and without the checksums
    for fp in (32, 128):
        for ft_ in (False, True):
            assert mma_layout(bm, fp, ft_)["stash"]


def test_ldmatrix_rows_fall_on_distinct_banks():
    """Each 8 x 16-byte matrix the kernel loads: 8 rows at the pitch of a
    ring slot (32 or 64 features + 8, 2 bytes each) or of X's stash (Fp + 8
    elements, Fp a multiple of 32) start on 8 distinct groups of 4 banks,
    at 16-byte alignment."""
    for pitch in [2 * (CHUNK + PAD), 2 * (WIDE + PAD)] + [
            2 * (fp + PAD) for fp in range(32, 2048, 32)]:
        assert pitch % 16 == 0
        banks = {(r * pitch // 4) % 32 for r in range(8)}
        assert len(banks) == 8 and all(b % 4 == 0 for b in banks), pitch


def test_column_checksum_words_are_conflict_free():
    """col_fma's 32-bit loads of C's rows (FT, pitch 40 elements): lane 4 g
    + q of warp w reads word q + 4 s of row 16 w + g (+ 8): 32 distinct
    banks."""
    for w in range(WARPS):
        for s in range(4):
            for h in range(2):
                banks = {((16 * w + g + 8 * h) * (CHUNK + PAD) * 2 // 4 + q
                          + 4 * s) % 32 for g in range(8) for q in range(4)}
                assert len(banks) == 32


# --- the fragments -----------------------------------------------------------

def ldmatrix_x4(tile: np.ndarray, rows, cols) -> np.ndarray:
    """``ldmatrix.sync.m8n8.x4.b16`` over a staged 2-byte tile (rows,
    elements): lane 8 i + r gives row ``rows[lane]`` / element
    ``cols[lane]`` of matrix i's row r (8 elements, 16-byte aligned); lane
    4 g + t receives word t (elements 2 t, 2 t + 1) of row g of each
    matrix. Returns (32 lanes, 4 registers, 2 elements)."""
    out = np.empty((LANES, 4, 2), tile.dtype)
    for lane in range(LANES):
        g, t = divmod(lane, 4)
        for i in range(4):
            src = 8 * i + g
            assert cols[src] % 8 == 0
            out[lane, i] = tile[rows[src], cols[src] + 2 * t:
                                cols[src] + 2 * t + 2]
    return out


def a_fragment(regs: np.ndarray) -> np.ndarray:
    """The 16 x 16 A operand of a warp's registers under PTX m16n8k16: a[0]
    row g, k 2t, 2t+1; a[1] row g + 8; a[2] row g, k 2t + 8..; a[3] row g +
    8, k 2t + 8.."""
    a = np.empty((16, 16), np.float64)
    for lane in range(LANES):
        g, t = divmod(lane, 4)
        for q, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
            a[g + dr, 2 * t + dk:2 * t + dk + 2] = regs[lane, q]
    return a


def b_fragment(b0: np.ndarray, b1: np.ndarray) -> np.ndarray:
    """The 16 x 8 B operand (column-major) of b0, b1: b0 column g, k 2t,
    2t+1; b1 column g, k 2t + 8, 2t + 9."""
    b = np.empty((16, 8), np.float64)
    for lane in range(LANES):
        g, t = divmod(lane, 4)
        b[2 * t:2 * t + 2, g] = b0[lane]
        b[2 * t + 8:2 * t + 10, g] = b1[lane]
    return b


C_POS = {(lane, e): (lane // 4 + 8 * (e // 2), 2 * (lane % 4) + e % 2)
         for lane in range(LANES) for e in range(4)}


def kernel_block(x: np.ndarray, c: np.ndarray, bm: int, ft: bool):
    """One (row tile, centroid tile) of the kernel: X kept at a pitch of Fp
    + 8 or streamed in each step's slot, C's 128 rows staged a step at a
    time at the slot's pitch, each warp's ldmatrix + mma walk over the
    steps' k16 steps. Returns the BM x 128 block assembled from every
    lane's accumulators, how many accumulators each output got, and the
    k16 steps each accumulator took in order."""
    fp = x.shape[1]
    lay = mma_layout(bm, fp, ft)
    ck, cp = lay["ck"], lay["cpitch"]
    stash = None
    if lay["stash"]:
        stash = np.zeros((bm, lay["xpitch"]), np.float64)
        stash[:, :fp] = x
    block = np.zeros((bm, TILE_K))
    hits = np.zeros((bm, TILE_K), np.int64)
    order = {}
    kmf, kwm = bm // 32, bm // 2
    lanes = np.arange(LANES)
    erows = 8 if ft else 0
    for w in range(WARPS):
        r0, n0 = (w // 4) * kwm, (w % 4) * 32
        acc = np.zeros((kmf, 4, LANES, 4))
        seen = {(i, j): [] for i in range(kmf) for j in range(4)}
        for f0 in range(0, fp, ck):
            width = min(ck, fp - f0)
            slot = np.zeros((TILE_K + erows + (0 if stash is not None
                                               else bm), cp))
            slot[:TILE_K, :width] = c[:, f0:f0 + width]
            if stash is not None:       # X kept: its columns f0 ..
                xs, xc = stash, f0
            else:                       # X's chunk below C's (and C's enc)
                slot[TILE_K + erows:, :width] = x[:, f0:f0 + width]
                xs, xc = slot[TILE_K + erows:], 0
            for kk in range(width // 16):
                b = {}
                for jj in range(2):
                    regs = ldmatrix_x4(
                        slot, n0 + 16 * jj + (lanes & 7) + 8 * (lanes >> 4),
                        16 * kk + 8 * ((lanes >> 3) & 1))
                    b[2 * jj] = b_fragment(regs[:, 0], regs[:, 1])
                    b[2 * jj + 1] = b_fragment(regs[:, 2], regs[:, 3])
                for i in range(kmf):
                    regs = ldmatrix_x4(
                        xs, r0 + 16 * i + (lanes & 7) + 8 * ((lanes >> 3) & 1),
                        xc + 16 * kk + 8 * (lanes >> 4))
                    a = a_fragment(regs)
                    for j in range(4):
                        d = a @ b[j]
                        seen[i, j].append((f0 + 16 * kk) // 16)
                        for (lane, e), (r, cc) in C_POS.items():
                            acc[i, j, lane, e] += d[r, cc]
        for (i, j), ks in seen.items():
            order[w, i, j] = ks
        for i in range(kmf):
            for j in range(4):
                for (lane, e), (r, cc) in C_POS.items():
                    row, col = r0 + 16 * i + r, n0 + 8 * j + cc
                    block[row, col] += acc[i, j, lane, e]
                    hits[row, col] += 1
    return block, hits, order


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("bm,fp,ft", [(64, 96, False), (128, 160, False),
                                      (64, 32, False), (128, 96, True),
                                      (64, 320, False)])
def test_fragments_assemble_the_exact_product(bm, fp, ft, dtype):
    """Fp 96: a 64-feature step and a tail of two k16 steps; Fp 160: two
    full steps and a tail; Fp 32: one step of two k16 steps (the PQ
    shape); kFT at Fp 96: 32-feature steps with C's encoding rows below
    C; Fp 320 at BM 64 keeps X, at BM 128 it would stream (the layout
    test). Integer values, exact in the 2-byte dtype and in f32."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(bm + fp)
    x = torch.from_numpy(rng.integers(-8, 9, (bm, fp)).astype(np.float32))
    c = torch.from_numpy(rng.integers(-8, 9, (TILE_K, fp)).astype(np.float32))
    x, c = x.to(dt), c.to(dt)
    block, hits, order = kernel_block(x.float().numpy(), c.float().numpy(),
                                      bm, ft)
    assert bool((hits == 1).all())
    np.testing.assert_array_equal(block, (x.float() @ c.float().T).numpy())
    for ks in order.values():      # the k16 steps in feature order, once
        assert ks == list(range(fp // 16))


def test_streamed_x_assembles_the_exact_product():
    """BM 128 at Fp 320 streams X (past the 48 KB stash): 32-feature steps,
    X's chunk below C's in each slot."""
    bm, fp = 128, 320
    assert not mma_layout(bm, fp, False)["stash"]
    rng = np.random.default_rng(5)
    x = rng.integers(-8, 9, (bm, fp)).astype(np.float64)
    c = rng.integers(-8, 9, (TILE_K, fp)).astype(np.float64)
    block, hits, order = kernel_block(x, c, bm, False)
    assert bool((hits == 1).all())
    np.testing.assert_array_equal(block, x @ c.T)
    assert all(ks == list(range(fp // 16)) for ks in order.values())


# --- the epilogue ------------------------------------------------------------

def _min_pair(v, c, ov, oc):
    return (ov, oc) if (ov < v or (ov == v and oc < c)) else (v, c)


def register_scan(acc: np.ndarray, cn: np.ndarray, bm: int) -> list:
    """The kernel's epilogue on one tile's accumulator (BM, 128) f32 and its
    norms cn (128,): each lane's d = cn - 2 acc over its columns n0 + 8 j +
    2 t + e of each of its rows in column order (strict '<'; a NaN first
    column becomes (-inf, -1) at the tile's column 0, else (+inf, that
    column)), the quad's shuffle combine (xor 1, then 2), then the 4 warps
    of the row band in warp order. Returns per row (value, column), column
    -1 where the tile does not fold."""
    kmf, kwm = bm // 32, bm // 2
    d = (cn[None, :] - np.float32(2.0) * acc).astype(np.float32)
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
        vv, cc = v[4 * band, 4 * g, i, h], c[4 * band, 4 * g, i, h]
        for q in range(1, 4):
            vv, cc = _min_pair(vv, cc, v[4 * band + q, 4 * g, i, h],
                               c[4 * band + q, 4 * g, i, h])
        out.append((vv, cc))
    return out


def serial_tile(acc_row: np.ndarray, cn: np.ndarray) -> tuple:
    """tile_min_argmin on one row of a stored tile: d = cn - 2 acc, strict
    '<' from column 0."""
    best = np.float32(cn[0] - np.float32(2.0) * acc_row[0])
    arg = 0
    for c in range(1, TILE_K):
        d = np.float32(cn[c] - np.float32(2.0) * acc_row[c])
        if d < best:
            best, arg = d, c
    return best, arg


def fold(tiles: list, bm: int, mirror: bool) -> tuple:
    """The row state after folding each tile (acc, cn) with fold_min from
    (FLT_MAX, 0): through the register epilogue or the serial scan."""
    best = [FLT_MAX] * bm
    arg = [0] * bm
    for kt, (acc, cn) in enumerate(tiles):
        got = (register_scan(acc, cn, bm) if mirror
               else [serial_tile(r, cn) for r in acc])
        for r, (v, c) in enumerate(got):
            if c >= 0 and v < best[r]:
                best[r], arg[r] = v, c + kt * TILE_K
    return np.array(best, np.float32), np.array(arg)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _tiles(kind: str, n_tiles: int, bm: int, seed: int) -> list:
    """(acc, cn) pairs: small integer products and norms, then the case's
    values."""
    rng = np.random.default_rng(seed)
    out = []
    for kt in range(n_tiles):
        acc = rng.integers(-4, 5, size=(bm, TILE_K)).astype(np.float32)
        cn = rng.integers(0, 9, size=TILE_K).astype(np.float32)
        if kind == "ties":       # equal minima within and across tiles
            acc[:, ::17] = 9.0
            cn[::17] = 0.0
        elif kind == "zeros":    # d = +0 and -0 as the minima
            cn[:] = 20.0
            acc[:] = 2.0
            cols = rng.integers(0, TILE_K, 12)
            cn[cols[:6]] = 0.0
            acc[:, cols[:6]] = 0.0         # d = 0 - 0 = +0
            cn[cols[6:]] = -0.0
            acc[:, cols[6:]] = 0.0         # d = -0 - 0 = -0
        elif kind == "infs":     # padded centroids' +inf norms, huge products
            if kt == n_tiles - 1:
                cn[TILE_K - 40:] = np.inf
            acc[::5, 3] = -np.inf          # d = +inf
            acc[7, 77] = np.float32(3e38)  # 2 acc overflows: d = -inf
        elif kind == "nans":     # NaN at column 0, elsewhere, everywhere
            acc[::3, 0] = np.nan
            acc[1::3, rng.integers(1, TILE_K, 9)] = np.nan
            acc[2::7] = np.nan
            acc[4::7, :] = -np.inf
            acc[4::7, 50] = np.nan
            cn[5] = np.inf
            acc[6::7, 5] = np.inf          # inf - 2 inf = NaN
        out.append((acc, cn))
    return out


@pytest.mark.parametrize("bm", [64, 128])
@pytest.mark.parametrize("n_tiles", [1, 2])
@pytest.mark.parametrize("kind", ["ties", "zeros", "infs", "nans"])
def test_epilogue_is_the_serial_scan(kind, n_tiles, bm):
    tiles = _tiles(kind, n_tiles, bm, seed=bm + 7 * n_tiles)
    with np.errstate(invalid="ignore", over="ignore"):
        got_v, got_c = fold(tiles, bm, mirror=True)
        want_v, want_c = fold(tiles, bm, mirror=False)
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_array_equal(_bits(got_v), _bits(want_v))
