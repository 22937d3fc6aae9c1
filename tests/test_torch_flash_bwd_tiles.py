"""The attention backward kernels' tiles and walks, on the CPU.

``csrc/fk_attention_bwd.cu``'s dK / dV kernel takes blocks of
``BWD_BLOCK`` keys, two warpgroups of ``BWD_ROWS`` keys each, and walks
query tiles of ``BWD_TILE`` rows; its dQ kernel takes blocks of
``BWD_BLOCK`` query rows, ``BWD_ROWS`` a warpgroup, and walks KV tiles of
``BWD_TILE`` keys. The producer skips a step that ``live_tiles`` calls
DEAD for the whole block; each warpgroup skips a step DEAD for its own rows
and leaves the mask out of a FULL one. Held here: the constants are the
source's; at those sizes ``live_tiles`` never calls DEAD a tile that holds
a valid pair and calls FULL only tiles whose pairs are all valid (against
``position_mask``, over seeded random positions with holes, windows,
causal or not, ragged Sq / Skv); the kernels' two-level walk, written in
plain PyTorch below, gives ``flash_attention_backward_plain``'s gradient;
the CPU route of ``flash_attention_backward`` is the plain version; the
wrapper names, counters and entry points ``chip_smoke.py`` reads exist.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

SRC = Path(fa.__file__).resolve().parent.parent / "csrc" / \
    "fk_attention_bwd.cu"
BLOCK, ROWS, TILE = fa.BWD_BLOCK, fa.BWD_ROWS, fa.BWD_TILE
# (query rows, keys) of each classification the kernels make
SIZES = {"dkdv_producer": (TILE, BLOCK), "dkdv_warpgroup": (TILE, ROWS),
         "dq_producer": (BLOCK, TILE), "dq_warpgroup": (ROWS, TILE)}
RTOL = 2e-5        # x max|grad|: f32 sums in another order


def _positions(seed: int):
    """Seeded (qpos, kpos, causal, window): ragged lengths, shuffled or
    shifted positions, query and key holes."""
    rng = np.random.default_rng(seed)
    sq = int(rng.integers(1, 300))
    skv = int(rng.integers(1, 400))
    kpos = np.arange(skv) + int(rng.integers(-20, 20))
    if rng.random() < 0.3:
        rng.shuffle(kpos)
    kpos[rng.random(skv) < rng.choice([0.0, 0.05, 0.5])] = -1
    qpos = np.sort(rng.integers(-10, skv + 20, size=sq))
    qpos[rng.random(sq) < 0.05] = -7
    causal = bool(rng.random() < 0.7)
    window = int(rng.choice([0, 0, 5, 64, 130]))
    return (torch.from_numpy(qpos.astype(np.int32)),
            torch.from_numpy(kpos.astype(np.int32)), causal, window)


def test_tiles_are_the_sources():
    text = SRC.read_text()
    got = {n: int(re.search(rf"constexpr int {n} = (\d+);", text)[1])
           for n in ("kBlock", "kRows", "kTile")}
    assert got == {"kBlock": BLOCK, "kRows": ROWS, "kTile": TILE}
    assert BLOCK == 2 * ROWS                     # two consumer warpgroups


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("size", sorted(SIZES))
def test_tile_rule_is_sound(size, seed):
    bq, bk = SIZES[size]
    qpos, kpos, causal, window = _positions(seed)
    cls = fa.live_tiles(qpos, kpos, bq, bk, causal, window)
    sq, skv = qpos.shape[0], kpos.shape[0]
    mask = fa.position_mask(qpos, kpos, causal, window).expand(sq, skv)
    nq, nk = -(-sq // bq), -(-skv // bk)
    assert tuple(cls.shape) == (nq, nk)
    for i in range(nq):
        for j in range(nk):
            tile = mask[i * bq:(i + 1) * bq, j * bk:(j + 1) * bk]
            if cls[i, j] == fa.DEAD:
                assert not tile.any(), (i, j)
            if cls[i, j] == fa.FULL:
                assert tile.shape[1] == bk and tile.all(), (i, j)


def _inputs(seed: int):
    qpos, kpos, causal, window = _positions(seed)
    rng = np.random.default_rng(100 + seed)
    b, kv, g, hd = 1, 2, int(rng.choice([1, 2, 3])), 8
    sq, skv = qpos.shape[0], kpos.shape[0]
    q, do = (torch.from_numpy(rng.normal(size=(b, kv * g, sq, hd))
                              .astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(b, kv, skv, hd))
                             .astype(np.float32)) for _ in range(2))
    out = fa.flash_attention_plain(q, k, v, qpos, kpos, causal=causal,
                                   window=window, zero_empty_rows=True)
    lse = fa.flash_lse_plain(q, k, qpos, kpos, causal=causal, window=window)
    return q, k, v, out, do, lse, qpos, kpos, causal, window


def _step(q, k, v, do, lse, dsum, mask, qs, ks, cls):
    """P and dS of the (query rows qs, keys ks) step of one (batch, head):
    masked only when LIVE, as the kernels do."""
    s = q[qs] @ k[ks].T
    p = torch.exp(s - lse[qs, None])
    if cls == fa.LIVE:
        p = torch.where(mask[qs, ks], p, 0.0)
    return p, p * (do[qs] @ v[ks].T - dsum[qs, None])


def _walk(q, k, v, out, do, lse, qpos, kpos, causal, window):
    """The two kernels' walks in plain PyTorch, f32: the dK / dV kernel's
    blocks over the group's heads and the query tiles live for the block,
    each warpgroup skipping or unmasking by its own class; the dQ kernel's
    blocks over the KV tiles live for the block, the same per warpgroup."""
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    g = h // kvh
    mask = fa.position_mask(qpos, kpos, causal, window).expand(sq, skv)
    dsum = (do * out).sum(-1)
    cls = {n: fa.live_tiles(qpos, kpos, *SIZES[n], causal, window)
           for n in SIZES}
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for bi in range(b):
        for kh in range(kvh):
            for kb in range(-(-skv // BLOCK)):
                for qt in range(-(-sq // TILE)):
                    if cls["dkdv_producer"][qt, kb] == fa.DEAD:
                        continue
                    qs = slice(qt * TILE, (qt + 1) * TILE)
                    for j in range(g):
                        hh = kh * g + j
                        for w in range(BLOCK // ROWS):
                            c = cls["dkdv_warpgroup"][qt, kb * 2 + w] \
                                if kb * 2 + w < cls["dkdv_warpgroup"].shape[1] \
                                else fa.DEAD
                            if c == fa.DEAD:
                                continue
                            ks = slice(kb * BLOCK + w * ROWS,
                                       kb * BLOCK + (w + 1) * ROWS)
                            p, ds = _step(q[bi, hh], k[bi, kh], v[bi, kh],
                                          do[bi, hh], lse[bi, hh], dsum[bi, hh],
                                          mask, qs, ks, c)
                            dv[bi, kh, ks] += p.T @ do[bi, hh, qs]
                            dk[bi, kh, ks] += ds.T @ q[bi, hh, qs]
        for hh in range(h):
            kh = hh // g
            for qb in range(-(-sq // BLOCK)):
                for t in range(-(-skv // TILE)):
                    if cls["dq_producer"][qb, t] == fa.DEAD:
                        continue
                    ks = slice(t * TILE, (t + 1) * TILE)
                    for w in range(BLOCK // ROWS):
                        if qb * 2 + w >= cls["dq_warpgroup"].shape[0]:
                            continue
                        c = cls["dq_warpgroup"][qb * 2 + w, t]
                        if c == fa.DEAD:
                            continue
                        qs = slice(qb * BLOCK + w * ROWS,
                                   qb * BLOCK + (w + 1) * ROWS)
                        _, ds = _step(q[bi, hh], k[bi, kh], v[bi, kh],
                                      do[bi, hh], lse[bi, hh], dsum[bi, hh],
                                      mask, qs, ks, c)
                        dq[bi, hh, qs] += ds @ k[bi, kh, ks]
    return dq, dk, dv


@pytest.mark.parametrize("seed", range(8))
def test_walk_gives_the_plain_gradient(seed):
    q, k, v, out, do, lse, qpos, kpos, causal, window = _inputs(seed)
    got = _walk(q, k, v, out, do, lse, qpos, kpos, causal, window)
    want = fa.flash_attention_backward_plain(q, k, v, out, do, lse, qpos,
                                             kpos, causal=causal,
                                             window=window)
    for name, a, w in zip("qkv", got, want):
        bar = RTOL * max(float(w.abs().max()), 1e-30)
        assert float((a - w).abs().max()) <= bar, f"d{name}"


@pytest.mark.parametrize("seed", range(3))
def test_cpu_route_is_the_plain_version(seed):
    q, k, v, out, do, lse, qpos, kpos, causal, window = _inputs(seed)
    got = fa.flash_attention_backward(q, k, v, out, do, lse, qpos, kpos,
                                      causal=causal, window=window)
    want = fa.flash_attention_backward_plain(q, k, v, out, do, lse, qpos,
                                             kpos, causal=causal,
                                             window=window)
    for a, w in zip(got, want):
        assert torch.equal(a, w)


def test_names_chip_smoke_reads():
    for name in ("flash_bwd_prep", "flash_bwd_dkdv", "flash_bwd_dq"):
        assert isinstance(getattr(fa, name).launches, int)
    assert set(_build.SOURCES["fk_attention_bwd"]) == {
        "fk_flash_bwd_prep", "fk_flash_bwd_dkdv", "fk_flash_bwd_dq",
        "fk_flash_bwd_resources"}
    assert callable(fa.bwd_resources)
    assert fa.GRAD_MAX_HEAD_DIM == 256
    text = SRC.read_text()
    for kernel in ("flash_bwd_prep_kernel", "flash_bwd_dkdv_kernel",
                   "flash_bwd_dq_kernel"):
        assert f"\n{kernel}(" in text
