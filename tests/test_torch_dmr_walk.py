"""The DMR update kernel's bucket walk, on the CPU.

``centroid_update_dmr`` on the card buckets each slab's rows by cluster
(a stable counting sort: a histogram per (cluster, chunk of rows), its
exclusive scan, ranks within each 32-row group in row order) and gathers
each bucket in chunks of ``WALK_CHUNK`` rows, ``WALK_GROUP`` rows at once:
the primary replica adds a group in ascending order, the shadow in
descending order. Here a numpy model of the bucketing is held to a stable
sort, a serial float32 loop in the stated order is held bit for bit to
``dmr_walk_plain`` (the walk's PyTorch statement, which ``chip_smoke.py``
holds the kernel to bit for bit on the card), and the walk is held to the
reference Pallas kernel in interpret mode and to the plain version at
rtol 1e-5 / atol 1e-4 (``tests/test_torch_dmr.py``'s tolerance: the same
f32 values in other orders), counts exact: a cluster holding every row or
half of them, empty clusters, K not a multiple of 64, M not a multiple
of ``block_m``, labels -1 and >= K, and the shadow faults of
``test_dmr_shadow_fault_flags``. Inputs are made from a seed with numpy.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.centroid_update_dmr import \
    centroid_update_dmr as j_dmr  # noqa: E402
from repro_torch.kernels import centroid_update_dmr as cud  # noqa: E402

RTOL, ATOL = 1e-5, 1e-4
HIST_ROWS = 1024        # csrc/fk_kernels.cu: kDmrHistRows


def _labels(kind: str, m: int, k: int, rng) -> np.ndarray:
    if kind == "one_cluster":
        return np.full(m, 3 % k, np.int32)
    if kind == "half_in_one":
        a = rng.integers(0, k, size=m).astype(np.int32)
        a[rng.random(m) < 0.5] = 1 % k
        return a
    if kind == "empty_clusters":          # only the even clusters
        return (2 * rng.integers(0, (k + 1) // 2, size=m)).astype(np.int32)
    if kind == "out_of_range":            # -1 (padding) and >= K
        a = rng.integers(0, k, size=m).astype(np.int32)
        a[rng.random(m) < 0.2] = -1
        a[rng.random(m) < 0.1] = k + 5
        return a
    return rng.integers(0, k, size=m).astype(np.int32)


def _bucket_positions(a: np.ndarray, k: int, slab: int,
                      hrows: int) -> np.ndarray:
    """The kernel's bucketing of one slab, modelled in numpy: each chunk of
    ``hrows`` rows counts its rows by cluster, the counts' exclusive scan
    in (cluster, chunk) order gives each chunk's first slot of a cluster,
    and each 32-row group places its rows at that slot plus their rank
    among the group's rows of the same cluster. Returns the slab's rows by
    slot."""
    valid = (a >= 0) & (a < k)
    nch = -(-slab // hrows)
    hist = np.zeros((k, nch), np.int64)
    for c in range(nch):
        rows = a[c * hrows:(c + 1) * hrows]
        rows = rows[(rows >= 0) & (rows < k)]
        hist[:, c] = np.bincount(rows, minlength=k)
    pos = (np.cumsum(hist.ravel()) - hist.ravel()).reshape(k, nch)
    out = np.full(int(valid.sum()), -1, np.int64)
    for c in range(nch):
        for g in range(c * hrows, min((c + 1) * hrows, len(a)), 32):
            grp = a[g:g + 32]
            for lane, lab in enumerate(grp):
                if not 0 <= lab < k:
                    continue
                rank = int((grp[:lane] == lab).sum())
                out[pos[lab, c] + rank] = g + lane
            for lab in set(int(v) for v in grp if 0 <= v < k):
                pos[lab, c] += int((grp == lab).sum())
    return out


@pytest.mark.parametrize("kind", ["random", "one_cluster", "half_in_one",
                                  "empty_clusters", "out_of_range"])
@pytest.mark.parametrize("slab,hrows", [(4096, 1024), (2080, 1024),
                                        (96, 96)])
def test_bucketing_is_a_stable_sort(kind, slab, hrows):
    """Whatever order the chunks run in, each bucket holds its rows in row
    order: the positions equal a stable sort of the valid rows by cluster;
    and a slab's gather items fit the kernel's capacity (slab /
    WALK_CHUNK + K)."""
    rng = np.random.default_rng(len(kind) + slab)
    k = 37
    a = _labels(kind, slab - 7, k, rng)
    got = _bucket_positions(a, k, slab, hrows)
    valid = np.nonzero((a >= 0) & (a < k))[0]
    want = valid[np.argsort(a[valid], kind="stable")]
    np.testing.assert_array_equal(got, want)
    n = np.bincount(a[valid], minlength=k)
    items = int((-(-n // cud.WALK_CHUNK)).sum())
    assert items <= -(-slab // cud.WALK_CHUNK) + k


def _serial_walk(x: np.ndarray, a: np.ndarray, k: int, block_m: int):
    """The kernel's order of float32 adds as a serial loop."""
    m, f = x.shape
    one = np.float32
    sums = np.zeros((k, f), np.float32)
    sums2 = np.zeros((k, f), np.float32)
    counts = np.zeros(k, np.int64)
    counts2 = np.zeros(k, np.int64)
    for s0 in range(0, max(m, 1), block_m):
        sa = a[s0:s0 + block_m]
        for c in range(k):
            rows = s0 + np.nonzero(sa == c)[0]
            q1 = np.zeros(f, np.float32)
            q2 = np.zeros(f, np.float32)
            for j0 in range(0, len(rows), cud.WALK_CHUNK):
                chunk = rows[j0:j0 + cud.WALK_CHUNK]
                p1 = np.zeros(f, np.float32)
                p2 = np.zeros(f, np.float32)
                for r in chunk:
                    p1 = (p1 + x[r]).astype(one)
                for g0 in range(0, len(chunk), cud.WALK_GROUP):
                    for r in chunk[g0:g0 + cud.WALK_GROUP][::-1]:
                        p2 = (p2 + x[r]).astype(one)
                q1 = (q1 + p1).astype(one)
                q2 = (q2 + p2).astype(one)
                counts2[c] += len(chunk)
            sums[c] = (sums[c] + q1).astype(one)
            sums2[c] = (sums2[c] + q2).astype(one)
            counts[c] += len(rows)
    return sums, sums2, counts, counts2


@pytest.mark.parametrize("kind", ["random", "one_cluster", "out_of_range"])
def test_walk_adds_in_the_stated_order(kind):
    """``dmr_walk_plain`` is, bit for bit, the serial loop of its
    docstring: chunks of WALK_CHUNK rows of a bucket, groups of WALK_GROUP
    reversed for the shadow, chunks then slabs in order; and the shadow's
    order really differs (its sums differ from the primary's in some bit,
    two computations, not one)."""
    rng = np.random.default_rng(11)
    m, f, k, bm = 1400, 5, 3, 1024
    x = (rng.normal(size=(m, f)) * 10.0 ** rng.integers(-3, 4, size=(m, 1))
         ).astype(np.float32)
    a = _labels(kind, m, k, rng)
    s1, s2, c1, c2 = _serial_walk(x, a, k, bm)
    got, counts, bad = cud.dmr_walk_plain(torch.from_numpy(x),
                                          torch.from_numpy(a), k, bm)
    np.testing.assert_array_equal(got.numpy(), s1)
    np.testing.assert_array_equal(counts.numpy(), c1.astype(np.float32))
    assert (c1 == c2).all() and int(bad) == 0
    assert not np.array_equal(s1, s2)


CASES = {   # name: (m, f, k, block_m, labels)
    "random": (2048, 64, 16, 1024, "random"),
    "one_cluster": (3000, 32, 8, 1024, "one_cluster"),
    "half_in_one": (2500, 32, 70, 512, "half_in_one"),
    "empty_clusters": (2048, 48, 21, 1024, "empty_clusters"),
    "k_not_64": (1536, 40, 100, 512, "random"),
    "m_ragged": (2000, 24, 13, 768, "random"),
    "out_of_range": (2100, 32, 9, 1024, "out_of_range"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_walk_matches_reference_and_plain(name):
    m, f, k, bm, kind = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    x = rng.normal(size=(m, f)).astype(np.float32)
    a = _labels(kind, m, k, rng)
    xt, at = torch.from_numpy(x), torch.from_numpy(a)
    sums, counts, bad = cud.dmr_walk_plain(xt, at, k, bm)
    ps, pc, pbad = cud.centroid_update_dmr_plain(xt, at, k, bm)
    # the reference takes M a multiple of its block: padded rows carry -1
    mp = -(-m // bm) * bm
    xp = np.pad(x, ((0, mp - m), (0, 0)))
    ap = np.pad(np.where((a >= 0) & (a < k), a, -1), (0, mp - m),
                constant_values=-1)
    js, jc, jbad = j_dmr(jnp.asarray(xp), jnp.asarray(ap), k, block_m=bm,
                         interpret=True)
    assert int(bad) == int(pbad) == int(jbad) == 0
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(counts.numpy(), pc.numpy())
    np.testing.assert_allclose(sums.numpy(), np.asarray(js), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(sums.numpy(), ps.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("fault,bad", [((0, 3, 5, 1.0), 1),
                                       ((1, 0, 127, -64.0), 1),
                                       ((1, 7, 0, 1e-6), 0)])
def test_walk_shadow_fault_flags(fault, bad):
    """``test_dmr_shadow_fault_flags``' faults on the walk: one slab's
    shadow partial moved, flagged above 1e-4 * max(max|sums|, 1), as the
    plain version flags it; the primary sums and counts stay clean."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2048, 128)).astype(np.float32)
    a = rng.integers(0, 16, size=2048).astype(np.int32)
    xt, at = torch.from_numpy(x), torch.from_numpy(a)
    clean, counts, _ = cud.dmr_walk_plain(xt, at, 16, 1024)
    sums, counts2, flag = cud.dmr_walk_plain(xt, at, 16, 1024,
                                             shadow_fault=fault)
    assert int(flag) == bad == int(cud.centroid_update_dmr_plain(
        xt, at, 16, 1024, shadow_fault=fault)[2])
    assert torch.equal(sums, clean) and torch.equal(counts, counts2)


def test_walk_fault_on_an_empty_slab_cluster_flags():
    """A fault on a (slab, cluster) with no rows still lands: the slab's
    partial is +0.0 plus the delta, as in the plain version."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2048, 16)).astype(np.float32)
    a = rng.integers(0, 4, size=2048).astype(np.int32)
    a[1024:][a[1024:] == 2] = 3                 # slab 1 has no row of 2
    fault = (1, 2, 7, 0.5)
    xt, at = torch.from_numpy(x), torch.from_numpy(a)
    assert int(cud.dmr_walk_plain(xt, at, 4, 1024, shadow_fault=fault)[2]) \
        == int(cud.centroid_update_dmr_plain(xt, at, 4, 1024,
                                             shadow_fault=fault)[2]) == 1
