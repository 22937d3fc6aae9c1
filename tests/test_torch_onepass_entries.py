"""The one-pass steps' update as entries, on the CPU, held to the dense
route and to the reference.

``lloyd_step`` and ``lloyd_step_ft`` emit their update in
``update.update_entries``' layout (one row per present (row tile, cluster)
pair, ``idx`` pointing at it), summed by ``update.reduce_entries``; on the
CPU the wrappers build it from the dense plain specification, so these
tests run the verify-over-entries, the one-tile recompute and the tree the
card runs. Held to:

* the port's dense route (``lloyd_step_plain``'s per-tile blocks, then
  ``update.tree_sum_plain``): sums and counts bit for bit;
* the reference (``repro.kernels.ops`` in interpret mode, numpy inputs
  from a seed): labels and counts equal, sums to rtol 1e-5 of the largest
  (the two packages sum f32 products in different orders);
* for each update-fault case (a present (tile, cluster) pair, an absent
  one, a padded cluster row, a distance fault, both slots), the detection
  count equals the dense route's and the reference's, and the corrected
  sums equal the clean ones bit for bit;
* the entries-form verification flags the tiles the dense one flags;
* a failing control: two leaves swapped change the bits.
"""
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import lloyd_step_ft as j_llft  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.data.blobs import make_blobs  # noqa: E402
from repro_torch.kernels import distance_argmin_ft as daft  # noqa: E402
from repro_torch.kernels import lloyd_step as ll  # noqa: E402
from repro_torch.kernels import lloyd_step_ft as llft  # noqa: E402
from repro_torch.kernels import ops, update as up  # noqa: E402
from repro_torch.kernels.matmul_abft import encoding_scales  # noqa: E402

DTYPES = ["float32", "bfloat16", "float16"]
NP_DTYPES = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16,
             "float16": np.float16}
M, K, F = 300, 150, 40           # ragged: 3 / 5 row tiles, 2 centroid tiles
RTOL = 1e-5


def _labels_case(case: str, seed: int = 4):
    """(x (M, F), c (K, F)) f32 whose nearest centroids give the case's
    labels: blobs (the kernel's own spread), one (every row nearest
    centroid 0) or skewed (half the rows on centroid 3, the rest on a few)."""
    rng = np.random.default_rng(seed)
    x, _ = make_blobs(M, F, 6, seed=seed)
    if case == "blobs":
        c = x[rng.choice(M, K, replace=False)] + rng.normal(size=(K, F))
        return x, c.astype(np.float32)
    c = (rng.normal(size=(K, F)) * 50.0 + 400.0).astype(np.float32)
    if case == "one":
        c[0] = x.mean(0)
        return x, c
    few = x[rng.choice(M, 4, replace=False)]
    c[[3, 40, 77, 140]] = few
    x = few[rng.integers(1, 4, M)] + rng.normal(size=(M, F)) * 0.1
    x[rng.random(M) < 0.5] = few[0]
    return x.astype(np.float32), c


def _both(x, c, bm, dtype):
    lo = x.astype(NP_DTYPES[dtype])
    tx = torch.from_numpy(lo.astype(np.float32)).to(getattr(torch, dtype))
    return (tx, torch.from_numpy(c), ops.KernelParams(bm, 128, 32), lo, c,
            jops.KernelParams(bm, 128, 32))


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=RTOL * max(np.abs(b).max(), 1.0))


def _dense_route(tx, tc, p):
    """The dense specification at the padded shapes: per-tile blocks, then
    the torch halving tree."""
    plan, cp, cn, _ = ops._resolve_padded(tx, tc, p)
    _, am, sums_p, counts_p = ll.lloyd_step_plain(plan.xp, cp, cn, plan.m,
                                                  p.block_m)
    k = tc.shape[0]
    return (am[:plan.m], up.tree_sum_plain(sums_p)[:k, :plan.f],
            up.tree_sum_plain(counts_p)[:k])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bm", [64, 128])
@pytest.mark.parametrize("case", ["blobs", "one", "skewed"])
def test_entries_route_is_dense_route_and_reference(case, bm, dtype):
    x, c = _labels_case(case)
    tx, tc, p, jx, jc, jp = _both(x, c, bm, dtype)
    am, _, sums, counts = ops.fused_lloyd(tx, tc, p)
    d_am, d_sums, d_counts = _dense_route(tx, tc, p)
    assert torch.equal(am, d_am)
    assert torch.equal(sums, d_sums) and torch.equal(counts, d_counts)
    ft = ops.fused_lloyd_ft(tx, tc, p)
    assert int(ft[4]) == 0 and torch.equal(ft[0], am)
    assert torch.equal(ft[2], sums) and torch.equal(ft[3], counts)
    jam, _, jsums, jcounts = jops.fused_lloyd(jx, jc, jp, interpret=True)
    np.testing.assert_array_equal(am.numpy(), np.asarray(jam))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    _close(sums.numpy(), jsums)
    if case == "one":
        assert int((counts > 0).sum()) == 1


def _fault_cases(am, bm, kp):
    """The tentpole's injection cases on row tile 1 of the clean labels."""
    tile = am[bm:2 * bm]
    absent = next(k for k in range(K) if k not in tile)
    return {
        "present": {"update": (1, tile[5], 7, 2.0 ** 19)},
        "absent": {"update": (1, absent, 3, -2.0 ** 20)},
        "padded": {"update": (1, kp - 1, 11, 2.0 ** 21)},
        "distance": {"distance": (2, 1, 0, 17, 100, 2.0 ** 21)},
        "both": {"distance": (0, 0, 0, 4, 3, -2.0 ** 22),
                 "update": (1, absent, 0, 2.0 ** 22)},
    }


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["present", "absent", "padded", "distance",
                                  "both"])
def test_fault_cases_match_dense_route_and_reference(name, dtype):
    x, c = _labels_case("blobs")
    tx, tc, p, jx, jc, jp = _both(x, c, 128, dtype)
    clean = ops.fused_lloyd_ft(tx, tc, p)
    slots = _fault_cases(clean[0].tolist(), 128, 256)[name]
    inj = llft.make_injection(**slots)
    jinj = j_llft.make_injection(**slots)
    np.testing.assert_array_equal(inj.numpy(), np.asarray(jinj))
    hit = ops.fused_lloyd_ft(tx, tc, p, inj=inj)
    plan, cp, cn, _ = ops._resolve_padded(tx, tc, p)
    dense = llft.lloyd_ft_dense_plain(
        plan.xp, cp, cn, inj, plan.m, 128, 128, 32,
        ops.threshold_factor(plan.xp.shape[1], plan.xp.dtype),
        ops.threshold_factor(128, plan.xp.dtype))
    jhit = jops.fused_lloyd_ft(jx, jc, jp, inj=jinj, interpret=True)
    assert int(hit[4]) == int(dense[2]) == int(jhit[4]) == len(slots)
    for a, b in zip(hit[:4], clean[:4]):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(hit[0].numpy(), np.asarray(jhit[0]))
    _close(hit[2].numpy(), jhit[2])


@pytest.mark.parametrize("name", ["clean", "present", "absent", "padded",
                                  "under"])
def test_entries_verify_flags_dense_verify_tiles(name):
    """Without the recompute: the tiles the checksums of the keyed entries
    flag are the tiles the dense blocks' flag (a fault under the threshold
    flags neither)."""
    x, c = _labels_case("blobs")
    tx, tc, p, *_ = _both(x, c, 64, "float32")
    plan, cp, cn, _ = ops._resolve_padded(tx, tc, p)
    factor = ops.threshold_factor(plan.xp.shape[1], torch.float32)
    clean = ll.lloyd_step(plan.xp, cp, cn, plan.m, block_m=64, block_k=128,
                          block_f=32)[1]
    cases = _fault_cases(clean.tolist(), 64, 256)
    cases["under"] = {"update": (2, 9, 5, 1e-3)}
    slots = {} if name == "clean" else cases[name]
    inj = llft.make_injection(**slots)
    out = llft.lloyd_step_ft(plan.xp, cp, cn, inj, plan.m, block_m=64,
                             block_k=128, block_f=32, factor=factor)
    dense = llft.lloyd_step_ft_plain(plan.xp, cp, cn, inj, plan.m, 64, 128,
                                     32, factor)
    ufactor = ops.threshold_factor(64, torch.float32)
    bad_e = llft.update_mismatch(llft.entries_observed(*out[3:5], *out[6:8],
                                                       64),
                                 out[8], out[9], ufactor)
    bad_d = llft.update_mismatch(llft.dense_observed(dense[3], dense[4]),
                                 dense[5], dense[6], ufactor)
    assert torch.equal(bad_e, bad_d)
    assert int(bad_e.sum()) == (0 if name in ("clean", "under") else 1)
    n_bad, worst = llft.verify_entries(*out[3:5], *out[6:10], block_m=64,
                                       factor=ufactor)
    assert int(n_bad) == int(bad_e.sum())
    if int(n_bad):
        assert int(worst) == int(bad_e.int().argmax())
    if name in ("absent", "padded"):
        k = slots["update"][1]
        assert out[7].tolist() == [1, k] and int(out[6][-1]) == k
        assert int(out[5][k, int(up.tree_slots(plan.xp.shape[0] // 64)[1])]
                   ) == plan.xp.shape[0]


def test_keyed_layout_and_one_tile_recompute():
    """lloyd_step_ft's keyed entries: each tile's rows past its last entry
    are zeros with key -1; update_entries of one tile rewrites it and its
    idx column (dropping a spare row the column pointed at), and a closed
    gate writes nothing."""
    x, c = _labels_case("skewed")
    tx, tc, p, *_ = _both(x, c, 64, "bfloat16")
    plan, cp, cn, _ = ops._resolve_padded(tx, tc, p)
    mp = plan.xp.shape[0]
    factor = ops.threshold_factor(plan.xp.shape[1], plan.xp.dtype)
    run = dict(block_m=64, block_k=128, block_f=32, factor=factor)
    clean = llft.lloyd_step_ft(plan.xp, cp, cn, llft.no_injection(), plan.m,
                               **run)
    ent, ecnt, idx, ekey, spare = clean[3:8]
    unused = ekey[:mp] < 0
    assert bool((ent[:mp][unused] == 0).all()) and bool(
        (ecnt[:mp][unused] == 0).all())
    assert spare.tolist() == [-1, -1]
    assert int((~unused).sum()) == int((idx >= 0).sum())
    absent = next(k for k in range(K)
                  if k not in clean[1][64:128].tolist())
    inj = llft.make_injection(update=(1, absent, 2, 2.0 ** 20))
    hit = list(llft.lloyd_step_ft(plan.xp, cp, cn, inj, plan.m, **run))
    assert not torch.equal(hit[5], idx)
    out = (hit[3], hit[4], hit[5])
    for gate in (0, 1):
        up.update_entries(plan.xp, hit[1], cp.shape[0], true_m=plan.m,
                          block_m=64, tile=torch.tensor(1, dtype=torch.int32),
                          gate=torch.tensor(gate, dtype=torch.int32),
                          out=out, ekey=hit[6])
        assert torch.equal(hit[5], idx) == bool(gate)
    assert torch.equal(hit[3][:mp], ent[:mp]) and torch.equal(hit[6][:mp],
                                                              ekey[:mp])


@pytest.mark.parametrize("dtype", DTYPES)
def test_swapped_leaves_change_the_bits(dtype):
    """Control: two tiles' leaves of the busiest cluster swapped in idx give
    the torch tree's bits on the swapped dense blocks, not the unswapped
    result (rows scaled over 23 binades, so the order decides)."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(1100, F)) * np.exp2(rng.integers(-14, 9, (1100, 1)))
    tx = torch.from_numpy(x.astype(np.float32)).to(getattr(torch, dtype))
    c = torch.zeros(3, F)
    c[1:] = 1e4
    plan, cp, cn, _ = ops._resolve_padded(tx, c, ops.KernelParams(64, 128,
                                                                  32))
    nt = plan.xp.shape[0] // 64
    _, am, ent, ecnt, idx = ll.lloyd_step(plan.xp, cp, cn, plan.m,
                                          block_m=64, block_k=128, block_f=32)
    base = up.reduce_entries(ent, ecnt, idx, ntiles=nt)[0]
    _, _, sums_p, _ = ll.lloyd_step_plain(plan.xp, cp, cn, plan.m, 64)
    assert torch.equal(base, up.tree_sum_plain(sums_p))
    slots = (idx[0] >= 0).nonzero().squeeze(1)
    first, last = int(slots[0]), int(slots[-1])
    swapped = idx.clone()
    swapped[0, first], swapped[0, last] = idx[0, last], idx[0, first]
    got = up.reduce_entries(ent, ecnt, swapped, ntiles=nt)[0]
    t_f, t_l = int(idx[0, first]) // 64, int(idx[0, last]) // 64
    sums_p[[t_f, t_l]] = sums_p[[t_l, t_f]]
    assert torch.equal(got[0], up.tree_sum_plain(sums_p)[0])
    assert not torch.equal(got[0], base[0])


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_centroid_encodings_split(dtype):
    """The 2-byte FT kernels' C encodings: per 128-row tile, e1 = sum_j C[j]
    and e2 = sum_j (j + 1) C[j] (f32, in j order), scaled down by the
    ABFT GEMM's powers of two (7 and 14 at 128 rows) and split into three
    parts that add back to the f32 value within 2^-20 of it; rows 6-7 zero."""
    rng = np.random.default_rng(2)
    c = torch.from_numpy(rng.normal(size=(256, 64)).astype(np.float32) * 300)
    c = c.to(getattr(torch, dtype))
    enc = daft.encode_centroids(c).float()
    assert enc.shape == (2, 8, 64) and bool((enc[:, 6:] == 0).all())
    assert encoding_scales(128) == (7, 14)
    cv = c.double().view(2, 128, 64)
    w = torch.arange(1, 129, dtype=torch.float64)[None, :, None]
    for rows, want, s in ((slice(0, 3), cv.sum(1), 7),
                          (slice(3, 6), (w * cv).sum(1), 14)):
        got = enc[:, rows].double().sum(1) * 2.0 ** s
        assert bool(((got - want).abs() <= 2.0 ** -20 * want.abs().max()
                     ).all())
