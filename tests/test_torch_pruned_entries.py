"""``lloyd_step_pruned`` as a pruned-entries mode of the tile kernels.

The pruned step's update is ``lloyd_step``'s entries (one row per present
(row tile, cluster) pair, ``update.reduce_entries`` sums them), where the
first design wrote a dense (Kp, Fp) block a row tile. On the CPU:

* the entries through the tree are bit for bit the dense route's tree
  (``lloyd_step_pruned_plain``'s partials through ``tree_sum_plain``), at
  random and all-zero skip masks, f32 / bf16 / fp16, row tiles of 64 and
  128; at a zero mask they are ``lloyd_step``'s entries exactly;
* ``ops.fused_lloyd_pruned`` is bit for bit ``fused_lloyd`` over a fit's
  steps where the mask skips only losing tiles (rows sorted by cluster, so
  tiles are skipped);
* the kernels' tile bound from the register fold (a row's tile minimum
  from the lanes' scan and combine, (-inf, -1) for a NaN at the tile's
  column 0) equals the first design's ``pruned_trip_end`` rule on the
  serial scan's minimum (NaN there), for NaNs, +inf norms and padding rows.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import lloyd_step as ll  # noqa: E402
from repro_torch.kernels import lloyd_step_pruned as llp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import update as up  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_mma_loop as loop  # noqa: E402

DTYPES = ["float32", "bfloat16", "float16"]
FLT_MAX = np.float32(torch.finfo(torch.float32).max)


def _inputs(m, k, f, dtype, bm, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-3, 4, (m, f)).astype(np.float32))
    c = torch.from_numpy(rng.integers(-3, 4, (k, f)).astype(np.float32))
    params = ops.clamp_params(m, k, f, ops.KernelParams(bm, 128, 32))
    plan, cp, cn, params = ops._resolve_padded(
        ops.plan_data(x.to(getattr(torch, dtype)), params), c, params)
    mp = plan.xp.shape[0]
    xn = torch.nn.functional.pad(plan.xn, (0, mp - m)).contiguous()
    return plan, cp, cn, xn, params


@pytest.mark.parametrize("bm", [64, 128])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mask", ["random", "zero"])
def test_entries_through_the_tree_are_the_dense_route(mask, dtype, bm):
    m, k, f = 700, 300, 40
    plan, cp, cn, xn, params = _inputs(m, k, f, dtype, bm, seed=bm)
    tiles = dict(block_m=params.block_m, block_k=params.block_k,
                 block_f=params.block_f)
    nt, nkt = plan.xp.shape[0] // bm, cp.shape[0] // params.block_k
    rng = np.random.default_rng(3)
    skip = torch.from_numpy((rng.random((nt, nkt)) < 0.4).astype(np.int32))
    if mask == "zero":
        skip.zero_()
    got = llp.lloyd_step_pruned(plan.xp, cp, cn, xn, skip, m, **tiles)
    assert len(got) == 6 and got[2].shape == plan.xp.shape
    mind, am, sums_p, counts_p, tmin = llp.lloyd_step_pruned_plain(
        plan.xp, cp, cn, xn, skip, m, bm, params.block_k)
    sums, counts = up.reduce_entries(got[2], got[3], got[4], ntiles=nt)
    assert torch.equal(sums, up.tree_sum_plain(sums_p))
    assert torch.equal(counts, up.tree_sum_plain(counts_p))
    assert float(counts.sum()) == m
    for g, w in ((got[0], mind), (got[1], am), (got[5], tmin)):
        assert torch.equal(g, w)
    if mask == "zero":      # lloyd_step's entries, row for row
        one = ll.lloyd_step(plan.xp, cp, cn, m, **tiles)
        for g, w in zip(got[:5], one):
            assert torch.equal(g, w)


def _sorted_blobs(m, k, f, seed=0, sep=8.0):
    """Rows contiguous by cluster and centres in cluster order: centroid
    tiles align with row tiles, so the mask skips tiles."""
    rng = np.random.default_rng(seed)
    centers = (rng.normal(size=(k, f)) * sep).astype(np.float32)
    labels = (np.arange(m) * k) // m
    x = centers[labels] + rng.normal(size=(m, f)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(centers)


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_lloyd_pruned_is_fused_lloyd(dtype):
    """Five steps of a fit: each pruned step's labels, distances, sums and
    counts bit for bit ``fused_lloyd``'s at the same centroids, and the
    later steps skip tiles."""
    from repro_torch.core.kmeans import means_from_sums
    x, c = _sorted_blobs(1024, 384, 24)
    x = x.to(getattr(torch, dtype))
    params = ops.KernelParams(128, 128, 32)
    bounds, fracs = None, []
    for _ in range(5):
        a, md, s, n, bounds, frac = ops.fused_lloyd_pruned(
            x, c, params, bounds=bounds)
        want = ops.fused_lloyd(x, c, params)
        for g, w in zip((a, md, s, n), want):
            assert torch.equal(g, w)
        fracs.append(float(frac))
        c = means_from_sums(s, n, c)
    assert fracs[0] == 0.0 and max(fracs[1:]) > 0.0, fracs


def tmin_rule(pairs, xn, valid) -> np.float32:
    """A computed tile's bound from each row's tile minimum v: min over
    valid rows of sqrt(max(v + xn, 0)) (fmaxf: a NaN sum gives 0),
    FLT_MAX for padding rows."""
    e = [np.sqrt(np.fmax(np.float32(v + x), np.float32(0.0)))
         if ok else FLT_MAX for (v, _), x, ok in zip(pairs, xn, valid)]
    return np.float32(min(e))


@pytest.mark.parametrize("bm", [64, 128])
@pytest.mark.parametrize("kind", ["nans", "infs", "ties", "padding"])
def test_register_fold_bound_is_the_serial_rule(kind, bm):
    """The register epilogue's (value, column) per row (``loop.
    register_scan``, -inf for a NaN at the tile's column 0) through the
    bound's rule against ``pruned_trip_end``'s serial minimum (NaN there:
    both give 0 for such a row), with padding rows past ``true_m``."""
    rng = np.random.default_rng(bm)
    (acc, cn), = loop._tiles("nans" if kind == "padding" else kind, 1, bm,
                             seed=bm)
    xn = rng.integers(0, 50, bm).astype(np.float32)
    valid = np.arange(bm) < (bm - 9 if kind == "padding" else bm)
    with np.errstate(invalid="ignore", over="ignore"):
        reg = loop.register_scan(acc, cn, bm)
        ser = [loop.serial_tile(r, cn) for r in acc]
        got, want = tmin_rule(reg, xn, valid), tmin_rule(ser, xn, valid)
    assert np.float32(got).view(np.int32) == np.float32(want).view(np.int32)
    if kind in ("nans", "padding"):     # a NaN at column 0 bounds by 0
        assert got == 0.0
        rows = [r for r in range(bm) if valid[r] and np.isnan(ser[r][0])]
        assert rows and all(reg[r] == (-np.inf, -1) for r in rows)
    # the row minima themselves: the serial scan's wherever it is not NaN
    for (v, cc), (sv, sc) in zip(reg, ser):
        if not np.isnan(sv):
            assert (float(v), int(cc)) == (float(sv), int(sc))
