"""The 2-byte batched step's update as per-problem entries, on the CPU.

On the card a bf16 / fp16 ``lloyd_step_batched`` writes each problem's
entries with ``lloyd_step``'s writer (``csrc/fk_entries.cuh``): problem b's
row tile t at global tile b T + t (entry rows (b T + t) bm ..), its
clusters at idx rows b Kp .., and one tree over B Kp rows sums every
problem (``update.reduce_entries``). These tests hold that layout, built
by a plain writer written here from the labels (each present cluster of a
tile one entry, in cluster order, its rows summed in row order from +0),
and by the port's own plain layout (``update.dense_to_entries_batched``),
bit for bit to:

* ``tree_sum_plain`` over ``lloyd_step_batched_plain``'s dense partials
  (the dense route, the f32 and CPU route);
* the reference's ``lloyd_step_batched`` (Pallas, interpret mode) and its
  ``_tree_sum``, on small integers (every product and sum exact);
* each problem's single-problem entries (``lloyd_step``) alone.

Cases: B 3-7, ragged N, F 20, K 100 and 200, bf16 and fp16 inputs widened
exactly, an empty cluster and a cluster present in every row tile. A
perturbed entry must change the sums (the control).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import lloyd_step as j_ll  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.data.blobs import make_blobs  # noqa: E402
from repro_torch.kernels import lloyd_step as ll  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import update as up  # noqa: E402

F, BK, BF = 20, 128, 32
# (B, N, K, dtype, block_m)
CASES = [(3, 300, 100, "bfloat16", 64), (5, 1000, 200, "float16", 128),
         (7, 517, 100, "float16", 64), (4, 70, 200, "bfloat16", 128)]


def _stack(b, n, k, seed):
    """Small-integer rows (exact in bf16 and fp16, every sum exact): row i
    is its drawn centroid plus noise in {-1, 0, 1}; the first row of every
    64-row block is centroid 0 itself (cluster 0 lies in every row tile);
    the last centroid lies far from every row (an empty cluster)."""
    rng = np.random.default_rng(seed)
    c = rng.integers(-8, 9, size=(b, k, F)).astype(np.float32)
    c[:, k - 1] = 100.0
    lab = rng.integers(0, k - 1, size=(b, n))
    lab[:, ::64] = 0
    x = np.take_along_axis(c, lab[..., None], 1)
    noise = rng.integers(-1, 2, size=x.shape) * (rng.random(x.shape) < 0.2)
    noise[:, ::64] = 0
    return (x + noise).astype(np.float32), c


def _padded(b, n, k, dtype, bm, seed):
    x, c = _stack(b, n, k, seed)
    params = ops.KernelParams(bm, BK, BF)
    plan, cp, cn, _ = ops._resolve_padded_batched(
        torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(c),
        params)
    return plan, cp, cn


def _writer_plain(xp, am, true_m, bm, kp):
    """The per-problem entries writer, from the labels: (entries (B Np,
    Fp), ecnt (B Np,), idx (B Kp, 2**L)), the kernel's layout."""
    nb, mp, fp = xp.shape
    nt = mp // bm
    slots = up.tree_slots(nt)
    entries = torch.zeros((nb * mp, fp))
    ecnt = torch.zeros(nb * mp)
    idx = torch.full((nb * kp, 1 << up.tree_levels(nt)), -1,
                     dtype=torch.int32)
    xw = xp.float()
    for b in range(nb):
        for t in range(nt):
            rows = [r for r in range(t * bm, (t + 1) * bm) if r < true_m]
            for e, k in enumerate(sorted({int(am[b, r]) for r in rows})):
                row = (b * nt + t) * bm + e
                s = torch.zeros(fp)
                members = [r for r in rows if int(am[b, r]) == k]
                for r in members:            # row order, from +0
                    s = s + xw[b, r]
                entries[row] = s
                ecnt[row] = float(len(members))
                idx[b * kp + k, slots[t]] = row
    return entries, ecnt, idx


def _reduce(entries, ecnt, idx, nb, kp, nt):
    sums, counts = up.reduce_entries(entries, ecnt, idx, ntiles=nt)
    return sums.view(nb, kp, -1), counts.view(nb, kp)


@pytest.mark.parametrize("b,n,k,dtype,bm", CASES)
def test_writer_layout_and_tree_match_dense_and_reference(b, n, k, dtype,
                                                          bm):
    plan, cp, cn = _padded(b, n, k, dtype, bm, seed=b + n)
    nb, mp, fp = plan.xp.shape
    kp, nt = cp.shape[1], mp // bm
    tiles = dict(block_m=bm, block_k=BK, block_f=BF)
    mind, am, entries, ecnt, idx = ll.lloyd_step_batched_entries(
        plan.xp, cp, cn, n, **tiles)
    # the layout: the port's plain entries are the writer's, bit for bit
    w_ent, w_cnt, w_idx = _writer_plain(plan.xp, am, n, bm, kp)
    assert torch.equal(idx, w_idx)
    assert torch.equal(ecnt, w_cnt) and torch.equal(entries, w_ent)
    counts_k = (idx.view(nb, kp, -1) >= 0).sum(2)
    assert bool((counts_k[:, 0] == nt).all()), "cluster 0 in every tile"
    assert bool((counts_k[:, k - 1] == 0).all()), "cluster K-1 empty"
    # the tree over B Kp rows against the dense route's torch tree
    sums, counts = _reduce(entries, ecnt, idx, nb, kp, nt)
    d_min, d_am, d_sums, d_counts = ll.lloyd_step_batched_plain(
        plan.xp, cp, cn, n, bm)
    assert torch.equal(d_min, mind) and torch.equal(d_am, am)
    assert torch.equal(sums, up.tree_sum_plain(d_sums.movedim(1, 0)))
    assert torch.equal(counts, up.tree_sum_plain(d_counts.movedim(1, 0)))
    # the reference kernel and its tree, per problem (exact integers)
    jdt = getattr(jnp, dtype)
    want = j_ll.lloyd_step_batched(
        jnp.asarray(plan.xp.float().numpy()).astype(jdt),
        jnp.asarray(cp.float().numpy()).astype(jdt),
        jnp.asarray(cn.numpy()[:, None, :]), jnp.array([n], jnp.int32),
        block_m=bm, block_f=fp, interpret=True)
    np.testing.assert_array_equal(am.numpy(), np.asarray(want[1])[..., 0])
    for i in range(nb):
        np.testing.assert_array_equal(
            sums[i].numpy(), np.asarray(jops._tree_sum(want[2][i])))
        np.testing.assert_array_equal(
            counts[i].numpy(), np.asarray(jops._tree_sum(want[3][i])))


@pytest.mark.parametrize("b,n,k,dtype,bm", CASES)
def test_each_problem_is_its_single_problem_entries(b, n, k, dtype, bm):
    plan, cp, cn = _padded(b, n, k, dtype, bm, seed=3 * b + n)
    nb, mp, _ = plan.xp.shape
    kp, nt = cp.shape[1], mp // bm
    tiles = dict(block_m=bm, block_k=BK, block_f=BF)
    mind, am, entries, ecnt, idx = ll.lloyd_step_batched_entries(
        plan.xp, cp, cn, n, **tiles)
    sums, counts = _reduce(entries, ecnt, idx, nb, kp, nt)
    for i in range(nb):
        one = ll.lloyd_step(plan.xp[i], cp[i], cn[i], n, **tiles)
        rows = slice(i * mp, (i + 1) * mp)
        assert torch.equal(mind[i], one[0]) and torch.equal(am[i], one[1])
        assert torch.equal(entries[rows], one[2])
        assert torch.equal(ecnt[rows], one[3])
        own = idx[i * kp:(i + 1) * kp]
        assert torch.equal(own, torch.where(one[4] >= 0, one[4] + i * mp,
                                            -1))
        s1, c1 = up.reduce_entries(one[2], one[3], one[4], ntiles=nt)
        assert torch.equal(sums[i], s1) and torch.equal(counts[i], c1)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("k", [100, 200])
def test_entries_route_is_bitwise_the_dense_route_on_blobs(dtype, k):
    """On blob rows (sums inexact, order-dependent) the entries route
    through ``ops.fused_lloyd_batched`` gives the dense route's bits; a
    perturbed entry does not."""
    b, n = 4, 1001
    x = np.stack([make_blobs(n, F, k, seed=i)[0] for i in range(b)])
    c = (np.random.default_rng(5).normal(size=(b, k, F)) * 10.0).astype(
        np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    params = ops.KernelParams(128, BK, BF)
    dense = ops.fused_lloyd_batched(xt, torch.from_numpy(c), params)
    route = ops._batched_writes_entries
    try:
        ops._batched_writes_entries = lambda xp: True
        got = ops.fused_lloyd_batched(xt, torch.from_numpy(c), params)
    finally:
        ops._batched_writes_entries = route
    for g, w in zip(got, dense):
        assert torch.equal(g, w)
    # control: one present entry moved by 1.0 changes that cluster's sum
    plan, cp, cn, _ = ops._resolve_padded_batched(xt, torch.from_numpy(c),
                                                  params)
    mp, kp = plan.xp.shape[1], cp.shape[1]
    out = ll.lloyd_step_batched_entries(plan.xp, cp, cn, n, block_m=128,
                                        block_k=BK, block_f=BF)
    entries, ecnt, idx = out[2:]
    sums, _ = _reduce(entries, ecnt, idx, b, kp, mp // 128)
    kk = int((idx[2 * kp:3 * kp] >= 0).sum(1).argmax())
    row = int(idx[2 * kp + kk][idx[2 * kp + kk] >= 0][0])
    entries[row, 0] += 1.0
    moved, _ = _reduce(entries, ecnt, idx, b, kp, mp // 128)
    assert not torch.equal(moved[2, kk], sums[2, kk])
    assert torch.equal(moved[:2], sums[:2]) and torch.equal(moved[3:],
                                                            sums[3:])


def test_entries_on_the_cpu_widen_exactly_and_launch_nothing():
    """On the CPU the entries wrapper runs the plain route at any dtype: a
    2-byte stack and its exact f32 widening give the same entries, and no
    kernel launch is counted."""
    plan, cp, cn = _padded(3, 300, 100, "bfloat16", 64, seed=1)
    before = ll.lloyd_step_batched_entries.launches
    tiles = dict(block_m=64, block_k=BK, block_f=BF)
    wide = ll.lloyd_step_batched_entries(plan.xp.float(), cp.float(), cn,
                                         300, **tiles)
    low = ll.lloyd_step_batched_entries(plan.xp, cp, cn, 300, **tiles)
    for g, w in zip(wide, low):
        assert torch.equal(g, w)
    assert ll.lloyd_step_batched_entries.launches == before
