"""The compact two-pass update and the fixed-order tree sum, on the CPU.

* the sparse tree (present leaves only, a node with one present child being
  that child) equals ``ops._tree_sum`` over the dense zero-filled leaves bit
  for bit, for 1-70, 513, 1024 and 8193 leaves, on values whose sum depends
  on the order; a tree of adjacent pairs over the leaves does not;
* the slots (``update.tree_slots``) lay the halving tree out as the perfect
  tree of adjacent pairs; a mirror of the kernel's slot-to-leaf walk and
  of its chunked shift-reduce passes gives the same bits;
* ``update.update_plain`` (the update's specification) and the compact
  route on the CPU (``update.compact_update``) equal ``_tree_sum`` over
  ``tile_update_plain``'s partials bit for bit: labels in random order,
  sorted, skewed and all in one cluster, padding rows, row tiles of 64 and
  128, one and several centroid tiles, X in f32, bf16 and fp16;
* the tree over a stack of problems' partials at the problem stride equals
  the ``movedim`` route;
* ``ops.tiled_update`` (with and without DMR) agrees with the reference's
  ``protected_sums``: counts equal, sums within rtol 1e-5 (atol 1e-4: the
  reference sums by a one-hot product, in another order).

Inputs come from numpy seeds.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import kmeans as j_kmeans  # noqa: E402
from repro_torch.kernels import lloyd_step as ll  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import update as up  # noqa: E402

TREE_SIZES = list(range(1, 71)) + [513, 1024, 8193]


def _order_sensitive(rng, shape):
    """Values over six decades, so that regrouping a sum moves its bits."""
    mag = 10.0 ** rng.integers(-3, 4, size=shape)
    return (rng.standard_normal(shape) * mag).astype(np.float32)


def _leaves(n, width=3, share=0.3, seed=0):
    rng = np.random.default_rng(seed + n)
    vals = torch.from_numpy(_order_sensitive(rng, (n, width)))
    present = torch.from_numpy(rng.random(n) < share)
    present[rng.integers(n)] = True
    return vals, present


def _pair_tree_of_leaves(vals, leaf, n):
    """Adjacent pairs over the leaves as they are numbered (the control)."""
    return up.pair_tree_plain(vals, leaf, torch.zeros_like(leaf),
                              up.tree_levels(n), 1)[0]


# --- the sparse tree ---------------------------------------------------------

@pytest.mark.parametrize("n", TREE_SIZES)
def test_sparse_tree_is_dense_tree_bitwise(n):
    vals, present = _leaves(n)
    want = ops._tree_sum(torch.where(present[:, None], vals, 0.0))
    leaf = present.nonzero().squeeze(1)
    got = up.sparse_tree_plain(vals[leaf], leaf, torch.zeros_like(leaf), n, 1)
    assert torch.equal(got[0], want)
    slots = up.tree_slots(n)[leaf]
    assert torch.equal(up.pair_tree_plain(vals[leaf], slots,
                                          torch.zeros_like(leaf),
                                          up.tree_levels(n), 1)[0], want)


@pytest.mark.parametrize("n", [6, 13, 70, 513, 1024, 8193])
def test_adjacent_pairs_tree_differs(n):
    """Control: the same leaves in adjacent pairs (the slot layout left out)
    give other bits, so the bitwise checks above can fail."""
    vals, present = _leaves(n, width=16, share=1.0)
    want = ops._tree_sum(vals)
    leaf = torch.arange(n)
    assert not torch.equal(_pair_tree_of_leaves(vals, leaf, n), want)


def test_sparse_tree_groups_and_empty_groups():
    """Groups reduce apart; a group without entries is +0.0."""
    rng = np.random.default_rng(3)
    n, groups = 37, 5
    leaf = torch.from_numpy(np.concatenate(       # group 4 stays empty
        [rng.choice(n, size=n // 2 + g, replace=False) for g in range(4)]))
    group = torch.cat([torch.full((n // 2 + g,), g) for g in range(4)])
    vals = torch.from_numpy(_order_sensitive(rng, (len(leaf), 2)))
    order = torch.from_numpy(rng.permutation(len(leaf)))
    vals, leaf, group = vals[order], leaf[order], group[order]
    got = up.sparse_tree_plain(vals, leaf, group, n, groups)
    for g in range(4):
        dense = torch.zeros(n, 2)
        dense[leaf[group == g]] = vals[group == g]
        assert torch.equal(got[g], ops._tree_sum(dense))
    assert torch.equal(got[4], torch.zeros(2))
    assert not torch.signbit(got[4]).any()


# --- the slot layout and the kernel's walk -----------------------------------

def _tree_leaf(slot, n, levels):
    """Mirror of fk_update.cu's tree_leaf: the leaf at a slot, or -1."""
    i = 0
    for level in range(levels - 1, -1, -1):
        half = (((n - 1) >> level) + 1) // 2
        bit = (slot >> level) & 1
        if i < half:
            i += bit * half
        elif bit:
            return -1
        else:
            i = 2 * half
    return i


@pytest.mark.parametrize("n", [1, 2, 3, 5, 7, 12, 33, 70, 513, 1024, 1025])
def test_slots_are_a_bijection(n):
    levels = up.tree_levels(n)
    slots = up.tree_slots(n)
    assert int(slots.max()) < 1 << levels
    assert len(set(slots.tolist())) == n
    leaf = [_tree_leaf(s, n, levels) for s in range(1 << levels)]
    assert sum(t >= 0 for t in leaf) == n
    assert all(leaf[int(s)] == t for t, s in enumerate(slots))


def _walk(slot_vals):
    """Mirror of tree_reduce_kernel's walk over one chunk: (slot, value)
    pairs in slot order, combined with the shift-reduce stack."""
    stack, pending, cur, prev = {}, 0, None, None
    for slot, v in slot_vals:
        if prev is not None:
            h = (slot ^ prev).bit_length() - 1
            below = pending & ((1 << h) - 1)
            while below:
                level = (below & -below).bit_length() - 1
                cur = stack[level] + cur
                below &= below - 1
            pending = (pending & ~((1 << h) - 1)) | (1 << h)
            stack[h] = cur
        cur, prev = v, slot
    while pending:
        level = (pending & -pending).bit_length() - 1
        cur = stack[level] + cur
        pending &= pending - 1
    return cur


def _kernel_passes(leaves, chunk_log2s):
    """The chunked passes of tree_passes, each chunk by ``_walk``: leaves is
    {slot: value} over 2**L slots; each pass's chunk size is given."""
    level_nodes = leaves
    for c in chunk_log2s:
        nxt = {}
        for chunk in sorted({s >> c for s in level_nodes}):
            members = sorted((s, v) for s, v in level_nodes.items()
                             if s >> c == chunk)
            nxt[chunk] = _walk(members)
        level_nodes = nxt
    assert set(level_nodes) <= {0}
    return level_nodes.get(0)


@pytest.mark.parametrize("n,chunks", [(1, [0]), (2, [1]), (5, [1, 1, 1]),
                                      (17, [2, 3]), (64, [3, 3]),
                                      (70, [5, 2]), (513, [4, 3, 3]),
                                      (1024, [8, 2])])
def test_kernel_walk_is_the_tree(n, chunks):
    """The kernel's order (slots, chunks as aligned subtrees, shift-reduce
    within a chunk) reproduces _tree_sum bit for bit."""
    vals, present = _leaves(n, width=4, share=0.4, seed=11)
    assert sum(chunks) == up.tree_levels(n)
    slots = up.tree_slots(n)
    leaves = {int(slots[t]): vals[t] for t in range(n) if present[t]}
    want = ops._tree_sum(torch.where(present[:, None], vals, 0.0))
    assert torch.equal(_kernel_passes(leaves, chunks), want)


def test_chunk_plan():
    """Passes split finer only for parallelism, never below 2**5 slots or
    past a chunk of 2**8, and always end in one chunk."""
    assert up._chunk_log2(1, 1, 128) == 0
    assert up._chunk_log2(8192, 1 << 20, 128) == up.MAX_CHUNK_LOG2
    assert up._chunk_log2(8192, 1, 128) == up.MIN_CHUNK_LOG2
    assert up._chunk_log2(16, 1, 32) == 4
    assert up._chunk_log2(8192, 1024, 32) == 8   # 32 chunks x 1024 blocks


# --- the update --------------------------------------------------------------

LABELS = ("random", "sorted", "skewed", "one")


def _labels(kind, m, k, rng):
    if kind == "random":
        return rng.integers(0, k, m)
    if kind == "sorted":
        return np.sort(rng.integers(0, k, m))
    if kind == "skewed":
        # one cluster holds half the rows, 90 % of the clusters stay empty
        few = rng.choice(k, size=max(k // 10, 2), replace=False)
        out = rng.choice(few[1:], size=m)
        out[rng.random(m) < 0.5] = few[0]
        return out
    return np.full(m, k - 1)


def _update_case(kind, block_m, k, dtype, m=1000, f=40, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(_order_sensitive(rng, (m, f))).to(dtype)
    p = ops.clamp_params(m, k, f, ops.KernelParams(block_m, 128, 32))
    plan = ops.plan_data(x, p)
    mp, fp = plan.xp.shape
    am = torch.from_numpy(_labels(kind, m, k, rng).astype(np.int32))
    amp = torch.nn.functional.pad(am, (0, mp - m))
    nt, kp = mp // p.block_m, -(-k // p.block_k) * p.block_k
    rows = torch.arange(mp).view(nt, p.block_m)
    tiles = (plan.xp.view(nt, p.block_m, fp), amp.view(nt, p.block_m),
             rows < m, kp)
    return plan, am, amp, kp, tiles


DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16", "fp16"])
@pytest.mark.parametrize("k", [100, 300])
@pytest.mark.parametrize("block_m", [64, 128])
@pytest.mark.parametrize("kind", LABELS)
def test_update_plain_is_dense_tree_bitwise(kind, block_m, k, dtype):
    plan, _, amp, kp, tiles = _update_case(kind, block_m, k, dtype)
    assert plan.xp.shape[0] > plan.m           # padding rows enter nothing
    sums_p, counts_p = ll.tile_update_plain(*tiles)
    sums, counts = up.update_plain(*tiles)
    assert torch.equal(sums, ops._tree_sum(sums_p))
    assert torch.equal(counts, ops._tree_sum(counts_p))
    assert int(counts.sum()) == plan.m


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16", "fp16"])
@pytest.mark.parametrize("block_m", [64, 128])
@pytest.mark.parametrize("kind", LABELS)
def test_compact_route_is_the_specification(kind, block_m, dtype):
    """The card's dataflow run by the plain versions (entries in the
    kernel's layout, chunked tree passes over sums and counts) gives the
    specification's bits, as the dense route of ``tiled_update`` does."""
    plan, am, amp, kp, tiles = _update_case(kind, block_m, 300, dtype,
                                            m=2100, seed=4)
    want = up.update_plain(*tiles)
    got = up.compact_update(plan.xp, amp, kp, true_m=plan.m,
                            block_m=plan.params.block_m)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    dense = ops.tiled_update(plan, am, 300)
    assert torch.equal(dense[0], want[0][:300, :plan.f])
    assert torch.equal(dense[1], want[1][:300])


def test_entries_layout():
    """Entry t * bm + j is the j-th present cluster of tile t; idx points
    at it from (cluster, slot of t) and is -1 elsewhere."""
    plan, _, amp, kp, tiles = _update_case("random", 64, 300, torch.float32)
    entries, ecnt, idx = up.update_entries_plain(*tiles)
    sums_p, counts_p = ll.tile_update_plain(*tiles)
    slots = up.tree_slots(sums_p.shape[0])
    for t in (0, 3, sums_p.shape[0] - 1):
        ks = (counts_p[t] > 0).nonzero().squeeze(1)
        rows = t * 64 + torch.arange(len(ks))
        assert torch.equal(entries[rows], sums_p[t, ks])
        assert torch.equal(ecnt[rows], counts_p[t, ks])
        assert torch.equal(idx[ks, slots[t]], rows.to(torch.int32))
    assert int((idx >= 0).sum()) == int((counts_p > 0).sum())


@pytest.mark.parametrize("gate", [0, 1])
def test_gated_update_writes_only_when_open(gate):
    plan, _, amp, kp, tiles = _update_case("skewed", 128, 300, torch.float32)
    out = (torch.full((kp, plan.xp.shape[1]), 7.0), torch.full((kp,), 7.0))
    up.compact_update(plan.xp, amp, kp, true_m=plan.m, block_m=128, out=out,
                      gate=torch.tensor(gate, dtype=torch.int32))
    if gate:
        want = up.update_plain(*tiles)
        assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])
    else:
        assert bool((out[0] == 7.0).all()) and bool((out[1] == 7.0).all())


# --- the tree over a stack of problems ---------------------------------------

@pytest.mark.parametrize("shape", [(7, 79, 256, 20), (3, 1, 128, 8),
                                   (2, 513, 4, 3), (48, 5, 2)])
def test_strided_batched_tree_is_movedim_route(shape):
    rng = np.random.default_rng(len(shape) + shape[1])
    a = torch.from_numpy(_order_sensitive(rng, shape))
    want = ops._tree_sum(a.movedim(1, 0).contiguous())
    width = int(np.prod(shape[2:]))
    out = torch.empty((shape[0],) + shape[2:])
    up.tree_passes(a, None, out, rows=shape[0], ntiles=shape[1], width=width,
                   rstride=shape[1] * width, tstride=width)
    assert torch.equal(out, want)
    assert torch.equal(ops._tree_sum(a, 1), want)


@pytest.mark.parametrize("n", [1, 2, 9, 64, 100, 8193])
def test_dense_tree_passes_are_tree_sum(n):
    rng = np.random.default_rng(n)
    a = torch.from_numpy(_order_sensitive(rng, (n, 6)))
    out = torch.empty(6)
    up.tree_passes(a, None, out, rows=1, ntiles=n, width=6, rstride=6 * n,
                   tstride=6)
    assert torch.equal(out, up.tree_sum_plain(a))


# --- parity with the reference package ---------------------------------------

@pytest.mark.parametrize("use_dmr", [False, True])
@pytest.mark.parametrize("block_m", [64, 128])
@pytest.mark.parametrize("kind", ["random", "skewed"])
def test_tiled_update_matches_reference_protected_sums(kind, block_m,
                                                       use_dmr):
    rng = np.random.default_rng(7)
    m, f, k = 1500, 24, 150
    x = rng.standard_normal((m, f)).astype(np.float32)
    am = _labels(kind, m, k, rng).astype(np.int32)
    p = ops.clamp_params(m, k, f, ops.KernelParams(block_m, 128, 32))
    sums, counts = ops.tiled_update(ops.plan_data(torch.from_numpy(x), p),
                                    torch.from_numpy(am), k, use_dmr=use_dmr)
    j_sums, j_counts = j_kmeans.protected_sums(
        jnp.asarray(x), jnp.asarray(am), k, use_dmr=use_dmr)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))
    np.testing.assert_allclose(sums.numpy(), np.asarray(j_sums), rtol=1e-5,
                               atol=1e-4)


def test_wrappers_count_no_launch_on_cpu_and_refuse_other_devices():
    plan, am, amp, kp, _ = _update_case("random", 128, 300, torch.float32)
    before = (up.update_entries.launches, up.tree_reduce.launches,
              dict(up.tree_reduce.kernel_launches))
    up.compact_update(plan.xp, amp, kp, true_m=plan.m, block_m=128)
    up.tree_sum(torch.ones(5, 3, 4), 1)
    ops.tiled_update(plan, am, 300, use_dmr=True)
    assert (up.update_entries.launches, up.tree_reduce.launches,
            up.tree_reduce.kernel_launches) == before
    with pytest.raises(RuntimeError, match="CPU or on one CUDA"):
        up.tree_sum(torch.empty((4, 8), device="meta"))
    with pytest.raises(ValueError):
        up.tree_sum(torch.ones(3, 2), 2)
